"""The row families and the GEMM ladder of the port's zoo slice against
the JAX package's: rope (#18 on rope_batched's kernel, and the cached and
interleaved variants), rms_norm's nine variants (#4 with scalar g, the
accumulator dtype and f16 rows), and the matmul ladder (#16 matmul_naive,
the `matmul` tiers #1-#3, matmul_kpipe #17, hgemm, the torch.matmul
baselines).

The same numpy inputs go through the JAX variant (Pallas in interpret
mode) and the port's (its plain version on the CPU), at the tolerance of
the variant's dtype (core.tolerances: f32 1e-5, bf16 2e-2, f16 2e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpukern.ops  # noqa: F401
import tpukern_torch.ops  # noqa: F401
from torch_parity import assert_parity
from tpukern.core import registry as jax_registry
from tpukern.ops import matmul as jax_matmul
from tpukern_torch.core import registry
from tpukern_torch.ops import matmul, rmsnorm, rope


def _dtype(name):
    tokens = name.split("_")
    return ("bfloat16" if "bf16" in tokens or name.startswith("hgemm")
            else "float16" if "f16" in tokens else "float32")


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(64, 128), (63, 130)], ids=str)
@pytest.mark.parametrize("name", sorted(registry.variants("rope")))
def test_rope_variant_matches_jax(name, shape):
    assert_parity(jax_registry.get("rope", name).fn,
                  registry.get("rope", name).fn, _randn(1, *shape),
                  dtype=_dtype(name), name=name)


RMS = sorted(registry.variants("rms_norm"))


@pytest.mark.parametrize("g", ["one", "scalar", "vector"])
@pytest.mark.parametrize("name", RMS)
def test_rms_norm_variant_matches_jax(name, g):
    """g = 1.0 (the registry's default), a scalar, and a (K,) vector."""
    x = _randn(2, 63, 130)
    jv, tv = jax_registry.get("rms_norm", name), registry.get("rms_norm",
                                                              name)
    if g == "vector":
        gv = 1 + 0.1 * _randn(3, 130)
        assert_parity(jv.fn, tv.fn, x, gv, dtype=_dtype(name), name=name)
        return
    gs = 1.0 if g == "one" else 0.37
    assert_parity(lambda a: jv.fn(a, gs), lambda a: tv.fn(a, gs), x,
                  dtype=_dtype(name), name=name)


def test_rms_norm_bf16_accumulator_rounds_the_mean_square():
    """With acc_dtype bf16 the row's mean square is rounded to bf16 before
    the rsqrt (rmsnorm.py:44-46): a row whose mean square is 1 + 2^-9
    (between two bf16 values) normalizes as if it were 1."""
    x = torch.full((1, 4), (1 + 2 ** -9) ** 0.5)
    y = rmsnorm.rms_norm(x, 1.0, eps=0.0, acc_dtype=torch.bfloat16)
    torch.testing.assert_close(y, x, rtol=0, atol=0)
    y32 = rmsnorm.rms_norm(x, 1.0, eps=0.0)
    assert not torch.equal(y32, x)


MATMUL = sorted(registry.variants("matmul"))


@pytest.mark.parametrize("name", MATMUL)
def test_matmul_ladder_matches_jax(name):
    """(64, 48) @ (48, 80); hgemm_tn_bf16 takes b as (80, 48)."""
    a = _randn(4, 64, 48)
    b = _randn(5, 80, 48) if "_tn_" in name else _randn(5, 48, 80)
    jv, tv = jax_registry.get("matmul", name), registry.get("matmul", name)
    out = tv.fn(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == {"hgemm_accio_bf16_f32acc": torch.float32}.get(
        name, getattr(torch, _dtype(name)))
    assert_parity(jv.fn, tv.fn, a, b, dtype=_dtype(name), name=name)


def test_matmul_ladder_pending_and_ported_cover_jax():
    assert set(MATMUL) | {n for f, n in registry.PENDING if f == "matmul"} \
        == set(jax_registry.variants("matmul"))
    assert len(MATMUL) == 16


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("trans_b", [False, True])
def test_matmul_kpipe_matches_jax_matmul(trans_b, dt):
    """JAX's matmul_kpipe needs a TPU (its emit_pipeline has no interpret
    mode on the CPU); it computes JAX's `matmul`, which the port's is held
    to."""
    a = _randn(6, 64, 48)
    b = _randn(7, 80, 48) if trans_b else _randn(7, 48, 80)
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    assert_parity(
        lambda x, y: jax_matmul.matmul(
            x.astype(jdt), y.astype(jdt), trans_b=trans_b, block_m=32,
            block_n=128, block_k=128),
        lambda x, y: matmul.matmul_kpipe(x.to(tdt), y.to(tdt),
                                         trans_b=trans_b),
        a, b, dtype=dt, name="matmul_kpipe")


@pytest.mark.parametrize("out", [None, "float32"])
def test_hgemm_matches_jax(out):
    a, b = _randn(8, 64, 48), _randn(9, 48, 80)
    jout = None if out is None else jnp.float32
    tout = None if out is None else torch.float32
    assert_parity(
        lambda x, y: jax_matmul.hgemm(x, y, out_dtype=jout, block_m=64,
                                      block_n=128, block_k=128),
        lambda x, y: matmul.hgemm(x, y, out_dtype=tout), a, b,
        dtype="bfloat16", name="hgemm")


def test_rope_is_rope_batched_at_seq_len_s():
    x = torch.from_numpy(_randn(10, 37, 64))
    torch.testing.assert_close(rope.rope(x), rope.rope_batched(x, 37),
                               rtol=0, atol=0)
    torch.testing.assert_close(rope.rope(x), rope.rope_ref(x),
                               rtol=0, atol=0)


def test_matmul_naive_errors():
    with pytest.raises(ValueError, match="matmul_naive"):
        matmul.matmul_naive(torch.ones(4, 3), torch.ones(4, 5))
    with pytest.raises(ValueError, match="matmul_naive"):
        matmul.matmul_naive(torch.ones(4, 3),
                            torch.ones(3, 5, dtype=torch.bfloat16))


def _misaligned(shape, dtype):
    """A contiguous view 2 bytes (bf16) past its buffer's 16-byte aligned
    base."""
    buf = torch.zeros(int(np.prod(shape)) + 1, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    return buf[1:].view(shape)


def _ones(*shape, dtype=torch.bfloat16):
    return torch.ones(shape, dtype=dtype)


# (a, b, the bf16 kernel's load path of each operand): TMA needs a 16-byte
# aligned base and rows a multiple of 16 bytes (K % 8 for A, N % 8 for B)
TMA_CASES = {
    "aligned": (lambda: (_ones(64, 48), _ones(48, 80)), (True, True)),
    "an M and K tail": (lambda: (_ones(200, 1000), _ones(1000, 264)),
                        (True, True)),
    "K % 8 != 0": (lambda: (_ones(64, 45), _ones(45, 80)), (False, True)),
    "N % 8 != 0": (lambda: (_ones(64, 48), _ones(48, 81)), (True, False)),
    "neither": (lambda: (_ones(77, 45), _ones(45, 130)), (False, False)),
    "misaligned view of A": (
        lambda: (_misaligned((64, 48), torch.bfloat16), _ones(48, 80)),
        (False, True)),
    "misaligned views": (
        lambda: (_misaligned((64, 48), torch.bfloat16),
                 _misaligned((48, 80), torch.bfloat16)), (False, False)),
    "a view 16 bytes on": (
        lambda: (_ones(65, 48)[1:], _ones(49, 80)[1:]), (True, True)),
    "f32": (lambda: (_ones(64, 48, dtype=torch.float32),
                     _ones(48, 80, dtype=torch.float32)), (False, False)),
}


@pytest.mark.parametrize("case", sorted(TMA_CASES))
def test_tma_operands_picks_each_load_path(case):
    """matmul.tma_operands, the rule by which #16's launcher picks each
    operand's bf16 load path, on aligned, unaligned and misaligned-view
    inputs; the CPU result is the plain version's whatever the path."""
    make, want = TMA_CASES[case]
    a, b = make()
    assert matmul.tma_operands(a, b) == want
    torch.testing.assert_close(matmul.matmul_naive(a, b),
                               matmul.matmul_naive_ref(a, b), rtol=0, atol=0)


# (trans_b, a, b, the load path of matmul's bf16 kernel, csrc/matmul.cu):
# the same rule per operand on its row-major rows, K for A and a TN B
# (N, K), N for an NN B (K, N); a TN launch is never mixed. The wrapper
# aligns every base first (_build.aligned), so a launch meets only the
# shape rule; the misaligned views give the rule's pointer half.
MATMUL_PATH_CASES = {
    "NN whole": (False, lambda: (_ones(64, 48), _ones(48, 80)), "tma"),
    "NN K tail": (False, lambda: (_ones(200, 1000), _ones(1000, 264)),
                  "tma"),
    "NN K % 8": (False, lambda: (_ones(64, 45), _ones(45, 80)), "mixed"),
    "NN N % 8": (False, lambda: (_ones(64, 48), _ones(48, 81)), "mixed"),
    "NN both": (False, lambda: (_ones(77, 45), _ones(45, 130)), "copy"),
    "NN K 0": (False, lambda: (_ones(64, 0), _ones(0, 80)), "tma"),
    "TN whole": (True, lambda: (_ones(64, 48), _ones(80, 48)), "tma"),
    "TN N % 8": (True, lambda: (_ones(64, 48), _ones(81, 48)), "tma"),
    "TN K % 8": (True, lambda: (_ones(64, 45), _ones(80, 45)), "copy"),
    "TN misaligned B": (
        True, lambda: (_ones(64, 48), _misaligned((80, 48), torch.bfloat16)),
        "mixed"),
    "f32": (False, lambda: (_ones(64, 48, dtype=torch.float32),
                            _ones(48, 80, dtype=torch.float32)), "copy"),
}


@pytest.mark.parametrize("case", sorted(MATMUL_PATH_CASES))
def test_matmul_load_path_rule(case):
    """matmul.load_path(tma_operands(a, b)), the mirror by which matmul
    counts its bf16 launches in path_launches, NN and TN; the CPU result
    is the plain version's whatever the path, and counts no launch."""
    trans_b, make, want = MATMUL_PATH_CASES[case]
    a, b = make()
    assert matmul.load_path(matmul.tma_operands(a, b)) == want
    before = dict(matmul.matmul.path_launches)
    torch.testing.assert_close(
        matmul.matmul(a, b, trans_b=trans_b, out_dtype=torch.float32),
        matmul.matmul_ref(a, b, trans_b=trans_b), rtol=0, atol=0)
    assert matmul.matmul.path_launches == before
