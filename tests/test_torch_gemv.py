"""The gemv family of the port (ops/gemv.py, kernel #44) against the JAX
package's (tpukern/ops/gemv.py).

Every variant takes the same numpy A and x through the JAX variant (its
Pallas kernel in interpret mode) and the port's (its plain version on the
CPU) at tests/test_matmul.py:63-73's shape and tolerances (M 300, K 1024;
f32 rtol 1e-4, atol 3e-3; bf16 and f16 2e-2 and 0.6). At K 1000, a K
that is no multiple of 512, JAX's `_k512` kernel sums the padded tail of
its last block unmasked and returns NaN (ROADMAP.md §3), so there every
variant is held to the f64 product instead. ops_bench.check holds a gemv
to TOLS plus its contraction slack: a sequential f32 sum passes, a
product of TF32-rounded inputs misses.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpukern.ops  # noqa: F401
import tpukern_torch.ops  # noqa: F401
from torch_parity import to_numpy
from tpukern.core import registry as jax_registry
from tpukern.ops import gemv as jax_gemv
from tpukern_torch.core import registry
from tpukern_torch.harness import ops_bench
from tpukern_torch.ops import gemv

NAMES = sorted(registry.variants("gemv"))
# tests/test_matmul.py:70-73
TOLS = {"f32": dict(rtol=1e-4, atol=3e-3), "2-byte": dict(rtol=2e-2,
                                                          atol=0.6)}


def _inputs(M, K, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal(K).astype(np.float32))


def _tol(name):
    return TOLS["f32" if "_f32_" in name else "2-byte"]


def _dtype(name):
    return {"f32": torch.float32, "bf16": torch.bfloat16,
            "f16": torch.float16}[name.split("_")[1]]


def test_every_jax_variant_has_a_case():
    assert set(jax_registry.variants("gemv")) == set(NAMES)
    assert len(NAMES) == 9
    assert not [k for k in registry.PENDING if k[0] == "gemv"]


@pytest.mark.parametrize("name", NAMES)
def test_variant_matches_jax(name):
    """Both variants round the f32 inputs to their dtype themselves."""
    A, x = _inputs(300, 1024)
    want = jax_registry.get("gemv", name).fn(jnp.asarray(A), jnp.asarray(x))
    got = registry.get("gemv", name).fn(torch.from_numpy(A),
                                        torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (300,)
    np.testing.assert_allclose(to_numpy(got), to_numpy(want), err_msg=name,
                               **_tol(name))


@pytest.mark.parametrize("name", NAMES)
def test_variant_masks_the_k_tail(name):
    """K 1000, a tail in every block_k: held to the f64 product of the
    inputs rounded to the variant's dtype (JAX's gemv_ref in f64)."""
    A, x = _inputs(40, 1000, seed=1)
    dt = _dtype(name)
    got = registry.get("gemv", name).fn(torch.from_numpy(A),
                                        torch.from_numpy(x))
    a, v = (torch.from_numpy(t).to(dt).double() for t in (A, x))
    np.testing.assert_allclose(to_numpy(got), (a @ v).numpy(), err_msg=name,
                               **_tol(name))


def test_jax_k512_sums_its_padded_tail():
    """Why the K 1000 case compares with f64: JAX's own `block_k=512`
    kernel returns non-finite values there, the port's do not."""
    A, x = _inputs(40, 1000)
    out = np.asarray(jax_gemv.gemv(jnp.asarray(A), jnp.asarray(x),
                                   block_k=512))
    assert not np.isfinite(out).all()
    got = gemv.gemv(torch.from_numpy(A), torch.from_numpy(x), block_k=512)
    np.testing.assert_allclose(got.numpy(), A.astype(np.float64) @ x,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("block_k", [None, 7, 512, 2048])
def test_block_sums_are_added_in_order(block_k):
    """gemv_plain sums each K block alone, then adds the blocks in order;
    block_k beyond K is one block."""
    A, x = _inputs(5, 1000, seed=2)
    a, v = torch.from_numpy(A), torch.from_numpy(x)
    bk = 1000 if block_k is None else min(block_k, 1000)
    want = torch.zeros(5)
    for k0 in range(0, 1000, bk):
        want = want + a[:, k0:k0 + bk] @ v[k0:k0 + bk]
    assert torch.equal(gemv.gemv(a, v, block_k=block_k), want)


def test_gemv_checks_its_arguments():
    a, v = torch.zeros(4, 8), torch.zeros(8)
    with pytest.raises(ValueError):
        gemv.gemv(a, v[:7])
    with pytest.raises(ValueError):
        gemv.gemv(a, v, mode="tpu")
    with pytest.raises(ValueError):
        gemv.gemv(a, v, block_k=0)
    assert torch.equal(gemv.gemv(a[:, :0], v[:0]), torch.zeros(4))


def test_ops_bench_inputs_and_check_at_tiny():
    gen = torch.Generator().manual_seed(0)
    S, K = ops_bench.TINY.S, ops_bench.TINY.K
    for name, v in sorted(registry.variants("gemv").items()):
        args = ops_bench.inputs("gemv", name, ops_bench.TINY, gen)
        assert [tuple(a.shape) for a in args] == [(S, K), (K,)]
        assert args[0].dtype == _dtype(name)
        ok, err, rule = ops_bench.check(v, args)
        assert ok and "sum|terms|" in rule, (name, rule, err)
        flops, _, nbytes = ops_bench.work(v, args, v.fn(*args))
        assert flops == 2 * S * K
        assert nbytes == (S * K + K) * args[0].element_size() + 4 * S


def _tf32(t):
    # round to nearest on TF32's 10 mantissa bits, as a TF32 mma reads
    bits = t.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("order,ok", [("columns in sequence", True),
                                      ("tf32 inputs", False)])
def test_gemv_check_holds_f32_rounding_not_tf32(order, ok):
    """ops_bench.check holds gemv_f32_mxu within TOLS plus its contraction
    slack: a product summing K = 1024 columns one after another in f32
    passes, one that reads its inputs as TF32 misses."""
    v = registry.get("gemv", "gemv_f32_mxu")
    gen = torch.Generator("cpu").manual_seed(0)
    A = torch.randn(768, 1024, generator=gen)
    x = torch.randn(1024, generator=gen)

    def fn(A, x):
        if order == "tf32 inputs":
            return v.ref(_tf32(A), _tf32(x))
        y = torch.zeros(768)
        for k in range(1024):
            y = y + A[:, k] * x[k]
        return y

    other = dataclasses.replace(v, fn=fn)
    good, err, rule = ops_bench.check(other, (A, x))
    assert good == ok, f"{order}: {rule} ({err:.3e})"
    assert err > 0
