"""tpukern_torch ops against the JAX package on CPU.

Inputs come from a numpy seed and go through both sides. The JAX side
runs its Pallas kernels in interpret mode (conftest forces the CPU
platform); the port side takes the plain PyTorch versions, as its
wrappers do for CPU tensors.

Tolerances: f32 2e-5 (both sides compute in f32; sums are taken in
another order), bf16 the _TOLS bf16 row. The CUDA kernels against their
plain versions are in tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.core.tolerances import _TOLS as JAX_TOLS
from tpukern.ops.attention import flash_attention as jax_flash_attention
from tpukern.ops.paged_attention import paged_attention as jax_paged_attention
from tpukern.ops.rmsnorm import rms_norm as jax_rms_norm
from tpukern.ops.rope import make_cos_sin as jax_make_cos_sin
from tpukern.ops.rope import rope_cached as jax_rope_cached
from tpukern_torch.core.tolerances import _TOLS, check_all_close
from tpukern_torch.ops import attention, paged_attention, rmsnorm, rope

F32 = dict(rtol=2e-5, atol=2e-5)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _both(x, dt):
    """numpy f32 x as a (JAX, torch) pair of dtype key dt."""
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _close(t_out, j_out, dt, name):
    ref = np.asarray(j_out.astype(jnp.float32))
    tol = F32 if dt == "f32" else {}
    check_all_close(t_out.float(), ref, dtype=DTYPES[dt][1], name=name, **tol)


def test_tolerance_table_matches_jax():
    assert _TOLS == JAX_TOLS


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rms_norm_matches_jax(dt):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((24, 256)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    (jx, tx), (jg, tg) = _both(x, dt), _both(g, dt)
    _close(rmsnorm.rms_norm(tx, tg), jax_rms_norm(jx, jg), dt, "rms_norm")


def test_make_cos_sin_matches_jax():
    # angle = pos * exp(...): one ulp of exp grows by pos (up to 511 here)
    for t, j in zip(rope.make_cos_sin(512, 64, device="cpu"),
                    jax_make_cos_sin(512, 64)):
        check_all_close(t, np.asarray(j), rtol=0, atol=1e-4)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rope_cached_matches_jax(dt):
    rng = np.random.default_rng(1)
    R, D = 40, 64
    x = rng.standard_normal((R, D)).astype(np.float32)
    pos = rng.integers(0, 512, R)
    cos, sin = (np.asarray(a)[pos] for a in jax_make_cos_sin(512, D))
    jx, tx = _both(x, dt)
    out = rope.rope_cached(tx, torch.from_numpy(cos), torch.from_numpy(sin))
    _close(out, jax_rope_cached(jx, jnp.asarray(cos), jnp.asarray(sin)), dt,
           "rope_cached")


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", [48, 100, 128])
@pytest.mark.parametrize("group", [1, 2])
def test_flash_attention_matches_jax(group, S, D):
    rng = np.random.default_rng(S + D + group)
    Hkv = 2
    q = rng.standard_normal((1, Hkv * group, S, D)).astype(np.float32)
    k, v = (rng.standard_normal((1, Hkv, S, D)).astype(np.float32)
            for _ in range(2))
    out = attention.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                    causal=True)
    ref = jax_flash_attention(*map(jnp.asarray, (q, k, v)), causal=True)
    _close(out, ref, "f32", f"flash_attention g{group} S{S} D{D}")


def _paged_inputs(rng, B, Hq, Hkv, D, page, pps):
    P = B * pps
    table = rng.permutation(P).reshape(B, pps).astype(np.int32)
    kp, vp = (rng.standard_normal((Hkv, P, page, D)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    return q, kp, vp, table


@pytest.mark.parametrize("dt,D,group", [("f32", 32, 2), ("f32", 128, 1),
                                        ("bf16", 64, 2)])
def test_paged_attention_matches_jax(dt, D, group):
    """Shuffled page table; lengths 0, 1, a ragged one and the full pool."""
    rng = np.random.default_rng(D)
    page, pps = 16, 4
    q, kp, vp, table = _paged_inputs(rng, 4, 2 * group, 2, D, page, pps)
    lengths = np.array([0, 1, 37, page * pps], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dt) for a in (q, kp, vp))
    out = paged_attention.paged_attention(
        tq, tk, tv, torch.from_numpy(lengths), torch.from_numpy(table))
    ref = jax_paged_attention(jq, jk, jv, jnp.asarray(lengths),
                              jnp.asarray(table), pages_per_block=2)
    _close(out, ref, dt, f"paged_attention {dt} D{D}")
    assert not out[0].any()  # length 0 -> 0


def test_unported_features_raise():
    q = torch.zeros(1, 2, 8, 32)
    for kw in (dict(causal_offset=3), dict(return_carry=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            attention.flash_attention(q, q, q, causal=True, **kw)
    kp = torch.zeros(2, 4, 16, 32)
    args = (torch.zeros(2, 2, 32), kp, kp, torch.ones(2, dtype=torch.int32),
            torch.zeros(2, 2, dtype=torch.int32))
    # ring pools and ALiBi are ported: what JAX asserts raises ValueError
    # (a ring without a window, a window past the ring, softcap + ALiBi)
    for kw in (dict(ring=True), dict(ring=True, window=33),
               dict(alibi_slopes=torch.ones(2), softcap=1.0)):
        with pytest.raises(ValueError):
            paged_attention.paged_attention(*args, **kw)
