"""The f32 flash-attention forward's order of work, on CPU: the plain walk
`attention_tf32_ref` (tpukern_torch/ops/attention.py) that the split-TF32
wgmma kernel of csrc/flash_attention_tf32.cu computes, against the JAX
package and against the unfused `attention_ref`.

The walk takes tiles of 64 query rows over tiles of 32 keys in `kv_tiles`
order, query head h reading KV head h // (Hq // Hkv); S = Q K^T as
split-TF32 products (hi and lo of each operand, lo read as its TF32
truncation) in fresh f32 sums each 32 columns of D; P V from P split in
the kernel's fragment order (`split_tf32.key_order` on P's columns and
V's rows). Inputs come from a numpy seed. The JAX side runs its Pallas
kernel in interpret mode (conftest forces the CPU platform). Tolerance
2e-5: both sides compute in f32, the split products within 1.25 2^-20 of
each product (ops/split_tf32.py SPLIT_REL), sums in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.ops.attention import flash_attention as jax_flash_attention
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.ops import attention, split_tf32

F32 = dict(rtol=2e-5, atol=2e-5)
# (S, D): lengths off the 64-row and 32-key tiles at every head dim
SHAPES = [(77, 32), (200, 64), (300, 128)]


def _qkv(seed, Hq, Hkv, S, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, Hq, S, D)).astype(np.float32)
    k, v = (rng.standard_normal((1, Hkv, S, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,D", SHAPES)
def test_tf32_walk_matches_jax(S, D, causal, group):
    """o and lse of the walk against JAX's flash_attention (return_stats)
    and attention_ref in f32, 2 KV heads, GQA groups 1, 2 and 4."""
    q, k, v = _qkv(S + D + group, 2 * group, 2, S, D)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = attention.attention_tf32_ref(tq, tk, tv, causal=causal,
                                          return_stats=True)
    jo, jlse = jax_flash_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=causal, return_stats=True)
    ro, rlse = attention.attention_ref(tq, tk, tv, causal=causal,
                                       return_stats=True)
    assert o.dtype == lse.dtype == torch.float32
    check_all_close(o, np.asarray(jo), name="o vs jax", **F32)
    check_all_close(lse, np.asarray(jlse), name="lse vs jax", **F32)
    check_all_close(o, ro, name="o vs ref", **F32)
    check_all_close(lse, rlse, name="lse vs ref", **F32)


@pytest.mark.parametrize("feat", [dict(window=50, sinks=5),
                                  dict(softcap=3.0)], ids=str)
def test_tf32_walk_features_match_jax(feat):
    """The featured instances (window + sinks, softcap) of the walk, GQA
    2, S 200, D 64, against JAX."""
    q, k, v = _qkv(len(feat), 4, 2, 200, 64)
    o, lse = attention.attention_tf32_ref(*map(torch.from_numpy, (q, k, v)),
                                          causal=True, return_stats=True,
                                          **feat)
    jo, jlse = jax_flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                   return_stats=True, **feat)
    check_all_close(o, np.asarray(jo), name="o vs jax", **F32)
    check_all_close(lse, np.asarray(jlse), name="lse vs jax", **F32)


def test_key_order_is_the_fragment_order():
    """split_tf32.key_order mirrors the kernels' tf_perm and tf_frag: A's
    k8 fragment takes an accumulator's columns 2q and 2q + 1 as its columns
    q and q + 4, so B's column c holds key order[c], each key once a slab
    of 8."""
    order = split_tf32.key_order(32)
    assert sorted(order.tolist()) == list(range(32))
    for c in range(32):
        q, hi = c % 4, c % 8 >= 4
        assert order[c] == c // 8 * 8 + 2 * q + hi
    # tf_perm (key -> column) is its inverse
    perm = [(c & ~7) | ((c & 7) >> 1) | ((c & 1) << 2) for c in range(32)]
    assert [perm[int(k)] for k in order] == list(range(32))


def test_split_bmm_ref_sums_slabs_of_32():
    """split_bmm_ref: the split products of each slab of 32 contraction
    values rounded once to f32, slabs added in order; within the split's
    bound (SPLIT_REL of sum |a b|, plus f32 sums) of the f64 product."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((2, 7, 100)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 9, 100)).astype(np.float32))
    out = split_tf32.split_bmm_ref(a, b)
    exact = a.double() @ b.double().mT
    terms = a.abs().double() @ b.abs().double().mT
    slack = (split_tf32.SPLIT_REL + 8 * 2.0 ** -24) * terms
    assert out.dtype == torch.float32 and out.shape == (2, 7, 9)
    assert ((out.double() - exact).abs() <= slack).all()
    by_slab = sum(split_tf32.split_bmm_ref(a[..., s:s + 32], b[..., s:s + 32])
                  for s in range(0, 100, 32))
    assert torch.equal(out, by_slab)
