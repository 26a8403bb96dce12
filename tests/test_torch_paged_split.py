"""The split-KV order of the float paged decode kernel (#23) on the CPU:
paged_attention_split_ref (the slots cut into splits, each with its own
running max and bf16 P against it, merged in split order) against the
JAX package's interpret-mode paged_attention and against the port's
plain paged_attention_ref.

Lengths of 0, 1, chunk - 1, chunk, chunk + 1, the pool's end and past
it; every mask of test_paged_decode_features_match_jax (a window of 7 at
the longer lengths leaves whole splits before the band empty); ring
pools wrapped past their slots, with sinks; ALiBi on a flat pool and on
a ring. Tolerances: f32 pools to 2e-5 (torch_serving_common.F32: the
merge rescales by exp(m_z - M) where JAX rescales tile by tile, f32
rounding apart); bf16 pools at the _TOLS bf16 row (both round P to bf16,
against different running maxima).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.ops import paged_attention as jax_pa
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.ops import paged_attention as pa
from torch_serving_common import F32

# the masks of tests/test_torch_prefix_kernels.py FEATURES
FEATURES = {"plain": {}, "window": dict(window=7),
            "window+sinks": dict(window=7, sinks=3),
            "softcap": dict(softcap=0.5),
            "all": dict(window=9, sinks=2, softcap=0.5)}
HQ, HKV, PAGE = 4, 2, 16
SLOPES = 2.0 ** (-np.arange(1, HQ + 1, dtype=np.float32))
# ring pools of 128 slots (two splits of 64): lengths that wrapped the
# ring, one at its end and one short; windows at the ring's limit
RING_CASES = {"limit": dict(window=128, lengths=[300, 9, 128, 129]),
              "sinks limit": dict(window=124, sinks=4,
                                  lengths=[300, 70, 131, 200]),
              "sinks narrow": dict(window=20, sinks=3,
                                   lengths=[261, 66, 127, 190])}


def _edge_lengths(chunk, S):
    return [0, 1, chunk - 1, chunk, chunk + 1, S, S + 9]


def _inputs(B, D, pps, lengths, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    P = B * pps
    q = scale * rng.standard_normal((B, HQ, D)).astype(np.float32)
    k, v = (rng.standard_normal((HKV, P, PAGE, D)).astype(np.float32)
            for _ in range(2))
    table = rng.permutation(P).reshape(B, pps).astype(np.int32)
    return q, k, v, np.asarray(lengths, np.int32), table


def _jax(args, dt=jnp.float32, **kw):
    q, k, v, lengths, table = args
    jkw = dict(kw)
    if "alibi_slopes" in kw:
        jkw["alibi_slopes"] = jnp.asarray(kw["alibi_slopes"].numpy())
    out = jax_pa.paged_attention(
        *(jnp.asarray(a).astype(dt) for a in (q, k, v)), jnp.asarray(lengths),
        jnp.asarray(table), pages_per_block=2, **jkw)
    return np.asarray(out, np.float32)


def _torch(args, dt=torch.float32):
    q, k, v, lengths, table = (torch.from_numpy(a) for a in args)
    return q.to(dt), k.to(dt), v.to(dt), lengths, table


@pytest.mark.parametrize("feat", sorted(FEATURES))
@pytest.mark.parametrize("chunk", [64, 128])
def test_split_ref_matches_jax(chunk, feat):
    """f32 pools of three splits (S = 3 chunk), every edge length, each
    mask: the split order against JAX's kernel and the plain version."""
    S = 3 * chunk
    lengths = _edge_lengths(chunk, S)
    args = _inputs(len(lengths), 32, S // PAGE, lengths, seed=chunk)
    kw = FEATURES[feat]
    t = _torch(args)
    out = pa.paged_attention_split_ref(*t, chunk=chunk, **kw)
    check_all_close(out, _jax(args, **kw), name=f"{feat} chunk {chunk}",
                    **F32)
    check_all_close(out, pa.paged_attention_ref(*t, **kw),
                    name=f"{feat} chunk {chunk} vs ref", **F32)
    assert not out[0].any()  # length 0: zeros


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_split_ref_ring_matches_jax(case, alibi):
    """Ring pools of two splits, wrapped past their slots, with sinks and
    windows at the ring's limit, with and without ALiBi."""
    kw = dict(RING_CASES[case])
    lengths = kw.pop("lengths")
    args = _inputs(len(lengths), 32, 8, lengths, seed=len(case) + alibi)
    kw["ring"] = True
    if alibi:
        kw["alibi_slopes"] = torch.from_numpy(SLOPES)
    t = _torch(args)
    out = pa.paged_attention_split_ref(*t, chunk=64, **kw)
    check_all_close(out, _jax(args, **kw), name=f"ring {case}", **F32)
    check_all_close(out, pa.paged_attention_ref(*t, **kw),
                    name=f"ring {case} vs ref", **F32)


@pytest.mark.parametrize("feat", ["alibi", "alibi+window"])
def test_split_ref_alibi_matches_jax(feat):
    """ALiBi on a flat pool of three splits, alone and with a window that
    empties the splits before its band."""
    lengths = _edge_lengths(64, 192)
    args = _inputs(len(lengths), 64, 12, lengths, seed=31)
    kw = dict(alibi_slopes=torch.from_numpy(SLOPES))
    if feat == "alibi+window":
        kw["window"] = 7
    t = _torch(args)
    out = pa.paged_attention_split_ref(*t, chunk=64, **kw)
    check_all_close(out, _jax(args, **kw), name=feat, **F32)
    check_all_close(out, pa.paged_attention_ref(*t, **kw),
                    name=f"{feat} vs ref", **F32)


@pytest.mark.parametrize("feat", ["plain", "all"])
def test_split_ref_bf16_matches_jax(feat):
    """bf16 pools: P rounded to bf16 against each split's running max,
    within the bf16 tolerance of JAX's kernel (P rounded against its
    page blocks' running max) and of the plain version (the final max).
    The scores are scaled up so that P spreads over many tokens."""
    lengths = _edge_lengths(64, 192)
    args = _inputs(len(lengths), 64, 12, lengths, seed=5, scale=2.0)
    kw = FEATURES[feat]
    bf = torch.bfloat16
    t = _torch(args, bf)
    out = pa.paged_attention_split_ref(*t, chunk=64, **kw)
    assert out.dtype == bf
    check_all_close(out.float(), _jax(args, jnp.bfloat16, **kw), dtype=bf,
                    name=f"bf16 {feat}")
    check_all_close(out.float(), pa.paged_attention_ref(*t, **kw).float(),
                    dtype=bf, name=f"bf16 {feat} vs ref")


def test_split_ref_one_split_is_one_pass():
    """A chunk as long as the pool is one split: the merge is the
    identity, and the default chunk is DECODE_CHUNK."""
    args = _torch(_inputs(3, 32, 8, [5, 100, 128], seed=2))
    one = pa.paged_attention_split_ref(*args, chunk=128)
    check_all_close(one, pa.paged_attention_split_ref(*args, chunk=64),
                    **F32)
    assert torch.equal(pa.paged_attention_split_ref(*args),
                       pa.paged_attention_split_ref(
                           *args, chunk=pa.DECODE_CHUNK))


@pytest.mark.parametrize("pps,page,chunk,want", [
    (8, 128, 128, 8), (8, 128, 256, 4), (64, 128, 128, 64), (1, 16, 64, 1),
    (5, 16, 64, 2), (0, 16, 64, 1)])
def test_decode_splits(monkeypatch, pps, page, chunk, want):
    """n_split = ceil(slots / DECODE_CHUNK), at least 1, from shapes
    alone."""
    monkeypatch.setattr(pa, "DECODE_CHUNK", chunk)
    assert pa.decode_splits(pps, page) == want
