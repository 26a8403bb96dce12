"""The bf16 flash-attention forward's order of work, on CPU: the plain walk
`attention_tiled_ref` (tpukern_torch/ops/attention.py) that the TMA +
wgmma kernel of csrc/flash_attention.cu computes, against the JAX package
and against the unfused `attention_ref`.

The walk visits each query tile's KV tiles in `kv_tiles` order (the
kernel's KvRange: sink tiles, then the band), runs the online softmax in
log2 units with l summed from the f32 p, and rounds P to the inputs'
dtype before P V. Inputs come from a numpy seed. The JAX side runs its
Pallas kernel in interpret mode (conftest forces the CPU platform) with
64-row blocks. Tolerances: f32 2e-5 (both sides compute in f32; sums in
another order), bf16 the bf16 row of tpukern_torch/core/tolerances.py
(JAX's bf16 tier rounds q · scale to bf16, the walk scales the f32
score, and both round P to bf16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.ops.attention import flash_attention as jax_flash_attention
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.ops import attention

F32 = dict(rtol=2e-5, atol=2e-5)
# the masks of tests/test_torch_featured_attention.py: a window whose band
# straddles the 64-row tiles, with sinks, a softcap that bends the scores,
# and segments whose last id only queries carry
FEATURES = {
    "window": dict(window=50),
    "window+sinks": dict(window=50, sinks=5),
    "softcap": dict(softcap=3.0),
    "segments": dict(segments=True),
    "window+softcap+segments": dict(window=50, softcap=3.0, segments=True),
}


def _qkv(seed, B, Hq, Hkv, S, D, Skv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, S, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Hkv, Skv or S, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _segments(B, n):
    """(q_seg, kv_seg) numpy int32 (B, n): packed sequences of 60, 100 and
    n - 160 tokens, the last a query-only padding id."""
    q_seg = np.repeat(np.array([0, 1, 2], np.int32), [60, 100, n - 160])
    kv_seg = np.where(q_seg == 2, 3, q_seg).astype(np.int32)
    return np.tile(q_seg, (B, 1)), np.tile(kv_seg, (B, 1))


def _kwargs(feat, B, n):
    """(JAX kwargs, port kwargs, bool (n,) rows that see a key)."""
    kw = {k: v for k, v in feat.items() if k != "segments"}
    if not feat.get("segments"):
        return kw, dict(kw), np.ones(n, bool)
    q_seg, kv_seg = _segments(B, n)
    return (dict(kw, segment_ids=(jnp.asarray(q_seg), jnp.asarray(kv_seg))),
            dict(kw, segment_ids=(torch.from_numpy(q_seg),
                                  torch.from_numpy(kv_seg))), q_seg[0] != 2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,D", [(200, 64), (300, 128), (300, 64),
                                 (200, 128)])
def test_tiled_walk_matches_jax_f32(S, D, causal):
    """o and lse of the walk, GQA 2, lengths off the 64-row tiles, against
    JAX's flash_attention and attention_ref in f32."""
    q, k, v = _qkv(S + D, 2, 4, 2, S, D)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = attention.attention_tiled_ref(tq, tk, tv, causal=causal,
                                           return_stats=True)
    jo, jlse = jax_flash_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=causal, return_stats=True,
                                   block_q=64, block_k=64)
    ro, rlse = attention.attention_ref(tq, tk, tv, causal=causal,
                                       return_stats=True)
    check_all_close(o, np.asarray(jo), name="o vs jax", **F32)
    check_all_close(lse, np.asarray(jlse), name="lse vs jax", **F32)
    check_all_close(o, ro, name="o vs ref", **F32)
    check_all_close(lse, rlse, name="lse vs ref", **F32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,D", [(200, 64), (300, 128)])
def test_tiled_walk_matches_jax_bf16(S, D, causal):
    """bf16 inputs: the walk rounds P to bf16 before P V, as the kernel
    does; held to JAX's bf16 tier and to attention_ref at the bf16
    tolerance, its lse (f32 scores) at f32's."""
    q, k, v = _qkv(S * D, 1, 4, 2, S, D)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    o, lse = attention.attention_tiled_ref(tq, tk, tv, causal=causal,
                                           return_stats=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    jo = jax_flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                               for a in (q, k, v)), causal=causal,
                             block_q=64, block_k=64)
    ro, rlse = attention.attention_ref(tq, tk, tv, causal=causal,
                                       return_stats=True)
    check_all_close(o.float(), np.asarray(jo.astype(jnp.float32)),
                    dtype=torch.bfloat16, name="o vs jax")
    check_all_close(o.float(), ro.float(), dtype=torch.bfloat16,
                    name="o vs ref")
    check_all_close(lse, rlse, name="lse vs ref", rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(FEATURES))
def test_tiled_walk_features_match_jax(name):
    """The window (+ sinks), softcap and segments in f32, GQA 2: o on
    every row, lse on the rows that see a key; a row that sees no key
    gives 0."""
    S = 200
    q, k, v = _qkv(len(name), 2, 4, 2, S, 64)
    jkw, tkw, seen = _kwargs(FEATURES[name], 2, S)
    o, lse = attention.attention_tiled_ref(*map(torch.from_numpy, (q, k, v)),
                                           causal=True, return_stats=True,
                                           **tkw)
    jo, jlse = jax_flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                   return_stats=True, block_q=64, block_k=64,
                                   **jkw)
    ro, rlse = attention.attention_ref(*map(torch.from_numpy, (q, k, v)),
                                       causal=True, return_stats=True, **tkw)
    check_all_close(o, np.asarray(jo), name=f"{name} o vs jax", **F32)
    check_all_close(lse[..., seen], np.asarray(jlse)[..., seen],
                    name=f"{name} lse vs jax", **F32)
    check_all_close(o, ro, name=f"{name} o vs ref", **F32)
    check_all_close(lse[..., seen], rlse[..., seen],
                    name=f"{name} lse vs ref", **F32)
    assert not o[..., ~seen, :].any()


@pytest.mark.parametrize("block_q,block_k", [(128, 64), (64, 128),
                                             (128, 128)])
@pytest.mark.parametrize("feat", [None, "window+sinks"])
def test_tile_shapes_compute_one_function(block_q, block_k, feat):
    """The kernel's tile shapes (128 query rows a block, 128-key tiles)
    walk other tiles in another order: the same function within f32
    rounding, at D 128 and S 300."""
    q, k, v = _qkv(block_q + block_k, 1, 4, 2, 300, 128)
    kw = FEATURES[feat] if feat else {}
    args = tuple(map(torch.from_numpy, (q, k, v)))
    o, lse = attention.attention_tiled_ref(*args, causal=True,
                                           return_stats=True,
                                           block_q=block_q, block_k=block_k,
                                           **kw)
    o64, lse64 = attention.attention_tiled_ref(*args, causal=True,
                                               return_stats=True, **kw)
    check_all_close(o, o64, name="o", **F32)
    check_all_close(lse, lse64, name="lse", **F32)


@pytest.mark.parametrize("q0,kv_end,block_k,window,sinks,want", [
    (256, 320, 64, None, None, [0, 64, 128, 192, 256]),
    (256, 320, 64, 50, None, [192, 256]),
    (256, 320, 64, 50, 5, [0, 192, 256]),
    (256, 384, 128, 50, 5, [0, 128, 256]),
    (64, 128, 64, 50, 5, [0, 64]),
    (0, 64, 64, 50, 70, [0]),
])
def test_kv_tiles_walks_sinks_then_the_band(q0, kv_end, block_k, window,
                                            sinks, want):
    """kv_tiles, the kernel's KvRange: the sink tiles first, then the band
    from the tile holding q0 - window + 1, each tile once."""
    assert list(attention.kv_tiles(q0, kv_end, block_k, window,
                                   sinks)) == want


def test_kv_tiles_cover_every_visible_key():
    """Every key a row of the query tile sees lies in a walked tile, over
    windows, sinks and tile sizes around the tile edges."""
    S = 300
    for block in (64, 128):
        for window in (None, 1, 37, 64, 65, 200):
            for sinks in ((None,) if window is None else (None, 5, 64, 70)):
                keep = attention.visible(S, S, "cpu", causal=True,
                                         window=window, sinks=sinks)[0, 0]
                for q0 in range(0, S, block):
                    end = min(S, q0 + block)
                    cols = torch.zeros(S, dtype=torch.bool)
                    tiles = list(attention.kv_tiles(q0, end, block, window,
                                                    sinks))
                    assert len(set(tiles)) == len(tiles)
                    for k0 in tiles:
                        cols[k0:k0 + block] = True
                    assert not (keep[q0:end] & ~cols).any(), (block, window,
                                                              sinks, q0)


@pytest.mark.parametrize("B,Hq,S,want", [
    (1, 16, 512, (64, 128, False)),   # the 7bish prefill: 128 blocks
    (1, 16, 128, (64, 128, False)),
    (1, 16, 4096, (128, 64, False)),  # 1024 blocks of 64 rows
    (2, 16, 1024, (128, 64, False)),  # the training shape
    (1, 16, 528, (128, 64, False)),   # 144 blocks of 64 rows: two waves
])
def test_fwd_tiles_rule(B, Hq, S, want):
    """The bf16 kernel's default tiles on a 132-SM card: 64-row blocks of
    128-key tiles where they fit in one wave, else 128-row blocks of
    64-key tiles; both are FWD_CONFIGS shapes."""
    got = attention.fwd_tiles(B, Hq, S, 132)
    assert got == want and got in attention.FWD_CONFIGS
