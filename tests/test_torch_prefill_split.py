"""The split-KV order of the float paged prefix kernel (#24) on the CPU:
paged_prefill_split_ref (the slots cut into splits, each with its own
running max per query row and bf16 P against it, merged in split order)
against the JAX package's interpret-mode paged_prefill_attention and
against the port's plain paged_prefill_ref; and prefill_splits, the
split length the kernel takes from the shapes alone.

T of 1, 5 and 70 new tokens over lengths of 0, 1, chunk - 1, chunk,
chunk + 1, the pool's end and past it (a length below T leaves the
earliest tokens nothing to see). JAX's kernel gives a row that sees no
position the mean of the V rows of the blocks it ran (p = exp(0) against
a running max still at NEG_BIG), where the port's plain version and
kernels give 0: the sequences with such rows (a length below T, or past
the pool with a window) are held to paged_prefill_ref alone. Every mask of
test_paged_decode_features_match_jax (a window of 7 at the longer
lengths leaves whole splits before the band empty); ring pools wrapped
past their slots, with sinks and windows at the ring's limit for T = 5;
ALiBi on a flat pool and on a ring. Tolerances: f32 pools to 2e-5
(torch_serving_common.F32: the merge rescales by exp(m_z - M) where JAX
rescales block by block, f32 rounding apart); bf16 pools at the _TOLS
bf16 row (both round P to bf16, against different running maxima).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_paged_split import FEATURES, HKV, HQ, PAGE, SLOPES
from tpukern.ops import paged_attention as jax_pa
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.ops import paged_attention as pa
from torch_serving_common import F32

CHUNK = 64
S = 3 * CHUNK  # three splits of a 12-page pool
EDGES = [0, 1, CHUNK - 1, CHUNK, CHUNK + 1, S, S + 9]
# ring pools of 128 slots (two splits of 64) verifying T = 5 tokens:
# lengths that wrapped the ring, one at its end and one short; windows
# at the ring's limit (window + T - 1 = ring slots - sinks)
RING_T = 5
RING_CASES = {"limit": dict(window=124, lengths=[300, 9, 128, 129]),
              "sinks limit": dict(window=120, sinks=4,
                                  lengths=[300, 70, 131, 200]),
              "sinks narrow": dict(window=20, sinks=3,
                                   lengths=[261, 66, 127, 190])}


def _inputs(T, D, pps, lengths, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    P = B * pps
    q = scale * rng.standard_normal((B, HQ, T, D)).astype(np.float32)
    k, v = (rng.standard_normal((HKV, P, PAGE, D)).astype(np.float32)
            for _ in range(2))
    table = rng.permutation(P).reshape(B, pps).astype(np.int32)
    return q, k, v, np.asarray(lengths, np.int32), table


def _jax(args, dt=jnp.float32, **kw):
    q, k, v, lengths, table = args
    jkw = dict(kw)
    if "alibi_slopes" in kw:
        jkw["alibi_slopes"] = jnp.asarray(kw["alibi_slopes"].numpy())
    out = jax_pa.paged_prefill_attention(
        *(jnp.asarray(a).astype(dt) for a in (q, k, v)), jnp.asarray(lengths),
        jnp.asarray(table), pages_per_block=2, **jkw)
    return np.asarray(out, np.float32)


def _seen(args, T):
    """The sequences every one of whose rows sees a position in JAX's
    semantics too: lengths from T to the pool's end."""
    lengths, table = args[3], args[4]
    return (lengths >= T) & (lengths <= table.shape[1] * PAGE)


def _torch(args, dt=torch.float32):
    q, k, v, lengths, table = (torch.from_numpy(a) for a in args)
    return q.to(dt), k.to(dt), v.to(dt), lengths, table


@pytest.mark.parametrize("feat", sorted(FEATURES))
@pytest.mark.parametrize("T", [1, 5, 70])
def test_prefill_split_ref_matches_jax(T, feat):
    """f32 pools of three splits, every edge length, each mask: the split
    order against JAX's kernel and the plain version."""
    args = _inputs(T, 32, S // PAGE, EDGES, seed=T + len(feat))
    kw = FEATURES[feat]
    t = _torch(args)
    out = pa.paged_prefill_split_ref(*t, chunk=CHUNK, **kw)
    seen = _seen(args, T)
    check_all_close(out[seen], _jax(args, **kw)[seen], name=f"T{T} {feat}",
                    **F32)
    check_all_close(out, pa.paged_prefill_ref(*t, **kw),
                    name=f"T{T} {feat} vs ref", **F32)
    assert not out[0].any()  # length 0: zeros


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_prefill_split_ref_ring_matches_jax(case, alibi):
    """Ring pools of two splits, wrapped past their slots, with sinks and
    windows at the ring's limit, with and without ALiBi."""
    kw = dict(RING_CASES[case])
    lengths = kw.pop("lengths")
    args = _inputs(RING_T, 32, 8, lengths, seed=len(case) + alibi)
    kw["ring"] = True
    if alibi:
        kw["alibi_slopes"] = torch.from_numpy(SLOPES)
    t = _torch(args)
    out = pa.paged_prefill_split_ref(*t, chunk=CHUNK, **kw)
    check_all_close(out, _jax(args, **kw), name=f"ring {case}", **F32)
    check_all_close(out, pa.paged_prefill_ref(*t, **kw),
                    name=f"ring {case} vs ref", **F32)


@pytest.mark.parametrize("feat", ["alibi", "alibi+window"])
def test_prefill_split_ref_alibi_matches_jax(feat):
    """ALiBi on a flat pool of three splits, alone and with a window that
    empties the splits before its band."""
    args = _inputs(5, 64, S // PAGE, EDGES, seed=31)
    kw = dict(alibi_slopes=torch.from_numpy(SLOPES))
    if feat == "alibi+window":
        kw["window"] = 7
    t = _torch(args)
    out = pa.paged_prefill_split_ref(*t, chunk=CHUNK, **kw)
    seen = _seen(args, 5)
    check_all_close(out[seen], _jax(args, **kw)[seen], name=feat, **F32)
    check_all_close(out, pa.paged_prefill_ref(*t, **kw),
                    name=f"{feat} vs ref", **F32)


@pytest.mark.parametrize("feat", ["plain", "all"])
@pytest.mark.parametrize("T", [5, 70])
def test_prefill_split_ref_bf16_matches_jax(T, feat):
    """bf16 pools: P rounded to bf16 against each split's running max,
    within the bf16 tolerance of JAX's kernel (P rounded against its
    page blocks' running max) and of the plain version (the final max).
    The scores are scaled up so that P spreads over many tokens."""
    args = _inputs(T, 64, S // PAGE, EDGES, seed=5 + T, scale=2.0)
    kw = FEATURES[feat]
    bf = torch.bfloat16
    t = _torch(args, bf)
    out = pa.paged_prefill_split_ref(*t, chunk=CHUNK, **kw)
    assert out.dtype == bf
    seen = _seen(args, T)
    check_all_close(out.float()[seen], _jax(args, jnp.bfloat16, **kw)[seen],
                    dtype=bf, name=f"bf16 T{T} {feat}")
    check_all_close(out.float(), pa.paged_prefill_ref(*t, **kw).float(),
                    dtype=bf, name=f"bf16 T{T} {feat} vs ref")


def test_prefill_split_ref_one_split_is_one_pass():
    """A chunk as long as the pool is one split (the merge is the
    identity), and the default chunk is prefill_splits'."""
    args = _torch(_inputs(5, 32, 8, [5, 100, 128], seed=2))
    one = pa.paged_prefill_split_ref(*args, chunk=128)
    check_all_close(one, pa.paged_prefill_split_ref(*args, chunk=64), **F32)
    chunk, _ = pa.prefill_splits(3, HQ, HKV, 5, 128, torch.float32)
    assert torch.equal(pa.paged_prefill_split_ref(*args),
                       pa.paged_prefill_split_ref(*args, chunk=chunk))


def test_decode_split_ref_is_the_prefix_order_at_one_token():
    """paged_attention_split_ref is paged_prefill_split_ref with T = 1."""
    q, k, v, lengths, table = _torch(_inputs(1, 32, S // PAGE, EDGES, 4))
    assert torch.equal(
        pa.paged_attention_split_ref(q[:, :, 0], k, v, lengths, table,
                                     chunk=CHUNK, window=7, sinks=3),
        pa.paged_prefill_split_ref(q, k, v, lengths, table, chunk=CHUNK,
                                   window=7, sinks=3)[:, :, 0])


# (B, Hq, Hkv, T, S, dtype) -> (slots a split, n_split): the verify and
# chunk shapes of chip_smoke.py in both tiers, the GPU tests' split edges,
# one tile, no slot, and a prefill that fills the card alone
@pytest.mark.parametrize("shape,want", [
    ((4, 16, 8, 5, 1024, torch.bfloat16), (128, 8)),
    ((4, 16, 8, 5, 1024, torch.float32), (64, 16)),
    ((1, 16, 8, 256, 1024, torch.bfloat16), (256, 4)),
    ((1, 16, 8, 256, 1024, torch.float32), (128, 8)),
    ((7, 8, 2, 5, 192, torch.bfloat16), (64, 3)),
    ((2, 4, 2, 1, 64, torch.float32), (64, 1)),
    ((3, 4, 2, 5, 0, torch.float32), (64, 1)),
    ((8, 32, 8, 2048, 4096, torch.bfloat16), (4096, 1))])
def test_prefill_splits(shape, want):
    """n_split from shapes alone: the fewest splits that give
    SPLIT_BLOCKS[dtype] blocks, whole tiles of keys each, at least
    one."""
    assert pa.prefill_splits(*shape) == want


@pytest.mark.parametrize("B,T,S", [(1, 1, 64), (4, 5, 1024), (2, 70, 300),
                                   (16, 3, 8192), (1, 512, 2048)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_prefill_splits_cover_the_slots(B, T, S, dt):
    """Every split is whole tiles of keys, has a slot below S, and the
    splits cover all S slots."""
    chunk, n = pa.prefill_splits(B, 16, 8, T, S, dt)
    assert chunk % pa.PREFILL_TILE == 0 and n >= 1
    assert (n - 1) * chunk < S <= n * chunk


def test_prefill_chunk_overrides_the_rule(monkeypatch):
    """PREFILL_CHUNK, where set, is the split length at every shape."""
    monkeypatch.setattr(pa, "PREFILL_CHUNK", 256)
    assert pa.prefill_splits(4, 16, 8, 5, 1024, torch.bfloat16) == (256, 4)
    assert pa.prefill_splits(1, 16, 8, 256, 300, torch.float32) == (256, 2)
