"""The split-KV order of the quantized paged kernel (csrc/paged_quant.cu,
#23/#24 on int8 and fp8 pools) on the CPU: the plain walk
`paged_prefill_quantized_split_ref` / `paged_attention_quantized_split_ref`
(tpukern_torch/ops/paged_attention.py: the slots cut into splits, each
split with its own running max and p' = p * v_scale rounded to q's type;
with pv_int8 two passes, the pieces' maxima first, then each split's
share of each page block against the block's running max and amax; the
splits merged in split order) against the JAX package's interpret-mode
quantized decode and prefix kernels, and the split rule `quant_splits`.

Tiers: int8, int8 with q_int8, int8 with pv_int8 at one page a block and
at two (the whole pool, as served), with q_int8 too, and fp8; splits of
64 slots that cut the 128-slot page blocks, and pv_int8 splits of a
whole page block and of two; the window, sinks and softcap, ring
pools wrapped past their slots, and ALiBi. Pages of 64 slots: the JAX
kernels' interpret mode takes about a second a call at two pages a
block, four at eight pages of 16. JAX's pools are zero-padded to
128 columns (zero columns change neither absmax nor a dot). Tolerances:
q in f32 to 1e-5, as tests/test_torch_quantized_paged.py holds the plain
version (the merge rescales by exp(m_z - M) where JAX rescales block by
block, f32 rounding apart); q in bf16 at the _TOLS bf16 row (both round
p * v_scale to bf16, against different running maxima).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.ops import paged_attention as jax_pa
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.ops import paged_attention as pa

B, HQ, HKV, D, PAGE, PPS = 2, 4, 2, 32, 64, 2
S = PAGE * PPS  # 128 slots a sequence: two 64-slot tiles, two pages
JAX_QDT = {torch.int8: jnp.int8, torch.float8_e4m3fn: jnp.float8_e4m3fn}
# (pool dtype, q_int8, pv_int8, pages_per_block)
TIERS = {"int8": ("int8", False, False, 2),
         "int8 q_int8": ("int8", True, False, 2),
         "int8 pv_int8 ppb1": ("int8", False, True, 1),
         "int8 q_int8 pv_int8 ppb2": ("int8", True, True, 2),
         "fp8": ("fp8", False, False, 2)}
QDTYPES = {"f32": (torch.float32, jnp.float32, dict(rtol=1e-5, atol=1e-5)),
           "bf16": (torch.bfloat16, jnp.bfloat16, {})}
SLOPES = 2.0 ** (-np.arange(1, HQ + 1, dtype=np.float32))


def _inputs(T, lengths, seed):
    rng = np.random.default_rng(seed)
    P = B * PPS
    q = rng.standard_normal((B, HQ, T, D)).astype(np.float32)
    k, v = (rng.standard_normal((HKV, P, PAGE, D)).astype(np.float32)
            for _ in range(2))
    table = rng.permutation(P).reshape(B, PPS).astype(np.int32)
    return q, k, v, np.asarray(lengths, np.int32), table


def _chunks(pv_int8, ppb):
    """The split lengths to walk: the rule's (64 slots: two splits, which
    cut the 128-slot page blocks) and one split, or with pv_int8 a page
    block and two."""
    return [None, S] + ([PAGE * ppb, 2 * PAGE * ppb] if pv_int8 else [])


def _run(T, tier, qdt, lengths, seed, **feat):
    """The split walk at each of _chunks against JAX's kernel (T = 0: one
    token a sequence, the decode kernel)."""
    decode = T == 0
    dtype, q_int8, pv_int8, ppb = TIERS[tier]
    tdt, jdt, tol = QDTYPES[qdt]
    q, k, v, lengths, table = _inputs(max(T, 1), lengths, seed)
    kq, ks = pa.quantize_pages(torch.from_numpy(k), dtype)
    vq, vs = pa.quantize_pages(torch.from_numpy(v), dtype)

    def jax_pool(x):  # JAX's pools carry D padded to 128 lanes
        arr = jnp.pad(jnp.asarray(x.float().numpy()),
                      ((0, 0), (0, 0), (0, 0), (0, 128 - D)))
        return arr.astype(JAX_QDT[x.dtype])

    kw = dict(pages_per_block=ppb, q_int8=q_int8, pv_int8=pv_int8, **feat)
    jkw = dict(kw)
    if "alibi_slopes" in feat:
        jkw["alibi_slopes"] = jnp.asarray(feat["alibi_slopes"].numpy())
    tq = torch.from_numpy(q).to(tdt)
    jq = jnp.asarray(tq.float().numpy()).astype(jdt)
    if decode:
        tq, jq = tq[:, :, 0], jq[:, :, 0]
    jfn = (jax_pa.paged_attention_quantized if decode
           else jax_pa.paged_prefill_attention_quantized)
    fn = (pa.paged_attention_quantized_split_ref if decode
          else pa.paged_prefill_quantized_split_ref)
    ref = np.asarray(jfn(jq, jax_pool(kq), jnp.asarray(ks.numpy()),
                         jax_pool(vq), jnp.asarray(vs.numpy()),
                         jnp.asarray(lengths), jnp.asarray(table), **jkw),
                     np.float32)
    for chunk in _chunks(pv_int8, ppb):
        out = fn(tq, kq, ks, vq, vs, torch.from_numpy(lengths),
                 torch.from_numpy(table), chunk=chunk, **kw)
        assert out.dtype == tdt and out.shape == tq.shape
        check_all_close(out.float(), ref, dtype=tdt,
                        name=f"{tier} {qdt} T{T} chunk {chunk} {feat}", **tol)


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("T", [0, 5])
def test_split_walk_matches_jax(T, tier):
    """Decode (T = 0) and T = 5 new tokens at lengths of one slot, one
    past a tile and a full pool, each tier, each split length."""
    _run(T, tier, "f32", [1, 65] if T == 0 else [6, S], seed=T + len(tier))


@pytest.mark.parametrize("T,tier", [(0, "int8 q_int8"), (5, "fp8"),
                                    (0, "int8 q_int8 pv_int8 ppb2")])
def test_split_walk_bf16_matches_jax(T, tier):
    """q in bf16: p * v_scale rounded to bf16 against the split's running
    max."""
    _run(T, tier, "bf16", [1, 65] if T == 0 else [6, S], seed=40 + T)


@pytest.mark.parametrize("T,tier", [(0, "int8 q_int8 pv_int8 ppb2"),
                                    (5, "fp8")])
def test_split_walk_window_softcap_matches_jax(T, tier):
    """The window, sinks and softcap: a window of 20 leaves the first
    split of 64 slots empty but for its sinks."""
    _run(T, tier, "f32", [100, S], seed=11 + T, window=20, sinks=2,
         softcap=0.5)


@pytest.mark.parametrize("T,tier", [(0, "fp8"), (5, "int8 pv_int8 ppb1")])
def test_split_walk_on_rings_matches_jax(T, tier):
    """Ring pools of 128 slots wrapped past their end, sinks 4 and the
    window at the ring's limit: every written slot in some split."""
    window = S - 4 - max(T, 1) + 1
    _run(T, tier, "f32", [300, 131], seed=21 + T, ring=True, sinks=4,
         window=window)


@pytest.mark.parametrize("T,tier", [(0, "int8 q_int8 pv_int8 ppb2"),
                                    (5, "int8 q_int8")])
def test_split_walk_alibi_matches_jax(T, tier):
    """ALiBi slopes on a flat pool."""
    _run(T, tier, "f32", [40, 100], seed=31 + T,
         alibi_slopes=torch.from_numpy(SLOPES))


@pytest.mark.parametrize("pv_int8", [False, True])
def test_split_rule_covers_the_slots(pv_int8):
    """quant_splits: whole tiles a split (64 slots, or with pv_int8 a power
    of two dividing the page block), with pv_int8 whole page blocks or a
    whole share of one, every slot in one split and no split empty, the
    same for every length (it reads shapes only); QUANT_CHUNK overrides
    the rule, rounded up to the tile."""
    for Bb, Hq, Hkv, T in ((4, 16, 8, 1), (4, 16, 8, 5), (1, 16, 8, 256),
                           (2, 4, 2, 1), (64, 32, 8, 1), (1, 8, 8, 3)):
        for pages, page, ppb in ((8, 128, 8), (8, 128, 1), (64, 128, 4),
                                 (5, 128, 5), (8, 16, 2), (3, 16, 1)):
            S_ = pages * page
            bk = page * ppb
            chunk, n = pa.quant_splits(Bb, Hq, Hkv, T, S_, bk, pv_int8)
            unit = pa.quant_tile(bk, pv_int8)
            assert chunk % unit == 0 and chunk > 0
            assert not pv_int8 or bk % unit == 0
            assert not pv_int8 or chunk % bk == 0 or bk % chunk == 0
            assert (n - 1) * chunk < S_ <= n * chunk
    # the serving shape (chip_smoke.py): decode in 8 splits of 128 slots,
    # with pv_int8 at 8 pages a block (the whole pool) too
    assert pa.quant_splits(4, 16, 8, 1, 1024, 1024, pv_int8) == (128, 8)
    keep = pa.QUANT_CHUNK
    try:
        pa.QUANT_CHUNK = 100
        assert pa.quant_splits(4, 16, 8, 1, 1024, 256, pv_int8) == (128, 8)
        pa.QUANT_CHUNK = 300
        assert pa.quant_splits(4, 16, 8, 1, 1024, 256, pv_int8) == (
            (512, 2) if pv_int8 else (320, 4))
    finally:
        pa.QUANT_CHUNK = keep
