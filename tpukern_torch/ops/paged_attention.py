"""Paged-KV attention: queries against their sequence's pages of a shared
KV pool, one token per sequence (decode) or T new tokens per sequence
(prefix prefill).

The port of tpukern/ops/paged_attention.py. Kernels:
csrc/paged_attention.cu, which replaces `_decode_kernel`
(paged_attention.py:77) on float pools, split-KV: a block a (KV head,
sequence, DECODE_CHUNK slots), the splits merged in the same launch
(paged_attention_split_ref is its order, a test aid); and
csrc/paged_prefill.cu, which replaces `_prefix_kernel` (:513) on float
pools, split-KV too: a block a (query-row tile, KV head, sequence, split
of prefill_splits' slots), merged alike (paged_prefill_split_ref). Both
take the sliding window, attention sinks
and logit softcap of the JAX kernels, on float pools (bf16, f32) and on
the quantized tier: 1-byte int8 or fp8 e4m3 pools with one f32 scale per
token (quantize_pages, paged_attention_quantized,
paged_prefill_attention_quantized), with JAX's q_int8 (an int8 score
dot) and pv_int8 (an int8 P V dot) options, whose decode and prefix
instances are one kernel, csrc/paged_quant.cu, split-KV as the float ones
(quant_splits; paged_prefill_quantized_split_ref is its order, a test
aid). Every instance also
takes JAX's ring pools (ring=True: the pool is a rolling buffer of
pages_per_seq * page_size slots a sequence, and each slot's position is
recovered from the length, _positions) and ALiBi (alibi_slopes: (Hq,)
slopes, slope * (k_pos - q_pos) added to the scaled score before the
mask). Pools carry the natural head dim: the 128-lane pad of the JAX
pools is a TPU compiler requirement and is not ported.
"""

import math

import torch

from tpukern_torch import _build
from tpukern_torch.core.registry import register
from tpukern_torch.ops.quant import (quantize_fp8, quantize_fp8_ref,
                                    quantize_int8, quantize_ref)

MAX_GROUP = 8      # csrc/paged_attention.cu PA_GMAX, csrc/paged_prefill.cu
HEAD_DIMS = (32, 64, 128)  # launch_d of both kernels
DECODE_TILE = 64   # csrc/paged_attention.cu PA_TILE: tokens a tile
# slots a split of the float decode kernel (a multiple of DECODE_TILE),
# chosen on an H100 among 64, 128 and 256 at the serving shape and at 4 x
# 8192 tokens (PERF.md)
DECODE_CHUNK = 128
# csrc/paged_prefill.cu: query rows a block (MMA_BQ bf16, FMA_BQ f32) and
# keys a tile (MMA_BK; a split is a multiple of it)
PREFILL_ROWS = {torch.bfloat16: 64, torch.float32: 16}
PREFILL_TILE = 64
# the blocks prefill_splits aims at: bf16 two for each of an H100's 132
# SMs; f32, whose FMA tile takes several times as long, more (chosen on
# an H100 among split lengths of 64, 128, 256 and one split at the verify
# and chunk shapes of chip_smoke.py, PERF.md); and a split length that
# overrides the rule (a multiple of PREFILL_TILE; None: the rule)
SPLIT_BLOCKS = {torch.bfloat16: 264, torch.float32: 2048}
PREFILL_CHUNK = None


def _check_features(name, q, k_pages, page_table, window, sinks, softcap,
                    alibi_slopes, ring, T=1):
    """JAX's asserts on the masks, as ValueErrors. A ring pool needs a
    window, and T new tokens need window + T - 1 <= ring_tokens - sinks
    (the earliest keeps its window after the T wrapped writes; decode is
    T = 1); ALiBi slopes are (Hq,), and not with a softcap."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1: {window}")
    if sinks and window is None:
        raise ValueError("sinks require a window")
    if sinks is not None and sinks < 0:
        raise ValueError(f"sinks must be >= 0: {sinks}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0: {softcap}")
    if alibi_slopes is not None:
        if softcap is not None:
            raise ValueError(f"{name}: softcap + alibi ordering is "
                             "ambiguous")
        if tuple(alibi_slopes.shape) != (q.shape[1],):
            raise ValueError(f"{name}: alibi_slopes "
                             f"{tuple(alibi_slopes.shape)} for {q.shape[1]} "
                             "query heads")
    if ring:
        cap = page_table.shape[1] * k_pages.shape[2] - int(sinks or 0)
        if window is None or window + T - 1 > cap:
            raise ValueError(f"{name}: a ring cache needs window + T - 1 <= "
                             f"ring capacity - sinks: {window} + {T} - 1 vs "
                             f"{cap}")


def _ring_args(q, page_table, k_pages, ring, alibi_slopes):
    """The kernels' ring (slots a sequence, 0 for a flat pool) and slopes
    (an f32 tensor on q's device, or None)."""
    ring_tokens = page_table.shape[1] * k_pages.shape[2] if ring else 0
    slopes = (None if alibi_slopes is None else
              alibi_slopes.to(q.device, torch.float32).contiguous())
    return ring_tokens, slopes


def _launch_checks(q, k_pages, v_pages, lengths, page_table):
    """The kernels' conditions on CUDA tensors."""
    _build.check_cuda(q, k_pages, v_pages, lengths, page_table)
    Hq, D, Hkv = q.shape[1], q.shape[-1], k_pages.shape[0]
    if Hq // Hkv > MAX_GROUP or D not in HEAD_DIMS:
        raise ValueError(f"group {Hq // Hkv} > {MAX_GROUP} or head dim {D} "
                         f"not in {HEAD_DIMS}")
    if not q.dtype == k_pages.dtype == v_pages.dtype:
        raise TypeError(f"dtypes differ: {q.dtype} {k_pages.dtype} "
                        f"{v_pages.dtype}")
    if lengths.dtype != torch.int32 or page_table.dtype != torch.int32:
        raise TypeError("lengths and page_table must be int32")


def _check_shapes(q, k_pages, v_pages):
    Hq, D = q.shape[1], q.shape[-1]
    Hkv, _, _, Dp = k_pages.shape
    if Hq % Hkv or Dp != D or v_pages.shape != k_pages.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} pools "
                         f"{tuple(k_pages.shape)} {tuple(v_pages.shape)}")


def paged_attention(q, k_pages, v_pages, lengths, page_table, *,
                    pages_per_block=None, window=None, softcap=None,
                    alibi_slopes=None, ring=False, sinks=None):
    """Decode attention against a paged KV cache.

    q:          (B, Hq, D)            current-token queries
    k_pages:    (Hkv, P, page, D)     paged K pool
    v_pages:    (Hkv, P, page, D)     paged V pool
    lengths:    (B,) int32            live tokens per sequence
    page_table: (B, pages_per_seq)    physical page of each logical page
    Returns (B, Hq, D): softmax(q k^T / sqrt(D)) v over positions
    < lengths[b] (lengths past the pool count as the whole pool); a length
    of 0 gives 0. window keeps positions >= lengths[b] - window, or
    < sinks; softcap maps each scaled score s to cap·tanh(s/cap) before
    the mask; alibi_slopes (Hq,) adds slope * (k_pos - q_pos) to it.
    ring=True reads the pool as a rolling buffer (the module docstring):
    lengths count absolute tokens and may pass the pool.

    pages_per_block is the TPU kernel's page-DMA batch: accepted and
    ignored, since the CUDA kernel gathers token rows, not whole pages.
    A CPU tensor takes paged_attention_ref; a CUDA tensor launches the
    kernel (head dim 32, 64 or 128), one launch a call whatever its
    splits (decode_splits); `featured_launches` counts the launches of
    its featured instance (window, softcap, ring or ALiBi),
    `ring_launches` those on ring pools."""
    del pages_per_block
    _check_features("paged_attention", q, k_pages, page_table, window, sinks,
                    softcap, alibi_slopes, ring)
    _check_shapes(q, k_pages, v_pages)
    feat = dict(window=window, sinks=sinks, softcap=softcap,
                alibi_slopes=alibi_slopes, ring=ring)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, lengths, page_table,
                                   **feat)
    _launch_checks(q, k_pages, v_pages, lengths, page_table)
    B, Hq, D = q.shape
    Hkv, P, page_size, _ = k_pages.shape
    q = q.contiguous()
    k_pages, v_pages = _build.aligned(k_pages), _build.aligned(v_pages)
    lengths, page_table = lengths.contiguous(), page_table.contiguous()
    ring_tokens, slopes = _ring_args(q, page_table, k_pages, ring,
                                     alibi_slopes)
    o = torch.empty_like(q)
    stream = _build.stream(q)
    n_split = decode_splits(page_table.shape[1], page_size)
    ws = tickets = None
    if n_split > 1:  # each split's (o, m, l) per head, f32
        ws = torch.empty(B * Hq * n_split * (D + 2), device=q.device)
        tickets = _build.tickets(q.device, stream, B * Hkv)
    _build.launch("tk_paged_attention", q.data_ptr(), k_pages.data_ptr(),
                  v_pages.data_ptr(), lengths.data_ptr(),
                  page_table.data_ptr(), o.data_ptr(), B, Hq, Hkv, P,
                  page_size, page_table.shape[1], D, 1.0 / math.sqrt(D),
                  window or 0, sinks or 0, softcap or 0.0, ring_tokens,
                  _build.ptr(slopes), DECODE_CHUNK, _build.ptr(ws),
                  _build.ptr(tickets), _build.dtype_code(q), stream)
    paged_attention.launches += 1
    paged_attention.ring_launches += bool(ring)
    if window or softcap or ring or slopes is not None:  # the featured one
        paged_attention.featured_launches += 1
    return o


paged_attention.launches = 0
paged_attention.featured_launches = 0
paged_attention.ring_launches = 0


def decode_splits(pages_per_seq, page_size):
    """The float decode kernel's splits a sequence: ceil(slots /
    DECODE_CHUNK), from shapes alone."""
    return max(1, -(-pages_per_seq * page_size // DECODE_CHUNK))


def prefill_splits(B, Hq, Hkv, T, S, dtype):
    """(slots a split, n_split) of the float prefix kernel over S slots a
    sequence, from shapes alone: PREFILL_CHUNK where set, else the fewest
    splits that give SPLIT_BLOCKS[dtype] blocks of (query-row tile, KV
    head, sequence, split), at most one a tile of keys, each a whole
    number of tiles."""
    n_tiles = -(-S // PREFILL_TILE)
    if PREFILL_CHUNK:
        chunk = PREFILL_CHUNK
    else:
        blocks = B * Hkv * -(-T * (Hq // Hkv) // PREFILL_ROWS[dtype])
        want = min(n_tiles,
                   max(1, -(-SPLIT_BLOCKS[dtype] // max(blocks, 1))))
        chunk = -(-n_tiles // max(want, 1)) * PREFILL_TILE
    chunk = max(chunk, PREFILL_TILE)
    return chunk, max(1, -(-S // chunk))


def paged_prefill_attention(q, k_pages, v_pages, lengths, page_table, *,
                            pages_per_block=None, window=None, softcap=None,
                            alibi_slopes=None, ring=False, sinks=None):
    """Multi-token causal attention against a paged KV cache (chunked
    prefill continuation and speculative verification).

    q: (B, Hq, T, D): T new tokens per sequence whose K/V are already in
    the pages; lengths (B,) int32 counts live tokens including those T.
    Token t of sequence b sees positions [0, lengths[b] - T + t] (within
    the pool), and with a window only those >= lengths[b] - T + t -
    window + 1, or < sinks; softcap, alibi_slopes and ring as in
    paged_attention (a ring needs window + T - 1 <= ring_tokens - sinks).
    A row that sees no position gives 0. Returns (B, Hq, T, D).

    pages_per_block is accepted and ignored, as in paged_attention. A CPU
    tensor takes paged_prefill_ref; a CUDA tensor launches the kernel
    (bf16 or f32, head dim 32, 64 or 128, GQA group at most 8), one
    launch a call whatever its splits (prefill_splits); `ring_launches`
    counts those on ring pools."""
    del pages_per_block
    _check_features("paged_prefill_attention", q, k_pages, page_table,
                    window, sinks, softcap, alibi_slopes, ring, T=q.shape[2])
    _check_shapes(q, k_pages, v_pages)
    if q.device.type == "cpu":
        return paged_prefill_ref(q, k_pages, v_pages, lengths, page_table,
                                 window=window, sinks=sinks, softcap=softcap,
                                 alibi_slopes=alibi_slopes, ring=ring)
    _launch_checks(q, k_pages, v_pages, lengths, page_table)
    B, Hq, T, D = q.shape
    Hkv, P, page_size, _ = k_pages.shape
    q = q.contiguous()
    k_pages, v_pages = _build.aligned(k_pages), _build.aligned(v_pages)
    lengths, page_table = lengths.contiguous(), page_table.contiguous()
    ring_tokens, slopes = _ring_args(q, page_table, k_pages, ring,
                                     alibi_slopes)
    o = torch.empty_like(q)
    stream = _build.stream(q)
    chunk, n_split = prefill_splits(B, Hq, Hkv, T,
                                    page_table.shape[1] * page_size, q.dtype)
    ws = tickets = None
    if n_split > 1:  # each split's (o, m, l) per row of a tile, f32
        rows = PREFILL_ROWS[q.dtype]
        R = T * (Hq // Hkv)
        tiles = B * Hkv * -(-R // rows)
        ws = torch.empty(tiles * n_split * min(rows, R) * (D + 2),
                         device=q.device)
        tickets = _build.tickets(q.device, stream, tiles)
    _build.launch("tk_paged_prefill", q.data_ptr(), k_pages.data_ptr(),
                  v_pages.data_ptr(), lengths.data_ptr(),
                  page_table.data_ptr(), o.data_ptr(), B, Hq, Hkv, T, P,
                  page_size, page_table.shape[1], D, 1.0 / math.sqrt(D),
                  window or 0, sinks or 0, softcap or 0.0, ring_tokens,
                  _build.ptr(slopes), chunk, _build.ptr(ws),
                  _build.ptr(tickets), _build.dtype_code(q), stream)
    paged_prefill_attention.launches += 1
    paged_prefill_attention.ring_launches += bool(ring)
    return o


paged_prefill_attention.launches = 0
paged_prefill_attention.ring_launches = 0


def _positions(lengths, T, S, sinks, ring, device):
    """(query positions (B, T), key positions (B, S) of each sequence's S
    slots). Token t sits at lengths[b] - T + t. A flat pool's slot j holds
    position j; a ring's slot j holds j below the sinks, else the largest
    position <= lengths[b] - 1 congruent to j mod ring - sinks, or -1
    where that falls below the sinks (not written yet), as the TPU
    kernels recover it (paged_attention.py:213-231)."""
    last = lengths.to(device).long()[:, None] - 1                # (B, 1)
    qpos = last - (T - 1) + torch.arange(T, device=device)
    slot = torch.arange(S, device=device)[None, :]
    if not ring:
        return qpos, slot.expand(qpos.shape[0], S)
    sinks = int(sinks or 0)
    kpos = last - torch.remainder(last - slot, S - sinks)
    return qpos, torch.where(slot < sinks, slot,
                             torch.where(kpos < sinks, -1, kpos))


def _visible(lengths, T, S, window, sinks, ring, device):
    """(keep, rel), both (B, T, S): whether token t of sequence b sees
    slot j (a live position <= the token's, and the window or the sinks)
    and the slot's position less the token's."""
    qpos, kpos = _positions(lengths, T, S, sinks, ring, device)
    rel = kpos[:, None, :] - qpos[..., None]
    keep = (kpos[:, None, :] >= 0) & (rel <= 0)
    if window is not None:
        band = rel >= 1 - window
        if sinks:
            band |= kpos[:, None, :] < sinks
        keep &= band
    return keep, rel


def _masked_scores(s, lengths, T, window, sinks, ring, alibi_slopes):
    """Scaled (and capped) scores s (B, Hkv, group, T, S) with ALiBi added,
    -inf where the token does not see the slot; and keep (B, T, S)."""
    B, Hkv, group, _, S = s.shape
    keep, rel = _visible(lengths, T, S, window, sinks, ring, s.device)
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(s.device, torch.float32)
        s = s + slopes.reshape(1, Hkv, group, 1, 1) * rel[:, None, None]
    return s.masked_fill(~keep[:, None, None], float("-inf")), keep


def _softmax_terms(s, lengths, T, window, sinks, ring, alibi_slopes):
    """The unnormalized weights p = exp(s - max) of scaled (and capped)
    scores s (B, Hkv, group, T, S) and their sum over S: ALiBi added
    first, then the masks (_visible); a row that sees nothing has p = 0
    and a sum of 0."""
    s, keep = _masked_scores(s, lengths, T, window, sinks, ring,
                             alibi_slopes)
    empty = ~keep.any(dim=-1)[:, None, None, :, None]  # sees nothing -> 0
    s = s.masked_fill(empty, 0.0)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).masked_fill(empty, 0.0)
    return p, p.sum(dim=-1, keepdim=True)


def paged_prefill_ref(q, k_pages, v_pages, lengths, page_table, *,
                      window=None, sinks=None, softcap=None,
                      alibi_slopes=None, ring=False):
    """Gather each sequence's pages, then masked f32 attention of its T
    new tokens (the visible positions of paged_prefill_attention, with
    ALiBi and ring positions by _softmax_terms).

    On bf16 pools the unnormalized weights exp(s - m) are rounded to bf16
    before the P V product, as the kernels (and JAX's _pv_accumulate)
    round P to V's dtype; the normalizer sums them in f32. Here m is the
    row's final max, where the kernels round against a running max, so
    the two agree to bf16 rounding, not bit for bit."""
    B, Hq, T, D = q.shape
    Hkv, _, page_size, _ = k_pages.shape
    group = Hq // Hkv
    S = page_table.shape[1] * page_size
    table = page_table.long()
    # (Hkv, B, pages_per_seq, page, D) -> (B, Hkv, S, D)
    k_seq = k_pages[:, table].permute(1, 0, 2, 3, 4).reshape(B, Hkv, S, D)
    v_seq = v_pages[:, table].permute(1, 0, 2, 3, 4).reshape(B, Hkv, S, D)
    qf = q.reshape(B, Hkv, group, T, D).float()
    s = torch.einsum("bhgtd,bhkd->bhgtk", qf, k_seq.float()) / math.sqrt(D)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    p, denom = _softmax_terms(s, lengths, T, window, sinks, ring,
                              alibi_slopes)
    if v_pages.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).float()
    o = torch.einsum("bhgtk,bhkd->bhgtd", p, v_seq.float())
    o = o / torch.where(denom == 0, 1.0, denom)
    return o.reshape(B, Hq, T, D).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, lengths, page_table, **kw):
    """paged_prefill_ref with one new token per sequence."""
    return paged_prefill_ref(q[:, :, None], k_pages, v_pages, lengths,
                             page_table, **kw)[:, :, 0]


def paged_attention_split_ref(q, k_pages, v_pages, lengths, page_table, *,
                              chunk=None, **feat):
    """paged_attention in the float decode kernel's order, a test aid off
    the main path: _split_order with one new token a sequence and
    `chunk` slots a split (DECODE_CHUNK by default)."""
    return _split_order(q[:, :, None], k_pages, v_pages, lengths,
                        page_table, chunk or DECODE_CHUNK, **feat)[:, :, 0]


def paged_prefill_split_ref(q, k_pages, v_pages, lengths, page_table, *,
                            chunk=None, **feat):
    """paged_prefill_attention in the float prefix kernel's order, a test
    aid off the main path: _split_order with `chunk` slots a split (by
    default prefill_splits' for these shapes)."""
    B, Hq, T, _ = q.shape
    S = page_table.shape[1] * k_pages.shape[2]
    chunk = chunk or prefill_splits(B, Hq, k_pages.shape[0], T, S,
                                    q.dtype)[0]
    return _split_order(q, k_pages, v_pages, lengths, page_table, chunk,
                        **feat)


def _split_order(q, k_pages, v_pages, lengths, page_table, chunk, *,
                 window=None, sinks=None, softcap=None, alibi_slopes=None,
                 ring=False):
    """The float paged kernels' split-KV order for q (B, Hq, T, D): the
    slots cut into splits of `chunk`, each walked in tiles of DECODE_TILE
    keys with its own running max m, sum l and accumulator per query row
    (on bf16 pools P = exp(s - m) rounded to bf16 against the split's
    running max before the P V product, l summing it in f32); then the
    splits merged in split order in f32: M = max m, o = sum exp(m_z - M)
    o_z / sum exp(m_z - M) l_z, 0 where the sum is 0 (a split that sees
    no position adds nothing). The masks, ALiBi and ring positions are
    paged_prefill_ref's."""
    B, Hq, T, D = q.shape
    Hkv, _, page_size, _ = k_pages.shape
    group = Hq // Hkv
    S = page_table.shape[1] * page_size
    table = page_table.long()
    k_seq, v_seq = (p[:, table].permute(1, 0, 2, 3, 4).reshape(B, Hkv, S, D)
                    .float() for p in (k_pages, v_pages))
    qf = q.reshape(B, Hkv, group, T, D).float()
    s = torch.einsum("bhgtd,bhkd->bhgtk", qf, k_seq) / math.sqrt(D)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s, _ = _masked_scores(s, lengths, T, window, sinks, ring, alibi_slopes)
    bf16 = v_pages.dtype == torch.bfloat16
    parts = []
    for c0 in range(0, S, chunk):
        m = s.new_full(s.shape[:-1], float("-inf"))
        l = s.new_zeros(s.shape[:-1])
        acc = s.new_zeros(*s.shape[:-1], D)
        for t0 in range(c0, min(c0 + chunk, S), DECODE_TILE):
            st = s[..., t0:t0 + DECODE_TILE]
            mn = torch.maximum(m, st.amax(dim=-1))
            seen = torch.isfinite(mn)[..., None]   # no position yet: p = 0
            mf = torch.where(seen[..., 0], mn, 0.0)
            p = torch.where(seen, torch.exp(st - mf[..., None]), 0.0)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - mf), 0.0)
            pv = p.to(torch.bfloat16).float() if bf16 else p
            l = l * alpha + p.sum(dim=-1)
            acc = (acc * alpha[..., None]
                   + torch.einsum("bhgtk,bhkd->bhgtd", pv,
                                  v_seq[:, :, t0:t0 + DECODE_TILE]))
            m = mn
        parts.append((m, l, acc))
    return _merge_splits(parts).reshape(B, Hq, T, D).to(q.dtype)


def _merge_splits(parts):
    """The kernels' merge of the splits' partials [(m, l, o)] in split
    order, in f32: M = max m, o = sum exp(m_z - M) o_z / sum exp(m_z - M)
    l_z, 0 where the sum is 0 (a split that sees no position adds
    nothing)."""
    m = torch.stack([p[0] for p in parts])               # (splits, ...)
    M = m.amax(dim=0)
    a = torch.where(torch.isfinite(m), torch.exp(m - M), 0.0)
    L = torch.zeros_like(M)
    O = torch.zeros_like(parts[0][2])
    for z, (_, l, o) in enumerate(parts):  # split order
        L = L + a[z] * l
        O = O + a[z][..., None] * o
    return O / torch.where(L == 0, 1.0, L)[..., None]


# ---------------------------------------------------------------------------
# the quantized tier: 1-byte pools with per-token scales

QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)
BLOCK_TOKENS_MAX = 2048  # csrc/paged_quant.cu PQ_BK_MAX
# csrc/paged_quant.cu: query rows a block (PQ_RB) and tokens a K/V tile
# (PQ_TK; with pv_int8 quant_tile's)
QUANT_ROWS = 16
QUANT_TILE = 64
# the blocks quant_splits aims at (two for each of an H100's 132 SMs, as
# the float bf16 prefix kernel's SPLIT_BLOCKS), and a split length that
# overrides the rule (rounded up to whole tiles; None: the rule)
QUANT_SPLIT_BLOCKS = 264
QUANT_CHUNK = None


def quantize_pages(pages, dtype="int8"):
    """Quantize a (Hkv, P, page, D) pool to "int8" or "fp8" (e4m3) with
    per-token scales (Hkv, P, page): the layout of
    paged_attention_quantized. Through quantize_int8 / quantize_fp8 (#20 /
    #22 on the card). No padding of D: JAX pads it to 128 lanes, and zero
    columns change neither absmax nor a dot."""
    Hkv, P, page, D = pages.shape
    qfn = {"int8": quantize_int8, "fp8": quantize_fp8}[dtype]
    vals, scales = qfn(pages.reshape(Hkv * P * page, D))
    return vals.reshape(Hkv, P, page, D), scales.reshape(Hkv, P, page)


def _check_quantized(name, q, k_pages, k_scales, v_pages, v_scales,
                     page_table, pages_per_block, q_int8, pv_int8):
    """JAX's asserts of the quantized kernels, as ValueErrors."""
    Hq, D = q.shape[1], q.shape[-1]
    Hkv, P, page, Dp = k_pages.shape
    if (Hq % Hkv or Dp != D or v_pages.shape != k_pages.shape
            or k_scales.shape != (Hkv, P, page)
            or v_scales.shape != (Hkv, P, page)):
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)} pools "
                         f"{tuple(k_pages.shape)} {tuple(v_pages.shape)} "
                         f"scales {tuple(k_scales.shape)} "
                         f"{tuple(v_scales.shape)}")
    for pool in (k_pages, v_pages):
        if pool.dtype not in QUANT_DTYPES:
            raise TypeError(f"{name}: pools are int8 or float8_e4m3fn, got "
                            f"{pool.dtype}")
    if k_pages.dtype != v_pages.dtype:
        raise TypeError(f"{name}: K {k_pages.dtype}, V {v_pages.dtype}")
    if q_int8 and k_pages.dtype != torch.int8:
        raise ValueError("q_int8 needs int8 K pages")
    if pv_int8 and v_pages.dtype != torch.int8:
        raise ValueError("pv_int8 needs int8 V pages")
    if pages_per_block < 1 or page_table.shape[1] % pages_per_block:
        raise ValueError(f"pages_per_block {pages_per_block} does not divide "
                         f"{page_table.shape[1]} pages a sequence")


def quant_tile(block_tokens, pv_int8):
    """Slots a tile of the quantized kernel: QUANT_TILE, or with pv_int8
    the largest power of two dividing both it and the page block (no tile
    crosses a block; csrc/paged_quant.cu)."""
    tile = QUANT_TILE
    while pv_int8 and block_tokens % tile:
        tile //= 2
    return tile


def quant_splits(B, Hq, Hkv, T, S, block_tokens, pv_int8):
    """(slots a split, n_split) of the quantized kernel over S slots a
    sequence, from shapes alone: splits of whole tiles (quant_tile);
    QUANT_CHUNK where set, else the fewest splits that give
    QUANT_SPLIT_BLOCKS blocks of (row tile, KV head, sequence, split), at
    most one a tile. With pv_int8 a split then holds whole page blocks or
    a whole share of one (the largest such share no longer than the
    rule's split), so each of its pieces (min(chunk, block_tokens) slots)
    lies in one block."""
    unit = quant_tile(block_tokens, pv_int8)
    n_units = -(-S // unit)
    if QUANT_CHUNK:
        chunk = -(-QUANT_CHUNK // unit) * unit
    else:
        blocks = B * Hkv * -(-T * (Hq // Hkv) // QUANT_ROWS)
        want = min(n_units,
                   max(1, -(-QUANT_SPLIT_BLOCKS // max(blocks, 1))))
        chunk = -(-n_units // want) * unit
    if pv_int8:
        bk = block_tokens
        chunk = (-(-chunk // bk) * bk if chunk >= bk else
                 max(d for d in range(unit, chunk + 1, unit) if bk % d == 0))
    return chunk, max(1, -(-S // chunk))


def _launch_quantized(q, k_pages, k_scales, v_pages, v_scales, lengths,
                      page_table, pages_per_block, q_int8, pv_int8, window,
                      sinks, softcap, alibi_slopes, ring):
    """Launch a quantized instance on CUDA tensors, q (B, Hq, T, D); q_int8
    row-quantizes q through quantize_int8 (#20) first. Returns o (q's
    shape and type)."""
    _build.check_cuda(q, k_pages, k_scales, v_pages, v_scales, lengths,
                      page_table)
    Hkv, P, page, D = k_pages.shape
    bk = page * pages_per_block
    if D not in HEAD_DIMS or bk > BLOCK_TOKENS_MAX or page % 4:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}, a page block "
                         f"of {bk} tokens > {BLOCK_TOKENS_MAX}, or pages of "
                         f"{page} slots (the kernel copies the scales of 4 "
                         "slots of a page at once)")
    if lengths.dtype != torch.int32 or page_table.dtype != torch.int32:
        raise TypeError("lengths and page_table must be int32")
    q = q.contiguous()
    o = torch.empty_like(q)
    dtype = _build.dtype_code(q)
    qk, q_scales = q, None
    if q_int8:
        qk, q_scales = quantize_int8(q.reshape(-1, D))
    k_pages, v_pages = _build.aligned(k_pages), _build.aligned(v_pages)
    k_scales, v_scales = (_build.aligned(s.float()) for s in (k_scales,
                                                              v_scales))
    lengths, page_table = lengths.contiguous(), page_table.contiguous()
    ring_tokens, slopes = _ring_args(q, page_table, k_pages, ring,
                                     alibi_slopes)
    B, Hq, T = q.shape[:3]
    stream = _build.stream(q)
    chunk, n_split = quant_splits(B, Hq, Hkv, T, page_table.shape[1] * page,
                                  bk, pv_int8)
    R = T * (Hq // Hkv)
    tiles = B * Hkv * -(-R // QUANT_ROWS)
    ws = tickets = stats = None
    if n_split > 1:  # each split's (o, m, l) per row of a tile, f32
        ws = torch.empty(tiles * n_split * min(QUANT_ROWS, R) * (D + 2),
                         device=q.device)
        tickets = _build.tickets(q.device, stream, tiles)
    if pv_int8:  # each piece's (m, a) per row of a tile, f32
        pieces = -(-page_table.shape[1] * page // min(chunk, bk))
        stats = torch.empty(2 * tiles * pieces * min(QUANT_ROWS, R),
                            device=q.device)
    _build.launch("tk_paged_prefill_quantized", qk.data_ptr(),
                  _build.ptr(q_scales), k_pages.data_ptr(),
                  k_scales.data_ptr(), v_pages.data_ptr(),
                  v_scales.data_ptr(), lengths.data_ptr(),
                  page_table.data_ptr(), o.data_ptr(), B, Hq, Hkv, T, P,
                  page, page_table.shape[1], D, bk, 1.0 / math.sqrt(D),
                  window or 0, sinks or 0, softcap or 0.0, ring_tokens,
                  _build.ptr(slopes), chunk, _build.ptr(ws),
                  _build.ptr(tickets), _build.ptr(stats), dtype,
                  _build.KV_CODES[k_pages.dtype], int(pv_int8), stream)
    return o


def _count_tier(fn, k_pages, pv_int8, ring):
    fn.launches += 1
    fn.ring_launches += bool(ring)
    if k_pages.dtype == torch.float8_e4m3fn:
        fn.fp8_launches += 1
    elif pv_int8:
        fn.pv_int8_launches += 1
    else:
        fn.int8_launches += 1


def paged_attention_quantized(q, k_pages, k_scales, v_pages, v_scales,
                              lengths, page_table, *, pages_per_block=4,
                              q_int8=False, pv_int8=False, window=None,
                              softcap=None, alibi_slopes=None, ring=False,
                              sinks=None):
    """Decode attention against a quantized paged KV cache.

    k_pages/v_pages: (Hkv, P, page, D) int8 or float8_e4m3fn (quantize_
    pages); k_scales/v_scales: (Hkv, P, page) f32; the rest as
    paged_attention. Each score is q . k (k cast to q's type, exact) times
    the token's K scale, then 1/sqrt(D); p = exp(s - m) times the token's
    V scale is rounded to q's type before the P V product, as JAX's
    _pv_accumulate rounds it.

    q_int8 (int8 K): q is row-quantized (quantize_int8) and the score is
    an int32 dot times both scales. pv_int8 (int8 V): p * v_scale is
    row-quantized to int8 against its maximum over each block of page *
    pages_per_block tokens, so the result depends on pages_per_block as
    JAX's does, and contracted against the raw int8 V in int32.
    pages_per_block (default 4, as JAX's) must divide the pages a
    sequence. window, sinks, softcap, alibi_slopes and ring as in
    paged_attention. A CPU tensor takes paged_attention_quantized_ref; a
    CUDA tensor launches the kernel (head dim 32, 64 or 128; blocks of at
    most BLOCK_TOKENS_MAX tokens; pages of a multiple of 4 slots), split-KV
    by quant_splits (with pv_int8 two launches: the pieces' maxima, then
    the splits), and launches, int8_launches, pv_int8_launches and
    fp8_launches count its calls by tier, ring_launches those on ring
    pools."""
    _check_features("paged_attention_quantized", q, k_pages, page_table,
                    window, sinks, softcap, alibi_slopes, ring)
    _check_quantized("paged_attention_quantized", q, k_pages, k_scales,
                     v_pages, v_scales, page_table, pages_per_block, q_int8,
                     pv_int8)
    kw = dict(pages_per_block=pages_per_block, q_int8=q_int8,
              pv_int8=pv_int8, window=window, sinks=sinks, softcap=softcap,
              alibi_slopes=alibi_slopes, ring=ring)
    if q.device.type == "cpu":
        return paged_attention_quantized_ref(q, k_pages, k_scales, v_pages,
                                             v_scales, lengths, page_table,
                                             **kw)
    o = _launch_quantized(q[:, :, None], k_pages, k_scales, v_pages,
                          v_scales, lengths, page_table, **kw)[:, :, 0]
    _count_tier(paged_attention_quantized, k_pages, pv_int8, ring)
    return o


def paged_prefill_attention_quantized(q, k_pages, k_scales, v_pages,
                                      v_scales, lengths, page_table, *,
                                      pages_per_block=4, q_int8=False,
                                      pv_int8=False, window=None,
                                      softcap=None, alibi_slopes=None,
                                      ring=False, sinks=None):
    """Multi-token causal attention against a quantized paged KV cache:
    q (B, Hq, T, D) as paged_prefill_attention, the pools, scales and
    options as paged_attention_quantized (a ring needs window + T - 1 <=
    ring_tokens - sinks). Returns (B, Hq, T, D)."""
    _check_features("paged_prefill_attention_quantized", q, k_pages,
                    page_table, window, sinks, softcap, alibi_slopes, ring,
                    T=q.shape[2])
    _check_quantized("paged_prefill_attention_quantized", q, k_pages,
                     k_scales, v_pages, v_scales, page_table,
                     pages_per_block, q_int8, pv_int8)
    kw = dict(pages_per_block=pages_per_block, q_int8=q_int8,
              pv_int8=pv_int8, window=window, sinks=sinks, softcap=softcap,
              alibi_slopes=alibi_slopes, ring=ring)
    if q.device.type == "cpu":
        return paged_prefill_quantized_ref(q, k_pages, k_scales, v_pages,
                                           v_scales, lengths, page_table,
                                           **kw)
    o = _launch_quantized(q, k_pages, k_scales, v_pages, v_scales, lengths,
                          page_table, **kw)
    _count_tier(paged_prefill_attention_quantized, k_pages, pv_int8, ring)
    return o


for _fn in (paged_attention_quantized, paged_prefill_attention_quantized):
    _fn.launches = _fn.int8_launches = _fn.pv_int8_launches = 0
    _fn.fp8_launches = _fn.ring_launches = 0


def _quant_scores(q, k_pages, k_scales, v_pages, v_scales, page_table,
                  q_int8, softcap):
    """(s, vs, v_seq) of the quantized kernels: the scores (B, Hkv, group,
    T, S) in the TPU kernels' order (q_int8: float(int dot) * q_scale;
    else q . k cast to q's type; * k_scale, * 1/sqrt(D), the softcap),
    before ALiBi and the masks; the V scales (B, Hkv, S) and the V rows
    (B, Hkv, S, D) in slot order."""
    B, Hq, T, D = q.shape
    Hkv, _, page, _ = k_pages.shape
    group = Hq // Hkv
    S = page_table.shape[1] * page
    table = page_table.long()

    def seq(pool):  # (Hkv, P, page, ...) -> (B, Hkv, S, ...)
        g = pool[:, table]
        return g.permute(1, 0, *range(2, g.dim())).reshape(
            B, Hkv, S, *pool.shape[3:])

    k_seq = seq(k_pages)
    ks, vs = seq(k_scales.float()), seq(v_scales.float())
    q5 = q.reshape(B, Hkv, group, T, D)
    if q_int8:
        qi, qs = quantize_ref(q5.reshape(-1, D))
        s32 = torch.einsum("bhgtd,bhkd->bhgtk",
                           qi.reshape(q5.shape).double(), k_seq.double())
        s = s32.float() * qs.reshape(B, Hkv, group, T, 1)
    else:
        s = torch.einsum("bhgtd,bhkd->bhgtk", q5.float(),
                         k_seq.to(q.dtype).float())
    s = s * ks[:, :, None, None] * (1.0 / math.sqrt(D))
    if softcap is not None:
        s = softcap * torch.tanh(s * (1.0 / softcap))
    return s, vs, seq(v_pages)


def paged_prefill_quantized_ref(q, k_pages, k_scales, v_pages, v_scales,
                                lengths, page_table, *, pages_per_block=4,
                                q_int8=False, pv_int8=False, window=None,
                                sinks=None, softcap=None, alibi_slopes=None,
                                ring=False):
    """The quantized kernels' function, gathered per sequence, in the TPU
    kernels' order: the score (q_int8: float(int dot) * q_scale; else
    q . k cast to q's type), * k_scale, * 1/sqrt(D), the softcap, ALiBi
    and the masks of _softmax_terms; p = exp(s - m) with m the row's final max
    (the kernels take a running max: the same up to rounding, since
    pv_int8's quantization is invariant to p's scale), l = sum p;
    p' = p * v_scale, then

    - pv_int8: per block of page * pages_per_block tokens, amax = the
      row's max of p' (1 where 0), pq = round(p' * (127 / amax)), and the
      block adds (pq . v_int8) * (amax / 127), the integer sums exact in
      f64;
    - else: p' rounded to q's type, times V cast to f32.

    o = that sum / l; a row that sees nothing gives 0."""
    B, Hq, T, D = q.shape
    page = k_pages.shape[2]
    S = page_table.shape[1] * page
    s, vs, v_seq = _quant_scores(q, k_pages, k_scales, v_pages, v_scales,
                                 page_table, q_int8, softcap)
    Hkv, group = s.shape[1:3]
    p, denom = _softmax_terms(s, lengths, T, window, sinks, ring,
                              alibi_slopes)
    pv = p * vs[:, :, None, None]
    if pv_int8:
        bk = page * pages_per_block
        blocks = pv.reshape(B, Hkv, group, T, S // bk, bk)
        amax = blocks.amax(dim=-1, keepdim=True)
        amax = torch.where(amax <= 0, 1.0, amax)
        # a true division (a Python scalar over a tensor multiplies by
        # its reciprocal)
        pq = torch.round(blocks * (torch.full_like(amax, 127.0) / amax))
        # JAX's cast to int8: where 127 / amax overflows, inf saturates to
        # 127 and 0 * inf (NaN) gives 0
        pq = torch.nan_to_num(pq, nan=0.0).clamp(max=127.0)
        vb = v_seq.reshape(B, Hkv, S // bk, bk, D).double()
        ob = torch.einsum("bhgtnk,bhnkd->bhgtnd", pq.double(), vb)
        o = (ob.float() * (amax * (1.0 / 127.0))).sum(dim=-2)
    else:
        o = torch.einsum("bhgtk,bhkd->bhgtd", pv.to(q.dtype).float(),
                         v_seq.to(q.dtype).float())
    o = o * torch.where(denom == 0, 0.0, 1.0 / denom)
    return o.reshape(B, Hq, T, D).to(q.dtype)


def paged_attention_quantized_ref(q, k_pages, k_scales, v_pages, v_scales,
                                  lengths, page_table, **kw):
    """paged_prefill_quantized_ref with one new token per sequence."""
    return paged_prefill_quantized_ref(q[:, :, None], k_pages, k_scales,
                                       v_pages, v_scales, lengths,
                                       page_table, **kw)[:, :, 0]


def paged_prefill_quantized_split_ref(q, k_pages, k_scales, v_pages,
                                      v_scales, lengths, page_table, *,
                                      pages_per_block=4, q_int8=False,
                                      pv_int8=False, window=None,
                                      sinks=None, softcap=None,
                                      alibi_slopes=None, ring=False,
                                      chunk=None):
    """paged_prefill_attention_quantized in the kernel's order, a test aid
    off the main path: the scores of paged_prefill_quantized_ref, the
    slots cut into splits of `chunk` (quant_splits' by default), merged in
    split order in f32 (_merge_splits). Without pv_int8 each split walks
    tiles of QUANT_TILE slots with its own running max m, sum l and
    accumulator per query row, p' = p * v_scale rounded to q's type. With
    pv_int8, two passes: the first takes each piece's (min(chunk,
    page block) slots) max m_z and a_z = max exp(s - m_z) v_scale; the
    second walks each split's share of each page block against the
    block's running max M (the largest m_z of the pieces up to the block,
    JAX's) and amax = max exp(m_z - M) a_z over the block's pieces (1
    where 0): p = exp(s - M), pq = round(p v_scale 127 / amax), the
    share's int sum pq . v (exact, in f64) times amax / 127 added to acc
    * alpha."""
    B, Hq, T, D = q.shape
    Hkv, _, page, _ = k_pages.shape
    S = page_table.shape[1] * page
    bk = page * pages_per_block
    if chunk is None:
        chunk = quant_splits(B, Hq, Hkv, T, S, bk, pv_int8)[0]
    s, vs, v_seq = _quant_scores(q, k_pages, k_scales, v_pages, v_scales,
                                 page_table, q_int8, softcap)
    s, _ = _masked_scores(s, lengths, T, window, sinks, ring, alibi_slopes)
    vs = vs[:, :, None, None]  # over the group and the tokens
    vf = v_seq.double() if pv_int8 else v_seq.to(q.dtype).float()

    def exp_from(x, m):  # exp(x - m), 0 where m or x is -inf
        ok = torch.isfinite(m)
        return torch.where(ok, torch.exp(x - torch.where(ok, m, 0.0)), 0.0)

    parts = []
    if not pv_int8:
        for c0 in range(0, S, chunk):
            m = s.new_full(s.shape[:-1], float("-inf"))
            l = s.new_zeros(s.shape[:-1])
            acc = s.new_zeros(*s.shape[:-1], D)
            for t0 in range(c0, min(c0 + chunk, S), QUANT_TILE):
                u = slice(t0, t0 + QUANT_TILE)
                mn = torch.maximum(m, s[..., u].amax(dim=-1))
                p = exp_from(s[..., u], mn[..., None])
                alpha = exp_from(m, mn)
                l = l * alpha + p.sum(dim=-1)
                pv = (p * vs[..., u]).to(q.dtype).float()
                acc = (acc * alpha[..., None]
                       + torch.einsum("bhgtk,bhkd->bhgtd", pv, vf[:, :, u]))
                m = mn
            parts.append((m, l, acc))
        return _merge_splits(parts).reshape(B, Hq, T, D).to(q.dtype)

    pz = min(chunk, bk)
    mz, az = [], []  # the first pass: each piece's (m, a)
    for z0 in range(0, S, pz):
        u = slice(z0, z0 + pz)
        m = s[..., u].amax(dim=-1)
        mz.append(m)
        az.append((exp_from(s[..., u], m[..., None]) * vs[..., u])
                  .amax(dim=-1))
    mz, az = torch.stack(mz), torch.stack(az)  # (pieces, ...)
    for c0 in range(0, S, chunk):
        m = s.new_full(s.shape[:-1], float("-inf"))
        l = s.new_zeros(s.shape[:-1])
        acc = s.new_zeros(*s.shape[:-1], D)
        for b0 in range(c0 - c0 % bk, min(c0 + chunk, S), bk):
            g0, g1 = max(b0, c0), min(b0 + bk, c0 + chunk, S)  # the share
            M = mz[:(b0 + bk) // pz].amax(dim=0)
            blk = slice(b0 // pz, (b0 + bk) // pz)
            amax = (exp_from(mz[blk], M) * az[blk]).amax(dim=0)
            amax = torch.where(amax <= 0, 1.0, amax)[..., None]
            alpha = exp_from(m, M)
            p = exp_from(s[..., g0:g1], M[..., None])
            l = l * alpha + p.sum(dim=-1)
            pq = torch.round(p * vs[..., g0:g1]
                             * (torch.full_like(amax, 127.0) / amax))
            # JAX's cast to int8: where 127 / amax overflows, inf
            # saturates to 127 and 0 * inf (NaN) gives 0
            pq = torch.nan_to_num(pq, nan=0.0).clamp(max=127.0)
            ob = torch.einsum("bhgtk,bhkd->bhgtd", pq.double(),
                              vf[:, :, g0:g1]).float()
            acc = acc * alpha[..., None] + ob * (amax * (1.0 / 127.0))
            m = M
        parts.append((m, l, acc))
    return _merge_splits(parts).reshape(B, Hq, T, D).to(q.dtype)


def paged_attention_quantized_split_ref(q, k_pages, k_scales, v_pages,
                                        v_scales, lengths, page_table, **kw):
    """paged_prefill_quantized_split_ref with one new token a sequence."""
    return paged_prefill_quantized_split_ref(
        q[:, :, None], k_pages, k_scales, v_pages, v_scales, lengths,
        page_table, **kw)[:, :, 0]


# ---------------------------------------------------------------- registry

def default_alibi_slopes(n_heads, device="cuda"):
    """The standard ALiBi slopes 2^(-8 i / n), i = 1..n (JAX's
    default_alibi_slopes), f32 on `device`."""
    i = torch.arange(1, n_heads + 1, dtype=torch.float32, device=device)
    return 2.0 ** (-8.0 * i / n_heads)


def _plain_pages(pages, dtype):
    """quantize_pages with the plain quantizers (#20/#22 equal them bit
    for bit)."""
    Hkv, P, page, D = pages.shape
    qfn = {"int8": quantize_ref, "fp8": quantize_fp8_ref}[dtype]
    vals, scales = qfn(pages.reshape(Hkv * P * page, D))
    return vals.reshape(Hkv, P, page, D), scales.reshape(Hkv, P, page)


def _bf16(fn, alibi=False):
    """fn on q, k, v cast to bf16 (JAX's variants), with ALiBi slopes."""
    def run(q, k, v, lengths, table, **kw):
        if alibi:
            kw["alibi_slopes"] = default_alibi_slopes(q.shape[1], q.device)
        bf = torch.bfloat16
        return fn(q.to(bf), k.to(bf), v.to(bf), lengths, table, **kw)
    return run


def _alibi(fn):
    def run(q, k, v, lengths, table, **kw):
        return fn(q, k, v, lengths, table, alibi_slopes=default_alibi_slopes(
            q.shape[1], q.device), **kw)
    return run


def _quantized(fn, pages, dtype="int8", **opts):
    """fn on pools quantized by `pages` (quantize_pages or _plain_pages),
    q in bf16 (JAX's _paged_quantized)."""
    def run(q, k, v, lengths, table, **kw):
        kq, ks = pages(k, dtype)
        vq, vs = pages(v, dtype)
        return fn(q.to(torch.bfloat16), kq, ks, vq, vs, lengths, table,
                  **opts, **kw)
    return run


_DECODE_Q = dict(int8kv={}, int8kv_mxu=dict(q_int8=True),
                 fp8kv=dict(dtype="fp8"),
                 int8kv_mxu_full=dict(q_int8=True, pv_int8=True))
_PREFILL_Q = dict(int8kv={}, int8kv_mxu=dict(q_int8=True))

register("paged_attention", "paged_decode_f32", ref=paged_attention_ref)(
    paged_attention)
register("paged_attention", "paged_decode_bf16",
         ref=_bf16(paged_attention_ref))(_bf16(paged_attention))
register("paged_attention", "paged_decode_alibi",
         ref=_bf16(paged_attention_ref, alibi=True))(
    _bf16(paged_attention, alibi=True))
register("paged_attention", "paged_prefix_prefill", ref=paged_prefill_ref)(
    paged_prefill_attention)
register("paged_attention", "paged_prefix_prefill_alibi",
         ref=_alibi(paged_prefill_ref))(_alibi(paged_prefill_attention))
for _sfx, _kw in _DECODE_Q.items():
    register("paged_attention", f"paged_decode_{_sfx}",
             ref=_quantized(paged_attention_quantized_ref, _plain_pages,
                            **_kw))(
        _quantized(paged_attention_quantized, quantize_pages, **_kw))
for _sfx, _kw in _PREFILL_Q.items():
    register("paged_attention", f"paged_prefix_prefill_{_sfx}",
             ref=_quantized(paged_prefill_quantized_ref, _plain_pages,
                            **_kw))(
        _quantized(paged_prefill_attention_quantized, quantize_pages, **_kw))
