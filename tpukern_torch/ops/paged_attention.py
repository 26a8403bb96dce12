"""Paged-KV attention: queries against their sequence's pages of a shared
KV pool, one token per sequence (decode) or T new tokens per sequence
(prefix prefill).

The port of tpukern/ops/paged_attention.py. Kernels:
csrc/paged_attention.cu, which replaces `_decode_kernel`
(paged_attention.py:77), and csrc/paged_prefill.cu, which replaces
`_prefix_kernel` (:513). Both take the sliding window, attention sinks
and logit softcap of the JAX kernels, on float pools (bf16, f32) and on
the quantized tier: 1-byte int8 or fp8 e4m3 pools with one f32 scale per
token (quantize_pages, paged_attention_quantized,
paged_prefill_attention_quantized), with JAX's q_int8 (an int8 score
dot) and pv_int8 (an int8 P V dot) options, whose decode and prefix
instances are one kernel, csrc/paged_quant.cu. Pools carry the natural
head dim:
the 128-lane pad of the JAX pools is a TPU compiler requirement and is
not ported. ALiBi and ring pools are not ported yet.
"""

import math

import torch

from tpukern_torch import _build
from tpukern_torch.ops.quant import quantize_fp8, quantize_int8, quantize_ref

MAX_GROUP = 8      # csrc/paged_attention.cu PA_GMAX, csrc/paged_prefill.cu
HEAD_DIMS = (32, 64, 128)  # launch_d of both kernels
_TODO = "ROADMAP.md queue 1 item 10 (ops/paged_attention.py options)"


def _check_features(name, window, sinks, softcap, alibi_slopes, ring):
    """JAX's asserts on the masks as ValueErrors; the options the port
    lacks raise NotImplementedError."""
    for opt, value in dict(alibi_slopes=alibi_slopes,
                           ring=ring or None).items():
        if value is not None:
            raise NotImplementedError(f"{name}({opt}=...) is not ported "
                                      f"yet: {_TODO}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1: {window}")
    if sinks and window is None:
        raise ValueError("sinks require a window")
    if sinks is not None and sinks < 0:
        raise ValueError(f"sinks must be >= 0: {sinks}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0: {softcap}")


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
    the mask.

    pages_per_block is the TPU kernel's page-DMA batch: accepted and
    ignored, since the CUDA kernel gathers token rows, not whole pages.
    alibi_slopes and ring raise NotImplementedError. A CPU tensor takes
    paged_attention_ref; a CUDA tensor launches the kernel (head dim 32,
    64 or 128), and `featured_launches` counts the launches of its
    window/softcap instance."""
    del pages_per_block
    _check_features("paged_attention", window, sinks, softcap, alibi_slopes,
                    ring)
    _check_shapes(q, k_pages, v_pages)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, lengths, page_table,
                                   window=window, sinks=sinks,
                                   softcap=softcap)
    _launch_checks(q, k_pages, v_pages, lengths, page_table)
    B, Hq, D = q.shape
    Hkv, P, page_size, _ = k_pages.shape
    q = q.contiguous()
    k_pages, v_pages = _build.aligned(k_pages), _build.aligned(v_pages)
    lengths, page_table = lengths.contiguous(), page_table.contiguous()
    o = torch.empty_like(q)
    _build.launch("tk_paged_attention", q.data_ptr(), k_pages.data_ptr(),
                  v_pages.data_ptr(), lengths.data_ptr(),
                  page_table.data_ptr(), o.data_ptr(), B, Hq, Hkv, P,
                  page_size, page_table.shape[1], D, 1.0 / math.sqrt(D),
                  window or 0, sinks or 0, softcap or 0.0,
                  _build.dtype_code(q), _build.stream(q))
    paged_attention.launches += 1
    if window or softcap:  # the featured instance
        paged_attention.featured_launches += 1
    return o


paged_attention.launches = 0
paged_attention.featured_launches = 0


def paged_prefill_attention(q, k_pages, v_pages, lengths, page_table, *,
                            pages_per_block=None, window=None, softcap=None,
                            alibi_slopes=None, ring=False, sinks=None):
    """Multi-token causal attention against a paged KV cache (chunked
    prefill continuation and speculative verification).

    q: (B, Hq, T, D): T new tokens per sequence whose K/V are already in
    the pages; lengths (B,) int32 counts live tokens including those T.
    Token t of sequence b sees positions [0, lengths[b] - T + t] (within
    the pool), and with a window only those >= lengths[b] - T + t -
    window + 1, or < sinks; softcap as in paged_attention. A row that
    sees no position gives 0. Returns (B, Hq, T, D).

    pages_per_block is accepted and ignored, as in paged_attention.
    alibi_slopes and ring raise NotImplementedError. A CPU tensor takes
    paged_prefill_ref; a CUDA tensor launches the kernel (bf16 or f32,
    head dim 32, 64 or 128, GQA group at most 8)."""
    del pages_per_block
    _check_features("paged_prefill_attention", window, sinks, softcap,
                    alibi_slopes, ring)
    _check_shapes(q, k_pages, v_pages)
    if q.device.type == "cpu":
        return paged_prefill_ref(q, k_pages, v_pages, lengths, page_table,
                                 window=window, sinks=sinks, softcap=softcap)
    _launch_checks(q, k_pages, v_pages, lengths, page_table)
    B, Hq, T, D = q.shape
    Hkv, P, page_size, _ = k_pages.shape
    q = q.contiguous()
    k_pages, v_pages = _build.aligned(k_pages), _build.aligned(v_pages)
    lengths, page_table = lengths.contiguous(), page_table.contiguous()
    o = torch.empty_like(q)
    _build.launch("tk_paged_prefill", q.data_ptr(), k_pages.data_ptr(),
                  v_pages.data_ptr(), lengths.data_ptr(),
                  page_table.data_ptr(), o.data_ptr(), B, Hq, Hkv, T, P,
                  page_size, page_table.shape[1], D, 1.0 / math.sqrt(D),
                  window or 0, sinks or 0, softcap or 0.0,
                  _build.dtype_code(q), _build.stream(q))
    paged_prefill_attention.launches += 1
    return o


paged_prefill_attention.launches = 0


def paged_prefill_ref(q, k_pages, v_pages, lengths, page_table, *,
                      window=None, sinks=None, softcap=None):
    """Gather each sequence's pages, then masked f32 attention of its T
    new tokens (the visible positions of paged_prefill_attention).

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
    qpos = (lengths.to(q.device).long()[:, None] - T
            + torch.arange(T, device=q.device))                   # (B, T)
    pos = torch.arange(S, device=q.device)
    keep = pos <= qpos[..., None]                                 # (B, T, S)
    if window is not None:
        band = pos >= qpos[..., None] - window + 1
        if sinks:
            band |= pos < sinks
        keep &= band
    s = s.masked_fill(~keep[:, None, None], float("-inf"))
    empty = ~keep.any(dim=-1)[:, None, None, :, None]  # sees nothing -> 0
    s = s.masked_fill(empty, 0.0)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).masked_fill(empty, 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    if v_pages.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).float()
    o = torch.einsum("bhgtk,bhkd->bhgtd", p, v_seq.float())
    o = o / torch.where(denom == 0, 1.0, denom)
    return o.reshape(B, Hq, T, D).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, lengths, page_table, *,
                        window=None, sinks=None, softcap=None):
    """paged_prefill_ref with one new token per sequence."""
    return paged_prefill_ref(q[:, :, None], k_pages, v_pages, lengths,
                             page_table, window=window, sinks=sinks,
                             softcap=softcap)[:, :, 0]


# ---------------------------------------------------------------------------
# the quantized tier: 1-byte pools with per-token scales

QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)
BLOCK_TOKENS_MAX = 2048  # csrc/paged_quant.cu PQ_BK_MAX


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


def _launch_quantized(q, k_pages, k_scales, v_pages, v_scales, lengths,
                      page_table, pages_per_block, q_int8, pv_int8, window,
                      sinks, softcap):
    """Launch a quantized instance on CUDA tensors, q (B, Hq, T, D); q_int8
    row-quantizes q through quantize_int8 (#20) first. Returns o (q's
    shape and type)."""
    _build.check_cuda(q, k_pages, k_scales, v_pages, v_scales, lengths,
                      page_table)
    Hkv, P, page, D = k_pages.shape
    bk = page * pages_per_block
    if D not in HEAD_DIMS or bk > BLOCK_TOKENS_MAX:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS} or a page block "
                         f"of {bk} tokens > {BLOCK_TOKENS_MAX}")
    if lengths.dtype != torch.int32 or page_table.dtype != torch.int32:
        raise TypeError("lengths and page_table must be int32")
    q = q.contiguous()
    o = torch.empty_like(q)
    dtype = _build.dtype_code(q)
    qk, q_scales = q, None
    if q_int8:
        qk, q_scales = quantize_int8(q.reshape(-1, D))
    k_pages, v_pages = _build.aligned(k_pages), _build.aligned(v_pages)
    k_scales, v_scales = (s.float().contiguous() for s in (k_scales,
                                                           v_scales))
    lengths, page_table = lengths.contiguous(), page_table.contiguous()
    B, Hq, T = q.shape[:3]
    _build.launch("tk_paged_prefill_quantized", qk.data_ptr(),
                  _build.ptr(q_scales), k_pages.data_ptr(),
                  k_scales.data_ptr(), v_pages.data_ptr(),
                  v_scales.data_ptr(), lengths.data_ptr(),
                  page_table.data_ptr(), o.data_ptr(), B, Hq, Hkv, T, P,
                  page, page_table.shape[1], D, bk, 1.0 / math.sqrt(D),
                  window or 0, sinks or 0, softcap or 0.0, dtype,
                  _build.KV_CODES[k_pages.dtype], int(pv_int8),
                  _build.stream(q))
    return o


def _count_tier(fn, k_pages, pv_int8):
    fn.launches += 1
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
    sequence. A CPU tensor takes paged_attention_quantized_ref; a CUDA
    tensor launches the kernel (head dim 32, 64 or 128; blocks of at most
    BLOCK_TOKENS_MAX tokens), and launches, int8_launches,
    pv_int8_launches and fp8_launches count its launches by tier."""
    _check_features("paged_attention_quantized", window, sinks, softcap,
                    alibi_slopes, ring)
    _check_quantized("paged_attention_quantized", q, k_pages, k_scales,
                     v_pages, v_scales, page_table, pages_per_block, q_int8,
                     pv_int8)
    kw = dict(pages_per_block=pages_per_block, q_int8=q_int8,
              pv_int8=pv_int8, window=window, sinks=sinks, softcap=softcap)
    if q.device.type == "cpu":
        return paged_attention_quantized_ref(q, k_pages, k_scales, v_pages,
                                             v_scales, lengths, page_table,
                                             **kw)
    o = _launch_quantized(q[:, :, None], k_pages, k_scales, v_pages,
                          v_scales, lengths, page_table, **kw)[:, :, 0]
    _count_tier(paged_attention_quantized, k_pages, pv_int8)
    return o


def paged_prefill_attention_quantized(q, k_pages, k_scales, v_pages,
                                      v_scales, lengths, page_table, *,
                                      pages_per_block=4, q_int8=False,
                                      pv_int8=False, window=None,
                                      softcap=None, alibi_slopes=None,
                                      ring=False, sinks=None):
    """Multi-token causal attention against a quantized paged KV cache:
    q (B, Hq, T, D) as paged_prefill_attention, the pools, scales and
    options as paged_attention_quantized. Returns (B, Hq, T, D)."""
    _check_features("paged_prefill_attention_quantized", window, sinks,
                    softcap, alibi_slopes, ring)
    _check_quantized("paged_prefill_attention_quantized", q, k_pages,
                     k_scales, v_pages, v_scales, page_table,
                     pages_per_block, q_int8, pv_int8)
    kw = dict(pages_per_block=pages_per_block, q_int8=q_int8,
              pv_int8=pv_int8, window=window, sinks=sinks, softcap=softcap)
    if q.device.type == "cpu":
        return paged_prefill_quantized_ref(q, k_pages, k_scales, v_pages,
                                           v_scales, lengths, page_table,
                                           **kw)
    o = _launch_quantized(q, k_pages, k_scales, v_pages, v_scales, lengths,
                          page_table, **kw)
    _count_tier(paged_prefill_attention_quantized, k_pages, pv_int8)
    return o


for _fn in (paged_attention_quantized, paged_prefill_attention_quantized):
    _fn.launches = _fn.int8_launches = _fn.pv_int8_launches = 0
    _fn.fp8_launches = 0


def paged_prefill_quantized_ref(q, k_pages, k_scales, v_pages, v_scales,
                                lengths, page_table, *, pages_per_block=4,
                                q_int8=False, pv_int8=False, window=None,
                                sinks=None, softcap=None):
    """The quantized kernels' function, gathered per sequence, in the TPU
    kernels' order: the score (q_int8: float(int dot) * q_scale; else
    q . k cast to q's type), * k_scale, * 1/sqrt(D), the softcap, the
    masks of paged_prefill_ref; p = exp(s - m) with m the row's final max
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
    Hkv, _, page, _ = k_pages.shape
    group = Hq // Hkv
    pps = page_table.shape[1]
    S = pps * page
    table = page_table.long()

    def seq(pool):  # (Hkv, P, page, ...) -> (B, Hkv, S, ...)
        g = pool[:, table]
        return g.permute(1, 0, *range(2, g.dim())).reshape(
            B, Hkv, S, *pool.shape[3:])

    k_seq, v_seq = seq(k_pages), seq(v_pages)
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
    qpos = (lengths.to(q.device).long()[:, None] - T
            + torch.arange(T, device=q.device))                   # (B, T)
    pos = torch.arange(S, device=q.device)
    keep = pos <= qpos[..., None]                                 # (B, T, S)
    if window is not None:
        band = pos >= qpos[..., None] - window + 1
        if sinks:
            band |= pos < sinks
        keep &= band
    s = s.masked_fill(~keep[:, None, None], float("-inf"))
    empty = ~keep.any(dim=-1)[:, None, None, :, None]
    s = s.masked_fill(empty, 0.0)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).masked_fill(empty, 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    pv = p * vs[:, :, None, None]
    if pv_int8:
        bk = page * pages_per_block
        blocks = pv.reshape(B, Hkv, group, T, S // bk, bk)
        amax = blocks.amax(dim=-1, keepdim=True)
        amax = torch.where(amax <= 0, 1.0, amax)
        # a true division (a Python scalar over a tensor multiplies by
        # its reciprocal)
        pq = torch.round(blocks * (torch.full_like(amax, 127.0) / amax))
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
