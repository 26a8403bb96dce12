"""Paged-KV attention: queries against their sequence's pages of a shared
KV pool, one token per sequence (decode) or T new tokens per sequence
(prefix prefill).

The port of tpukern/ops/paged_attention.py for float pools. Kernels:
csrc/paged_attention.cu, which replaces `_decode_kernel`
(paged_attention.py:77), and csrc/paged_prefill.cu, which replaces
`_prefix_kernel` (:513). Both take the sliding window, attention sinks
and logit softcap of the JAX kernels. Pools carry the natural head dim:
the 128-lane pad of the JAX pools is a TPU compiler requirement and is
not ported.
"""

import math

import torch

from tpukern_torch import _build

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
