"""Paged-KV decode attention: one query token per sequence against its
pages of a shared KV pool.

The port of tpukern/ops/paged_attention.py's decode path for float pools.
Kernel: csrc/paged_attention.cu, which replaces `_decode_kernel`
(paged_attention.py:77). Pools carry the natural head dim: the 128-lane
pad of the JAX pools is a TPU compiler requirement and is not ported.
"""

import math

import torch

from tpukern_torch import _build

MAX_GROUP = 8      # csrc/paged_attention.cu PA_GMAX
HEAD_DIMS = (32, 64, 128)  # csrc/paged_attention.cu launch_d
_TODO = "ROADMAP.md queue 1 item 10 (ops/paged_attention.py options)"


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
    of 0 gives 0.

    pages_per_block is the TPU kernel's page-DMA batch: accepted and
    ignored, since the CUDA kernel gathers token rows, not whole pages.
    window, softcap, alibi_slopes, ring and sinks raise
    NotImplementedError. A CPU tensor takes paged_attention_ref; a CUDA
    tensor launches the kernel (head dim 32, 64 or 128)."""
    del pages_per_block
    for name, value in dict(window=window, softcap=softcap,
                            alibi_slopes=alibi_slopes, sinks=sinks,
                            ring=ring or None).items():
        if value is not None:
            raise NotImplementedError(f"paged_attention({name}=...) is not "
                                      f"ported yet: {_TODO}")
    B, Hq, D = q.shape
    Hkv, P, page_size, Dp = k_pages.shape
    if Hq % Hkv or Dp != D or v_pages.shape != k_pages.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} pools "
                         f"{tuple(k_pages.shape)} {tuple(v_pages.shape)}")
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, lengths, page_table)
    _build.check_cuda(q, k_pages, v_pages, lengths, page_table)
    if Hq // Hkv > MAX_GROUP or D not in HEAD_DIMS:
        raise ValueError(f"group {Hq // Hkv} > {MAX_GROUP} or head dim {D} "
                         f"not in {HEAD_DIMS}")
    if not q.dtype == k_pages.dtype == v_pages.dtype:
        raise TypeError(f"dtypes differ: {q.dtype} {k_pages.dtype} "
                        f"{v_pages.dtype}")
    if lengths.dtype != torch.int32 or page_table.dtype != torch.int32:
        raise TypeError("lengths and page_table must be int32")
    q = q.contiguous()
    k_pages, v_pages = _build.aligned(k_pages), _build.aligned(v_pages)
    lengths, page_table = lengths.contiguous(), page_table.contiguous()
    o = torch.empty_like(q)
    _build.launch("tk_paged_attention", q.data_ptr(), k_pages.data_ptr(),
                  v_pages.data_ptr(), lengths.data_ptr(),
                  page_table.data_ptr(), o.data_ptr(), B, Hq, Hkv, P,
                  page_size, page_table.shape[1], D, 1.0 / math.sqrt(D),
                  _build.dtype_code(q), _build.stream(q))
    paged_attention.launches += 1
    return o


paged_attention.launches = 0


def paged_attention_ref(q, k_pages, v_pages, lengths, page_table):
    """Gather each sequence's pages, then masked f32 attention."""
    B, Hq, D = q.shape
    Hkv, P, page_size, _ = k_pages.shape
    group = Hq // Hkv
    S = page_table.shape[1] * page_size
    table = page_table.long()
    # (Hkv, B, pages_per_seq, page, D) -> (B, Hkv, S, D)
    k_seq = k_pages[:, table].permute(1, 0, 2, 3, 4).reshape(B, Hkv, S, D)
    v_seq = v_pages[:, table].permute(1, 0, 2, 3, 4).reshape(B, Hkv, S, D)
    qf = q.reshape(B, Hkv, group, D).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qf, k_seq.float()) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    live = pos[None, :] < lengths.to(q.device)[:, None]          # (B, S)
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    empty = ~live.any(dim=-1)[:, None, None, None]   # length 0 -> output 0
    p = torch.softmax(s.masked_fill(empty, 0.0), dim=-1).masked_fill(empty,
                                                                     0.0)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v_seq.float())
    return o.reshape(B, Hq, D).to(q.dtype)
