"""FlashAttention-2 forward: split-Q tiling with a fused online softmax.

The port of tpukern/ops/attention.py's forward for the features the
serving prefill and the training step use: causal masking, GQA (query
head h reads KV head h // (Hq // Hkv)), any Sq == Skv including lengths
that are not a tile multiple, head dims 32, 64 and 128, and the lse
output (return_stats) that the backward recomputes P from. Kernel:
csrc/flash_attention.cu, which replaces `_fa_kernel` (attention.py:62)
and its transposed-layout twin `_fa_tpv_kernel` (:656).
"""

import math

import torch

from tpukern_torch import _build

HEAD_DIMS = (32, 64, 128)
_TODO = "ROADMAP.md queue 1 item 5 (flash_attention features)"


def _reject(**features):
    for name, value in features.items():
        if value is None or value is False or (type(value) is int
                                               and value == 0):
            continue
        raise NotImplementedError(f"flash_attention({name}=...) is not "
                                  f"ported yet: {_TODO}")


def flash_attention(q, k, v, *, causal=False, sm_scale=None, window=None,
                    sinks=None, softcap=None, alibi_slopes=None,
                    segment_ids=None, causal_offset=0, carry=None,
                    return_carry=False, return_stats=False):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) with Hkv | Hq -> o like q,
    and with return_stats also the f32 (B, Hq, Sq) log-sum-exp of the
    scaled scores, in natural log.

    causal=True needs Sq == Skv. sm_scale defaults to 1/sqrt(D). A CPU
    tensor takes attention_ref; a CUDA tensor launches the kernel (bf16
    on the tensor cores, f32 on CUDA cores). The remaining keywords of
    the JAX signature raise NotImplementedError."""
    _reject(window=window, sinks=sinks, softcap=softcap,
            alibi_slopes=alibi_slopes, segment_ids=segment_ids,
            causal_offset=causal_offset, carry=carry,
            return_carry=return_carry)
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if Hq % Hkv or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if causal and Sq != Skv:
        raise NotImplementedError(f"causal with Sq != Skv: {_TODO}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, sm_scale=sm_scale,
                             return_stats=return_stats)
    _build.check_cuda(q, k, v)
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype} {k.dtype} "
                        f"{v.dtype}")
    q, k, v = (_build.aligned(t) for t in (q, k, v))
    o = torch.empty_like(q)
    lse = (torch.empty(B, Hq, Sq, device=q.device) if return_stats
           else None)
    _build.launch("tk_flash_attention", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o.data_ptr(),
                  None if lse is None else lse.data_ptr(), B, Hq, Hkv, Sq,
                  Skv, D, sm_scale, int(causal), _build.dtype_code(q),
                  _build.stream(q))
    flash_attention.launches += 1
    return (o, lse) if return_stats else o


flash_attention.launches = 0


def attention_ref(q, k, v, *, causal=False, sm_scale=None,
                  return_stats=False):
    """Unfused f32 reference with GQA broadcast; fully masked rows give 0.
    return_stats also returns the f32 natural-log lse of each row."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    kf = k.float().repeat_interleave(Hq // Hkv, dim=1)
    vf = v.float().repeat_interleave(Hq // Hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * sm_scale
    if causal:
        mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    all_masked = torch.isneginf(s).all(dim=-1, keepdim=True)
    p = torch.softmax(s.masked_fill(all_masked, 0.0), dim=-1)
    p = p.masked_fill(all_masked, 0.0)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if return_stats else o
