"""FlashAttention-2 forward: split-Q tiling with a fused online softmax.

The port of tpukern/ops/attention.py's forward for the features the
serving prefill and the training step use: causal masking, GQA (query
head h reads KV head h // (Hq // Hkv)), any Sq == Skv including lengths
that are not a tile multiple, head dims 32, 64 and 128, the lse output
(return_stats) that the backward recomputes P from, and the masks of the
featured training path: a sliding window with attention sinks, a logit
softcap and segment ids. Kernel: csrc/flash_attention.cu, which replaces
`_fa_kernel` (attention.py:62) and its transposed-layout twin
`_fa_tpv_kernel` (:656).
"""

import math

import torch

from tpukern_torch import _build
from tpukern_torch.core.registry import register

HEAD_DIMS = (32, 64, 128)
_TODO = "ROADMAP.md queue 1 item 5 (flash_attention features)"


def _reject(**features):
    for name, value in features.items():
        if value is None or value is False or (type(value) is int
                                               and value == 0):
            continue
        raise NotImplementedError(f"flash_attention({name}=...) is not "
                                  f"ported yet: {_TODO}")


def check_features(causal, window=None, sinks=None, softcap=None,
                   alibi_slopes=None):
    """The JAX asserts on the masks (attention.py:475-485) as ValueErrors."""
    if window is not None and (not causal or window < 1):
        raise ValueError(f"window={window} needs causal=True and window >= 1")
    if sinks is not None and (window is None or sinks < 1):
        raise ValueError(f"sinks={sinks} needs a window and sinks >= 1")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap={softcap} must be > 0")
    if softcap is not None and alibi_slopes is not None:
        raise ValueError("softcap + alibi ordering is ambiguous")


def visible(Sq, Skv, device, *, causal=False, window=None, sinks=None,
            segment_ids=None):
    """Bool (B or 1, 1, Sq, Skv) mask of the (query, key) pairs a query
    sees, or None when it sees every key: causal keeps c <= r, the window
    c >= r - window + 1 (or c < sinks), segments equal ids."""
    keep = None
    if causal:
        r = torch.arange(Sq, device=device)[:, None]
        c = torch.arange(Skv, device=device)[None, :]
        keep = c <= r
        if window is not None:
            band = c >= r - window + 1
            if sinks is not None:
                band |= c < sinks
            keep &= band
        keep = keep[None, None]
    if segment_ids is not None:
        q_seg, kv_seg = (s.to(device) for s in segment_ids)
        same = (q_seg[:, None, :, None] == kv_seg[:, None, None, :])
        keep = same if keep is None else keep & same
    return keep


def segments_i32(segment_ids, B, Sq, Skv, device):
    """segment_ids = (q_seg (B, Sq), kv_seg (B, Skv)) as contiguous int32
    on `device`, or (None, None)."""
    if segment_ids is None:
        return None, None
    q_seg, kv_seg = segment_ids
    if tuple(q_seg.shape) != (B, Sq) or tuple(kv_seg.shape) != (B, Skv):
        raise ValueError(f"segment_ids must be ((B,Sq),(B,Skv)); got "
                         f"{tuple(q_seg.shape)}, {tuple(kv_seg.shape)}")
    return (q_seg.to(device, torch.int32).contiguous(),
            kv_seg.to(device, torch.int32).contiguous())


def flash_attention(q, k, v, *, causal=False, sm_scale=None, window=None,
                    sinks=None, softcap=None, alibi_slopes=None,
                    segment_ids=None, causal_offset=0, carry=None,
                    return_carry=False, return_stats=False):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) with Hkv | Hq -> o like q,
    and with return_stats also the f32 (B, Hq, Sq) log-sum-exp of the
    scaled (and capped) scores, in natural log.

    causal=True needs Sq == Skv. sm_scale defaults to 1/sqrt(D). window
    (causal only) keeps the last `window` keys of each query, sinks (with
    a window) also the first `sinks`; softcap maps each scaled score s to
    cap·tanh(s/cap) before masking; segment_ids = (q_seg (B, Sq), kv_seg
    (B, Skv)) ints lets a query see only keys of its own segment, and a
    query that sees no key outputs 0. A CPU tensor takes attention_ref; a
    CUDA tensor launches the kernel (bf16 on the tensor cores, f32 on CUDA
    cores). alibi_slopes, causal_offset and the carry raise
    NotImplementedError."""
    check_features(causal, window, sinks, softcap, alibi_slopes)
    _reject(alibi_slopes=alibi_slopes, causal_offset=causal_offset,
            carry=carry, return_carry=return_carry)
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
                             window=window, sinks=sinks, softcap=softcap,
                             segment_ids=segment_ids,
                             return_stats=return_stats)
    _build.check_cuda(q, k, v)
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype} {k.dtype} "
                        f"{v.dtype}")
    q, k, v = (_build.aligned(t) for t in (q, k, v))
    q_seg, kv_seg = segments_i32(segment_ids, B, Sq, Skv, q.device)
    o = torch.empty_like(q)
    lse = (torch.empty(B, Hq, Sq, device=q.device) if return_stats
           else None)
    _build.launch("tk_flash_attention", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o.data_ptr(),
                  None if lse is None else lse.data_ptr(),
                  _build.ptr(q_seg), _build.ptr(kv_seg), B, Hq, Hkv, Sq,
                  Skv, D, sm_scale, int(causal), window or 0, sinks or 0,
                  softcap or 0.0, _build.dtype_code(q), _build.stream(q))
    flash_attention.launches += 1
    return (o, lse) if return_stats else o


flash_attention.launches = 0


def attention_ref(q, k, v, *, causal=False, sm_scale=None, window=None,
                  sinks=None, softcap=None, segment_ids=None,
                  return_stats=False):
    """Unfused f32 reference with GQA broadcast and the masks of
    flash_attention; rows that see no key give 0. return_stats also
    returns the f32 natural-log lse of each row (-inf for such rows)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    kf = k.float().repeat_interleave(Hq // Hkv, dim=1)
    vf = v.float().repeat_interleave(Hq // Hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * sm_scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    keep = visible(Sq, Skv, q.device, causal=causal, window=window,
                   sinks=sinks, segment_ids=segment_ids)
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    all_masked = torch.isneginf(s).all(dim=-1, keepdim=True)
    p = torch.softmax(s.masked_fill(all_masked, 0.0), dim=-1)
    p = p.masked_fill(all_masked, 0.0)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if return_stats else o


# ---------------------------------------------------------------- registry

def _fa_flops(q, k, v, **kw):
    B, H, Sq, D = q.shape
    f = 4 * B * H * Sq * k.shape[2] * D
    return f // 2 if kw.get("causal") else f


def _cast(fn, dt):
    def wrapped(q, k, v, **kw):
        return fn(q.to(dt), k.to(dt), v.to(dt), **kw)
    return wrapped


def _sdpa(q, k, v, *, causal=False, sm_scale=None):
    """The SDPA baseline (attention.py sdpa_xla's role)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, scale=sm_scale,
        enable_gqa=q.shape[1] != k.shape[1])


# the bf16 tiers of attention.py:1053-1066 and the transposed-layout twin
# (`mha_splitq_bf16_tpv`): block sizes, the duo split and the layout are
# TPU knobs, so all are this kernel; mha_splitq_f16, the bf16
# accumulator, split-KV and the JAX library kernels are in
# core.registry.PENDING
for _name in ("mha_splitq_bf16", "mha_splitq_bf16_hyper",
              "mha_splitq_bf16_stage2", "mha_splitq_bf16_stage4",
              "mha_splitq_bf16_bigq", "mha_splitq_bf16_duo",
              "mha_splitq_bf16_tpv"):
    register("attention", _name, ref=_cast(attention_ref, torch.bfloat16),
             flops=_fa_flops)(_cast(flash_attention, torch.bfloat16))
register("attention", "mha_splitq_f32", ref=_cast(attention_ref, torch.float32),
         flops=_fa_flops)(_cast(flash_attention, torch.float32))
register("attention", "mha_xla_sdpa", ref=attention_ref, flops=_fa_flops,
         tags=("baseline",))(_sdpa)
register("attention", "mha_unfused", ref=attention_ref, flops=_fa_flops,
         tags=("baseline",))(attention_ref)
