"""FlashAttention-2 forward: split-Q tiling with a fused online softmax.

The port of tpukern/ops/attention.py's forward for the features the
serving prefill and the training step use: causal masking, GQA (query
head h reads KV head h // (Hq // Hkv)), any Sq == Skv including lengths
that are not a tile multiple, head dims 32, 64 and 128, the lse output
(return_stats) that the backward recomputes P from, and the masks of the
featured training path: a sliding window with attention sinks, a logit
softcap and segment ids. Kernel: csrc/flash_attention.cu, which replaces
`_fa_kernel` (attention.py:62) and its transposed-layout twin
`_fa_tpv_kernel` (:656): in bf16 a TMA + wgmma kernel (a producer and
consumer warpgroups of 64 query rows), in f32 split-TF32 products on
wgmma (csrc/flash_attention_tf32.cu). `attention_tiled_ref` is the bf16
kernel's order of work in plain torch, `attention_tf32_ref` the f32
kernel's.
"""

import math

import torch

from tpukern_torch import _build
from tpukern_torch.core.registry import register

HEAD_DIMS = (32, 64, 128)
_TODO = "ROADMAP.md queue 1 item 5 (flash_attention features)"

# The bf16 kernel's tile shape, (query rows a block, keys a KV tile, GQA
# pair), or None for the rule's (fwd_tiles): the timing harness's lever
# (tpukern_torch/harness/fa_times.py). The shapes other than the rule's
# two are built for head dim 128 without lse or masks beyond causal
# only. Codes as csrc/flash_attention.cu launch_bf16 reads them.
FWD_TILES = None
FWD_CONFIGS = {(64, 64, False): 1, (64, 128, False): 2, (128, 64, False): 3,
               (128, 128, False): 4, (64, 64, True): 5, (64, 128, True): 6}


def fwd_tiles(B, Hq, Sq, n_sms):
    """The tile shape the bf16 kernel takes by default (csrc launch_bf16's
    rule): blocks of 64 query rows walking 128-key tiles where they fit in
    one wave of the n_sms SMs, else blocks of 128 rows walking 64-key
    tiles."""
    if -(-Sq // 64) * Hq * B <= n_sms:
        return (64, 128, False)
    return (128, 64, False)


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
    CUDA tensor launches the kernel (bf16, and f32 as split-TF32 products,
    on the tensor cores). alibi_slopes, causal_offset and the carry raise
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
                  softcap or 0.0, _build.dtype_code(q),
                  FWD_CONFIGS[FWD_TILES] if FWD_TILES else 0,
                  _build.stream(q))
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


NEG_BIG = -0.7 * 3.4e38  # the kernels' mask value (csrc/common.cuh)
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def kv_tiles(q0, kv_end, block_k, window=None, sinks=None):
    """The KV tile starts a query tile whose first row is q0 walks, in
    order (csrc/common.cuh KvRange): the sink tiles, then the band from
    the tile holding q0 - window + 1, up to kv_end."""
    lo = max(0, q0 - window + 1) // block_k * block_k if window else 0
    sink_end = min(lo, -(-sinks // block_k) * block_k) if sinks else 0
    k0 = 0 if sink_end > 0 else lo
    while k0 < kv_end:
        yield k0
        k0 = lo if k0 + block_k == sink_end else k0 + block_k


def attention_tiled_ref(q, k, v, *, causal=False, sm_scale=None,
                        window=None, sinks=None, softcap=None,
                        segment_ids=None, return_stats=False, block_q=64,
                        block_k=64):
    """flash_attention in the bf16 kernel's order of work, a test aid off
    the main path: each tile of block_q query rows walks its KV tiles of
    block_k keys in kv_tiles order (up to its causal frontier) with an
    online softmax in log2 units: the f32 scores scaled by sm_scale, capped,
    scaled by log2 e and masked with NEG_BIG; l summed from the f32 p; P
    rounded to q's dtype before P V. A row that sees no key gives 0; with
    return_stats also the f32 natural-log lse (LN2 m + log l)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    qf = q.float()
    kf = k.float().repeat_interleave(Hq // Hkv, dim=1)
    vf = v.float().repeat_interleave(Hq // Hkv, dim=1)
    keep = visible(Sq, Skv, q.device, causal=causal, window=window,
                   sinks=sinks, segment_ids=segment_ids)
    o = torch.zeros(B, Hq, Sq, D, device=q.device)
    lse = torch.zeros(B, Hq, Sq, device=q.device)
    for q0 in range(0, Sq, block_q):
        rows = slice(q0, min(Sq, q0 + block_q))
        n = rows.stop - q0
        m = torch.full((B, Hq, n), NEG_BIG, device=q.device)
        l = torch.zeros(B, Hq, n, device=q.device)
        acc = torch.zeros(B, Hq, n, D, device=q.device)
        kv_end = min(Skv, q0 + block_q) if causal else Skv
        for k0 in kv_tiles(q0, kv_end, block_k, window, sinks):
            cols = slice(k0, min(Skv, k0 + block_k))
            s = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, rows],
                             kf[:, :, cols]) * sm_scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            s = s * LOG2E
            if keep is not None:
                s = s.masked_fill(~keep[..., rows, cols], NEG_BIG)
            mn = torch.maximum(m, s.amax(-1))
            a = torch.exp2(m - mn)
            p = torch.exp2(s - mn[..., None])
            l = l * a + p.sum(-1)
            acc = acc * a[..., None] + p.to(q.dtype).float() @ vf[:, :, cols]
            m = mn
        none = (l == 0) | ((m <= 0.5 * NEG_BIG) if segment_ids is not None
                           else False)
        o[:, :, rows] = torch.where(none[..., None], 0.0,
                                    acc * (1.0 / l)[..., None])
        lse[:, :, rows] = LN2 * m + torch.log(l.clamp(min=1e-37))
    o = o.to(q.dtype)
    return (o, lse) if return_stats else o


# the f32 kernel's tiles: query rows a block, keys a KV tile, and the
# columns of D a fresh accumulator of S = Q K^T sums
# (csrc/flash_attention_tf32.cu FT_QW, FT_BK)
TF32_BLOCK_Q, TF32_BLOCK_K = 64, 32


def attention_tf32_ref(q, k, v, *, causal=False, sm_scale=None, window=None,
                       sinks=None, softcap=None, segment_ids=None,
                       return_stats=False):
    """flash_attention's f32 tier in its order of work, a test aid off the
    main path: each tile of TF32_BLOCK_Q query rows (query head h reading
    KV head h // (Hq // Hkv)) walks its KV tiles of TF32_BLOCK_K keys in
    kv_tiles order up to its causal frontier; S = Q K^T as split-TF32
    products in slabs of 32 columns of D (split_tf32.split_bmm_ref),
    scaled by sm_scale, capped, masked with NEG_BIG; the online softmax in
    natural-log units, l summed from the f32 p; P V as split products of
    the tile's P and V, keys in the kernel's fragment order
    (split_tf32.key_order, P's columns and V's rows alike), a fresh sum
    added to O = alpha O + P V. A row that sees no key gives 0; with
    return_stats also the f32 lse (m + log l). f32 out."""
    from tpukern_torch.ops.split_tf32 import key_order, split_bmm_ref

    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    bq, bk = TF32_BLOCK_Q, TF32_BLOCK_K
    qf = q.float()
    kf = k.float().repeat_interleave(Hq // Hkv, dim=1)
    vf = v.float().repeat_interleave(Hq // Hkv, dim=1)
    keep = visible(Sq, Skv, q.device, causal=causal, window=window,
                   sinks=sinks, segment_ids=segment_ids)
    order = key_order(bk).to(q.device)
    o = torch.zeros(B, Hq, Sq, D, device=q.device)
    lse = torch.zeros(B, Hq, Sq, device=q.device)
    for q0 in range(0, Sq, bq):
        rows = slice(q0, min(Sq, q0 + bq))
        n = rows.stop - q0
        m = torch.full((B, Hq, n), NEG_BIG, device=q.device)
        l = torch.zeros(B, Hq, n, device=q.device)
        acc = torch.zeros(B, Hq, n, D, device=q.device)
        kv_end = min(Skv, q0 + bq) if causal else Skv
        for k0 in kv_tiles(q0, kv_end, bk, window, sinks):
            cols = slice(k0, min(Skv, k0 + bk))
            s = split_bmm_ref(qf[:, :, rows], kf[:, :, cols]) * sm_scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            if keep is not None:
                s = s.masked_fill(~keep[..., rows, cols], NEG_BIG)
            mn = torch.maximum(m, s.amax(-1))
            a = torch.exp(m - mn)
            p = torch.exp(s - mn[..., None])
            l = l * a + p.sum(-1)
            # the tile at its full width (keys past Skv: p and V zero)
            pad = bk - (cols.stop - k0)
            pt = torch.nn.functional.pad(p, (0, pad))[..., order]
            vt = torch.nn.functional.pad(vf[:, :, cols], (0, 0, 0, pad))
            acc = acc * a[..., None] + split_bmm_ref(pt, vt[..., order, :].mT)
            m = mn
        none = (l == 0) | ((m <= 0.5 * NEG_BIG) if segment_ids is not None
                           else False)
        o[:, :, rows] = torch.where(none[..., None], 0.0,
                                    acc * (1.0 / l)[..., None])
        lse[:, :, rows] = m + torch.log(l.clamp(min=1e-37))
    return (o, lse) if return_stats else o


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
