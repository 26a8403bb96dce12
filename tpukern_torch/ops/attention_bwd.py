"""FlashAttention-2 backward: dQ, dK, dV from the forward's saved (o, lse).

The port of tpukern/ops/attention_bwd.py `flash_attention_bwd` on its
fused path (no window, softcap or segment_ids). Kernel:
csrc/flash_attention_bwd.cu, which replaces `_bwd_fused_kernel`
(attention_bwd.py:339). The TPU's dQ tiers (`dq_resident`, the partials
tier, FUSED_BWD_DQ_BUDGET, fused_bwd_partials_budget) are not ported:
one CUDA design serves every S. The two-kernel featured backward
(`_dq_kernel`, `_dkv_kernel`) is ROADMAP.md queue 1 item 6.
"""

import math

import torch

from tpukern_torch import _build
from tpukern_torch.ops.attention import HEAD_DIMS


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=False, sm_scale=None):
    """q, o, do: (B, H, Sq, D); k, v: (B, H, Skv, D); lse: f32 (B, H, Sq),
    the forward's natural-log stats. Returns (dq, dk, dv) in the dtypes of
    q, k, v. H is the same for q and k here: the caller sums a GQA group.

    di = rowsum(o * do) is plain torch, as it is XLA in JAX. A CPU tensor
    takes flash_attention_bwd_ref; a CUDA tensor launches the kernel (f32
    or bf16, head dims 32, 64 and 128, causal needs Sq == Skv)."""
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    if (k.shape != (B, H, Skv, D) or v.shape != k.shape
            or o.shape != q.shape or do.shape != q.shape
            or lse.shape != (B, H, Sq)):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} o {tuple(o.shape)} lse "
                         f"{tuple(lse.shape)} do {tuple(do.shape)}")
    if causal and Sq != Skv:
        raise NotImplementedError("causal with Sq != Skv: ROADMAP.md queue 1 "
                                  "item 5")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       sm_scale=sm_scale)
    _build.check_cuda(q, k, v, o, lse, do)
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if not q.dtype == k.dtype == v.dtype == do.dtype:
        raise TypeError(f"dtypes differ: q {q.dtype} k {k.dtype} v {v.dtype} "
                        f"do {do.dtype}")
    di = (o.float() * do.float()).sum(-1)
    q, k, v, do = (_build.aligned(t) for t in (q, k, v, do))
    lse = lse.float().contiguous()
    dq = torch.zeros(B, H, Sq, D, device=q.device)  # atomicAdd target
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.launch("tk_flash_attention_bwd", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, Sq, Skv,
                  D, sm_scale, int(causal), _build.dtype_code(q),
                  _build.stream(q))
    flash_attention_bwd.launches += 1
    return dq.to(q.dtype), dk, dv


flash_attention_bwd.launches = 0


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=False,
                            sm_scale=None):
    """Recompute-from-lse backward in f32 einsums."""
    D = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
    p = torch.exp(s - lse.float()[..., None])
    if causal:
        Sq, Skv = s.shape[-2:]
        keep = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device).tril()
        p = p.masked_fill(~keep, 0.0)
    di = (o.float() * dof).sum(-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - di[..., None]) * sm_scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
