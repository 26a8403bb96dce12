"""FlashAttention-2 backward: dQ, dK, dV from the forward's saved (o, lse).

The port of tpukern/ops/attention_bwd.py `flash_attention_bwd` and its
dispatch (attention_bwd.py:587-598, :675-676):

- no window, softcap or segment_ids (and `fused` unset): the fused
  kernel, which replaces `_bwd_fused_kernel` (attention_bwd.py:339), GQA
  inside: a block walks every query head of its KV head's group, so K
  and V are not repeated and dK and dV are summed over the group in the
  kernel. f32 inputs run csrc/flash_attention_bwd.cu (split-TF32
  products on wgmma; `flash_attention_bwd_tf32_ref` is its order of
  work in plain torch); bf16 inputs csrc/flash_attention_bwd_bf16.cu
  (bf16 wgmma on the bf16 tensors as they are, P and dS rounded to bf16
  as the TPU kernel rounds them; `flash_attention_bwd_bf16_ref`).
  The TPU's dQ tiers (`dq_resident`, the partials tier,
  FUSED_BWD_DQ_BUDGET, fused_bwd_partials_budget) are not ported: one
  CUDA design serves every S.
- any of those features, or fused=False: the two-kernel featured
  backward, GQA inside both (K and V at their own heads, dK and dV summed
  over each group in the kernel): `flash_attention_dq` (#9) replaces
  `_dq_kernel` (:31) and `flash_attention_dkv` (#10) replaces
  `_dkv_kernel` (:110). f32 inputs run split-TF32 products on wgmma,
  csrc/flash_attention_featured_tf32.cu (`flash_attention_dq_tf32_ref`
  and `flash_attention_dkv_tf32_ref` are their orders of work); bf16
  inputs the CUDA-core kernels of
  csrc/flash_attention_featured_bwd.cu. Their transposed-layout twins
  `_dq_t_kernel` (:188) and `_dkv_t_kernel` (:261) compute the same
  function in the TPU's layout for D <= 64 and need no entry point here:
  their function is these two kernels'.

block_q, block_k, transposed and interpret are TPU layout and tiling
knobs and are not ported.
"""

import math

import torch

from tpukern_torch import _build
from tpukern_torch.ops.attention import (HEAD_DIMS, check_features,
                                         segments_i32, visible)


def _check(q, k, v, do, lse, causal, window, softcap, sm_scale, o=None,
           gqa=False):
    """sm_scale (1/sqrt(D) by default), after the shape checks: k and v
    of (B, Hkv, Skv, D), Hkv == Hq unless gqa, where Hkv divides Hq."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if ((Hkv != H and not (gqa and Hkv and H % Hkv == 0))
            or k.shape != (B, Hkv, Skv, D) or v.shape != k.shape
            or do.shape != q.shape or lse.shape != (B, H, Sq)
            or (o is not None and o.shape != q.shape)):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} lse {tuple(lse.shape)} do "
                         f"{tuple(do.shape)}")
    if causal and Sq != Skv:
        raise NotImplementedError("causal with Sq != Skv: ROADMAP.md queue 1 "
                                  "item 5")
    check_features(causal, window, softcap=softcap)
    return 1.0 / math.sqrt(D) if sm_scale is None else sm_scale


# the f32 kernel's tiles: keys a block, query rows a step
# (csrc/flash_attention_bwd.cu TB_BKV, TB_BQ)
TB_BLOCK_KV, TB_BLOCK_Q = 32, 64
# the bf16 kernel's (csrc/flash_attention_bwd_bf16.cu BB_BKV, BB_BQ)
BB_BLOCK_KV, BB_BLOCK_Q = 64, 64
# the f32 featured kernels' (csrc/flash_attention_featured_tf32.cu
# FT_ROWS, FT_KEYS): query rows (#9's block, #10's step) and keys (#9's
# tile, #10's block)
FT_BLOCK_Q, FT_BLOCK_KV = 64, 32


def ft_slab(D):
    """The slab of the f32 featured kernels' S and dP products (values of
    D a fresh accumulator; FT_SLAB in the kernels): 32 at D 128, 8
    below."""
    return 32 if D == 128 else 8


def _check_cuda(q, k, v, do, lse, di):
    _build.check_cuda(q, k, v, do, lse, di)
    D = q.shape[-1]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if not q.dtype == k.dtype == v.dtype == do.dtype:
        raise TypeError(f"dtypes differ: q {q.dtype} k {k.dtype} v {v.dtype} "
                        f"do {do.dtype}")


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=False, sm_scale=None,
                        window=None, softcap=None, segment_ids=None,
                        fused=None):
    """q, o, do: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D), Hkv dividing Hq
    (GQA: query head h reads KV head h // (Hq // Hkv)); lse: f32 (B, Hq,
    Sq), the forward's natural-log stats. Returns (dq, dk, dv) in the
    dtypes of q, k, v, dk and dv summed over each group.

    window, softcap and segment_ids mirror the forward's masks and run on
    the two-kernel featured backward, as does fused=False; otherwise the
    fused kernel. fused=True with a feature raises ValueError, as JAX's
    assert does. di = rowsum(o * do) is plain torch, as it is XLA in JAX. A CPU
    tensor takes the plain versions; a CUDA tensor launches the kernels
    (f32 or bf16, head dims 32, 64 and 128, causal needs Sq == Skv);
    `launches` counts the fused kernel's launches, `bf16_launches` those
    of its bf16 tier."""
    sm_scale = _check(q, k, v, do, lse, causal, window, softcap, sm_scale, o,
                      gqa=True)
    featured = (window is not None or softcap is not None
                or segment_ids is not None)
    if featured and fused:
        raise ValueError("window/softcap/segment_ids need the two-kernel "
                         "backward, not fused=True")
    if fused is None:
        fused = not featured
    kw = dict(causal=causal, sm_scale=sm_scale)
    if fused and q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    di = (o.float() * do.float()).sum(-1)
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    if not fused:  # the two-kernel backward, GQA inside both kernels
        feat = dict(kw, window=window, softcap=softcap,
                    segment_ids=segment_ids)
        return (flash_attention_dq(q, k, v, do, lse, di, **feat),
                *flash_attention_dkv(q, k, v, do, lse, di, **feat))
    _check_cuda(q, k, v, do, lse, di)
    # both tiers take the inputs as they are (f32 or bf16), dq an f32 sum
    qa, ka, va, doa = (_build.aligned(t) for t in (q, k, v, do))
    lse = lse.float().contiguous()
    dq = torch.zeros(B, Hq, Sq, D, device=q.device)  # atomicAdd target
    dk, dv = torch.empty_like(ka), torch.empty_like(va)
    _build.launch("tk_flash_attention_bwd", qa.data_ptr(), ka.data_ptr(),
                  va.data_ptr(), doa.data_ptr(), lse.data_ptr(),
                  di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  B, Hq, Hkv, Sq, k.shape[2], D, sm_scale, int(causal),
                  _build.dtype_code(qa), _build.stream(q))
    flash_attention_bwd.launches += 1
    flash_attention_bwd.bf16_launches += q.dtype == torch.bfloat16
    return dq.to(q.dtype), dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.bf16_launches = 0


def _launch_featured(name, q, k, v, do, lse, di, outs, *, causal, sm_scale,
                     window, softcap, segment_ids):
    """Launch one featured kernel writing `outs`. The contiguous copies
    made here stay referenced until the launch is queued, so the
    allocator cannot hand their memory to `outs` (it reuses a freed
    block only for work queued after the free)."""
    _check_cuda(q, k, v, do, lse, di)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    ins = (*(_build.aligned(t) for t in (q, k, v, do)),
           lse.float().contiguous(), di.float().contiguous(),
           *segments_i32(segment_ids, B, Sq, Skv, q.device))
    _build.launch(name, *map(_build.ptr, ins), *(t.data_ptr() for t in outs),
                  B, Hq, Hkv, Sq, Skv, D, sm_scale, int(causal), window or 0,
                  softcap or 0.0, _build.dtype_code(q), _build.stream(q))


def flash_attention_dq(q, k, v, do, lse, di, *, causal=False, sm_scale=None,
                       window=None, softcap=None, segment_ids=None):
    """dQ of the two-kernel backward (`_dq_kernel`), from the forward's
    natural-log lse and di = rowsum(o * do); in q's dtype. k and v at Hkv
    heads dividing Hq (query head h reads KV head h // (Hq // Hkv)). A CPU
    tensor takes flash_attention_dq_ref; a CUDA tensor launches the kernel
    (f32: split-TF32 wgmma; bf16: CUDA-core FMAs)."""
    sm_scale = _check(q, k, v, do, lse, causal, window, softcap, sm_scale,
                      gqa=True)
    feat = dict(causal=causal, sm_scale=sm_scale, window=window,
                softcap=softcap, segment_ids=segment_ids)
    if q.device.type == "cpu":
        return flash_attention_dq_ref(q, k, v, do, lse, di, **feat)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch_featured("tk_flash_attention_dq", q, k, v, do, lse, di, (dq,),
                     **feat)
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, do, lse, di, *, causal=False, sm_scale=None,
                        window=None, softcap=None, segment_ids=None):
    """(dK, dV) of the two-kernel backward (`_dkv_kernel`), in the dtypes
    of k and v, at Hkv heads: each summed over its group's query heads in
    the kernel. A CPU tensor takes flash_attention_dkv_ref; a CUDA tensor
    launches the kernel (f32: split-TF32 wgmma; bf16: CUDA-core FMAs)."""
    sm_scale = _check(q, k, v, do, lse, causal, window, softcap, sm_scale,
                      gqa=True)
    feat = dict(causal=causal, sm_scale=sm_scale, window=window,
                softcap=softcap, segment_ids=segment_ids)
    if q.device.type == "cpu":
        return flash_attention_dkv_ref(q, k, v, do, lse, di, **feat)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch_featured("tk_flash_attention_dkv", q, k, v, do, lse, di,
                     (dk, dv), **feat)
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


def _p_ds(q, k, v, do, lse, di, causal, sm_scale, window, softcap,
          segment_ids):
    """P and dS of the recompute from lse, in f32, zero where a pair is
    masked (where-selects: a row that sees no key has an lse of -inf or
    about NEG_BIG, and exp(s - lse) is inf there). sm_scale None is
    1/sqrt(D)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    p = torch.exp(s - lse.float()[..., None])
    keep = visible(q.shape[2], k.shape[2], q.device, causal=causal,
                   window=window, segment_ids=segment_ids)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - di.float()[..., None]) * sm_scale
    if softcap is not None:
        ds = ds * (1.0 - t * t)
    return p, ds


def _repeat(q, k, v):
    """k and v repeated over each GQA group to q's heads, and the group."""
    g = q.shape[1] // k.shape[1]
    return (*(t.repeat_interleave(g, dim=1) for t in (k, v)), g)


def _dq_of(ds, kr, dtype):
    return torch.einsum("bhqk,bhkd->bhqd", ds, kr.float()).to(dtype)


def _dkv_of(p, ds, q, do, g, k, v):
    """dK = dSᵀ·Q and dV = Pᵀ·dO, summed over each group of g query
    heads in f32, in the dtypes of k and v."""
    fold = (k.shape[0], k.shape[1], g, *k.shape[2:])
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    return (dk.reshape(fold).sum(2).to(k.dtype),
            dv.reshape(fold).sum(2).to(v.dtype))


def flash_attention_dq_ref(q, k, v, do, lse, di, *, causal=False,
                           sm_scale=None, window=None, softcap=None,
                           segment_ids=None):
    """Plain dQ = dS·K in f32 einsums, cast to q's dtype; GQA (Hkv
    dividing Hq): K and V repeated over each group."""
    kr, vr, _ = _repeat(q, k, v)
    _, ds = _p_ds(q, kr, vr, do, lse, di, causal, sm_scale, window, softcap,
                  segment_ids)
    return _dq_of(ds, kr, q.dtype)


def flash_attention_dkv_ref(q, k, v, do, lse, di, *, causal=False,
                            sm_scale=None, window=None, softcap=None,
                            segment_ids=None):
    """Plain dK = dSᵀ·Q and dV = Pᵀ·dO in f32 einsums, cast to k's and
    v's dtypes; GQA: K and V repeated over each group, dK and dV summed
    over it in f32."""
    kr, vr, g = _repeat(q, k, v)
    p, ds = _p_ds(q, kr, vr, do, lse, di, causal, sm_scale, window, softcap,
                  segment_ids)
    return _dkv_of(p, ds, q, do, g, k, v)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=False,
                            sm_scale=None, window=None, softcap=None,
                            segment_ids=None):
    """Recompute-from-lse backward in f32 einsums, with the forward's
    masks: (dq, dk, dv). GQA (Hkv dividing Hq): K and V repeated over each
    group, dk and dv summed over it in f32."""
    kr, vr, g = _repeat(q, k, v)
    di = (o.float() * do.float()).sum(-1)
    p, ds = _p_ds(q, kr, vr, do, lse, di, causal, sm_scale, window, softcap,
                  segment_ids)
    return (_dq_of(ds, kr, q.dtype), *_dkv_of(p, ds, q, do, g, k, v))


def _rows(t, r0, n):
    """Rows r0..r0+n of t (..., rows, D), zeros past its end (TMA's fill)."""
    part = t[..., r0:r0 + n, :]
    return torch.nn.functional.pad(part, (0, 0, 0, n - part.shape[-2]))


def flash_attention_bwd_tf32_ref(q, k, v, o, lse, do, *, causal=False,
                                 sm_scale=None):
    """flash_attention_bwd's fused f32 tier in its order of work, a test
    aid off the main path: each tile of TB_BLOCK_KV keys of each KV head
    walks the query heads of its group, and their tiles of TB_BLOCK_Q rows
    from the causal frontier on; S = Q K^T and dP = dO V^T as split-TF32
    products in slabs of 32 columns of D (split_tf32.split_bmm_ref); P =
    exp(sm_scale S - lse) and dS = P (dP - di) sm_scale, zero where a pair
    is masked; dQ += dS K with the keys in the kernel's fragment order
    (split_tf32.key_order, dS's columns and K's rows alike), added to an
    f32 dq tile by tile; dV^T += dO^T P and dK^T += Q^T dS as split products
    in slabs of 32 query rows, added in f32. (dq, dk, dv) in the dtypes of
    q, k, v."""
    from tpukern_torch.ops.split_tf32 import key_order, split_bmm_ref

    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    bkv, bq = TB_BLOCK_KV, TB_BLOCK_Q
    dev = q.device
    # (B, Hkv, group, ...) views: query head h = hk * group + j
    qg, dog = (t.float().reshape(B, Hkv, g, Sq, D) for t in (q, do))
    lseg = lse.float().reshape(B, Hkv, g, Sq)
    dig = (o.float() * do.float()).sum(-1).reshape(B, Hkv, g, Sq)
    dq = torch.zeros(B, Hkv, g, Sq, D, device=dev)
    dk = torch.zeros(B, Hkv, Skv, D, device=dev)
    dv = torch.zeros(B, Hkv, Skv, D, device=dev)
    order = key_order(bkv).to(dev)
    for kv0 in range(0, Skv, bkv):
        kt = _rows(k.float(), kv0, bkv)  # (B, Hkv, bkv, D)
        vt = _rows(v.float(), kv0, bkv)
        dkt = torch.zeros(B, Hkv, D, bkv, device=dev)
        dvt = torch.zeros(B, Hkv, D, bkv, device=dev)
        kvi = kv0 + torch.arange(bkv, device=dev)
        for j in range(g):
            for q0 in range(kv0 // bq * bq if causal else 0, Sq, bq):
                qt = _rows(qg[:, :, j], q0, bq)
                dot = _rows(dog[:, :, j], q0, bq)
                st = _rows(torch.stack((lseg[:, :, j], dig[:, :, j]), -1),
                           q0, bq)
                qi = q0 + torch.arange(bq, device=dev)
                ok = (kvi[None] < Skv) & (qi[:, None] < Sq)
                if causal:
                    ok &= kvi[None] <= qi[:, None]
                s = split_bmm_ref(qt, kt)
                dp = split_bmm_ref(dot, vt)
                p = torch.where(ok, torch.exp(s * sm_scale - st[..., :1]),
                                0.0)
                ds = torch.where(ok, p * (dp - st[..., 1:]) * sm_scale, 0.0)
                part = split_bmm_ref(ds[..., order], kt.mT[..., order])
                n = min(bq, Sq - q0)
                dq[:, :, j, q0:q0 + n] += part[..., :n, :]
                dvt += split_bmm_ref(dot.mT, p.mT)
                dkt += split_bmm_ref(qt.mT, ds.mT)
        n = min(bkv, Skv - kv0)
        dk[:, :, kv0:kv0 + n] = dkt.mT[..., :n, :]
        dv[:, :, kv0:kv0 + n] = dvt.mT[..., :n, :]
    return (dq.reshape(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _tile_ok(q0, nq, kv0, nk, Sq, Skv, causal, window, segment_ids, dev):
    """Bool (B or 1, 1, nq, nk): whether query q0 + i sees key kv0 + j,
    False past Sq or Skv."""
    qi = q0 + torch.arange(nq, device=dev)[:, None]
    kvi = kv0 + torch.arange(nk, device=dev)[None]
    ok = (qi < Sq) & (kvi < Skv)
    if causal:
        ok &= kvi <= qi
    if window is not None:
        ok &= kvi >= qi - window + 1
    ok = ok[None, None]
    if segment_ids is not None:
        qs, ks = (_rows(t.to(dev)[..., None], r0, n)[..., 0]
                  for t, r0, n in zip(segment_ids, (q0, kv0), (nq, nk)))
        ok = ok & (qs[:, None, :, None] == ks[:, None, None, :])
    return ok


def _tile_p_ds(s, dp, st, ok, sm_scale, softcap):
    """A tile's P and dS from its S and dP as the f32 featured kernels
    compute them: x = sm_scale S, t = tanh(x / cap) (as x times the f32 1
    / cap) and x = cap t with a softcap; P = exp(x - lse), dS = P (1 - t^2)
    (dP - di) sm_scale (t = 0 without a cap), with st[..., 0] lse and
    st[..., 1] di; both selected to 0 where not ok, after the
    arithmetic."""
    x = s * sm_scale
    if softcap is not None:
        t = torch.tanh(x * torch.tensor(1.0 / softcap, dtype=torch.float32))
        x = softcap * t
    p = torch.exp(x - st[..., :1])
    pc = p if softcap is None else p * (1 - t * t)
    ds = pc * (dp - st[..., 1:]) * sm_scale
    return torch.where(ok, p, 0.0), torch.where(ok, ds, 0.0)


def flash_attention_dq_tf32_ref(q, k, v, do, lse, di, *, causal=False,
                                sm_scale=None, window=None, softcap=None,
                                segment_ids=None):
    """flash_attention_dq's f32 kernel (#9) in its order of work, a test
    aid off the main path: each tile of FT_BLOCK_Q query rows of each
    query head walks the tiles of FT_BLOCK_KV keys of its KV head (h //
    group) that meet its band, from the one holding max(0, q0 - window +
    1) to the causal frontier; S = Q K^T and dP = dO V^T as split-TF32
    products in slabs of ft_slab(D) columns of D
    (split_tf32.split_bmm_ref); P and
    dS = P (1 - t^2) (dP - di) sm_scale as _tile_p_ds; dQ += dS K as one
    split product a tile (its 32 keys one slab, in their own order: the
    kernel sums dQ^T = K^T dS^T with A from K's planes, so no key
    permutation). The kernel's two warpgroups take the tiles in turns,
    each summing its own in f32, and dQ is the first's sum plus the
    second's. dq in q's dtype."""
    from tpukern_torch.ops.split_tf32 import split_bmm_ref

    B, Hq, Sq, D = q.shape
    Skv = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    bq, bkv, dev = FT_BLOCK_Q, FT_BLOCK_KV, q.device
    kr, vr = (t.float() for t in _repeat(q, k, v)[:2])
    qf, dof = q.float(), do.float()
    stats = torch.stack((lse.float(), di.float()), -1)
    dq = torch.zeros(B, Hq, Sq, D, device=dev)
    for q0 in range(0, Sq, bq):
        qt, dot = _rows(qf, q0, bq), _rows(dof, q0, bq)
        st = _rows(stats, q0, bq)
        lo = max(0, q0 - window + 1) // bkv * bkv if window else 0
        end = min(Skv, q0 + bq) if causal else Skv
        parts = torch.zeros(2, B, Hq, bq, D, device=dev)
        for i, kv0 in enumerate(range(lo, end, bkv)):
            kt, vt = _rows(kr, kv0, bkv), _rows(vr, kv0, bkv)
            ok = _tile_ok(q0, bq, kv0, bkv, Sq, Skv, causal, window,
                          segment_ids, dev)
            _, ds = _tile_p_ds(split_bmm_ref(qt, kt, ft_slab(D)),
                               split_bmm_ref(dot, vt, ft_slab(D)), st, ok,
                               sm_scale, softcap)
            parts[i % 2] += split_bmm_ref(ds, kt.mT)
        n = min(bq, Sq - q0)
        dq[:, :, q0:q0 + n] = (parts[0] + parts[1])[:, :, :n]
    return dq.to(q.dtype)


def flash_attention_dkv_tf32_ref(q, k, v, do, lse, di, *, causal=False,
                                 sm_scale=None, window=None, softcap=None,
                                 segment_ids=None):
    """flash_attention_dkv's f32 kernel (#10) in its order of work, a test
    aid off the main path: each tile of FT_BLOCK_KV keys of each KV head
    walks the steps of FT_BLOCK_Q query rows of every query head of its
    group, from the causal frontier to the last query whose window
    reaches the tile's last key, kv0 + FT_BLOCK_KV - 1 + window - 1; S and
    dP as split products in slabs of ft_slab(D) columns of D, P and dS as
    _tile_p_ds; dV^T += dO^T P and dK^T += Q^T dS as split products in
    slabs of 32 query rows, added in f32. The kernel's two warpgroups take
    the steps in turns, each summing its own, and dK and dV are the
    first's sums plus the second's. (dk, dv) in the dtypes of k and v,
    summed over each group."""
    from tpukern_torch.ops.split_tf32 import split_bmm_ref

    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    bkv, bq, dev = FT_BLOCK_KV, FT_BLOCK_Q, q.device
    # (B, Hkv, group, ...) views: query head h = hk * group + j
    qg, dog = (t.float().reshape(B, Hkv, g, Sq, D) for t in (q, do))
    stats = torch.stack((lse.float(), di.float()), -1).reshape(B, Hkv, g,
                                                               Sq, 2)
    dk = torch.zeros(B, Hkv, Skv, D, device=dev)
    dv = torch.zeros(B, Hkv, Skv, D, device=dev)
    for kv0 in range(0, Skv, bkv):
        kt, vt = _rows(k.float(), kv0, bkv), _rows(v.float(), kv0, bkv)
        dkt = torch.zeros(2, B, Hkv, D, bkv, device=dev)
        dvt = torch.zeros(2, B, Hkv, D, bkv, device=dev)
        first = kv0 // bq * bq if causal else 0
        end = min(Sq, kv0 + bkv - 1 + window) if window else Sq
        steps = [(j, q0) for j in range(g) for q0 in range(first, end, bq)]
        for i, (j, q0) in enumerate(steps):
            qt, dot = _rows(qg[:, :, j], q0, bq), _rows(dog[:, :, j], q0, bq)
            ok = _tile_ok(q0, bq, kv0, bkv, Sq, Skv, causal, window,
                          segment_ids, dev)
            p, ds = _tile_p_ds(split_bmm_ref(qt, kt, ft_slab(D)),
                               split_bmm_ref(dot, vt, ft_slab(D)),
                               _rows(stats[:, :, j], q0, bq), ok, sm_scale,
                               softcap)
            dvt[i % 2] += split_bmm_ref(dot.mT, p.mT)
            dkt[i % 2] += split_bmm_ref(qt.mT, ds.mT)
        n = min(bkv, Skv - kv0)
        dk[:, :, kv0:kv0 + n] = (dkt[0] + dkt[1]).mT[..., :n, :]
        dv[:, :, kv0:kv0 + n] = (dvt[0] + dvt[1]).mT[..., :n, :]
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_bf16_ref(q, k, v, o, lse, do, *, causal=False,
                                 sm_scale=None):
    """flash_attention_bwd's fused bf16 tier in its order of work, a test
    aid off the main path: each tile of BB_BLOCK_KV keys of each KV head
    takes every query row of its group's heads (the kernel's steps of
    BB_BLOCK_Q rows from the causal frontier on; rows before the frontier
    see none of the tile's keys); S = Q K^T and dP = dO V^T from the bf16
    values in f32; P = exp(sm_scale S - lse) and dS = P (dP - di)
    sm_scale, zero where a pair is masked; dV += P^T dO with P rounded to
    bf16, dK += dS^T Q and dQ += dS K with dS rounded to bf16 (as the TPU
    kernel rounds them, attention_bwd.py:426, :440, :445), dQ added to an
    f32 dq tile by tile of keys, dK and dV summed over the group in f32.
    (dq, dk, dv) in the dtypes of q, k, v."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    bkv, dev, bf = BB_BLOCK_KV, q.device, torch.bfloat16
    # (B, Hkv, group * Sq, D): the group's query rows, head by head
    qg, dog = (t.float().reshape(B, Hkv, g * Sq, D) for t in (q, do))
    lseg = lse.float().reshape(B, Hkv, g * Sq, 1)
    dig = (o.float() * do.float()).sum(-1).reshape(B, Hkv, g * Sq, 1)
    qi = torch.arange(Sq, device=dev).repeat(g)[:, None]  # each row's query
    dq = torch.zeros(B, Hkv, g * Sq, D, device=dev)
    dk = torch.zeros(B, Hkv, Skv, D, device=dev)
    dv = torch.zeros(B, Hkv, Skv, D, device=dev)

    def r16(x):  # rounded to bf16, computed on in f32
        return x.to(bf).float()

    for kv0 in range(0, Skv, bkv):
        kt = k[:, :, kv0:kv0 + bkv].float()  # (B, Hkv, n, D)
        vt = v[:, :, kv0:kv0 + bkv].float()
        kvi = kv0 + torch.arange(kt.shape[2], device=dev)
        ok = kvi[None] <= qi if causal else None
        s = qg @ kt.mT
        p = torch.exp(s * sm_scale - lseg)
        ds = p * (dog @ vt.mT - dig) * sm_scale
        if ok is not None:
            p, ds = torch.where(ok, p, 0.0), torch.where(ok, ds, 0.0)
        dq += r16(ds) @ kt
        dv[:, :, kv0:kv0 + bkv] = r16(p).mT @ dog
        dk[:, :, kv0:kv0 + bkv] = r16(ds).mT @ qg
    return (dq.reshape(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
