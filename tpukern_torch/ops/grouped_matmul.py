"""Grouped (ragged) GEMM: per-expert products over tokens sorted by group.

The port of tpukern/ops/grouped_matmul.py. The rows of x are sorted by
group (expert); group e owns the group_sizes[e] rows after the groups
before it, and sum(group_sizes) <= T. Kernels: csrc/grouped_matmul.cu,
#28 (`gmm`, with `trans_w` as a template flag) and #29 (`tgmm`), f32 on
CUDA-core FMAs; bf16 on TMA and `wgmma` through a multi-stage ring
(csrc/hopper.cuh gemm_pipeline): #28 a block per (work item, N tile),
the items as gmm_items mirrors, #29 a block per (K, N) tile of a group,
its slabs as tgmm_slabs mirrors; f32 accumulation; each block reads the
group sizes on the card, so no wrapper syncs with the host.

- gmm: y[rows_e] = x[rows_e] · w[e] (or · w[e]ᵀ). Rows past
  sum(group_sizes) belong to no group: the kernel and gmm_ref write zeros
  there, where JAX leaves them unspecified.
- tgmm: out[e] = x[rows_e]ᵀ · dy[rows_e]; an empty group's slab is zero.
- grouped_matmul: the differentiable product, with JAX's VJP: dx is
  gmm(dy, w, trans_w=True) and dw is tgmm(x, dy).

The Mosaic knobs (block_m, block_n, block_k, and grouped_matmul's
`config` dict of them) keep JAX's signature and are ignored: the port
keeps the names, not the knobs. A CPU tensor takes the plain version
(gmm_ref, tgmm_ref); a CUDA tensor launches the kernel or raises.
"""

import torch

from tpukern_torch import _build
from tpukern_torch.core.registry import register
from tpukern_torch.ops.matmul import load_path, tma_operands


def _offsets(group_sizes):
    """[0, s_0, s_0 + s_1, ...] on the host (the plain versions only)."""
    offs = [0]
    for s in group_sizes.tolist():
        offs.append(offs[-1] + max(int(s), 0))
    return offs


def _check(x, w, group_sizes, trans_w):
    if x.dim() != 2 or w.dim() != 3 or group_sizes.dim() != 1:
        raise ValueError(f"gmm: x (T, K), w (E, K, N) and group_sizes (E,),"
                         f" got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(group_sizes.shape)}")
    E = w.shape[0]
    K = w.shape[2] if trans_w else w.shape[1]
    if x.shape[1] != K or group_sizes.shape[0] != E:
        raise ValueError(f"gmm: x {tuple(x.shape)}, w {tuple(w.shape)} "
                         f"(trans_w={trans_w}) and group_sizes "
                         f"{tuple(group_sizes.shape)} do not match")
    if group_sizes.is_floating_point():
        raise TypeError(f"group_sizes must be integers, got "
                        f"{group_sizes.dtype}")
    return E, w.shape[1] if trans_w else w.shape[2]


def _cuda_args(a, b, group_sizes, out_dtype):
    """a and b in their common dtype, aligned; group_sizes as int32 on
    their device (no host sync); the output dtype checked."""
    _build.check_cuda(a, b, group_sizes)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grouped GEMM writes float32 or bfloat16, not "
                        f"{out_dtype}")
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = _build.aligned(a.to(dt)), _build.aligned(b.to(dt))
    return a, b, group_sizes.to(torch.int32).contiguous()


def _outputs(shape, out_dtype, device):
    out = torch.empty(shape, dtype=out_dtype, device=device)
    return out, (out.data_ptr() if out_dtype == torch.float32 else None,
                 out.data_ptr() if out_dtype == torch.bfloat16 else None)


def gmm(x, w, group_sizes, *, block_m=None, block_n=None, block_k=None,
        trans_w=False, out_dtype=None):
    """y[rows_e] = x[rows_e] @ w[e] (trans_w: @ w[e]ᵀ).

    x: (T, K) rows sorted by group; w: (E, K, N), or (E, N, K) with
    trans_w; group_sizes: (E,) integers, sum <= T. Returns (T, N) in
    out_dtype (x.dtype by default), zeros past sum(group_sizes).
    block_m/n/k are accepted and ignored (Mosaic knobs)."""
    E, N = _check(x, w, group_sizes, trans_w)
    out_dtype = out_dtype or x.dtype
    T, K = x.shape
    if x.device.type == "cpu":
        return gmm_ref(x, w, group_sizes, trans_w=trans_w).to(out_dtype)
    x, w, gs = _cuda_args(x, w, group_sizes, out_dtype)
    y, (y32, y16) = _outputs((T, N), out_dtype, x.device)
    _build.launch("tk_gmm", x.data_ptr(), w.data_ptr(), gs.data_ptr(), y32,
                  y16, T, N, K, E, int(trans_w), _build.dtype_code(x),
                  _build.stream(x))
    gmm.launches += 1
    if trans_w:
        gmm.trans_w_launches += 1
    return y


gmm.launches = 0          # every launch of #28
gmm.trans_w_launches = 0  # of which the trans_w instance (the VJP's dx)


def tgmm(x, dy, group_sizes, *, block_m=None, block_k=None, block_n=None,
         out_dtype=None):
    """out[e] = x[rows_e]ᵀ @ dy[rows_e]: the weight gradient.

    x: (T, K), dy: (T, N), rows sorted by group. Returns (E, K, N) in
    out_dtype (x.dtype by default); an empty group's slab is zero.
    block_m/k/n are accepted and ignored (Mosaic knobs)."""
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"tgmm: x (T, K) and dy (T, N), got "
                         f"{tuple(x.shape)}, {tuple(dy.shape)}")
    if group_sizes.dim() != 1 or group_sizes.is_floating_point():
        raise ValueError(f"tgmm: group_sizes (E,) integers, got "
                         f"{tuple(group_sizes.shape)} {group_sizes.dtype}")
    out_dtype = out_dtype or x.dtype
    (T, K), N, E = x.shape, dy.shape[1], group_sizes.shape[0]
    if x.device.type == "cpu":
        return tgmm_ref(x, dy, group_sizes).to(out_dtype)
    x, dy, gs = _cuda_args(x, dy, group_sizes, out_dtype)
    out, (o32, o16) = _outputs((E, K, N), out_dtype, x.device)
    _build.launch("tk_tgmm", x.data_ptr(), dy.data_ptr(), gs.data_ptr(), o32,
                  o16, T, K, N, E, _build.dtype_code(x), _build.stream(x))
    tgmm.launches += 1
    return out


tgmm.launches = 0


def tgmm_slabs(x, dy, group_sizes):
    """The slab plan of the bf16 tgmm kernel (csrc/grouped_matmul.cu), by
    its launcher's rule, from the shapes and data_ptr()s of x (T, K) and
    dy (T, N) as the kernel gets them (contiguous, aligned) and the group
    sizes (host integers): for each group, its slabs as (first row,
    rows, path). A slab takes 64 rows from the group's first row on (TMA
    takes any row); the last one keeps the rows left, and the kernel
    zeros its other rows (the next group's) before the products. Every
    slab loads x and dy as tma_operands says: "tma", "mixed" or "copy"
    (an operand whose rows TMA cannot take is copied in every slab). An
    empty group has no slab."""
    T = x.shape[0]
    path = load_path(tma_operands(x, dy))
    plan, off = [], 0
    for size in [int(s) for s in group_sizes]:
        s = min(off, T)
        off += max(size, 0)
        t = min(off, T)
        plan.append([(t0, min(64, t - t0), path) for t0 in range(s, t, 64)])
    return plan


def gmm_items(x, w, group_sizes, trans_w=False):
    """The work items of the bf16 gmm kernel (csrc/grouped_matmul.cu
    gmm_item), by its launcher's rule, from the shapes and data_ptr()s of
    x (T, K) and w (E, K, N), or (E, N, K) with trans_w, as the kernel
    gets them (contiguous, aligned), and the group sizes (host integers).
    Every N tile runs the same items, listed once here as (group, first
    row, rows, path): the rows [0, T) fall into the groups' rows (sizes
    clamped at 0, ends at T) and then the rows past the groups (group
    None); an item is such a segment's rows inside one 128-row tile, in
    segment order. Each item loads x and W[group] as tma_operands says:
    "tma", "mixed" or "copy"; the item of the rows past the groups loads
    nothing and writes zeros (path None). At most ceil(T / 128) + E
    items, the grid's bound."""
    if x.shape[1] != w.shape[2 if trans_w else 1]:
        raise ValueError(f"gmm_items: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} (trans_w={trans_w}) do not "
                         "contract")
    T = x.shape[0]
    path = load_path(tma_operands(x, w[0]))
    segments, off = [], 0
    for e, size in enumerate(int(s) for s in group_sizes):
        s = min(off, T)
        off += max(size, 0)
        segments.append((e, s, min(off, T)))
    segments.append((None, min(off, T), T))
    items = []
    for e, s, t in segments:
        starts = range(s // 128 * 128, t, 128) if s < t else ()
        items += [(e, max(s, m0), min(t, m0 + 128) - max(s, m0),
                   None if e is None else path) for m0 in starts]
    return items


def gmm_ref(x, w, group_sizes, *, trans_w=False):
    """f32 torch.matmul over each group's row range of the f32-cast
    inputs; zeros past sum(group_sizes). Differentiable."""
    T = x.shape[0]
    N = w.shape[1] if trans_w else w.shape[2]
    offs = _offsets(group_sizes)
    parts = []
    for e in range(w.shape[0]):
        s, t = min(offs[e], T), min(offs[e + 1], T)
        if t > s:
            we = w[e].float()
            parts.append(x[s:t].float() @ (we.T if trans_w else we))
    tail = T - min(offs[-1], T)
    parts.append(x.new_zeros((tail, N), dtype=torch.float32))
    return torch.cat(parts)


def tgmm_ref(x, dy, group_sizes):
    """f32 x[rows_e]ᵀ @ dy[rows_e] for each group; zeros for an empty
    group."""
    T, K = x.shape
    offs = _offsets(group_sizes)
    out = x.new_zeros((group_sizes.shape[0], K, dy.shape[1]),
                      dtype=torch.float32)
    for e in range(out.shape[0]):
        s, t = min(offs[e], T), min(offs[e + 1], T)
        if t > s:
            out[e] = x[s:t].float().T @ dy[s:t].float()
    return out


class _GroupedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        return gmm(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        # tpukern/ops/grouped_matmul.py _gm_bwd (:290-302); tgmm already
        # zeros the empty groups' slabs that JAX's `where` zeros. An input
        # that needs no gradient gets no launch.
        x, w, group_sizes = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gmm(dy, w, group_sizes, trans_w=True, out_dtype=x.dtype)
        if ctx.needs_input_grad[1]:
            dw = tgmm(x, dy, group_sizes, out_dtype=w.dtype)
        return dx, dw, None


def grouped_matmul(x, w, group_sizes, config=None):
    """Differentiable grouped GEMM y[rows_e] = x[rows_e] @ w[e]: gmm
    forward, gmm(trans_w=True) (dx) and tgmm (dw) backward, each launched
    only for an input that needs its gradient. A stand-in for
    lax.ragged_dot((T, K), (E, K, N), (E,)). `config` (JAX's dict of
    block sizes) is accepted and ignored."""
    return _GroupedMatmul.apply(x, w, group_sizes)


# ---------------------------------------------------------------- registry

def _gmm_flops(x, w, group_sizes):
    # the routed rows, not the padded grid (reads the sizes on the host)
    return 2 * int(group_sizes.sum()) * x.shape[1] * w.shape[-1]


def _cast(fn, dt):
    def wrapped(x, w, group_sizes):
        return fn(x.to(dt), w.to(dt), group_sizes).to(dt)
    return wrapped


register("grouped_matmul", "gmm_bf16", ref=_cast(gmm_ref, torch.bfloat16),
         flops=_gmm_flops)(_cast(gmm, torch.bfloat16))
register("grouped_matmul", "gmm_f32", ref=_cast(gmm_ref, torch.float32),
         flops=_gmm_flops)(_cast(gmm, torch.float32))
register("grouped_matmul", "gmm_ragged_dot_xla",
         ref=_cast(gmm_ref, torch.float32), flops=_gmm_flops,
         tags=("baseline",))(_cast(gmm_ref, torch.float32))
register("grouped_matmul", "tgmm_f32", ref=_cast(tgmm_ref, torch.float32),
         flops=lambda x, dy, gs: 2 * int(gs.sum()) * x.shape[1] * dy.shape[1])(
    _cast(tgmm, torch.float32))
