"""Fused linear + softmax cross-entropy: the LM-head loss without logits.

The port of tpukern/ops/cross_entropy.py. Kernels: csrc/cross_entropy.cu,
which replaces `_ce_fwd_kernel` (cross_entropy.py:53) with a split-vocab
forward (bf16: one TMA + wgmma GEMM launch, a partial for each 256-column
vocab tile; f32: one split-TF32 GEMM launch a vocab chunk of
bwd_vocab_chunk_f32, a partial for each 128-column tile of a chunk) and a
combine pass, and `_ce_dx_kernel` (:95) and `_ce_dw_kernel`
(:132) with three GEMM launches a vocab chunk: dlog into a scratch,
then dx and dW from it, no atomics; bf16 on the TMA + wgmma pipeline
(chunks of bwd_vocab_chunk), f32 on its split-TF32 form (chunks of
bwd_vocab_chunk_f32; ops/split_tf32.py). The logits never reach device
memory, forward or backward.

Layouts as in JAX: x (N, D) activations, w (D, V) head, logits = x @ w.
Tokens with target < 0 get loss 0 and gradient 0. The v5e block ladder
(`_ce_blocks`, block_n/block_v) and the (n_blocks, 1, bn) target layout
are not ported: the Hopper tiles are fixed inside the kernels.
`chunked_cross_entropy` is plain torch, as it is XLA in JAX.
"""

import torch

from tpukern_torch import _build
from tpukern_torch.core import cdiv
from tpukern_torch.core.registry import register
from tpukern_torch.ops import split_tf32

NEG_BIG = -0.7 * 3.4e38
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
TILE = 128  # vocab columns of an f32 forward partial (csrc TF_BN)
TILE_BF16 = 256  # vocab columns of a bf16 forward partial (csrc GP_BN)


def cross_entropy_ref(x, w, targets):
    """Per-token -log softmax(x @ w)[target] in f32; 0 where target < 0."""
    return _ce_ref(x, w, targets)[0]


def _ce_ref(x, w, targets):
    """(loss, natural-log lse), both f32 (N,), from the f32 logits."""
    logits = x.float() @ w.float()
    lse = torch.logsumexp(logits, dim=-1)
    t = logits.gather(-1, targets.long().clamp(min=0)[:, None])[:, 0]
    return torch.where(targets < 0, 0.0, lse - t), lse


def ce_bwd_ref(x, w, targets, lse, g):
    """(dx, dW) in f32 of sum(g * loss), from the saved lse: dlog =
    g·(softmax - onehot), zero on rows with target < 0, rounded to x's
    dtype before the products as JAX's kernels round it
    (cross_entropy.py:127, :157); a no-op for f32."""
    xf, wf = x.float(), w.float()
    dlog = torch.exp(xf @ wf - lse[:, None])
    rows = torch.arange(x.shape[0], device=x.device)
    dlog[rows, targets.long().clamp(min=0)] -= 1.0
    dlog *= torch.where(targets < 0, 0.0, g.float())[:, None]
    dlog = dlog.to(x.dtype).float()
    return dlog @ wf.T, xf.T @ dlog


def ce_bwd_chunked_ref(x, w, targets, lse, g, chunk):
    """ce_bwd_ref in the backward kernels' order (bf16 and f32), a test
    aid off the main path: for each vocab chunk of `chunk` columns in
    turn, dlog of its columns rounded to x's dtype (a no-op for f32), dx
    = dlog · W_c^T (the first chunk) or dx + dlog · W_c^T (the later
    ones, f32), and dW[:, chunk] = x^T · dlog."""
    xf, wf = x.float(), w.float()
    N, V = x.shape[0], w.shape[1]
    tgt = targets.long()[:, None]
    gk = torch.where(targets < 0, 0.0, g.float())[:, None]
    dx, dw = None, torch.empty(wf.shape, device=x.device)
    for v0 in range(0, V, chunk):
        wc = wf[:, v0:v0 + chunk]
        cols = torch.arange(v0, v0 + wc.shape[1], device=x.device)
        dlog = torch.exp(xf @ wc - lse[:, None]) - (cols == tgt).float()
        dlog = (dlog * gk).to(x.dtype).float()
        part = dlog @ wc.T
        dx = part if dx is None else dx + part
        dw[:, v0:v0 + chunk] = xf.T @ dlog
    return dx, dw


def bwd_vocab_chunk(N, D, V):
    """Vocab columns a chunk of the bf16 backward, from the shapes alone:
    all of V where its dlog scratch (N rows of V rounded up to 8 values)
    fits in D · V values (half the bytes of the f32 dW), else the widest
    multiple of 256 (a tile's width; of 8 below 256) that fits, at least
    8 (or V)."""
    budget = D * V // max(N, 1)
    if N == 0 or cdiv(V, 8) * 8 <= budget:
        return V
    step = 256 if budget >= 256 else 8
    return min(V, max(8, budget // step * step))


def bwd_vocab_chunk_f32(N, D, V):
    """Vocab columns a chunk of the f32 backward, from the shapes alone:
    its scratch holds the split-TF32 planes of dlog and of W's chunk, each
    in two layouts (split_tf32.ce_scratch), about 4 (N + D) values a
    column. All of V where that fits in 2 · D · V values (twice the f32 dW
    the call returns), else the widest multiple of 256 (a tile's width;
    of 8 below 256) that fits, at least 8 (or V): 8192 columns at N = D =
    2048, V = 32768."""
    budget = D * V // max(2 * (N + D), 1)
    if N == 0 or V <= budget:
        return V
    step = 256 if budget >= 256 else 8
    return min(V, max(8, budget // step * step))


def fwd_splits(N, D, V, dtype):
    """(partials, vocab chunk) of the forward for inputs of dtype: bf16
    writes one partial for each TILE_BF16-column vocab tile in one launch
    (the chunk is V); f32 launches once a chunk of bwd_vocab_chunk_f32
    columns and writes one partial for each TILE-column tile of a chunk
    (the last tile of a chunk may be narrower)."""
    if dtype == torch.bfloat16:
        return cdiv(V, TILE_BF16), V
    chunk = bwd_vocab_chunk_f32(N, D, V)
    return (V // chunk) * cdiv(chunk, TILE) + cdiv(V % chunk, TILE), chunk


def ce_fwd_tiled_ref(x, w, targets, tile=TILE_BF16, use_exp2=False,
                     chunk=None):
    """(loss, lse) of _ce_ref in the forward kernels' order, a test aid
    off the main path: for each vocab chunk of `chunk` columns (default
    all of V) in turn, the f32 scores of each `tile`-column tile of the
    chunk folded into a partial (its max in natural units, the sum of exp
    over it, in log2 units with use_exp2, and the target logit if the
    target lies in it), then the partials merged as ce_combine_kernel
    merges them (the max of the maxima, the sum of l * exp(m - max) and
    its log in f64, rounded once, the sum of t). The bf16 forward's order
    at the defaults; the f32 forward's at tile=TILE and chunk from
    fwd_splits."""
    xf, wf = x.float(), w.float()
    V = w.shape[1]
    tgt = targets.long()[:, None]
    parts = []
    starts = [(c0 + v0, min(c0 + v0 + tile, c0 + (chunk or V), V))
              for c0 in range(0, V, chunk or V)
              for v0 in range(0, min(chunk or V, V - c0), tile)]
    for v0, v1 in starts:
        s = xf @ wf[:, v0:v1]
        cols = torch.arange(v0, v1, device=x.device)
        t = torch.where(cols == tgt, s, 0.0).sum(-1)
        if use_exp2:
            u = s * LOG2E
            m = u.amax(-1)
            parts.append((m * LN2, torch.exp2(u - m[:, None]).sum(-1), t))
        else:
            m = s.amax(-1)
            parts.append((m, torch.exp(s - m[:, None]).sum(-1), t))
    m_all = torch.stack([p[0] for p in parts]).amax(0)
    z = m_all.double() + torch.log(sum(
        p[1].double() * torch.exp((p[0] - m_all).double()) for p in parts))
    t = sum(p[2] for p in parts)
    return (torch.where(targets < 0, 0.0, z - t).float(), z.float())


def ce_fwd(x, w, targets, use_exp2=False):
    """(loss, lse) f32 (N,) of logits = x @ w for int32 targets < V. A CPU
    tensor takes the plain version; a CUDA tensor launches the split
    forward (fwd_splits' partials: one launch in bf16, one a vocab chunk
    in f32, after the split-TF32 operand pass on x once a call and on W's
    chunk once a chunk, counted in split_tf32.split_tf32.launches) and
    the combine pass, each launch counted."""
    if x.device.type == "cpu":
        return _ce_ref(x, w, targets)
    _build.check_cuda(x, w, targets)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ce_fwd takes f32 or bf16 inputs, got {x.dtype}")
    N, D = x.shape
    V = w.shape[1]
    x, w = _build.aligned(x), _build.aligned(w)
    n_split, chunk = fwd_splits(N, D, V, x.dtype)
    part = torch.empty(n_split, 3, N, device=x.device)
    loss = torch.empty(N, device=x.device)
    lse = torch.empty(N, device=x.device)
    s = _build.stream(x)
    if x.dtype == torch.bfloat16:
        _build.launch("tk_ce_fwd", x.data_ptr(), w.data_ptr(),
                      targets.data_ptr(), part.data_ptr(), N, D, V,
                      int(use_exp2), s)
        ce_fwd.launches += 1
    elif N:
        xs, ws = (torch.empty(n, device=x.device)
                  for n in split_tf32.ce_fwd_scratch(N, D, chunk))
        for i, v0 in enumerate(range(0, V, chunk)):
            split_tf32.launch_counting_passes(
                "tk_ce_fwd_f32", x.data_ptr(), w.data_ptr(),
                targets.data_ptr(), part.data_ptr(), xs.data_ptr(),
                ws.data_ptr(), N, D, V, v0, min(chunk, V - v0),
                i * cdiv(chunk, TILE), int(v0 == 0), int(use_exp2), s)
            ce_fwd.launches += 1
    _build.launch("tk_ce_combine", part.data_ptr(), targets.data_ptr(),
                  loss.data_ptr(), lse.data_ptr(), N, n_split, s)
    ce_fwd.launches += 1
    return loss, lse


ce_fwd.launches = 0


def ce_bwd(x, w, targets, lse, g, use_exp2=False, vocab_chunk=None):
    """(dx, dW) in f32 of sum(g * loss), recomputed from the forward's
    lse. A CPU tensor takes ce_bwd_ref; a CUDA tensor launches three
    kernels a vocab chunk of vocab_chunk columns (a multiple of 8;
    default bwd_vocab_chunk for bf16 inputs, bwd_vocab_chunk_f32 for
    f32), each launch counted; f32 inputs also launch the split-TF32
    operand pass on x once a call and on W's chunk once a chunk, counted
    in split_tf32.split_tf32.launches."""
    if x.device.type == "cpu":
        return ce_bwd_ref(x, w, targets, lse, g)
    _build.check_cuda(x, w, targets, lse, g)
    N, D = x.shape
    V = w.shape[1]
    x, w = _build.aligned(x), _build.aligned(w)
    lse, g = lse.float().contiguous(), g.float().contiguous()
    s = _build.stream(x)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ce_bwd takes f32 or bf16 inputs, got {x.dtype}")
    if N == 0:
        return (torch.zeros(N, D, device=x.device),
                torch.zeros(D, V, device=x.device))
    f32 = x.dtype == torch.float32
    rule = bwd_vocab_chunk_f32 if f32 else bwd_vocab_chunk
    chunk = min(vocab_chunk or rule(N, D, V), V)
    if chunk < V and chunk % 8:
        raise ValueError(f"vocab_chunk {chunk} is not a multiple of 8")
    dx = torch.empty(N, D, device=x.device)
    dw = torch.empty(D, V, device=x.device)
    if f32:
        xs, ws, ds = (torch.empty(n, device=x.device)
                      for n in split_tf32.ce_scratch(N, D, chunk))
        for v0 in range(0, V, chunk):
            split_tf32.launch_counting_passes(
                "tk_ce_bwd", x.data_ptr(), w.data_ptr(), targets.data_ptr(),
                lse.data_ptr(), g.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                xs.data_ptr(), ws.data_ptr(), ds.data_ptr(), N, D, V, v0,
                min(chunk, V - v0), int(v0 > 0), int(v0 == 0),
                int(use_exp2), s)
            ce_bwd.launches += 3
        return dx, dw
    dlog = torch.empty(N * cdiv(chunk, 8) * 8, dtype=x.dtype,
                       device=x.device)
    for v0 in range(0, V, chunk):
        _build.launch("tk_ce_bwd_chunk", x.data_ptr(), w.data_ptr(),
                      targets.data_ptr(), lse.data_ptr(), g.data_ptr(),
                      dx.data_ptr(), dw.data_ptr(), dlog.data_ptr(), N, D, V,
                      v0, min(chunk, V - v0), int(v0 > 0), int(use_exp2), s)
        ce_bwd.launches += 3
    return dx, dw


ce_bwd.launches = 0


class _FusedCE(torch.autograd.Function):
    """The custom VJP of JAX's _fused_ce_core (cross_entropy.py:233-360):
    the forward saves (x, w, targets, lse), the backward recomputes."""

    @staticmethod
    def forward(ctx, x, w, targets, use_exp2):
        loss, lse = ce_fwd(x, w, targets, use_exp2)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.use_exp2 = use_exp2
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        dx, dw = ce_bwd(x, w, targets, lse, g, ctx.use_exp2)
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def _targets(targets, N, V):
    """int32 targets, checked once: shape (N,) and every value < V."""
    if targets.shape != (N,):
        raise ValueError(f"targets must have shape ({N},), got "
                         f"{tuple(targets.shape)}")
    if N and int(targets.max()) >= V:
        raise ValueError(f"a target is >= the vocab size {V}")
    return targets.to(torch.int32).contiguous()


def fused_cross_entropy(x, w, targets, *, use_exp2=None, return_lse=False):
    """Per-token CE loss of logits = x @ w without materializing logits.

    x: (N, D) f32 or bf16; w: (D, V) (inputs of two dtypes are promoted to
    one); targets: (N,) int, negative = ignored (zero loss and gradient).
    Returns f32 (N,) losses, differentiable w.r.t. x and w; with
    return_lse, (losses, natural-log lse), not differentiable. use_exp2
    picks the log2 tier (default: x other than f32), as in JAX."""
    N, D = x.shape
    if w.shape[0] != D:
        raise ValueError(f"x (N, {D}) vs w {tuple(w.shape)}")
    V = w.shape[1]
    tgt = _targets(targets, N, V)
    if use_exp2 is None:
        use_exp2 = x.dtype != torch.float32
    dt = torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(dt), w.to(dt)
    if return_lse:
        with torch.no_grad():
            return ce_fwd(x, w, tgt, bool(use_exp2))
    return _FusedCE.apply(x, w, tgt, bool(use_exp2))


def chunked_cross_entropy(x, w, targets, *, chunk=2048):
    """Streaming baseline (JAX's lax.scan version): one (N, chunk) logits
    slab at a time with an online (max, sum) and the target logit, in f32.
    Differentiable by autograd, which keeps every slab for the backward."""
    N = x.shape[0]
    V = w.shape[1]
    xf, wf = x.float(), w.float()
    tgt = targets.long()[:, None]
    m = torch.full((N, 1), NEG_BIG, device=x.device)
    l = torch.zeros(N, 1, device=x.device)
    t = torch.zeros(N, 1, device=x.device)
    for off in range(0, V, chunk):
        s = xf @ wf[:, off:off + chunk]
        cols = torch.arange(off, off + s.shape[1], device=x.device)
        t = t + torch.where(cols == tgt, s, 0.0).sum(-1, keepdim=True)
        m_new = torch.maximum(m, s.max(-1, keepdim=True).values)
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(
            -1, keepdim=True)
        m = m_new
    loss = (m + torch.log(l) - t)[:, 0]
    return torch.where(targets < 0, 0.0, loss)


# ---------------------------------------------------------------- registry

def _ce_flops(x, w, targets):
    return 2 * x.shape[0] * x.shape[1] * w.shape[1]


def _fused(dt):
    def run(x, w, targets):
        return fused_cross_entropy(x.to(dt), w.to(dt), targets)
    return run


def _ce_plain(dt):
    def run(x, w, targets):
        return cross_entropy_ref(x.to(dt), w.to(dt), targets)
    return run


register("cross_entropy", "fused_bf16", ref=_ce_plain(torch.bfloat16),
         flops=_ce_flops)(_fused(torch.bfloat16))
register("cross_entropy", "fused_f32", ref=_ce_plain(torch.float32),
         flops=_ce_flops)(_fused(torch.float32))
register("cross_entropy", "chunked_xla", ref=cross_entropy_ref,
         flops=_ce_flops, tags=("baseline",))(chunked_cross_entropy)
register("cross_entropy", "dense_xla", ref=cross_entropy_ref,
         flops=_ce_flops, tags=("baseline",))(cross_entropy_ref)
