"""Token sampling: a streaming greedy / gumbel-max pass and the per-row
top-k / top-p / min-p logit thresholds.

The port of tpukern/ops/sampling.py. Kernels: csrc/sampling.cu
`sample_kernel` (#26, replaces `_sample_kernel`, sampling.py:45) and
`threshold_cluster_kernel` (#27, replaces `_threshold_kernel`, :182: a
cluster of up to 16 blocks a row by threshold_plan's rule). Semantics
are JAX's:

- sampling is argmax(logits * (1/T) + g), g ~ Gumbel(0, 1), over the
  columns whose RAW logit (before the temperature) is >= the row's
  threshold; the others are masked to NEG_BIG after the noise;
- top-k, top-p and min-p thresholds merge by max; temperature 0 is
  greedy; ties go to the first index;
- top-k: the k-th largest logit; top-p: the smallest kept logit of the
  nucleus (keep a token iff the probability mass strictly above it is
  < p); min-p: max(x) + T * log(min_p), the log in double;
- above _BISECT_MAX_V columns the thresholds leave #27 for torch.topk /
  torch.sort, as JAX's leave its kernel for lax.top_k / sort.

The noise: `noise=` (B, V) f32 is added as given (JAX's interpret-mode
"input" noise); without it, Philox4x32-10 keyed by the seed at counter
(column, row, 0, 0), made in the kernel on the card and by _philox_bits
in plain PyTorch on the CPU, so both give the same draw for a seed. JAX
draws from the TPU's own PRNG (or jax.random.gumbel), so a draw matches
JAX's only through `noise=`.

A wrapper takes its plain twin for a CPU tensor and launches its kernel
for a CUDA tensor; `launches` counts the launches (and #27's
`count_launches` / `mass_launches` split them by mode).
"""

import math

import numpy as np
import torch

from tpukern_torch import _build
from tpukern_torch.core.registry import register
from tpukern_torch.core.tiling import cdiv

NEG_BIG = -0.7 * 3.4e38
_I32_MIN, _I32_MAX = -2**31, 2**31 - 1
# #27 keeps at most 2^20 values a row (csrc/sampling.cu; JAX's one-pass
# kernel holds 8 such rows in VMEM); longer rows take torch.topk / sort
_BISECT_MAX_V = 1 << 20
SAMPLE_CHUNK = 2048  # csrc/sampling.cu SA_CHUNK: columns per block of #26
# #27's cluster rule (csrc/sampling.cu threshold_plan): 16 blocks a row,
# halved while a block would hold fewer than TH_BLOCK_MIN values or B
# clusters would need more than TH_SMS blocks; a block's share staged in
# shared memory (4 bytes a value and 4 for its place in the list, and in
# mass mode as many again for the weights) up to TH_STAGE_MAX bytes,
# re-read every pass above; th_head_bytes of histograms ahead of it (two
# merged ones of 256 bins, and one a warp of its 16)
TH_CLUSTER_MAX, TH_BLOCK_MIN, TH_SMS, TH_WARPS = 16, 2048, 132, 16
TH_STAGE_MAX = 160 * 1024


def th_head_bytes(mode):
    return 2 * 256 * 12 + TH_WARPS * 256 * (12 if mode == "mass" else 4)


def threshold_plan(B, V, mode):
    """#27's launch shape for B rows of V values in `mode` ("count" or
    "mass"): (blocks a row, values a block, staged in shared memory,
    shared bytes a block), as csrc/sampling.cu threshold_plan gives it."""
    C = TH_CLUSTER_MAX
    while C > 1 and (C * TH_BLOCK_MIN > V or B * C > TH_SMS):
        C //= 2
    n = (cdiv(V, C) + 3) // 4 * 4
    stage = n * (16 if mode == "mass" else 8)
    staged = stage <= TH_STAGE_MAX
    return C, n, staged, th_head_bytes(mode) + (stage if staged else 0)


def threshold_plan_launcher(B, V, mode):
    """threshold_plan as the C launcher computes it (the built library;
    needs the card's toolkit): the mirror's check."""
    out = torch.zeros(4, dtype=torch.int32)
    _build.launch("tk_sample_threshold_plan", B, V, int(mode == "mass"),
                  out.data_ptr())
    C, n, staged, smem = out.tolist()
    return C, n, bool(staged), smem


def _keys_of(x):
    """Monotone int32 total-order keys of f32 values."""
    i = x.float().contiguous().view(torch.int32)
    return torch.where(i < 0, i ^ _I32_MAX, i)


def _unkey(k):
    i = torch.where(k < 0, k ^ _I32_MAX, k)
    return i.to(torch.int32).view(torch.float32)


# ---------------------------------------------------------------------------
# the noise: Philox4x32-10 in int64 arithmetic on 32-bit words

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _mulhilo(m, x):
    """(high, low) 32-bit words of the constant m times x (int64 tensor
    of 32-bit words), by 16-bit halves of x so no product overflows."""
    lo = m * (x & 0xFFFF)
    hi = m * (x >> 16)
    low = lo + ((hi & 0xFFFF) << 16)
    return (hi >> 16) + (low >> 32), low & _U32


def _philox_bits(seed, rows, cols, device):
    """(rows, cols) int64: word 0 of Philox4x32-10 keyed by the 64-bit
    seed at counter (column, row, 0, 0), as csrc/sampling.cu makes it."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    k0, k1 = s & _U32, s >> 32
    c0 = torch.arange(cols, dtype=torch.int64, device=device).expand(rows,
                                                                      cols)
    c1 = torch.arange(rows, dtype=torch.int64, device=device)[:, None].expand(
        rows, cols)
    c2 = c3 = torch.zeros_like(c0)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
    return c0


def _gumbel(seed, rows, cols, device):
    """Gumbel(0, 1) noise (rows, cols) f32 from the Philox bits: u from
    the low 23 bits plus 0.5, g = -log(-log u) (sampling.py:75-80)."""
    bits = _philox_bits(seed, rows, cols, device)
    u = ((bits & 0x7FFFFF).float() + 0.5) * (1.0 / 8388608.0)
    return -torch.log(-torch.log(u))


# ---------------------------------------------------------------------------
# #26: the streaming sample

def _stream_sample(logits, seed, *, inv_temp, gumbel, thresholds=None,
                   noise=None):
    """(B,) int32: per row the first index of the largest
    logits * inv_temp (+ Gumbel noise when `gumbel`: `noise` if given,
    else Philox from `seed`), over the columns whose raw logit is >= the
    row's threshold. logits (B, V) f32 or bf16."""
    B, V = logits.shape
    if thresholds is not None and thresholds.shape != (B,):
        raise ValueError(f"thresholds {tuple(thresholds.shape)} for {B} rows")
    if noise is not None and (not gumbel or noise.shape != (B, V)):
        raise ValueError(f"noise {tuple(noise.shape)} for logits {(B, V)}")
    if logits.device.type == "cpu":
        return _stream_sample_ref(logits, seed, inv_temp=inv_temp,
                                  gumbel=gumbel, thresholds=thresholds,
                                  noise=noise)
    extra = [t for t in (thresholds, noise) if t is not None]
    _build.check_cuda(logits, *extra)
    x = logits.contiguous()
    thr = None if thresholds is None else thresholds.float().contiguous()
    nz = None if noise is None else noise.float().contiguous()
    mode = 0 if not gumbel else 1 if noise is not None else 2
    n_split = cdiv(V, SAMPLE_CHUNK)
    part = (torch.empty((B, n_split), dtype=torch.int64, device=x.device)
            if n_split > 1 else None)
    out = torch.empty(B, dtype=torch.int32, device=x.device)
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    _build.launch("tk_sample", x.data_ptr(), _build.ptr(thr), _build.ptr(nz),
                  mode, s - (1 << 64) if s >> 63 else s, float(inv_temp), B,
                  V, n_split, _build.ptr(part), out.data_ptr(),
                  _build.dtype_code(x), _build.stream(x))
    _stream_sample.launches += 1
    return out


_stream_sample.launches = 0


def _stream_sample_ref(logits, seed, *, inv_temp, gumbel, thresholds=None,
                       noise=None):
    """#26's plain twin, in the TPU kernel's order: x * (1/T), then + g,
    then the NEG_BIG mask; the first index of the row's maximum."""
    x = logits.float()
    live = None if thresholds is None else x >= thresholds.float()[:, None]
    if inv_temp != 1.0:
        x = x * inv_temp
    if gumbel:
        x = x + (noise.float() if noise is not None
                 else _gumbel(seed, *x.shape, x.device))
    if live is not None:
        x = torch.where(live, x, NEG_BIG)
    return torch.argmax(x, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# #27: the top-k / top-p threshold

def _bisect_threshold(logits, *, mode, kk=0, pp=1.0, inv_temp=1.0):
    """(B,) f32 per-row threshold, a data value: in "count" mode the
    kk-th largest logit, in "mass" mode the smallest logit whose mass
    strictly above (w = exp((x - max) * inv_temp)) is < pp * sum(w)."""
    if mode not in ("count", "mass"):
        raise ValueError(f"mode {mode!r}")
    if mode == "count" and kk < 1:
        raise ValueError(f"k must be >= 1: {kk}")
    B, V = logits.shape
    if V > _BISECT_MAX_V:
        raise ValueError(f"{V} values a row: #27 takes at most "
                         f"{_BISECT_MAX_V}")
    if logits.device.type == "cpu":
        return _bisect_threshold_ref(logits, mode=mode, kk=kk, pp=pp,
                                     inv_temp=inv_temp)
    _build.check_cuda(logits)
    x = logits.float().contiguous()
    thr = torch.empty(B, dtype=torch.float32, device=x.device)
    _build.launch("tk_sample_threshold", x.data_ptr(), thr.data_ptr(), B, V,
                  int(mode == "mass"), int(kk), float(pp), float(inv_temp),
                  _build.stream(x))
    _bisect_threshold.launches += 1
    if mode == "count":
        _bisect_threshold.count_launches += 1
    else:
        _bisect_threshold.mass_launches += 1
    return thr


_bisect_threshold.launches = 0
_bisect_threshold.count_launches = 0
_bisect_threshold.mass_launches = 0


def _bisect_threshold_ref(logits, *, mode, kk=0, pp=1.0, inv_temp=1.0):
    """#27's plain twin: JAX's 33-step bisection over the int32 keys,
    each step a masked count (or mass sum) of the keys above mid. The
    weights are f32, as JAX's and the kernel's are; their sums run in
    f64, where the kernel's are exact in fixed point: f32 sums over a
    long row err by more than a tail token's mass."""
    x = logits.float()
    keys = _keys_of(x).long()
    if mode == "mass":
        m = x.amax(dim=-1, keepdim=True)
        w = torch.exp((x - m) * inv_temp).double()
        target = pp * w.sum(dim=-1, keepdim=True)
    B = x.shape[0]
    lo = torch.full((B, 1), _I32_MIN, dtype=torch.int64, device=x.device)
    hi = torch.full((B, 1), _I32_MAX, dtype=torch.int64, device=x.device)
    for _ in range(33):
        mid = (lo + hi) // 2
        above = keys > mid
        if mode == "count":
            q = above.sum(dim=-1, keepdim=True) < kk
        else:
            q = torch.where(above, w, 0.0).sum(dim=-1, keepdim=True) < target
        lo, hi = torch.where(q, lo, mid), torch.where(q, mid, hi)
    bk = torch.where(keys > lo, keys, _I32_MAX).amin(dim=-1)
    return _unkey(bk)


# ---------------------------------------------------------------------------
# thresholds (per row, in raw logit units)

def topk_threshold(logits, k, use_kernel=True):
    """k-th largest logit per row (keep logit >= this <=> top-k set)."""
    if use_kernel and logits.shape[1] <= _BISECT_MAX_V:
        return _bisect_threshold(logits, mode="count", kk=k)
    return torch.topk(logits, k, dim=-1).values[:, -1]


def topp_threshold(logits, p, temperature=1.0, use_kernel=True):
    """Smallest kept logit of the nucleus: keep a token iff the
    probability mass STRICTLY above its logit is < p (sort descending,
    keep while the cumulative probability before a token is < p: always
    keeps the top token, and the token that crosses p). The kernel path
    and the sort path agree up to the order of the mass sums."""
    if use_kernel and logits.shape[1] <= _BISECT_MAX_V:
        return _bisect_threshold(logits, mode="mass", pp=p,
                                 inv_temp=1.0 / temperature)
    srt = torch.sort(logits, dim=-1, descending=True).values.float()
    pr = torch.softmax(srt / temperature, dim=-1)
    kept = torch.cumsum(pr, dim=-1) - pr < p
    last = kept.sum(dim=-1) - 1
    return srt.gather(-1, last[:, None])[:, 0]


def minp_threshold(logits, min_p, temperature=1.0):
    """Sort-free: keep p_i >= min_p * p_max <=>
    logit_i >= max_logit + T * log(min_p)."""
    return (logits.float().amax(dim=-1)
            + temperature * float(np.log(min_p)))


# ---------------------------------------------------------------------------
# public API

def greedy_sample(logits):
    """Streaming argmax over the vocabulary; equal to torch.argmax (first
    index of the maximum)."""
    return _stream_sample(logits, 0, inv_temp=1.0, gumbel=False)


def sample(logits, seed, temperature=1.0, top_k=0, top_p=1.0, min_p=0.0,
           noise=None):
    """One sampling pass: categorical over softmax(logits / T) restricted
    to the top-k / top-p / min-p support, by gumbel-max; temperature 0 is
    greedy. Deterministic per (seed, shape). noise (B, V) f32, if given,
    replaces the Philox noise (JAX's interpret-mode noise)."""
    if temperature == 0.0:
        return greedy_sample(logits)
    thr = None

    def _merge(t):
        nonlocal thr
        thr = t if thr is None else torch.maximum(thr, t)

    if top_k:
        _merge(topk_threshold(logits, top_k))
    if top_p < 1.0:
        _merge(topp_threshold(logits, top_p, temperature))
    if min_p > 0.0:
        _merge(minp_threshold(logits, min_p, temperature))
    return _stream_sample(logits, seed, inv_temp=1.0 / temperature,
                          gumbel=True, thresholds=thr, noise=noise)


def sample_ref(logits, generator, temperature=1.0, top_k=0, top_p=1.0,
               min_p=0.0):
    """Plain reference: the same support (thresholds from torch.topk and
    the sort, no kernel), drawn with torch.multinomial from `generator`
    (a torch.Generator on the logits' device), where JAX's uses
    jax.random.categorical."""
    x = logits.float()
    if temperature == 0.0:
        return torch.argmax(x, dim=-1).to(torch.int32)
    thr = torch.full((x.shape[0],), NEG_BIG, device=x.device)
    if top_k:
        thr = torch.maximum(thr, topk_threshold(x, top_k, use_kernel=False))
    if top_p < 1.0:
        thr = torch.maximum(thr, topp_threshold(x, top_p, temperature,
                                                use_kernel=False))
    if min_p > 0.0:
        thr = torch.maximum(thr, minp_threshold(x, min_p, temperature))
    x = torch.where(x >= thr[:, None], x, -math.inf)
    probs = torch.softmax(x / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


# ---------------------------------------------------------------------------
# registry (sampling.py:344-420); seeds, k, p and min_p as JAX's defaults

def _nbytes(x, *a, **k):
    return x.numel() * x.element_size()


def _argmax(logits, *a, **k):
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)


def _sample_plain(logits, seed=0, top_k=0, top_p=1.0, min_p=0.0):
    """sample(logits, seed, 1.0, ...)'s plain twin: the support from the
    plain thresholds, the draw from #26's twin (the same Philox bits)."""
    thr = None
    for t in ((topk_threshold(logits, top_k, use_kernel=False)
               if top_k else None),
              (topp_threshold(logits, top_p, use_kernel=False)
               if top_p < 1.0 else None),
              minp_threshold(logits, min_p) if min_p > 0.0 else None):
        if t is not None:
            thr = t if thr is None else torch.maximum(thr, t)
    return _stream_sample_ref(logits, seed, inv_temp=1.0, gumbel=True,
                              thresholds=thr)


def _categorical(logits, seed=0, **kw):
    """The categorical baseline: torch.multinomial from a generator on the
    logits' device seeded with seed (jax.random.categorical's role)."""
    gen = torch.Generator(logits.device).manual_seed(int(seed))
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


register("sampling", "greedy_stream", ref=_argmax, bytes_moved=_nbytes)(
    lambda logits, **kw: greedy_sample(logits))
register("sampling", "gumbel_stream", ref=_sample_plain,
         bytes_moved=_nbytes)(
    lambda logits, seed=0: sample(logits, seed))
register("sampling", "topk_gumbel_stream",
         ref=lambda x, seed=0, k=40: _sample_plain(x, seed, top_k=k),
         bytes_moved=lambda x, *a, **k: 2 * _nbytes(x))(
    lambda x, seed=0, k=40: sample(x, seed, top_k=k))
register("sampling", "topp_gumbel_stream",
         ref=lambda x, seed=0, p=0.9: _sample_plain(x, seed, top_p=p),
         bytes_moved=lambda x, *a, **k: 3 * _nbytes(x))(
    lambda x, seed=0, p=0.9: sample(x, seed, top_p=p))
register("sampling", "minp_gumbel_stream",
         ref=lambda x, seed=0, mp=0.05: _sample_plain(x, seed, min_p=mp),
         bytes_moved=lambda x, *a, **k: 2 * _nbytes(x))(
    lambda x, seed=0, mp=0.05: sample(x, seed, min_p=mp))
register("sampling", "greedy_xla", ref=_argmax, bytes_moved=_nbytes,
         tags=("baseline",))(_argmax)
register("sampling", "categorical_xla", ref=_categorical, bytes_moved=_nbytes,
         tags=("baseline",))(_categorical)
