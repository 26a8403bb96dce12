"""Weight-only int8 GEMM (w8a16): int8 weights with one f32 scale per
output column, bf16 or f32 activations.

The port of tpukern/ops/matmul_w8a16.py. Kernel: csrc/matmul_w8a16.cu,
which replaces `kernel` (matmul_w8a16.py:106), the Pallas body of
`matmul_w8a16`:

    y[m, n] = (sum_k x[m, k] * float(q[k, n])) * s[n]

accumulated in f32 and written in out_dtype (default: x's). The int8
weights are read as int8 (half the bytes of bf16 weights: the point of
the tier at decode, where the product is bound by the weight read) and
widened in registers (bf16: tokens are the MMA's N, so a decode call pads
its few rows to 8, not 64; widen_int8_ref is the widening's arithmetic);
the scale multiplies each output once.

JAX's dispatch is kept: at M > 128 rows, unless force_kernel is set,
the product is jnp.dot over weights dequantized in the compute dtype
(w_q.astype(cd) * scale.astype(cd): in bf16 each dequantized weight and
the scale are rounded to bf16), which is a different function from the
kernel's. Here that path is the same dequant and torch.matmul
(_dequant_matmul), on any device, as the JAX package leaves it to XLA.
The kernel itself takes every M.

JAX's ValueError for a K with no 128-multiple divisor is a TPU compiler
constraint and is not ported: the kernel masks the K tail. The block
sizes (block_m, block_n, block_k) are Mosaic knobs and are not ported.

A CPU tensor at M <= 128 (or with force_kernel) takes matmul_w8a16_ref;
a CUDA tensor launches the kernel or raises; `launches` counts its
launches.
"""

import functools

import torch

from tpukern_torch import _build
from tpukern_torch.core import cdiv
from tpukern_torch.core.registry import register

KERNEL_MAX_M = 128  # JAX's dispatch: above this M the dequant-dot path
# csrc/matmul_w8a16.cu: the weight columns of a block (W_BN, Q_BN); the
# tokens of a block and the K rows of a slice (bf16: Q_TOKENS, Q_BK; f32:
# W_BM, W_BK)
TILE_N = 128
TILE_M = {torch.bfloat16: 128, torch.float32: 64}
TILE_K = {torch.bfloat16: 64, torch.float32: 32}


def quantize_weights(w):
    """Symmetric per-output-column int8 quantization of w (K, N):
    (q int8 (K, N), scale f32 (N,)) with q * scale ~= w, as JAX's
    quantize_weights: amax = max |w| over K in f32, scale = amax / 127
    (1 where amax is 0), q = clip(round(w / scale), -127, 127), rounding
    half to even. The divisor 127 is a tensor: PyTorch's CUDA division by
    a Python scalar multiplies by its reciprocal, one ulp off JAX's true
    division."""
    if w.dim() != 2:
        raise ValueError(f"quantize_weights takes (K, N), got "
                         f"{tuple(w.shape)}")
    wf = w.float()
    amax = wf.abs().amax(dim=0)
    scale = torch.where(amax == 0, 1.0,
                        amax / torch.full_like(amax, 127.0))
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return q.to(torch.int8), scale


def _check(x, w_q, scale):
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"matmul_w8a16: x {tuple(x.shape)} and w_q "
                         f"{tuple(w_q.shape)} do not contract")
    if w_q.dtype != torch.int8:
        raise TypeError(f"matmul_w8a16: w_q must be int8, got {w_q.dtype}")
    if scale.shape != (w_q.shape[1],):
        raise ValueError(f"matmul_w8a16: scale {tuple(scale.shape)} for "
                         f"{w_q.shape[1]} columns")


def _dequant_matmul(x, w_q, scale, out_dtype):
    """JAX's M > 128 path: weights dequantized in the compute dtype (bf16
    for bf16 x, else f32), then one product with f32 accumulation."""
    cd = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    w = w_q.to(cd) * scale.to(cd)
    if out_dtype == cd:
        return torch.matmul(x.to(cd), w)
    return torch.matmul(x.to(cd).float(), w.float()).to(out_dtype)


def matmul_w8a16_ref(x, w_q, scale, *, out_dtype=None):
    """The kernel's function in plain PyTorch: x times the int8 weights in
    f32 (x cast to f32 is exact, and so is each product of a bf16 by an
    integer of at most 127), times scale per column, in out_dtype."""
    y = torch.matmul(x.float(), w_q.float()) * scale.float()
    return y.to(out_dtype or x.dtype)


def widen_int8_ref(q):
    """int8 q as the bf16 kernel widens it, bit for bit: b & 0x7F in the
    mantissa of bf16 128 (bits 0x4300 | (b & 0x7F)) minus 128 or 256
    (0x4300 | (b & 0x80)), exact for every int8 (csrc/matmul_w8a16.cu
    widen_int8)."""
    b = q.to(torch.int32) & 0xFF

    def bf16(bits):
        return (bits << 16).view(torch.float32)
    return (bf16(0x4300 | (b & 0x7F)) - bf16(0x4300 | (b & 0x80))).to(
        torch.bfloat16)


def token_tiles(M):
    """n8 token tiles a block of the bf16 kernel takes (its instance):
    M's first 128 rows in tiles of 8, rounded up to a power of two."""
    n = cdiv(min(M, TILE_M[torch.bfloat16]), 8)
    return 1 << max(n - 1, 0).bit_length()


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


# a lever for timing: splits of K forced on the bf16 kernel (None: the
# rule of _splits)
SPLITS = None


@functools.cache
def _rule(M, N, K, sms, dtype):
    n_kt = cdiv(K, TILE_K[dtype])
    tiles = cdiv(M, TILE_M[dtype]) * cdiv(N, TILE_N)
    if dtype == torch.bfloat16:
        # at most two waves of blocks, rounded down, and 16 splits (8 from
        # 4 token tiles on: the last block's merge waits on more round
        # trips to L2 a split); the best of 1-32 splits on an H100 at the
        # 7bish shapes, M = 4, 20 and 128 (harness/w8a16_times.py --sweep)
        want = min(2 * sms // tiles, 16 if token_tiles(M) <= 2 else 8)
    else:
        want = cdiv(2 * sms, tiles)
    splits = max(1, min(n_kt, want))
    per = cdiv(n_kt, splits) if n_kt else 0
    return (cdiv(n_kt, per) if per else 1), per


def _splits(M, N, K, sms, dtype=torch.bfloat16):
    """K slices per output tile of the kernel for x of dtype, at least
    one K slice of TILE_K[dtype] rows each: bf16 at most two waves of
    blocks and 16 splits (8 from 4 token tiles on), f32 two waves (the
    decode shapes have a few dozen output tiles). Returns (splits, K
    slices a split); one answer a shape, kept. SPLITS, where set, forces
    the bf16 kernel's count."""
    if SPLITS is None or dtype != torch.bfloat16:
        return _rule(M, N, K, sms, dtype)
    n_kt = cdiv(K, TILE_K[dtype])
    per = cdiv(n_kt, max(1, min(SPLITS, n_kt))) if n_kt else 0
    return (cdiv(n_kt, per) if per else 1), per


# (device, stream) -> f32 workspace of the split-K partials, grown to the
# largest call's and kept: a call on the stream finishes with it before
# the next one starts
_WORKSPACE = {}


def _workspace(device, stream, n):
    """n f32 values of split-K workspace on device for a launch on
    stream, reused across calls."""
    ws = _WORKSPACE.get((device, stream))
    if ws is None or ws.numel() < n:
        ws = torch.empty(n, device=device)
        _WORKSPACE[(device, stream)] = ws
    return ws


def matmul_w8a16(x, w_q, scale, *, out_dtype=None, force_kernel=False):
    """x (M, K) bf16/f32 @ dequant(w_q (K, N) int8, scale (N,) f32) ->
    (M, N) in out_dtype (default x's dtype).

    M <= 128, or force_kernel: the kernel's function (matmul_w8a16_ref on
    a CPU tensor, csrc/matmul_w8a16.cu on a CUDA tensor). M > 128: JAX's
    dequant-then-dot path (_dequant_matmul) on either device."""
    _check(x, w_q, scale)
    out_dtype = out_dtype or x.dtype
    M, K = x.shape
    N = w_q.shape[1]
    if M > KERNEL_MAX_M and not force_kernel:
        return _dequant_matmul(x, w_q, scale, out_dtype)
    if x.device.type == "cpu":
        return matmul_w8a16_ref(x, w_q, scale, out_dtype=out_dtype)
    _build.check_cuda(x, w_q, scale)
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"matmul_w8a16 writes float32 or bfloat16, not "
                        f"{out_dtype}")
    dtype = _build.dtype_code(x)
    x, w_q = _build.aligned(x), _build.aligned(w_q)
    scale = scale.float().contiguous()
    out = torch.empty(M, N, dtype=out_dtype, device=x.device)
    splits, per = _splits(M, N, K, _sm_count(x.device.index or 0), x.dtype)
    stream = _build.stream(x)
    # f32 partials of every K slice of every tile, summed in slice order
    # by the last block of the tile to finish
    ws = (_workspace(x.device, stream, splits * M * N) if splits > 1
          else None)
    tiles = cdiv(M, TILE_M[x.dtype]) * cdiv(N, TILE_N)
    tickets = _build.tickets(x.device, stream, tiles)
    _build.launch("tk_matmul_w8a16", x.data_ptr(), w_q.data_ptr(),
                  scale.data_ptr(), out.data_ptr(), _build.ptr(ws),
                  tickets.data_ptr(), M, N, K, splits, per, dtype,
                  _build.DTYPE_CODES[out_dtype], stream)
    matmul_w8a16.launches += 1
    return out


matmul_w8a16.launches = 0


# ---------------------------------------------------------------- registry

def _w8a16_ref(x, w_q, scale):
    """The variant's function in plain PyTorch: the kernel's at M <= 128,
    JAX's dequant-then-dot path above (matmul_w8a16's dispatch)."""
    if x.shape[0] > KERNEL_MAX_M:
        return _dequant_matmul(x, w_q, scale, x.dtype)
    return matmul_w8a16_ref(x, w_q, scale)


def _dequant(x, w_q, scale):
    return _dequant_matmul(x, w_q, scale, x.dtype)


def _w8a16_flops(x, w_q, scale):
    return 2 * x.shape[0] * x.shape[1] * w_q.shape[1]


register("matmul_w8a16", "w8a16", ref=_w8a16_ref, flops=_w8a16_flops,
         bytes_moved=lambda x, w_q, scale: w_q.numel())(matmul_w8a16)
register("matmul_w8a16", "w8a16_dequant_xla", ref=_dequant,
         flops=_w8a16_flops, bytes_moved=lambda x, w_q, scale: 2 * w_q.numel(),
         tags=("baseline",))(_dequant)
