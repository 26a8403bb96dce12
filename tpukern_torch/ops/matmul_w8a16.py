"""Weight-only int8 GEMM (w8a16): int8 weights with one f32 scale per
output column, bf16 or f32 activations.

The port of tpukern/ops/matmul_w8a16.py. Kernel: csrc/matmul_w8a16.cu,
which replaces `kernel` (matmul_w8a16.py:106), the Pallas body of
`matmul_w8a16`:

    y[m, n] = (sum_k x[m, k] * float(q[k, n])) * s[n]

accumulated in f32 and written in out_dtype (default: x's). The int8
weights are read as int8 (half the bytes of bf16 weights: the point of
the tier at decode, where the product is bound by the weight read) and
widened in shared memory; the scale multiplies each output once.

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
from tpukern_torch.core.registry import register

KERNEL_MAX_M = 128  # JAX's dispatch: above this M the dequant-dot path
# csrc/matmul_w8a16.cu W_BM, W_BN, W_BK: the output tile and K slice
TILE_M, TILE_N, TILE_K = 64, 128, 32


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


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _splits(M, N, K, sms):
    """K slices per output tile: enough blocks for two waves of the
    card's SMs (the decode shapes have a few dozen output tiles), at
    least one K slice of TILE_K each. Returns (splits, K slices a
    split)."""
    n_kt = -(-K // TILE_K)
    tiles = -(-M // TILE_M) * -(-N // TILE_N)
    splits = max(1, min(n_kt, -(-2 * sms // tiles)))
    per = -(-n_kt // splits) if n_kt else 0
    return (-(-n_kt // per) if per else 1), per


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
    splits, per = _splits(M, N, K, _sm_count(x.device.index or 0))
    # f32 partials of every K slice of every tile, summed in slice order
    # by the last block of the tile to finish
    ws = (torch.empty(splits, M, N, device=x.device) if splits > 1
          else None)
    tiles = -(-M // TILE_M) * -(-N // TILE_N)
    stream = _build.stream(x)
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
