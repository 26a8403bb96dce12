"""Per-row quantization: int8 (round to nearest, or stochastic rounding)
and fp8 e4m3 with one f32 scale per row, and int8 dequantization.

The port of tpukern/ops/quant.py. Kernels: csrc/quant.cu
`quantize_kernel` (replaces quant.py:36 `kernel` of quantize_int8, #20,
and :128 `kernel` of quantize_fp8, #22) and `dequantize_kernel` (:89,
dequantize_int8, #21). Rows keep their natural width K: the 128-lane pad
and the (S, 128) scale block of the TPU kernels are Mosaic layout and
are not ported.

- scale = absmax / 127 (int8) or absmax / FP8_MAX (fp8), 1 for a row of
  zeros; values = x / scale, rounded half to even (int8) or to the
  nearest e4m3 (fp8). quantize_ref and quantize_fp8_ref compute JAX's
  functions of the same names, and the kernel equals them bit for bit.
- stochastic=True writes clip(floor(x / scale + u), -128, 127) with
  u ~ U[0, 1): on the card from Philox4x32-10 keyed by `seed` at counter
  (column, row), in the plain version from a torch.Generator seeded with
  `seed`. JAX draws u from the TPU's own PRNG, so only the distribution
  is shared.

A CPU tensor takes the plain version and a CUDA tensor launches the
kernel; `launches` on each wrapper counts its launches.
"""

import torch

from tpukern_torch import _build
from tpukern_torch.core.registry import register

FP8_MAX = 448.0  # float8_e4m3fn's largest finite value
_ROUND, _STOCHASTIC, _FP8 = 0, 1, 2  # csrc/quant.cu QuantMode


def _check_rows(x):
    if x.dim() != 2:
        raise ValueError(f"quantization takes 2-D rows, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantization takes f32 or bf16, got {x.dtype}")


def _scales(x, qmax):
    """(x as f32, per-row scales (S, 1)): absmax / qmax, 1 where 0. The
    divisor is a tensor: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which is not the true division of JAX
    and of the kernel."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    return xf, torch.where(absmax == 0, 1.0,
                           absmax / torch.full_like(absmax, qmax))


def quantize_ref(x):
    """Plain per-row symmetric int8, round half to even (JAX's
    quantize_ref). Returns (int8 (S, K), f32 scales (S,))."""
    xf, scale = _scales(x, 127.0)
    return torch.round(xf / scale).to(torch.int8), scale[:, 0]


def quantize_stochastic_ref(x, seed=0):
    """Plain stochastic rounding: clip(floor(x / scale + u), -128, 127),
    u ~ U[0, 1) from a torch.Generator on x's device seeded with seed."""
    xf, scale = _scales(x, 127.0)
    gen = torch.Generator(x.device).manual_seed(int(seed))
    u = torch.rand(xf.shape, generator=gen, device=x.device)
    values = torch.floor(xf / scale + u).clamp(-128, 127).to(torch.int8)
    return values, scale[:, 0]


def quantize_fp8_ref(x):
    """Plain per-row fp8 e4m3 (JAX's quantize_fp8_ref)."""
    xf, scale = _scales(x, FP8_MAX)
    return (xf / scale).to(torch.float8_e4m3fn), scale[:, 0]


def dequantize_ref(values, scales, out_dtype=torch.float32):
    """values * scale per row, in out_dtype."""
    return (values.float() * scales.float()[:, None]).to(out_dtype)


def _quantize(x, mode, seed=0):
    """Launch csrc/quant.cu's quantize_kernel on CUDA rows x."""
    _build.check_cuda(x)
    S, K = x.shape
    x = _build.aligned(x)
    vdtype = torch.float8_e4m3fn if mode == _FP8 else torch.int8
    values = torch.empty((S, K), dtype=vdtype, device=x.device)
    scales = torch.empty(S, dtype=torch.float32, device=x.device)
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    _build.launch("tk_quantize", x.data_ptr(), values.data_ptr(),
                  scales.data_ptr(), S, K, mode,
                  s - (1 << 64) if s >> 63 else s, _build.dtype_code(x),
                  _build.stream(x))
    return values, scales


def quantize_int8(x, seed=0, stochastic=False):
    """Per-row symmetric int8 quantization of 2-D f32/bf16 rows x (S, K).
    Returns (values int8 (S, K), scales f32 (S,))."""
    _check_rows(x)
    if x.device.type == "cpu":
        return (quantize_stochastic_ref(x, seed) if stochastic
                else quantize_ref(x))
    out = _quantize(x, _STOCHASTIC if stochastic else _ROUND, seed)
    quantize_int8.launches += 1
    return out


quantize_int8.launches = 0


def quantize_fp8(x):
    """Per-row scaled fp8 e4m3 quantization of 2-D f32/bf16 rows x (S, K)
    (the KV tier of the same byte a value as int8, with a tapered
    mantissa). Returns (values float8_e4m3fn (S, K), scales f32 (S,))."""
    _check_rows(x)
    if x.device.type == "cpu":
        return quantize_fp8_ref(x)
    out = _quantize(x, _FP8)
    quantize_fp8.launches += 1
    return out


quantize_fp8.launches = 0


def dequantize_int8(values, scales, out_dtype=torch.float32):
    """Inverse of quantize_int8: values (S, K) int8 times scales (S,),
    in out_dtype (f32 or bf16)."""
    if values.dim() != 2 or values.dtype != torch.int8:
        raise TypeError(f"dequantize takes 2-D int8, got {values.dtype} "
                        f"{tuple(values.shape)}")
    if scales.shape != values.shape[:1]:
        raise ValueError(f"scales {tuple(scales.shape)} for "
                         f"{values.shape[0]} rows")
    if values.device.type == "cpu":
        return dequantize_ref(values, scales, out_dtype)
    _build.check_cuda(values, scales)
    S, K = values.shape
    values = _build.aligned(values)
    scales = scales.float().contiguous()
    out = torch.empty((S, K), dtype=out_dtype, device=values.device)
    _build.launch("tk_dequantize", values.data_ptr(), scales.data_ptr(),
                  out.data_ptr(), S, K, _build.dtype_code(out),
                  _build.stream(values))
    dequantize_int8.launches += 1
    return out


dequantize_int8.launches = 0


# ---------------------------------------------------------------- registry

register("quant", "quantize_int8", ref=quantize_ref)(quantize_int8)
# the card draws Philox bits, the plain version a torch.Generator's: values
# within one step of each other, scales equal
register("quant", "quantize_int8_stochastic", ref=quantize_stochastic_ref,
         tags=("stochastic",))(
    lambda x, seed=0: quantize_int8(x, seed, stochastic=True))
register("quant", "dequantize_int8", ref=dequantize_ref)(dequantize_int8)
register("quant", "quantize_fp8", ref=quantize_fp8_ref)(quantize_fp8)
