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

write_kv_quantized is #20 / #22 as the serving path runs them
(csrc/quant.cu `write_kv_quant_kernel`): a layer's new K and V tokens
quantized per token and stored into the paged pools at the step's slots,
one launch for both; its plain twin write_kv_quantized_ref quantizes with
quantize_ref / quantize_fp8_ref and scatters (scatter_slots), as JAX's
_write_tokens_quantized does, and the two store the same bytes.

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


# ------------------------------------------------ the serving path's write

def scatter_slots(pool, layer, new, slots):
    """pool[layer][h, phys, row] = new[b, h, src] for the (B, T) slots of
    models/serving.py _slots (phys, row, src; src None for token t); new
    is (B, Hkv, T, ...)."""
    phys, row, src = slots
    if src is not None:
        b = torch.arange(new.shape[0], device=new.device)[:, None]
        new = new[b, :, src].movedim(1, 2)
    pool[layer][:, phys, row] = new.movedim(1, 0).to(pool.dtype)


def write_tokens_quantized_ref(pages, scales, layer, new, slots):
    """Row-quantize new (B, Hkv, T, D) tokens to the pool's 1-byte dtype
    (quantize_ref or quantize_fp8_ref over all B * Hkv * T rows, before the
    scatter) and write the values and per-token scales into pages[layer]
    and scales[layer] in place, at the step's slots (JAX's
    _write_tokens_quantized)."""
    B, Hkv, T, D = new.shape
    qfn = quantize_ref if pages.dtype == torch.int8 else quantize_fp8_ref
    vals, s = qfn(new.reshape(B * Hkv * T, D))
    scatter_slots(pages, layer, vals.reshape(B, Hkv, T, D), slots)
    scatter_slots(scales, layer, s.reshape(B, Hkv, T), slots)


def write_kv_quantized_ref(k, v, k_pages, k_scales, v_pages, v_scales,
                           layer, slots):
    """write_kv_quantized's plain twin: write_tokens_quantized_ref for K,
    then for V."""
    write_tokens_quantized_ref(k_pages, k_scales, layer, k, slots)
    write_tokens_quantized_ref(v_pages, v_scales, layer, v, slots)


def write_kv_quantized(k, v, k_pages, k_scales, v_pages, v_scales, layer,
                       slots):
    """Quantize one layer's new K and V tokens k, v (B, Hkv, T, D), f32 or
    bf16, any strides) per token and write values and scales into the
    1-byte pools (L, Hkv, P, page, D) (int8 or float8_e4m3fn) and their f32
    scale pools (L, Hkv, P, page) at `layer`, in place, at the step's
    slots (phys, row, src) of models/serving.py _slots. On the card one
    launch of csrc/quant.cu write_kv_quant_kernel; on the CPU the plain
    twin."""
    if k.shape != v.shape or k.dim() != 4 or k.dtype != v.dtype:
        raise ValueError(f"k {tuple(k.shape)} {k.dtype} and v "
                         f"{tuple(v.shape)} {v.dtype}")
    if k_pages.dtype != v_pages.dtype or k_pages.dtype not in (
            torch.int8, torch.float8_e4m3fn):
        raise TypeError(f"pools of {k_pages.dtype} and {v_pages.dtype}")
    if k_pages.device.type == "cpu":
        write_kv_quantized_ref(k, v, k_pages, k_scales, v_pages, v_scales,
                               layer, slots)
        return
    phys, row, src = slots
    B, H, T, D = k.shape
    L, Hp, P, page, Dp = k_pages.shape
    if ((Hp, Dp) != (H, D) or v_pages.shape != k_pages.shape
            or k_scales.shape != k_pages.shape[:4]
            or v_scales.shape != k_scales.shape or not 0 <= layer < L):
        raise ValueError(f"pools {tuple(k_pages.shape)} for tokens "
                         f"{tuple(k.shape)} at layer {layer}")
    _build.check_cuda(k, v, k_pages, k_scales, v_pages, v_scales, phys)
    if k.stride(3) != 1:
        k = k.contiguous()
    if v.stride(3) != 1:
        v = v.contiguous()
    for t in (phys, row) + (() if src is None else (src,)):
        if t.dtype != torch.int64 or t.shape != (B, T) or not t.is_contiguous():
            raise ValueError(f"slots of {t.dtype} {tuple(t.shape)}: "
                             f"_slots gives contiguous int64 ({B}, {T})")
    for t in (k_pages, k_scales, v_pages, v_scales):
        if not t.is_contiguous():
            raise ValueError("the pools must be contiguous")
    sk, ss = k_pages.stride(0), k_scales.stride(0) * 4
    _build.launch("tk_write_kv_quantized", k.data_ptr(), v.data_ptr(),
                  *k.stride()[:3], *v.stride()[:3], phys.data_ptr(),
                  row.data_ptr(), _build.ptr(src),
                  k_pages.data_ptr() + layer * sk,
                  k_scales.data_ptr() + layer * ss,
                  v_pages.data_ptr() + layer * sk,
                  v_scales.data_ptr() + layer * ss, B, H, T, D, P, page,
                  _FP8 if k_pages.dtype == torch.float8_e4m3fn else _ROUND,
                  _build.dtype_code(k), _build.stream(k))
    write_kv_quantized.launches += 1


write_kv_quantized.launches = 0


# ---------------------------------------------------------------- registry

register("quant", "quantize_int8", ref=quantize_ref)(quantize_int8)
# the card draws Philox bits, the plain version a torch.Generator's: values
# within one step of each other, scales equal
register("quant", "quantize_int8_stochastic", ref=quantize_stochastic_ref,
         tags=("stochastic",))(
    lambda x, seed=0: quantize_int8(x, seed, stochastic=True))
register("quant", "dequantize_int8", ref=dequantize_ref)(dequantize_int8)
register("quant", "quantize_fp8", ref=quantize_fp8_ref)(quantize_fp8)
