"""Layer norm: per-row mean/variance normalization.

The port of tpukern/ops/layernorm.py. Kernel: csrc/layernorm.cu (#37),
which replaces the Pallas `kernel` of layer_norm (layernorm.py:52) and
computes its function: mean = sum(x) / K and the one-pass variance
var = sum(x^2) / K - mean^2 (layernorm.py:60-62), both rounded through
bf16 under a bf16 accumulator after var is formed (:63-65), then
(x - mean) * rsqrt(var + eps) * g + b in f32, rounded once to x's dtype.
g and b are each a number or a (K,) tensor. f16 rows and an f16
accumulator are storage-only (core/config.py): f32 math. The TPU block
heights of the registry's names (_r8 ... _r128) are aliases of one
kernel; JAX's `_pad_cols0` (a Mosaic lane padding) is not ported.

`layer_norm_plain` is the kernel's function in plain PyTorch (the
registry's `ref`); `layer_norm_ref` is JAX's two-pass reference
(layernorm.py:96-102). The one-pass variance cancels where a row's mean
is large against its spread, so the two part there (tests/
test_torch_layernorm.py holds the port's plain version to JAX's kernel on
such rows).
"""

import torch

from tpukern_torch import _build
from tpukern_torch.core.config import STORAGE_ONLY_DTYPES, kernel_dtype
from tpukern_torch.core.registry import register

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_AFFINE = (torch.float32, torch.bfloat16)


def layer_norm(x, g=1.0, b=0.0, eps=1e-5, acc_dtype=torch.float32):
    """y = (x - mean) / sqrt(var + eps) * g + b over the last dim, with
    var = E[x^2] - mean^2; g and b each a number or a (K,) tensor.

    A CPU tensor takes layer_norm_plain; a CUDA tensor launches the kernel
    (f32, bf16 or f16 x and accumulator; g and b of f32 or bf16)."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, g, b, eps, acc_dtype)
    vecs = [t for t in (g, b) if isinstance(t, torch.Tensor)]
    _build.check_cuda(x, *vecs)
    K = x.shape[-1]
    for name, t in (("g", g), ("b", b)):
        if isinstance(t, torch.Tensor) and t.shape != (K,):
            raise ValueError(f"{name} must have shape ({K},), got "
                             f"{tuple(t.shape)}")
    if acc_dtype not in _DTYPES or x.dtype not in _DTYPES or any(
            t.dtype not in _AFFINE for t in vecs):
        raise TypeError(f"layer_norm takes f32, bf16 or f16 x and "
                        f"accumulator and f32 or bf16 g, b; got x "
                        f"{x.dtype}, accumulator {acc_dtype}, g and b "
                        f"{[t.dtype for t in vecs]}")
    if len({t.dtype for t in vecs}) > 1:  # one dtype for both (exact)
        g, b = g.float(), b.float()
    gv, gs = (g.contiguous(), 0.0) if isinstance(g, torch.Tensor) else (
        None, float(g))
    bv, bs = (b.contiguous(), 0.0) if isinstance(b, torch.Tensor) else (
        None, float(b))
    gb = gv if gv is not None else bv
    x2 = _build.aligned(x.reshape(-1, K))
    y = torch.empty_like(x2)
    _build.launch("tk_layer_norm", x2.data_ptr(), _build.ptr(gv), gs,
                  _build.ptr(bv), bs, y.data_ptr(), x2.shape[0], K, eps,
                  int(kernel_dtype(acc_dtype) == torch.bfloat16),
                  _build.CODES[x2.dtype],
                  0 if gb is None else _build.dtype_code(gb),
                  _build.stream(x2))
    layer_norm.launches += 1
    return y.reshape(x.shape)


layer_norm.launches = 0


def _affine(v):
    return v.float() if isinstance(v, torch.Tensor) else v


def layer_norm_plain(x, g=1.0, b=0.0, eps=1e-5, acc_dtype=torch.float32):
    """The kernel's function (tpukern/ops/layernorm.py:57-72): the
    one-pass variance in f32, the statistics rounded through bf16 under a
    bf16 accumulator, one rounding to x's dtype."""
    xf = x.float()
    # a true division (on CUDA, dividing by a Python number multiplies by
    # its reciprocal), as JAX's / K and the kernel's
    k = torch.full((), x.shape[-1], dtype=torch.float32, device=x.device)
    mean = xf.sum(-1, keepdim=True) / k
    var = (xf * xf).sum(-1, keepdim=True) / k - mean * mean
    if kernel_dtype(acc_dtype) == torch.bfloat16:
        mean = mean.to(torch.bfloat16).float()
        var = var.to(torch.bfloat16).float()
    y = (xf - mean) * torch.rsqrt(var + eps) * _affine(g) + _affine(b)
    return y.to(x.dtype)


def layer_norm_ref(x, g=1.0, b=0.0, eps=1e-5):
    """JAX's layer_norm_ref: the two-pass variance mean((x - mean)^2)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * _affine(g)
            + _affine(b)).to(x.dtype)


_F32, _BF16, _F16 = torch.float32, torch.bfloat16, torch.float16

# (suffix, x dtype, acc dtype) — layernorm.py:105-114
_VARIANTS = [
    ("f32_r8", _F32, _F32), ("f32_r64", _F32, _F32),
    ("bf16_bf16_r16", _BF16, _BF16), ("bf16_f32_r16", _BF16, _F32),
    ("bf16_f32_r128", _BF16, _F32), ("f16_f16_r16", _F16, _F16),
    ("f16_f32_r16", _F16, _F32), ("f16_f32_r128", _F16, _F32),
]


def _bytes(dt):
    def bytes_moved(x, g=1.0, b=0.0):
        # x read once, y written once, and g and b where they are vectors
        return 2 * x.numel() * dt.itemsize + sum(
            t.numel() * t.element_size() for t in (g, b)
            if isinstance(t, torch.Tensor))
    return bytes_moved


for _sfx, _in, _acc in _VARIANTS:
    register("layer_norm", f"layer_norm_{_sfx}",
             ref=lambda x, g=1.0, b=0.0, _in=_in, _acc=_acc:
             layer_norm_plain(x.to(_in), g, b, acc_dtype=_acc),
             bytes_moved=_bytes(_in),
             tags=("storage-only",) if _in in STORAGE_ONLY_DTYPES else ())(
        lambda x, g=1.0, b=0.0, _in=_in, _acc=_acc:
        layer_norm(x.to(_in), g, b, acc_dtype=_acc))
