"""RMS norm: per-row root-mean-square normalization.

The port of tpukern/ops/rmsnorm.py. Kernel: csrc/rmsnorm.cu, which
replaces the Pallas `kernel` of rms_norm (rmsnorm.py:34), with its
options: g a vector or a scalar, the accumulator dtype (bf16 rounds the
row's mean square through bf16, rmsnorm.py:44-46; an f16 one sums in
f32), and f16 rows, both by core/config.py's storage-only policy. The
TPU block heights of the registry's names (_r8 ... _r512) are aliases of
one kernel.
"""

import torch

from tpukern_torch import _build
from tpukern_torch.core.registry import register

_ACCS = (torch.float32, torch.bfloat16, torch.float16)


def rms_norm(x, g=1.0, eps=1e-5, acc_dtype=torch.float32):
    """y = x / sqrt(mean(x^2) + eps) * g over the last dim; g is (K,) or a
    number.

    Statistics and scaling in f32 (with acc_dtype bf16 the mean square is
    rounded to bf16), result in x.dtype. A CPU tensor takes rms_norm_ref;
    a CUDA tensor launches the kernel (f32, bf16 or f16 x; a vector g of
    f32 or bf16)."""
    if x.device.type == "cpu":
        return rms_norm_ref(x, g, eps, acc_dtype)
    vec = isinstance(g, torch.Tensor)
    _build.check_cuda(x, *([g] if vec else []))
    K = x.shape[-1]
    if vec and g.shape != (K,):
        raise ValueError(f"g must have shape ({K},), got {tuple(g.shape)}")
    if acc_dtype not in _ACCS or x.dtype not in _ACCS:
        raise TypeError(f"rms_norm takes f32, bf16 or f16 x and "
                        f"accumulator, got {x.dtype} and {acc_dtype}")
    x2 = _build.aligned(x.reshape(-1, K))
    gv, gs = (g.contiguous(), 0.0) if vec else (None, float(g))
    y = torch.empty_like(x2)
    _build.launch("tk_rms_norm", x2.data_ptr(), _build.ptr(gv), gs,
                  y.data_ptr(), x2.shape[0], K, eps,
                  int(acc_dtype == torch.bfloat16), _build.CODES[x2.dtype],
                  _build.dtype_code(gv) if vec else 0, _build.stream(x2))
    rms_norm.launches += 1
    return y.reshape(x.shape)


rms_norm.launches = 0


def rms_norm_ref(x, g=1.0, eps=1e-5, acc_dtype=torch.float32):
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    if acc_dtype == torch.bfloat16:
        ms = ms.to(torch.bfloat16).float()
    g = g.float() if isinstance(g, torch.Tensor) else g
    return (xf * torch.rsqrt(ms + eps) * g).to(x.dtype)


_F32, _BF16, _F16 = torch.float32, torch.bfloat16, torch.float16

# (suffix, x dtype, acc dtype) — rmsnorm.py:80-95
_VARIANTS = [
    ("f32_r8", _F32, _F32), ("f32_r64", _F32, _F32),
    ("bf16_bf16_r16", _BF16, _BF16), ("bf16_f32_r16", _BF16, _F32),
    ("bf16_f32_r128", _BF16, _F32), ("f16_f16_r16", _F16, _F16),
    ("f16_f32_r16", _F16, _F32), ("f16_f32_r128", _F16, _F32),
    ("bf16_f32_r512", _BF16, _F32),
]

for _sfx, _in, _acc in _VARIANTS:
    register("rms_norm", f"rms_norm_{_sfx}",
             ref=lambda x, g=1.0, _in=_in, _acc=_acc: rms_norm_ref(
                 x.to(_in), g, acc_dtype=_acc),
             bytes_moved=lambda x, g=1.0: 2 * x.numel() * x.element_size())(
        lambda x, g=1.0, _in=_in, _acc=_acc: rms_norm(x.to(_in), g,
                                                      acc_dtype=_acc))
