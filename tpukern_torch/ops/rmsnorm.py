"""RMS norm: per-row root-mean-square normalization.

The port of tpukern/ops/rmsnorm.py. Kernel: csrc/rmsnorm.cu, which
replaces the Pallas `kernel` of rms_norm (rmsnorm.py:34).
"""

import torch

from tpukern_torch import _build


def rms_norm(x, g, eps=1e-5):
    """y = x / sqrt(mean(x^2) + eps) * g over the last dim; g is (K,).

    Statistics and scaling in f32, result in x.dtype. A CPU tensor takes
    rms_norm_ref; a CUDA tensor launches the kernel (bf16 or f32 x, g of
    either)."""
    if x.device.type == "cpu":
        return rms_norm_ref(x, g, eps)
    _build.check_cuda(x, g)
    K = x.shape[-1]
    if g.shape != (K,):
        raise ValueError(f"g must have shape ({K},), got {tuple(g.shape)}")
    x2 = _build.aligned(x.reshape(-1, K))
    g = g.contiguous()
    y = torch.empty_like(x2)
    _build.launch("tk_rms_norm", x2.data_ptr(), g.data_ptr(), y.data_ptr(),
                  x2.shape[0], K, eps, _build.dtype_code(x2),
                  _build.dtype_code(g), _build.stream(x2))
    rms_norm.launches += 1
    return y.reshape(x.shape)


rms_norm.launches = 0


def rms_norm_ref(x, g, eps=1e-5):
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * g.float()).to(x.dtype)
