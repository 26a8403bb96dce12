"""The storage-only dtype policy (tpukern/core/config.py).

The JAX package's kernels compute in f32 where the TPU has no arithmetic
for a declared dtype: f16 and the two fp8 types are STORAGE-ONLY, so a
variant declared in one of them rounds through it at the boundary and
computes in f32 inside the kernel (tpukern/core/config.py:24-45). The
port keeps that policy, so that it computes the JAX package's functions:
its kernels read these dtypes directly (the widening to f32 is exact),
compute in f32 and round once on the way out.

JAX's `use_interpret` (compiled Mosaic on a TPU, interpret mode
elsewhere) has no counterpart: the port's wrappers dispatch on the
tensor's device, a CPU tensor to the plain version and a CUDA tensor to
the kernel (tpukern_torch/_build.py).
"""

import torch

STORAGE_ONLY_DTYPES = frozenset(
    (torch.float16, torch.float8_e4m3fn, torch.float8_e5m2))


def kernel_dtype(dt: torch.dtype) -> torch.dtype:
    """The dtype a kernel computes in for a declared dtype."""
    return torch.float32 if dt in STORAGE_ONLY_DTYPES else dt


def to_kernel_dtype(x: torch.Tensor) -> torch.Tensor:
    """x in the dtype a kernel computes in: widened to f32 if its own is
    storage-only, else x itself."""
    kdt = kernel_dtype(x.dtype)
    return x.to(kdt) if kdt != x.dtype else x
