"""GEMV: y[M] = A[M, K] @ x[K] in f32 (tpukern/ops/gemv.py).

Kernel: csrc/gemv.cu (#44, replaces gemv.py:37 `kernel`). `vpu`: a team
of lanes a row (a warp, or a part of one for short rows), 16-byte loads
of A and x, f32 FMAs, a shuffle fold; `mxu`: bf16 on mma.sync m16n8k16
with x as the B column, f32 and f16 on the vpu kernel (never TF32, which
rounds A and x to 10 mantissa bits). As in JAX, each K block of
`block_k` columns (K for None) is summed alone and added to the running
sum in block order; the K tail is masked (JAX's kernel sums the padded
tail of its last block, so its `_k512` variants are wrong at a K that is
no multiple of 512: ROADMAP.md §3). f16 is storage-only, as in JAX: the
kernel reads it and widens in registers. `block_m` is the TPU's row
block, checked and otherwise unused (the CUDA blocks take 8 to 64 rows).

A and x are of one dtype (f32, bf16 or f16); y is f32. On a CPU tensor
`gemv` returns its plain version, JAX's function with the tail masked.
"""

import torch

from tpukern_torch import _build
from tpukern_torch.core.registry import register

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_MODES = {"vpu": 0, "mxu": 1}


def _check(A, x, block_m, block_k, mode):
    if A.dim() != 2 or x.dim() != 1 or A.shape[1] != x.shape[0]:
        raise ValueError(f"gemv: A (M, K) and x (K,), got {tuple(A.shape)} "
                         f"and {tuple(x.shape)}")
    if mode not in _MODES:
        raise ValueError(f"gemv: mode 'vpu' or 'mxu', got {mode!r}")
    if not isinstance(block_m, int) or block_m <= 0:
        raise ValueError(f"gemv: block_m must be a positive int, got "
                         f"{block_m!r}")
    if block_k is not None and (not isinstance(block_k, int) or block_k <= 0):
        raise ValueError(f"gemv: block_k must be None or a positive int, got "
                         f"{block_k!r}")


def _block(K, block_k):
    """The K block: K for None, at most K, at least 1."""
    return max(1, K if block_k is None else min(block_k, K))


def gemv(A, x, block_m=256, block_k=None, mode="vpu"):
    """A @ x with f32 accumulation and output (#44). CPU: gemv_plain."""
    _check(A, x, block_m, block_k, mode)
    if A.device.type == "cpu":
        return gemv_plain(A, x, block_m, block_k, mode)
    _build.check_cuda(A, x)
    if A.dtype not in _DTYPES or x.dtype != A.dtype:
        raise TypeError(f"gemv takes A and x of one dtype, float32, bfloat16 "
                        f"or float16, got {A.dtype} and {x.dtype}")
    M, K = A.shape
    if M >= 2 ** 31:
        raise ValueError(f"gemv: M = {M} past int32")
    A, x = _build.aligned(A), _build.aligned(x)
    y = torch.empty(M, dtype=torch.float32, device=A.device)
    _build.launch("tk_gemv", A.data_ptr(), x.data_ptr(), y.data_ptr(), M, K,
                  _block(K, block_k), _MODES[mode], _build.CODES[A.dtype],
                  _build.stream(A))
    gemv.launches += 1
    return y


gemv.launches = 0


def gemv_plain(A, x, block_m=256, block_k=None, mode="vpu"):
    """Each K block's f32 product, added to the running sum in order."""
    _check(A, x, block_m, block_k, mode)
    a, v = A.float(), x.float()
    K = a.shape[1]
    bk = _block(K, block_k)
    y = torch.zeros(a.shape[0], dtype=torch.float32, device=a.device)
    for k0 in range(0, K, bk):
        y = y + a[:, k0:k0 + bk] @ v[k0:k0 + bk]
    return y


_F32, _BF16, _F16 = torch.float32, torch.bfloat16, torch.float16

# gemv.py:80-90
_VARIANTS = [
    ("f32_k_full", _F32, dict()),
    ("f32_k512", _F32, dict(block_k=512)),
    ("f32_k2048", _F32, dict(block_k=2048)),
    ("f32_mxu", _F32, dict(mode="mxu")),
    ("bf16_k_full", _BF16, dict()),
    ("bf16_k512", _BF16, dict(block_k=512)),
    ("bf16_mxu", _BF16, dict(mode="mxu")),
    ("f16_k_full", _F16, dict()),
    ("f16_k512", _F16, dict(block_k=512)),
]


def _flops(A, x, **_):
    return 2 * A.shape[0] * A.shape[1]


for _sfx, _dt, _kw in _VARIANTS:
    register("gemv", f"gemv_{_sfx}",
             ref=lambda A, x, _dt=_dt, _kw=_kw, **kw: gemv_plain(
                 A.to(_dt), x.to(_dt), **{**_kw, **kw}),
             flops=_flops)(
        lambda A, x, _dt=_dt, _kw=_kw, **kw: gemv(
            A.to(_dt), x.to(_dt), **{**_kw, **kw}))
