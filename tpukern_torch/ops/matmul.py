"""GEMM: C = A·B or A·Bᵀ with f32 accumulation.

The port of tpukern/ops/matmul.py `matmul`. Kernel: csrc/matmul.cu, one
kernel per input dtype (f32 on CUDA cores, bf16 on the tensor cores)
whose epilogue replaces the three Pallas bodies (matmul.py:140-172):
`kernel` writes the out dtype, `kernel_accio` the f32 accumulator,
`kernel_accio_dual` both. The Mosaic knobs (block sizes, swizzle,
buffer_count, lookahead, input_fusion, eager_store, jitter) are not
ported.
"""

import torch

from tpukern_torch import _build


def _out_dtype(a, out_dtype, acc_in_out):
    # acc_in_out's natural output is the f32 accumulator; only an explicit
    # lower-precision out_dtype engages the dual epilogue (matmul.py:76-79)
    if out_dtype is None:
        return torch.float32 if acc_in_out else a.dtype
    return out_dtype


def matmul(a, b, *, trans_b=False, out_dtype=None, acc_in_out=False):
    """C[M,N] = A[M,K] @ B[K,N], or A @ B[N,K]ᵀ with trans_b.

    Accumulates in f32 and returns out_dtype: a.dtype by default, f32
    with acc_in_out. acc_in_out with a bf16 out_dtype runs the dual
    epilogue (f32 accumulator and bf16 copy) and returns the bf16 copy,
    as the JAX function does. Inputs of two dtypes are promoted to one.
    A CPU tensor takes matmul_ref; a CUDA tensor launches the kernel
    (f32 or bf16 inputs; f32 or bf16 output)."""
    out_dtype = _out_dtype(a, out_dtype, acc_in_out)
    M, K = a.shape
    N = b.shape[0] if trans_b else b.shape[1]
    if (b.shape[1] if trans_b else b.shape[0]) != K:
        raise ValueError(f"matmul: a {tuple(a.shape)} and b {tuple(b.shape)}"
                         f" (trans_b={trans_b}) do not contract")
    if a.device.type == "cpu":
        return matmul_ref(a, b, trans_b=trans_b).to(out_dtype)
    _build.check_cuda(a, b)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"matmul writes float32 or bfloat16, not {out_dtype}")
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = _build.aligned(a.to(dt)), _build.aligned(b.to(dt))
    c32 = (torch.empty(M, N, device=a.device)
           if acc_in_out or out_dtype == torch.float32 else None)
    c16 = (torch.empty(M, N, device=a.device, dtype=torch.bfloat16)
           if out_dtype == torch.bfloat16 else None)
    _build.launch("tk_matmul", a.data_ptr(), b.data_ptr(),
                  None if c32 is None else c32.data_ptr(),
                  None if c16 is None else c16.data_ptr(), M, N, K,
                  int(trans_b), _build.dtype_code(a), _build.stream(a))
    matmul.launches += 1
    return c16 if c16 is not None else c32


matmul.launches = 0


def matmul_ref(a, b, *, trans_b=False):
    """f32 torch.matmul of the f32-cast inputs."""
    bf = b.float()
    return torch.matmul(a.float(), bf.T if trans_b else bf)
