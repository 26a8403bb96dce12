"""GEMM: C = A·B or A·Bᵀ with f32 accumulation.

The port of tpukern/ops/matmul.py. Kernels: csrc/matmul.cu, one kernel
per input dtype (f32 on CUDA cores; bf16 on the tensor cores, by TMA and
wgmma through a multi-stage ring, csrc/hopper.cuh gemm_pipeline) whose
epilogue replaces the three Pallas bodies of `matmul` (matmul.py:140-172):
`kernel` writes the out dtype, `kernel_accio` the f32 accumulator,
`kernel_accio_dual` both; `matmul_kpipe` (:311, the K loop inside the
kernel) is the same function, and that kernel already loops over K, so
it launches it too. csrc/matmul_naive.cu replaces `matmul_naive`'s
kernel (:384), the naive rung of the registry's ladder: one output tile
a block with no K pipeline, bf16 on TMA and wgmma. The Mosaic
knobs (block sizes, swizzle, buffer_count, lookahead, input_fusion,
eager_store, jitter) and the v5e tile model `auto_blocks` are not
ported: the ladder's ksliced, pipelined, swizzled and stage names are
aliases of `matmul`.
"""

import torch

from tpukern_torch import _build
from tpukern_torch.core.registry import register


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
    (f32 or bf16 inputs; f32 or bf16 output). Counts launches, and bf16
    launches by load path in `path_launches` (tma_operands: "tma" both
    operands by TMA, "copy" neither, "mixed")."""
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
    if dt == torch.bfloat16:
        matmul.path_launches[load_path(tma_operands(a, b))] += 1
    return c16 if c16 is not None else c32


matmul.launches = 0
matmul.path_launches = dict.fromkeys(("tma", "copy", "mixed"), 0)


def matmul_ref(a, b, *, trans_b=False):
    """f32 torch.matmul of the f32-cast inputs."""
    bf = b.float()
    return torch.matmul(a.float(), bf.T if trans_b else bf)


def matmul_kpipe(a, b, *, out_dtype=None, trans_b=False):
    """matmul with its K loop inside the kernel (matmul.py:277): `matmul`'s
    function and kernel, which walks K inside each block."""
    c = matmul(a, b, trans_b=trans_b, out_dtype=out_dtype)
    if a.device.type != "cpu":
        matmul_kpipe.launches += 1
    return c


matmul_kpipe.launches = 0


def hgemm(a, b, *, trans_b=False, out_dtype=None):
    """The bf16 GEMM (matmul.py hgemm): bf16 inputs into matmul; an f32
    out_dtype takes the accumulator epilogue, as in JAX."""
    out_dtype = out_dtype or torch.bfloat16
    return matmul(a.to(torch.bfloat16), b.to(torch.bfloat16),
                  trans_b=trans_b, out_dtype=out_dtype,
                  acc_in_out=out_dtype == torch.float32)


def tma_operands(a, b):
    """(A by TMA, B by TMA): the load path the bf16 kernels' launchers
    (csrc/matmul_naive.cu, csrc/matmul.cu, and csrc/grouped_matmul.cu's
    tgmm for x and dy) take for each operand, by their one rule, from the
    dtypes, shapes and data_ptr() alignments of the (contiguous) row-major
    operands; matmul_naive and matmul count launches by it, tgmm_slabs
    plans by it. TMA takes a 16-byte aligned base and rows a multiple of
    16 bytes: shape[1] % 8 == 0 (K for A (M, K) and for a TN B (N, K), N
    for an NN B (K, N)). Any other operand is copied by the block's
    threads; the f32 tier has no TMA path."""
    if a.dtype != torch.bfloat16:
        return False, False
    return (a.shape[1] % 8 == 0 and a.data_ptr() % 16 == 0,
            b.shape[1] % 8 == 0 and b.data_ptr() % 16 == 0)


def load_path(tma):
    """The name of a launch's load paths (tma_operands' pair): "tma",
    "copy" or "mixed"."""
    return {(True, True): "tma", (False, False): "copy"}.get(tma, "mixed")


def matmul_naive(a, b):
    """C[M,N] = A[M,K] @ B[K,N], f32 accumulation, in A's dtype, with no K
    pipeline: bf16 on wgmma, each operand loaded by TMA or by the block's
    threads (tma_operands), f32 on CUDA-core FMAs. A CPU tensor takes
    matmul_naive_ref; a CUDA tensor launches the kernel (f32 or bf16, one
    dtype). Counts launches, and bf16 launches by path in
    `path_launches` ("tma": both operands by TMA, "copy": neither,
    "mixed")."""
    M, K = a.shape
    if b.shape[0] != K or a.dtype != b.dtype:
        raise ValueError(f"matmul_naive: a {tuple(a.shape)} {a.dtype} and b "
                         f"{tuple(b.shape)} {b.dtype}")
    if a.device.type == "cpu":
        return matmul_naive_ref(a, b)
    _build.check_cuda(a, b)
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty(M, b.shape[1], dtype=a.dtype, device=a.device)
    _build.launch("tk_matmul_naive", a.data_ptr(), b.data_ptr(), c.data_ptr(),
                  M, b.shape[1], K, _build.dtype_code(a), _build.stream(a))
    matmul_naive.launches += 1
    if a.dtype == torch.bfloat16:
        matmul_naive.path_launches[load_path(tma_operands(a, b))] += 1
    return c


matmul_naive.launches = 0
matmul_naive.path_launches = dict.fromkeys(("tma", "copy", "mixed"), 0)


def matmul_naive_ref(a, b):
    return matmul_ref(a, b).to(a.dtype)


def _flops(a, b):
    # the (M, K) x (K, N) ladder and hgemm_tn_bf16's (N, K) b alike
    return 2 * a.shape[0] * a.shape[1] * (
        b.shape[0] if b.shape[1] == a.shape[1] else b.shape[1])


_F32, _BF16 = torch.float32, torch.bfloat16


def _ladder(dt, trans_b=False, out=None, acc_in_out=False):
    """(fn, plain version) of a `matmul` tier: inputs cast to dt."""
    out = out or (_F32 if acc_in_out else dt)

    def fn(a, b):
        return matmul(a.to(dt), b.to(dt), trans_b=trans_b, out_dtype=out,
                      acc_in_out=acc_in_out)

    def ref(a, b):
        return matmul_ref(a.to(dt), b.to(dt), trans_b=trans_b).to(out)
    return fn, ref


def _naive(dt):
    return (lambda a, b: matmul_naive(a.to(dt), b.to(dt)),
            lambda a, b: matmul_naive_ref(a.to(dt), b.to(dt)))


def _baseline(dt):
    """torch.matmul (cuBLAS on the card), the XLA baselines' role."""
    return (lambda a, b: torch.matmul(a.to(dt), b.to(dt)),
            lambda a, b: matmul_ref(a.to(dt), b.to(dt)).to(dt))


# the registry ladder (matmul.py:522-588); hgemm_accbf16_bf16, hgemm_f16
# and qgemm_i8_i32 are in core.registry.PENDING
_LADDER = {
    "sgemm_naive_f32": _naive(_F32),
    "sgemm_ksliced_f32": _ladder(_F32),
    "sgemm_pipelined_f32": _ladder(_F32),
    "sgemm_swizzled_f32": _ladder(_F32),
    "hgemm_naive_bf16": _naive(_BF16),
    "hgemm_ksliced_bf16": _ladder(_BF16),
    "hgemm_stage_bk256_bf16": _ladder(_BF16),
    "hgemm_stage_bk512_bf16": _ladder(_BF16),
    "hgemm_stage_bk1024_bf16": _ladder(_BF16),
    "hgemm_swizzled_bf16": _ladder(_BF16),
    "hgemm_accio_bf16": _ladder(_BF16, out=_BF16, acc_in_out=True),
    "hgemm_accio_bf16_f32acc": _ladder(_BF16, acc_in_out=True),
    "sgemm_accio_f32": _ladder(_F32, acc_in_out=True),
    "hgemm_tn_bf16": _ladder(_BF16, trans_b=True),
}
for _name, (_fn, _ref) in _LADDER.items():
    register("matmul", _name, ref=_ref, flops=_flops)(_fn)
for _name, _dt in (("sgemm_xla_f32", _F32), ("hgemm_xla_bf16", _BF16)):
    _fn, _ref = _baseline(_dt)
    register("matmul", _name, ref=_ref, flops=_flops, tags=("baseline",))(_fn)
