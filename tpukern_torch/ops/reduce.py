"""Full-array reductions: the block_all_reduce dtype/accumulator matrix
(tpukern/ops/reduce.py).

Kernel: csrc/reduce.cu (#31), which replaces the Pallas `kernel` of
_reduce_all (reduce.py:68): per-block partials, then one block, in a
fixed order, so a call repeats bit for bit. The result is a 0-d tensor
on the input's device: nothing is read back on the host.

JAX's dtype policy is kept so that the port can be held to it:
f16 and fp8 are storage-only (tpukern/core/config.py:24-45), so those
inputs, and an f16 accumulator, sum in f32 and round once at the end; a
bf16 accumulator is a real bf16 accumulator (each add rounds to bf16);
i8 sums into int32 exactly. The TPU's block heights (the _r8 ... _r512
suffixes) have no counterpart on Hopper, where every thread loads 16
bytes at a time: those names are aliases of one kernel instance.
"""

import torch

from tpukern_torch import _build
from tpukern_torch.core.registry import register

# 4-byte partials pass 1 writes at most (csrc/reduce.cu MAX_PARTIALS)
PARTIALS = 1024
_MODES = {"sum": 0, "max": 1, "dot": 2}
_FLOAT_IN = (torch.float32, torch.bfloat16, torch.float16,
             torch.float8_e4m3fn, torch.float8_e5m2)
_ACCS = (torch.float32, torch.float16, torch.bfloat16, torch.int32)


def _launch(x, y, mode, acc_dtype):
    """One launch of tk_reduce; returns the 0-d result in acc_dtype."""
    _build.check_cuda(*(t for t in (x, y) if t is not None))
    ints = x.dtype == torch.int8
    if (x.dtype not in _FLOAT_IN and not ints) or acc_dtype not in _ACCS \
            or ints != (acc_dtype == torch.int32):
        raise TypeError(f"{mode}: input {x.dtype} with accumulator "
                        f"{acc_dtype} (int8 needs int32, floats f32, f16 "
                        f"or bf16)")
    xs = _build.aligned(x.reshape(-1))
    ys = None if y is None else _build.aligned(y.reshape(-1))
    part = torch.empty(PARTIALS, dtype=torch.int32, device=x.device)
    out = torch.empty((), dtype=acc_dtype, device=x.device)
    _build.launch("tk_reduce", xs.data_ptr(), _build.ptr(ys),
                  part.data_ptr(), out.data_ptr(), xs.numel(), _MODES[mode],
                  _build.CODES[x.dtype], _build.CODES[acc_dtype],
                  _build.stream(xs))
    return out


def _reduce_all(x, *, mode, acc_dtype):
    """Reduce every element of x to a 0-d tensor (mode "sum" or "max")."""
    if x.device.type == "cpu":
        return (sum_all_ref if mode == "sum" else max_all_ref)(x, acc_dtype)
    out = _launch(x, None, mode, acc_dtype)
    _reduce_all.launches += 1
    return out


_reduce_all.launches = 0


def sum_all(x, acc_dtype=torch.float32):
    return _reduce_all(x, mode="sum", acc_dtype=acc_dtype)


def max_all(x, acc_dtype=torch.float32):
    return _reduce_all(x, mode="max", acc_dtype=acc_dtype)


def sum_all_ref(x, acc_dtype=torch.float32):
    """JAX's _ref_sum: the sum of x in acc_dtype, taken in f32 (in int64
    for int32) and rounded once."""
    if acc_dtype == torch.int32:
        return x.to(torch.int64).sum().to(torch.int32)
    return x.float().to(acc_dtype).float().sum().to(acc_dtype)


def max_all_ref(x, acc_dtype=torch.float32):
    """JAX's _ref_max: the largest element, in acc_dtype."""
    if acc_dtype == torch.int32:
        return x.to(torch.int32).max()
    return x.float().max().to(acc_dtype)


_F32, _BF16, _F16 = torch.float32, torch.bfloat16, torch.float16
_E4, _E5, _I8, _I32 = (torch.float8_e4m3fn, torch.float8_e5m2, torch.int8,
                       torch.int32)

# (variant suffix, in dtype, acc dtype) — JAX's 20-variant matrix
# (reduce.py:117-141), the block heights kept in the names
_SUM_VARIANTS = [
    ("f32_f32_r8", _F32, _F32), ("f32_f32_r64", _F32, _F32),
    ("f32_f32_r256", _F32, _F32), ("bf16_bf16_r16", _BF16, _BF16),
    ("bf16_f32_r16", _BF16, _F32), ("bf16_f32_r128", _BF16, _F32),
    ("bf16_f32_r512", _BF16, _F32), ("f16_f16_r16", _F16, _F16),
    ("f16_f32_r16", _F16, _F32), ("f16_f32_r128", _F16, _F32),
    ("i8_i32_r32", _I8, _I32), ("i8_i32_r256", _I8, _I32),
    ("fp8e4m3_f16_r32", _E4, _F16), ("fp8e4m3_f32_r32", _E4, _F32),
    ("fp8e5m2_f16_r32", _E5, _F16), ("fp8e5m2_f32_r32", _E5, _F32),
]

_MAX_VARIANTS = [
    ("f32_f32_r64", _F32, _F32), ("bf16_f32_r128", _BF16, _F32),
    ("f16_f32_r128", _F16, _F32), ("i8_i32_r256", _I8, _I32),
]


def _nbytes(x, *_, **__):
    return x.numel() * x.element_size()


for _sfx, _in, _acc in _SUM_VARIANTS:
    register("reduce", f"sum_{_sfx}",
             ref=lambda x, _in=_in, _acc=_acc: sum_all_ref(x.to(_in), _acc),
             bytes_moved=_nbytes,
             tags=("storage-only",) if "fp8" in _sfx or "f16_" in _sfx
             else ())(
        lambda x, _in=_in, _acc=_acc: sum_all(x.to(_in), acc_dtype=_acc))

for _sfx, _in, _acc in _MAX_VARIANTS:
    register("reduce", f"max_{_sfx}",
             ref=lambda x, _in=_in, _acc=_acc: max_all_ref(x.to(_in), _acc),
             bytes_moved=_nbytes)(
        lambda x, _in=_in, _acc=_acc: max_all(x.to(_in), acc_dtype=_acc))
