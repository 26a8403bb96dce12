"""Shared elementwise kernel template (tpukern/ops/_ew.py).

`ew_call(op, *xs, scalars=())` applies one op of a fixed table (OPS) to
same-shape arrays and at most one scalar. Kernel: csrc/elementwise.cu,
which replaces the Pallas `kernel` of ew_call (_ew.py:57). Each op
computes in f32 by the JAX kernels' formulas (activations.py:23-57: elu
is exp(x) - 1, gelu the tanh form, hardshrink at 0.5; softmax.py:201,
205: exp_sub is exp(a - s), div the true division a / s) and rounds once
to the inputs' dtype. A scalar operand may be a CUDA tensor: the kernel
reads it from device memory, so a traced value (softmax_global's max
and sum) is never read back on the host.

The six-tier ladder keeps the JAX names (EW_TIERS, stamp_ew_variants).
On the TPU a tier is the block height in sublanes; on Hopper it is the
vector width of each thread's loads and stores, as in the reference's
f32 / f32x4 / f16 / f16x2 / f16x8_pack ladder:

    f32_r8   -> 1 f32 a thread (4 bytes)   bf16_r16  -> 1 bf16 (2 bytes)
    f32_r64  -> 2 f32 (8 bytes)            bf16_r128 -> 2 bf16 (4 bytes)
    f32_r256 -> 4 f32 (16 bytes)           bf16_r512 -> 8 bf16 (16 bytes)

Inputs keep their natural shape; the (rows, 128) lane padding of
`as_rows` is a Mosaic workaround that is not ported.
"""

import math

import torch

from tpukern_torch import _build
from tpukern_torch.core.registry import register

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def _sigmoid(a):
    return 1.0 / (1.0 + torch.exp(-a))


def _gelu(a):
    inner = _SQRT_2_OVER_PI * (a + 0.044715 * a * a * a)
    return 0.5 * a * (1.0 + torch.tanh(inner))


# name -> (csrc/elementwise.cu EwOp code, operands, plain f32 function)
OPS = {
    "add": (0, 2, lambda a, b: a + b),
    "mul": (1, 2, lambda a, b: a * b),
    "relu": (2, 1, lambda a: torch.where(a < 0, 0.0, a)),
    "elu": (3, 1, lambda a: torch.where(a > 0, a, torch.exp(a) - 1.0)),
    "gelu": (4, 1, _gelu),
    "sigmoid": (5, 1, _sigmoid),
    "swish": (6, 1, lambda a: a * _sigmoid(a)),
    "hardswish": (7, 1, lambda a: a * torch.clamp(a + 3.0, 0.0, 6.0) / 6.0),
    "hardshrink": (8, 1, lambda a: torch.where((a > 0.5) | (a < -0.5), a,
                                               0.0)),
    # softmax_global's two steps (tpukern/ops/softmax.py:201, 205); a true
    # division: a tensor divisor (a CPU one too) is never turned into a
    # multiply by its reciprocal
    "exp_sub": (9, 2, lambda a, s: torch.exp(a - s)),
    "div": (10, 2, lambda a, s: a / s),
}

# (suffix, dtype, elements a thread loads and stores) — the 6-tier ladder
EW_TIERS = (
    ("f32_r8", torch.float32, 1),
    ("f32_r64", torch.float32, 2),
    ("f32_r256", torch.float32, 4),
    ("bf16_r16", torch.bfloat16, 1),
    ("bf16_r128", torch.bfloat16, 2),
    ("bf16_r512", torch.bfloat16, 8),
)
_VECS = {torch.float32: (1, 2, 4), torch.bfloat16: (1, 2, 8)}


def _check(op, xs, scalars):
    if op not in OPS:
        raise ValueError(f"ew_call: unknown op {op!r}; the table: "
                         f"{sorted(OPS)}")
    nargs = OPS[op][1]
    if not xs or len(scalars) > 1 or len(xs) + len(scalars) != nargs:
        raise ValueError(f"ew_call({op!r}) takes {nargs} operands, at most "
                         f"one a scalar: got {len(xs)} arrays and "
                         f"{len(scalars)} scalars")
    for x in xs[1:]:
        if x.shape != xs[0].shape or x.dtype != xs[0].dtype:
            raise ValueError(f"ew_call({op!r}): arrays of one shape and "
                             f"dtype, got {tuple(xs[0].shape)} "
                             f"{xs[0].dtype} and {tuple(x.shape)} {x.dtype}")


def ew_call(op, *xs, scalars=(), vec=None):
    """Apply the elementwise op `op` (a name of OPS) to the same-shape
    arrays xs and the scalars (at most one, passed last; a number or a
    0-d or 1-element tensor), in f32, rounded once to xs[0].dtype.

    A CPU tensor takes ew_ref; a CUDA tensor launches the kernel (f32 or
    bf16 arrays; vec, the elements a thread loads at once, defaults to
    16 bytes' worth)."""
    _check(op, xs, scalars)
    x0 = xs[0]
    if x0.device.type == "cpu":
        return ew_ref(op, *xs, scalars=scalars)
    _build.check_cuda(*xs)
    if x0.dtype not in _VECS:
        raise TypeError(f"ew_call takes float32 or bfloat16, got {x0.dtype}")
    vec = vec or _VECS[x0.dtype][-1]
    if vec not in _VECS[x0.dtype]:
        raise ValueError(f"ew_call: vec {vec} for {x0.dtype}, not one of "
                         f"{_VECS[x0.dtype]}")
    xs = [_build.aligned(x) for x in xs]
    s = (torch.as_tensor(scalars[0], dtype=torch.float32,
                         device=x0.device).reshape(1) if scalars else None)
    y = torch.empty_like(xs[0])
    _build.launch("tk_ew", OPS[op][0], xs[0].data_ptr(),
                  _build.ptr(xs[1] if len(xs) > 1 else None), _build.ptr(s),
                  y.data_ptr(), y.numel(), vec, _build.dtype_code(y),
                  _build.stream(y))
    ew_call.launches += 1
    return y


ew_call.launches = 0


def ew_ref(op, *xs, scalars=()):
    """ew_call's plain version: OPS[op] on the f32 casts, in x's dtype."""
    _check(op, xs, scalars)
    args = [x.float() for x in xs] + [
        torch.as_tensor(s, dtype=torch.float32, device=xs[0].device)
        for s in scalars]
    return OPS[op][2](*args).to(xs[0].dtype)


def _ew_bytes(nargs):
    def bytes_moved(*xs, **_):
        return (nargs + 1) * xs[0].numel() * xs[0].element_size()
    return bytes_moved


def stamp_ew_variants(family: str, opname: str):
    """Register the 6-tier variant ladder for one elementwise op."""
    nargs = OPS[opname][1]
    for suffix, dtype, vec in EW_TIERS:
        def fn(*xs, _dt=dtype, _vec=vec, **kw):
            return ew_call(opname, *(x.to(_dt) for x in xs), vec=_vec, **kw)

        def ref(*xs, _dt=dtype, **kw):
            return ew_ref(opname, *(x.to(_dt) for x in xs), **kw)

        register(family, f"{opname}_{suffix}", ref=ref,
                 bytes_moved=_ew_bytes(nargs),
                 doc=f"{opname} ({dtype}, {vec} a thread)")(fn)
