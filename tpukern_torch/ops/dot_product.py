"""Dot product sum(a * b) with f32 accumulation (tpukern/ops/dot_product.py).

Kernel: #32, the dot mode of csrc/reduce.cu, which replaces the Pallas
`kernel` of dot_prod (dot_product.py:27): per-block partials, then one
block, in a fixed order. The result is a 0-d f32 tensor on the inputs'
device. f16 inputs are storage-only, as in JAX: products and sums in
f32. The _r suffixes are the TPU's block heights; on Hopper they are
aliases of one kernel instance.
"""

import torch

from tpukern_torch.core.registry import register
from tpukern_torch.ops.reduce import _launch


def dot_prod(a, b, acc_dtype=torch.float32):
    """sum(a * b) over every element, a and b of one shape and dtype (f32,
    bf16 or f16). A CPU tensor takes dot_prod_ref; a CUDA tensor launches
    the kernel (f32 accumulator)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"dot_prod: a {tuple(a.shape)} {a.dtype} and b "
                         f"{tuple(b.shape)} {b.dtype}")
    if a.device.type == "cpu":
        return dot_prod_ref(a, b).to(acc_dtype)
    if acc_dtype != torch.float32 or a.dtype not in (
            torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"dot_prod takes f32, bf16 or f16 inputs and an f32 "
                        f"accumulator, got {a.dtype} and {acc_dtype}")
    out = _launch(a, b, "dot", acc_dtype)
    dot_prod.launches += 1
    return out


dot_prod.launches = 0


def dot_prod_ref(a, b):
    return (a.float() * b.float()).sum()


_VARIANTS = [
    ("f32_f32_r8", torch.float32),
    ("f32_f32_r64", torch.float32),
    ("bf16_f32_r16", torch.bfloat16),
    ("bf16_f32_r128", torch.bfloat16),
    ("f16_f32_r16", torch.float16),
]

for _sfx, _in in _VARIANTS:
    register("dot_product", f"dot_{_sfx}",
             ref=lambda a, b, _in=_in: dot_prod_ref(a.to(_in), b.to(_in)),
             bytes_moved=lambda a, b: 2 * a.numel() * a.element_size())(
        lambda a, b, _in=_in: dot_prod(a.to(_in), b.to(_in)))
