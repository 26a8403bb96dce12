"""Transpose: out[j, i] = x[i, j] (tpukern/ops/transpose.py).

Kernel: csrc/transpose.cu (#42, replaces transpose.py:39 `kernel`), for
f32 and bf16. A warp reads along the rows of x and writes along the rows
of out through a shared-memory tile: f32 32 x 32 padded to 33 columns,
bf16 64 x 64 as 4-byte words with an XOR swizzle (a pad cannot spread a
column of value pairs over the banks). The TPU block (bm, bn) is a
super-tile: a group of consecutive CUDA blocks, one tile each, and
`order` maps the groups to super-tiles as JAX's index maps map grid steps
to blocks (row, col, or diag: tile (i, j) -> ((i + j) % nI, j)). bm and
bn are multiples of 64, the bf16 tile. The result is bit-equal to x.T.

On a CPU tensor `transpose` returns its plain version.
"""

import torch

from tpukern_torch import _build
from tpukern_torch.core.registry import register

_ORDERS = {"row": 0, "col": 1, "diag": 2}
_DTYPES = (torch.float32, torch.bfloat16)


def _check(x, block, order):
    if x.dim() != 2:
        raise ValueError(f"transpose: x (M, N), got {tuple(x.shape)}")
    if order not in _ORDERS:
        raise ValueError(order)
    if (len(block) != 2 or not all(isinstance(b, int) and b > 0 and b % 64 == 0
                                   for b in block)):
        raise ValueError(f"transpose: block (bm, bn), positive multiples of "
                         f"64, got {block!r}")


def transpose(x, block=(128, 128), order="row"):
    """x.T of an (M, N) f32 or bf16 matrix (#42), (bm, bn) super-tiles
    walked in `order`. CPU: transpose_plain."""
    _check(x, block, order)
    if x.device.type == "cpu":
        return transpose_plain(x, block, order)
    _build.check_cuda(x)
    if x.dtype not in _DTYPES:
        raise TypeError(f"transpose takes float32 or bfloat16, got {x.dtype}")
    x = x.contiguous()
    M, N = x.shape
    out = torch.empty((N, M), dtype=x.dtype, device=x.device)
    _build.launch("tk_transpose", x.data_ptr(), out.data_ptr(), M, N,
                  block[0], block[1], _ORDERS[order], _build.CODES[x.dtype],
                  _build.stream(x))
    transpose.launches += 1
    return out


transpose.launches = 0


def transpose_plain(x, block=(128, 128), order="row"):
    _check(x, block, order)
    return x.t().contiguous()


_F32, _BF16 = torch.float32, torch.bfloat16

# transpose.py:76-85
_VARIANTS = [
    ("f32_row", _F32, (128, 128), "row"),
    ("f32_col", _F32, (128, 128), "col"),
    ("f32_diag", _F32, (128, 128), "diag"),
    ("f32_row_b256", _F32, (256, 256), "row"),
    ("f32_row_b512", _F32, (512, 512), "row"),
    ("bf16_row", _BF16, (128, 128), "row"),
    ("bf16_diag", _BF16, (128, 128), "diag"),
    ("bf16_row_b256", _BF16, (256, 256), "row"),
]

for _sfx, _dt, _blk, _ord in _VARIANTS:
    register("transpose", f"transpose_{_sfx}",
             ref=lambda x, _dt=_dt, _blk=_blk, _ord=_ord: transpose_plain(
                 x.to(_dt), _blk, _ord))(
        lambda x, _dt=_dt, _blk=_blk, _ord=_ord: transpose(
            x.to(_dt), _blk, _ord))
