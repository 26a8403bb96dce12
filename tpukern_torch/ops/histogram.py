"""Histogram: an int32 bincount over [0, num_bins)
(tpukern/ops/histogram.py).

Kernel: csrc/histogram.cu (#41, replaces histogram.py:47 `kernel`): each
warp counts its values into a histogram of its own in shared memory with
atomicAdd (one a block above 7264 bins), then the block adds its
non-zero bins to the output with global atomicAdd; above 58112 bins (227
KB) the counts go straight to global atomics. `block_rows` (the
TPU's 128-value rows a grid step) is the values a block takes a step,
128 block_rows: a power of two from 8 to 128 here. Integer atomics are
exact in any order, so the counts equal the plain version's.

Values outside [0, num_bins) are never counted, negatives included, as
the TPU kernel pads with -1 so that they are not (histogram.py:40) and
as `histogram_sorted` counts. `histogram_ref`, the counterpart of JAX's
jnp.bincount, clips negatives into bin 0; the variants' plain version
(`histogram_plain`, the registry's `ref`) does not. Integer inputs of
any width are narrowed to int32 first (on the device), as JAX's
`astype(int32)`. `histogram_sorted` is XLA's sort and searchsorted in
JAX, and torch.sort and torch.searchsorted here: a baseline, no kernel.

On a CPU tensor `histogram` returns its plain version.
"""

import torch

from tpukern_torch import _build
from tpukern_torch.core.registry import register

_BLOCK_ROWS = (8, 16, 32, 64, 128)


def _check(x, num_bins, block_rows=32):
    if x.dtype.is_floating_point or x.dtype.is_complex \
            or x.dtype == torch.bool:
        raise TypeError(f"histogram: integer values, got {x.dtype}")
    if not isinstance(num_bins, int) or not 0 < num_bins < 2 ** 31:
        raise ValueError(f"histogram: num_bins must be an int in [1, 2^31), "
                         f"got {num_bins!r}")
    if block_rows not in _BLOCK_ROWS:
        raise ValueError(f"histogram: block_rows one of {_BLOCK_ROWS}, got "
                         f"{block_rows!r}")


def histogram(x, num_bins, block_rows=32):
    """Counts of the values of x in [0, num_bins), int32 (#41). CPU:
    histogram_plain."""
    _check(x, num_bins, block_rows)
    if x.device.type == "cpu":
        return histogram_plain(x, num_bins, block_rows)
    _build.check_cuda(x)
    v = _build.aligned(x.reshape(-1).to(torch.int32))
    out = torch.zeros(num_bins, dtype=torch.int32, device=x.device)
    _build.launch("tk_histogram", v.data_ptr(), v.numel(), out.data_ptr(),
                  num_bins, block_rows, _build.stream(v))
    histogram.launches += 1
    return out


histogram.launches = 0


def _count(v, num_bins):
    """int32 counts of the int64 values v in [0, num_bins), the others
    sent to a bin past the end (no host sync)."""
    idx = torch.where((v >= 0) & (v < num_bins), v, num_bins)
    counts = torch.zeros(num_bins + 1, dtype=torch.int64, device=v.device)
    return counts.scatter_add_(0, idx, torch.ones_like(idx))[
        :num_bins].to(torch.int32)


def histogram_plain(x, num_bins, block_rows=32):
    _check(x, num_bins, block_rows)
    return _count(x.reshape(-1).to(torch.int32).long(), num_bins)


def histogram_sorted(x, num_bins):
    """The sort-based tier (histogram.py:76-83): sort, searchsorted of
    the bin edges, diff."""
    _check(x, num_bins)
    xs = torch.sort(x.reshape(-1).to(torch.int32)).values
    edges = torch.arange(num_bins + 1, dtype=torch.int32, device=x.device)
    return torch.diff(torch.searchsorted(xs, edges, side="left")).to(
        torch.int32)


def histogram_ref(x, num_bins):
    """JAX's histogram_ref, jnp.bincount: negatives counted in bin 0,
    values from num_bins on dropped."""
    _check(x, num_bins)
    return _count(x.reshape(-1).to(torch.int32).long().clamp_min(0), num_bins)


def _bytes(x, num_bins, **_):
    # the values read once (as int32), the bins written once
    return 4 * x.numel() + 4 * num_bins


register("histogram", "histogram_i32", ref=histogram_plain,
         bytes_moved=_bytes)(
    lambda x, num_bins, **kw: histogram(x, num_bins, **kw))
register("histogram", "histogram_i32_r128",
         ref=lambda x, num_bins: histogram_plain(x, num_bins, 128),
         bytes_moved=_bytes)(
    lambda x, num_bins, **kw: histogram(x, num_bins, block_rows=128, **kw))
register("histogram", "histogram_i32_sorted", ref=histogram_plain,
         bytes_moved=_bytes, tags=("baseline",))(
    lambda x, num_bins: histogram_sorted(x, num_bins))
