"""Ring collectives by hand-written kernels (tpukern/parallel/ring_kernels.py).

The JAX package's kernels DMA each chunk to the right neighbour's VMEM
with `make_async_remote_copy` and wait on DMA semaphores, n - 1 hops a
collective. Here every rank of the mesh lies on one card
(`mesh.Mesh.on_device`): csrc/ring.cu runs all the ranks in one
cooperative launch, and a hop is plain stores into the right neighbour's
buffer followed by a flag in device memory (the note in ring.cu gives the
design):

- #45 `ring_all_gather` (replaces ring_kernels.py:28 `_ag_kernel`):
  every rank ends with every rank's chunk; any dtype (bytes are copied).
- #46 `ring_reduce_scatter` (replaces :73 `_rs_kernel`): rank r ends with
  the sum over ranks of chunk r of their operands, added in the TPU
  kernel's ring order (chunk c starts at rank c + 1 and rank c adds
  last), every add rounded in x's dtype; f32, bf16 and f16.
- `ring_all_reduce_grads`: the reduce-scatter, then the all-gather of its
  result: the data-parallel gradient all-reduce.

Each function keeps JAX's signature `(x, mesh, axis="x")` and returns
what JAX's returns, the global tensor; with `ranks=True` it returns every
rank's own output buffer instead, stacked on a new dim 0, so that a
caller can check each rank's copy. JAX's asserts raise ValueError.

A CPU tensor takes the plain versions (`*_plain`), which walk the ring
hop by hop in torch in the kernels' order; a CUDA tensor launches the
kernel or raises. `ring_all_gather.launches` and
`ring_reduce_scatter.launches` count the launches.
"""

import torch

from tpukern_torch import _build
from tpukern_torch.parallel.mesh import axis_size, check_device, shards

RS_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
MAX_RANKS = 64  # csrc/ring.cu RING_MAX_RANKS
# the scratch of one stream: data flags and done counts for SLOT_BLOCKS
# (rank, block) pairs, the most that can be resident (132 SMs x 8 blocks of
# 256 threads), and two 16 KiB tiles (csrc/ring.cu RING_TILE_BYTES) each
SLOT_BLOCKS = 1056
TILE_BYTES = 16384


def _epoch(x, mesh, n, chunk):
    """(flags, slots, base) of the mesh's scratch on x's stream for one
    call (one set a stream, so two calls in flight never share one). The
    call posts flag values base + 1 ... base + n (chunk + 1) at most (a
    block sends at most one message a tile and hop, fewer tiles than
    elements), so the next call starts past all of them."""
    key = (x.device.index, _build.stream(x))
    s = mesh.ring_scratch.get(key)
    if s is None:
        s = mesh.ring_scratch[key] = [
            torch.zeros(2 * SLOT_BLOCKS, dtype=torch.int64, device=x.device),
            torch.empty(SLOT_BLOCKS * 2 * TILE_BYTES, dtype=torch.uint8,
                        device=x.device), 0]
    base = s[2]
    s[2] += n * (chunk + 1)
    return s[0], s[1], base


def _check_mesh(x, mesh, axis):
    check_device(x, mesh)
    n = axis_size(mesh, axis)
    if x.device.type == "cuda" and n > MAX_RANKS:
        raise ValueError(f"the ring kernels take at most {MAX_RANKS} ranks, "
                         f"got {n}")
    return n


def _check_rs(x, mesh, axis):
    n = _check_mesh(x, mesh, axis)
    # ring_kernels.py:113
    if x.dim() < 2 or x.shape[0] != n or x.shape[1] % n:
        raise ValueError(f"ring_reduce_scatter: x (n, R, ...) with n = {n} "
                         f"and R % n == 0, got {tuple(x.shape)}")
    if x.dtype not in RS_DTYPES:
        raise TypeError(f"ring_reduce_scatter takes float32, bfloat16 or "
                        f"float16, got {x.dtype}")
    return n


def ring_all_gather(x, mesh, axis="x", *, ranks=False):
    """All-gather the rows of x (dim 0 split over `axis`, rank r holding
    rows [r c, (r + 1) c)) by a ring of n - 1 hops (#45). Returns the
    gathered (n c, ...) tensor, or with ranks=True every rank's copy,
    (n, n c, ...). CPU: ring_all_gather_plain."""
    n = _check_mesh(x, mesh, axis)
    shards(x, mesh, axis)
    if x.device.type == "cpu":
        return ring_all_gather_plain(x, mesh, axis, ranks=ranks)
    _build.check_cuda(x)
    x = x.contiguous()
    out = torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
    chunk_bytes = x.numel() // n * x.element_size()
    if chunk_bytes:
        flags, _, base = _epoch(x, mesh, n, chunk_bytes)
        _build.launch("tk_ring_all_gather", x.data_ptr(), out.data_ptr(),
                      flags.data_ptr(), n, chunk_bytes, base, SLOT_BLOCKS,
                      _build.stream(x))
        ring_all_gather.launches += 1
    return out if ranks else out[0]


ring_all_gather.launches = 0


def ring_reduce_scatter(x, mesh, axis="x", *, ranks=False):
    """Reduce-scatter (sum) of x (n, R, ...), rank j's full operand x[j]
    (e.g. its gradients), by a ring of n - 1 hops (#46): rank r ends with
    sum_j x[j, r c:(r + 1) c], c = R / n, added in ring order. Returns
    the (R, ...) tensor of the ranks' results, or with ranks=True (n, c,
    ...), which is the same buffer. With one rank this returns x[0], the
    sum of one operand (JAX's kernel writes no output at n = 1: its hop
    loop is empty; ROADMAP.md §3). CPU: ring_reduce_scatter_plain."""
    n = _check_rs(x, mesh, axis)
    if x.device.type == "cpu":
        return ring_reduce_scatter_plain(x, mesh, axis, ranks=ranks)
    _build.check_cuda(x)
    x = x.contiguous()
    c = x.shape[1] // n
    out = torch.empty((n, c, *x.shape[2:]), dtype=x.dtype, device=x.device)
    chunk = out.numel() // n
    if chunk:
        flags, slots, base = _epoch(x, mesh, n, chunk)
        _build.launch("tk_ring_reduce_scatter", x.data_ptr(), out.data_ptr(),
                      slots.data_ptr(), flags.data_ptr(), n, chunk,
                      _build.CODES[x.dtype], base, SLOT_BLOCKS,
                      _build.stream(x))
        ring_reduce_scatter.launches += 1
    return out if ranks else out.reshape(x.shape[1:])


ring_reduce_scatter.launches = 0


def ring_all_reduce_grads(x, mesh, axis="x", *, ranks=False):
    """All-reduce (sum) of the ranks' operands x (n, R, ...): the ring
    reduce-scatter, then the ring all-gather of its result, the 2 (n - 1)
    hop schedule. Returns the (R, ...) sum, or with ranks=True every
    rank's copy, (n, R, ...)."""
    shard = ring_reduce_scatter(x, mesh, axis)
    return ring_all_gather(shard, mesh, axis, ranks=ranks)


def ring_all_gather_plain(x, mesh, axis="x", *, ranks=False):
    """#45's plain version: each hop, every rank forwards the chunk it
    received last (its own first) to its right neighbour, which writes it
    at the chunk's position."""
    n = _check_mesh(x, mesh, axis)
    xs = torch.stack(shards(x, mesh, axis))      # rank r's chunk
    m = torch.arange(n, device=x.device)
    out = torch.empty((n, *xs.shape), dtype=x.dtype, device=x.device)
    out[m, m] = xs
    buf = xs
    for step in range(n - 1):
        buf = buf.roll(1, 0)                     # rank r receives r - 1's
        out[m, (m - step - 1) % n] = buf
    out = out.reshape(n, *x.shape)
    return out if ranks else out[0]


def ring_reduce_scatter_plain(x, mesh, axis="x", *, ranks=False):
    """#46's plain version: rank r first sends its slice of chunk r - 1;
    each hop, every rank adds its own slice to the partial sum it
    received (one add in x's dtype) and forwards it, and after n - 1 hops
    rank r holds chunk r (ring_kernels.py:80-102)."""
    n = _check_rs(x, mesh, axis)
    c = x.shape[1] // n
    xs = x.reshape(n, n, c, *x.shape[2:])        # [rank, chunk]
    m = torch.arange(n, device=x.device)
    buf = xs[m, (m - 1) % n]
    for step in range(n - 1):
        buf = buf.roll(1, 0) + xs[m, (m + n - 2 - step) % n]
    return buf if ranks else buf.reshape(x.shape[1:])


def ring_all_reduce_grads_plain(x, mesh, axis="x", *, ranks=False):
    """The plain reduce-scatter, then the plain all-gather."""
    return ring_all_gather_plain(ring_reduce_scatter_plain(x, mesh, axis),
                                 mesh, axis, ranks=ranks)
