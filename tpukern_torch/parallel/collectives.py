"""The ten named collectives (tpukern/parallel/collectives.py:31-117).

In the JAX package each is an XLA collective under shard_map with no
Pallas body, so here each stays plain torch over a mesh whose ranks
share one device (`mesh.Mesh`), as the port keeps plain whatever JAX
leaves to XLA. They are the yardstick of the ring kernels
(`ring_kernels.py`).

Conventions, as JAX's: every function takes (x, mesh, axis) where x is
a GLOBAL tensor whose dim 0 is (or will be) split over `axis`, rank r
holding rows [r * c, (r + 1) * c); the result is the global tensor that
shard_map's out_specs assemble: replicated results (out_specs=P()) once,
sharded ones (P(axis)) as the concatenation of the ranks' shards. `root`
is kept for API parity: every rank receives the result.
"""

import torch

from tpukern_torch.parallel.mesh import axis_size, check_device, shards


def _split(x, mesh, axis):
    check_device(x, mesh)
    return shards(x, mesh, axis)


def p2p(x, mesh, axis, shift=1):
    """Ring point-to-point: rank i's shard moves to rank (i + shift) % n."""
    xs = _split(x, mesh, axis)
    n = len(xs)
    return torch.cat([xs[(i - shift) % n] for i in range(n)])


def broadcast(x, mesh, axis, root=0):
    """Every rank receives shard `root`, which must hold one row (JAX
    squeezes it); returns it without that dim."""
    xs = _split(x, mesh, axis)
    if xs[root].shape[0] != 1:
        raise ValueError(f"broadcast: a shard of {xs[root].shape[0]} rows "
                         "cannot be squeezed (JAX's shards hold one row)")
    return xs[root][0].clone()


def scatter(x, mesh, axis):
    """Shard a replicated tensor over `axis` (the inverse of all_gather).
    A resharding, as in JAX: the global values are x's."""
    _split(x, mesh, axis)
    return x.clone()


def gather(x, mesh, axis, root=0):
    """Collect all shards (every rank gets the result; `root` parity)."""
    return all_gather(x, mesh, axis)


def reduce(x, mesh, axis, op="sum", root=0):
    """Reduce shards elementwise (result replicated; `root` parity)."""
    return all_reduce(x, mesh, axis, op=op)


_REDUCE = {"sum": lambda t: t.sum(0), "max": lambda t: t.amax(0),
           "min": lambda t: t.amin(0)}


def all_reduce(x, mesh, axis, op="sum"):
    """Elementwise reduction over the ranks: a shard of one row is that
    rank's operand, a taller shard contributes the sum of its rows (as
    JAX's local sum before the psum)."""
    if op not in _REDUCE:
        raise ValueError(f"all_reduce: op sum, max or min, got {op!r}")
    local = [s[0] if s.shape[0] == 1 else s.sum(0)
             for s in _split(x, mesh, axis)]
    return _REDUCE[op](torch.stack(local))


def all_gather(x, mesh, axis):
    """Concatenate all shards along dim 0 on every rank: x's values."""
    return torch.cat(_split(x, mesh, axis))


def all_gather_object(tree, mesh, axis):
    """all_gather over every tensor of a nested dict, list or tuple."""
    if isinstance(tree, dict):
        return {k: all_gather_object(v, mesh, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(all_gather_object(v, mesh, axis) for v in tree)
    return all_gather(tree, mesh, axis)


def reduce_scatter(x, mesh, axis, op="sum"):
    """Sum the ranks' operands and leave rank r the r-th 1/n of the sum.
    x is (n, M, ...) or (n * M, ...), n stacked (M, ...) operands; the
    result is the (M, ...) sum, rank r's rows [r * M / n, ...)."""
    if op != "sum":
        raise ValueError("reduce_scatter: psum_scatter is a sum")
    check_device(x, mesh)
    n = axis_size(mesh, axis)
    ops = x if x.shape[0] == n else x.reshape(n, -1, *x.shape[1:])
    if ops.dim() < 2 or ops.shape[1] % n:
        raise ValueError(f"reduce_scatter: operands of shape "
                         f"{tuple(ops.shape[1:])} do not split {n} ways")
    return ops.sum(0)


def all_to_all(x, mesh, axis):
    """Rank i sends the j-th of its n column chunks to rank j, which
    stacks what it receives by sender. x is global (n * r, n * M, ...);
    the result is (n * n * r, M, ...), rank i's rows i * n * r onwards."""
    check_device(x, mesh)
    n = axis_size(mesh, axis)
    if x.dim() < 2 or x.shape[0] % n or x.shape[1] % n:
        raise ValueError(f"all_to_all: shape {tuple(x.shape)} does not "
                         f"split {n} ways on dims 0 and 1")
    r, m = x.shape[0] // n, x.shape[1] // n
    rest = tuple(range(4, x.dim() + 2))
    y = x.reshape(n, r, n, m, *x.shape[2:]).permute(2, 0, 1, 3, *rest)
    return y.reshape(n * n * r, m, *x.shape[2:])
