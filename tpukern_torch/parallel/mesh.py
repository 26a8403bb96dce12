"""A mesh of ranks: the counterpart of `jax.sharding.Mesh` as the JAX
package uses it (tpukern/parallel/*.py take `(x, mesh, axis)`).

A `Mesh` names its axes (`axis_names`), gives each axis its size
(`mesh.shape[axis]`, as JAX's) and holds a device for each rank. The
port runs every rank of a mesh on one device: `Mesh.on_device(8)` is
eight ranks on the card, `device="cpu"` eight on the CPU (the tests'
plain versions). Each rank's buffers are then distinct tensors on that
device, and the ring kernels (`ring_kernels.py`) pass messages between
them through device memory.

A mesh whose ranks lie on distinct devices raises NotImplementedError:
the ranks would need peer pointers across GPUs (or NVLink collectives),
which ROADMAP.md item 13 leaves for a host with more than one GPU. It
never gathers such ranks onto one card.

`shards(x, mesh, axis)` gives each rank its view of a global tensor as
shard_map's `in_specs=P(axis)` does: rank r's rows of dim 0.
"""

import numpy as np
import torch


class Mesh:
    """Ranks laid out over named axes, all on one device.

    devices: a nested sequence (or array) of devices, one per rank,
    shaped like the mesh (as `jax.sharding.Mesh(devices, axis_names)`);
    axis_names: one name per dimension of `devices`."""

    def __init__(self, devices, axis_names=("x",)):
        grid = np.array(devices, dtype=object)
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(f"Mesh: {grid.ndim}-d devices, "
                             f"{len(axis_names)} axis names {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"Mesh: repeated axis names {axis_names}")
        if grid.size == 0:
            raise ValueError("Mesh: no ranks")
        devs = {torch.device(d) for d in grid.flat}
        if len(devs) > 1:
            raise NotImplementedError(
                f"Mesh: ranks on distinct devices {sorted(map(str, devs))}; "
                "the port runs every rank of a mesh on one device (ranks on "
                "distinct GPUs need peer pointers or NVLink collectives: "
                "ROADMAP.md item 13)")
        self.devices = grid
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, grid.shape))
        self.device = devs.pop()
        # the ring kernels' flags, slots and epoch, one set a stream
        # (ring_kernels.py)
        self.ring_scratch = {}

    @classmethod
    def on_device(cls, n, axis_names=("x",), device="cuda"):
        """n ranks (an int, or a tuple of axis sizes) on one device."""
        return cls(np.full(n, torch.device(device), dtype=object),
                   axis_names)

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def axis_size(mesh, axis):
    if axis not in mesh.shape:
        raise ValueError(f"axis {axis!r} not in the mesh's axes "
                         f"{mesh.axis_names}")
    return mesh.shape[axis]


def check_device(x, mesh):
    """x must lie on the mesh's device (a "cuda" mesh takes any index)."""
    dev = mesh.device
    if x.device.type != dev.type or (dev.index is not None
                                     and x.device.index != dev.index):
        raise ValueError(f"tensor on {x.device}, mesh on {dev}")


def shards(x, mesh, axis):
    """Each rank's view of x as `in_specs=P(axis)` cuts it: rank r's
    rows [r * c, (r + 1) * c) of dim 0, c = x.shape[0] / n. Raises
    ValueError (as shard_map does) when n does not divide dim 0."""
    n = axis_size(mesh, axis)
    if x.dim() == 0 or x.shape[0] % n:
        raise ValueError(f"dim 0 of shape {tuple(x.shape)} does not split "
                         f"{n} ways over axis {axis!r}")
    return list(x.split(x.shape[0] // n))
