"""The parallel layer (tpukern/parallel): a mesh of ranks, the ten named
collectives and the ring collectives #45/#46.

Every rank of a port mesh lies on one device (`Mesh.on_device(n)`, the
card unless device="cpu"): the collectives are plain torch over the
ranks' shards, as JAX's are XLA collectives with no Pallas body, and the
ring collectives are hand-written kernels (csrc/ring.cu) that pass each
hop through the right neighbour's buffer and a flag in device memory.
`ring_all_reduce_grads` is the data-parallel gradient all-reduce.

Not ported yet (ROADMAP.md item 13): ring_attention (it needs
flash_attention's carry, item 5), ulysses_attention, all_gather_matmul,
matmul_reduce_scatter and tp_mlp, the pipeline, spmd_grads (with the
sharded train step), and ranks on distinct GPUs.
"""

from tpukern_torch.parallel.collectives import (
    p2p,
    broadcast,
    scatter,
    gather,
    reduce,
    all_reduce,
    all_gather,
    all_gather_object,
    reduce_scatter,
    all_to_all,
)
from tpukern_torch.parallel.mesh import Mesh
from tpukern_torch.parallel.ring_kernels import (
    ring_all_gather,
    ring_all_reduce_grads,
    ring_reduce_scatter,
)

__all__ = [
    "p2p", "broadcast", "scatter", "gather", "reduce", "all_reduce",
    "all_gather", "all_gather_object", "reduce_scatter", "all_to_all",
    "Mesh", "ring_all_gather", "ring_reduce_scatter",
    "ring_all_reduce_grads",
]
