"""The parallel layer of the port (tpukern_torch/parallel) against the JAX
package's (tpukern/parallel).

JAX's side runs on the conftest's 8 virtual CPU devices: its ring
kernels (#45 `_ag_kernel`, #46 `_rs_kernel`) in Pallas interpret mode on
a Mesh of the first n devices, its collectives as XLA collectives under
shard_map. The port's side is a Mesh of n ranks on the CPU, so the ring
functions take their plain versions, which walk the ring hop by hop in
the kernels' order. Inputs come from np.random.default_rng(seed).

- The ring functions equal JAX's bit for bit (torch.equal) in f32 and
  bf16 at n 2, 3 and 8, at tests/test_parallel.py's shapes ((64, 128)
  and (n, 64, 128); 66 rows at n = 3) and at a ragged chunk of 37 x 5
  elements: JAX's reduce-scatter adds in ring order, every add rounded
  in x's dtype, and so does the port.
- At n = 1 JAX's reduce-scatter never writes its output (its hop loop
  is empty; NaN in interpret mode, ROADMAP.md §3 open fault 3); the
  port returns x[0].
- The ten collectives match JAX's at tests/test_parallel.py's inputs,
  the sums at that file's 1e-5.
- The data-parallel gradient all-reduce of a 2-layer model's per-rank
  gradients equals JAX's ring on the same numbers and 4x the union
  batch's gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from tpukern.parallel import collectives as jax_coll
from tpukern.parallel import ring_kernels as jax_ring
from tpukern_torch import _build
from tpukern_torch import parallel
from tpukern_torch.models import Config, init_params, loss_fn, param_leaves
from tpukern_torch.parallel import collectives as coll
from tpukern_torch.parallel import ring_kernels as ring
from tpukern_torch.parallel.mesh import Mesh, shards

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
RING = {"all_gather": "ring_all_gather",
        "reduce_scatter": "ring_reduce_scatter",
        "all_reduce_grads": "ring_all_reduce_grads"}


def _meshes(n):
    return JaxMesh(np.array(jax.devices()[:n]), ("x",)), Mesh.on_device(
        n, device="cpu")


def _rows(n):
    """tests/test_parallel.py's 64 rows, or the nearest multiple of n."""
    return 64 if 64 % n == 0 else 66


def _ring_input(fn, n, shape, seed=0):
    rows, cols = (_rows(n), 128) if shape == "jax" else (37 * n, 5)
    full = (rows, cols) if fn == "all_gather" else (n, rows, cols)
    return np.random.default_rng(seed).standard_normal(full).astype(
        np.float32)


def _both(a, dt):
    tdt, jdt = DTYPES[dt]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


def _torch(jax_out, dtype):
    return torch.from_numpy(np.asarray(jax_out).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("shape", ["jax", "ragged"])
@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("fn", sorted(RING))
def test_ring_matches_jax(fn, dt, n, shape):
    jmesh, mesh = _meshes(n)
    x, xj = _both(_ring_input(fn, n, shape), dt)
    want = _torch(getattr(jax_ring, RING[fn])(xj, jmesh, "x"), x.dtype)
    got = getattr(ring, RING[fn])(x, mesh, "x")
    assert got.dtype == x.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    every = getattr(ring, RING[fn])(x, mesh, "x", ranks=True)
    if fn == "reduce_scatter":   # rank r holds rows r c ... of the result
        assert torch.equal(every.reshape(want.shape), want)
    else:                        # every rank holds the whole result
        assert every.shape == (n, *want.shape)
        assert all(torch.equal(copy, want) for copy in every)


def test_jax_reduce_scatter_writes_nothing_at_one_rank():
    """JAX's `_rs_kernel` loops `for step in range(n - 1)` and assigns its
    output inside the loop: at n = 1 it never does, and interpret mode
    returns the uninitialized (NaN) buffer; `ring_all_reduce_grads`
    inherits it. The port returns x[0], the sum of one operand."""
    jmesh, mesh = _meshes(1)
    a = np.random.default_rng(0).standard_normal((1, 6, 4)).astype(
        np.float32)
    x, xj = _both(a, "f32")
    assert not np.isfinite(np.asarray(
        jax_ring.ring_reduce_scatter(xj, jmesh, "x"))).any()
    assert not np.isfinite(np.asarray(
        jax_ring.ring_all_reduce_grads(xj, jmesh, "x"))).any()
    assert torch.equal(ring.ring_reduce_scatter(x, mesh), x[0])
    assert torch.equal(ring.ring_all_reduce_grads(x, mesh), x[0])
    # the all-gather is right at one rank on both sides
    assert torch.equal(ring.ring_all_gather(x[0], mesh), _torch(
        jax_ring.ring_all_gather(xj[0], jmesh, "x"), torch.float32))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_reduce_scatter_is_the_ring_order_not_sum(dt):
    """Chunk c is ((x[c+1][c] + x[c+2][c]) + ...) + x[c][c], indices mod n,
    spelled out here one add at a time; in bf16 that is not x.sum(0)
    (torch sums in f32 and rounds once), so a plain sum would fail."""
    n = 8
    x, _ = _both(_ring_input("reduce_scatter", n, "jax"), dt)
    xs = x.reshape(n, n, -1, x.shape[-1])
    want = []
    for c in range(n):
        acc = xs[(c + 1) % n, c]
        for k in range(2, n + 1):
            acc = acc + xs[(c + k) % n, c]
        want.append(acc)
    got = ring.ring_reduce_scatter(x, Mesh.on_device(n, device="cpu"))
    assert torch.equal(got, torch.cat(want))
    if dt == "bf16":
        assert not torch.equal(got, x.sum(0))


def test_data_parallel_grads_match_jax():
    """The slice as a whole: 4 ranks' gradients of a 2-layer model (one
    seeded batch each, the port's loss_fn on the CPU), flattened to x
    (4, R), reduced by JAX's ring and the port's: equal bit for bit, and
    4x the gradient of the union batch (the loss is a mean) within f32
    rounding."""
    n, S = 4, 16
    cfg = Config(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                 d_ff=64, max_seq=S)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_()
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (n, 2, S)))

    def grads(tokens, targets):
        loss = loss_fn(params, tokens, targets, cfg)
        return torch.cat([g.reshape(-1) for g in torch.autograd.grad(
            loss, leaves)])

    x = torch.stack([grads(toks[r, :1], toks[r, 1:]) for r in range(n)])
    R = -(-x.shape[1] // n) * n
    x = torch.nn.functional.pad(x, (0, R - x.shape[1]))
    jmesh, mesh = _meshes(n)
    want = _torch(jax_ring.ring_all_reduce_grads(jnp.asarray(x.numpy()),
                                                 jmesh, "x"), torch.float32)
    got = ring.ring_all_reduce_grads(x, mesh, ranks=True)
    assert all(torch.equal(copy, want) for copy in got)
    union = grads(toks[:, 0], toks[:, 1])
    torch.testing.assert_close(got[0, :union.numel()], n * union, rtol=1e-5,
                               atol=1e-6)


# ---- the ten collectives, at tests/test_parallel.py's inputs

def _collective_cases(n):
    rng = np.random.default_rng(42)
    f32 = np.float32
    return {
        "p2p": (dict(shift=1), np.arange(n * 4, dtype=f32).reshape(n, 4)),
        "p2p_shift3": (dict(shift=3), np.arange(n * 6, dtype=f32).reshape(
            2 * n, 3)),
        "broadcast": (dict(root=2), np.arange(n * 3, dtype=f32).reshape(
            n, 3)),
        "gather": ({}, rng.standard_normal((n * 2, 8)).astype(f32)),
        "all_gather": ({}, rng.standard_normal((n * 2, 8)).astype(f32)),
        "all_reduce": (dict(op="sum"), rng.standard_normal((n, 16)).astype(
            f32)),
        "all_reduce_rows": (dict(op="sum"), rng.standard_normal(
            (2 * n, 16)).astype(f32)),
        "reduce_max": (dict(op="max"), rng.standard_normal((n, 16)).astype(
            f32)),
        "reduce_min": (dict(op="min"), rng.standard_normal((n, 16)).astype(
            f32)),
        "reduce_scatter": ({}, rng.standard_normal((n, n * 4)).astype(f32)),
        "reduce_scatter_flat": ({}, rng.standard_normal((n * n * 4, 3)
                                                        ).astype(f32)),
        "all_to_all": ({}, np.arange(n * n * 2, dtype=f32).reshape(n, n * 2)),
        "all_to_all_3d": ({}, rng.standard_normal((2 * n, 2 * n, 3)).astype(
            f32)),
    }


COLLECTIVES = sorted(_collective_cases(8))


@pytest.mark.parametrize("case", COLLECTIVES)
def test_collective_matches_jax(case):
    n = 8
    jmesh, mesh = _meshes(n)
    kw, a = _collective_cases(n)[case]
    name = {"p2p_shift3": "p2p", "all_reduce_rows": "all_reduce",
            "reduce_max": "reduce", "reduce_min": "reduce",
            "reduce_scatter_flat": "reduce_scatter",
            "all_to_all_3d": "all_to_all"}.get(case, case)
    want = np.asarray(getattr(jax_coll, name)(jnp.asarray(a), jmesh, "x",
                                              **kw))
    got = getattr(coll, name)(torch.from_numpy(a), mesh, "x", **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if "reduce" not in case:  # data movement: exact
        np.testing.assert_array_equal(got, want)


def test_scatter_gather_and_object():
    n = 8
    jmesh, mesh = _meshes(n)
    a = np.random.default_rng(42).standard_normal((n * 2, 8)).astype(
        np.float32)
    x = torch.from_numpy(a)
    sharded = coll.scatter(x, mesh, "x")
    np.testing.assert_array_equal(sharded.numpy(), np.asarray(
        jax_coll.scatter(jnp.asarray(a), jmesh, "x")))
    assert torch.equal(coll.gather(sharded, mesh, "x"), x)
    tree = {"a": torch.arange(n * 2.0).reshape(n, 2),
            "b": [torch.ones(n, 3), (torch.zeros(2 * n),)]}
    jtree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
    want = jax_coll.all_gather_object(jtree, jmesh, "x")
    got = coll.all_gather_object(tree, mesh, "x")
    assert isinstance(got["b"], list) and isinstance(got["b"][1], tuple)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---- the asserts, the mesh and the dispatch

def test_jax_asserts_raise_value_error():
    jmesh, mesh = _meshes(4)
    bad = [np.zeros((3, 8, 2), np.float32),    # x.shape[0] != n
           np.zeros((4, 6, 2), np.float32)]    # R % n
    for a in bad:
        with pytest.raises(AssertionError):
            jax_ring.ring_reduce_scatter(jnp.asarray(a), jmesh, "x")
        for fn in (ring.ring_reduce_scatter, ring.ring_reduce_scatter_plain,
                   ring.ring_all_reduce_grads):
            with pytest.raises(ValueError, match="ring_reduce_scatter"):
                fn(torch.from_numpy(a), mesh)
    ragged = np.zeros((6, 2), np.float32)      # 6 rows over 4 ranks
    with pytest.raises(ValueError):
        jax_ring.ring_all_gather(jnp.asarray(ragged), jmesh, "x")
    for fn in (ring.ring_all_gather, ring.ring_all_gather_plain):
        with pytest.raises(ValueError, match="does not split"):
            fn(torch.from_numpy(ragged), mesh)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        ring.ring_reduce_scatter(torch.zeros(4, 8, dtype=torch.int32), mesh)
    with pytest.raises(ValueError, match="axis 'y'"):
        ring.ring_all_gather(torch.zeros(8, 2), mesh, axis="y")
    with pytest.raises(ValueError, match="op sum, max or min"):
        coll.all_reduce(torch.zeros(4, 2), mesh, "x", op="mean")
    with pytest.raises(ValueError, match="psum_scatter is a sum"):
        coll.reduce_scatter(torch.zeros(4, 8), mesh, "x", op="max")


def test_mesh():
    m = Mesh.on_device(8)
    assert m.device == torch.device("cuda") and m.shape == {"x": 8}
    assert m.axis_names == ("x",) and m.devices.shape == (8,)
    m2 = Mesh.on_device((2, 4), ("dp", "tp"), device="cpu")
    assert m2.shape == {"dp": 2, "tp": 4} and m2.devices.shape == (2, 4)
    assert Mesh([["cpu", "cpu"]], ("a", "b")).shape == {"a": 1, "b": 2}
    for devs in (["cuda:0", "cuda:1"], ["cpu", "cuda"]):
        with pytest.raises(NotImplementedError, match="ROADMAP.md item 13"):
            Mesh(devs)
    with pytest.raises(ValueError, match="axis names"):
        Mesh(["cpu"] * 4, ("x", "y"))
    # a tensor off the mesh's device
    with pytest.raises(ValueError, match="mesh on cuda"):
        ring.ring_all_gather(torch.zeros(8, 2), m)
    x = torch.arange(12.0).reshape(6, 2)
    cpu3 = Mesh.on_device(3, device="cpu")
    assert [s.tolist() for s in shards(x, cpu3, "x")] == [
        [[0, 1], [2, 3]], [[4, 5], [6, 7]], [[8, 9], [10, 11]]]
    assert parallel.Mesh is Mesh


def test_cpu_path_never_builds(monkeypatch):
    """On CPU tensors the wrappers take the plain versions: nothing of
    _build runs, and the launch counters stay put."""
    def boom(*a, **k):
        raise AssertionError("_build reached on the CPU path")

    for name in ("launch", "library", "build", "stream"):
        monkeypatch.setattr(_build, name, boom)
    counts = (ring.ring_all_gather.launches,
              ring.ring_reduce_scatter.launches)
    mesh = Mesh.on_device(4, device="cpu")
    x = torch.randn(4, 8, 3)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        ring.ring_all_reduce_grads(x.to(dt), mesh, ranks=True)
    ring.ring_all_gather(torch.zeros(8, dtype=torch.int64), mesh)
    assert counts == (ring.ring_all_gather.launches,
                      ring.ring_reduce_scatter.launches)
