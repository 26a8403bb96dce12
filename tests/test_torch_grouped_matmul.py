"""tpukern_torch's grouped GEMM against the JAX package on CPU.

gmm (NN and trans_w), tgmm and grouped_matmul's gradients of the port
(its plain versions here: the tensors lie on the CPU) against JAX's
Pallas gmm/tgmm/grouped_matmul in interpret mode and lax.ragged_dot, on
the same numpy inputs: every case of tests/test_grouped_matmul.py
(boundaries inside a block, empty groups, E = 1, one group over many
blocks, sum < T, all groups in one block). f32 at 2e-5 forward and 2e-4
for gradients, the JAX tests' tolerances. Rows past sum(group_sizes) are
unspecified in JAX and compared only on the port's side (zeros).

JAX's tgmm masks the rows of x outside the group but not those of dy
before its dot (tpukern/ops/grouped_matmul.py:242-247), so where
block_m does not divide T the padding rows of dy's last block enter the
sum (NaN in interpret mode; ROADMAP.md §3 records the fault). JAX's tgmm
and its VJP are therefore run with a block_m that divides T (_jax_bm);
the port has no block_m.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import grad, lax

from tpukern.ops import grouped_matmul as jgm
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.ops import grouped_matmul as gm

F32 = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)
JBLOCKS = dict(block_n=128, block_k=128)

CASES = [
    # (T, K, N, E, sizes, block_m): tests/test_grouped_matmul.py:32-41
    (256, 128, 128, 4, [64, 64, 64, 64], 64),        # aligned
    (256, 128, 128, 4, [37, 91, 3, 125], 64),        # boundaries mid-block
    (256, 128, 128, 4, [0, 200, 0, 56], 64),         # empty groups
    (256, 128, 128, 1, [256], 64),                   # E=1
    (512, 128, 128, 3, [500, 7, 5], 128),            # one group, many blocks
    (256, 128, 128, 4, [10, 20, 30, 40], 64),        # sum < T (padding tail)
    (192, 256, 384, 5, [64, 0, 65, 0, 63], 128),     # empty interleaved
    (64, 128, 128, 8, [8, 8, 8, 8, 8, 8, 8, 8], 64), # all in one block
]
IDS = ["aligned", "mid_block", "empty", "E1", "many_blocks", "sum_lt_T",
       "empty_interleaved", "one_block"]


def _jax_bm(T, bm):
    """A block_m for JAX's tgmm that divides T (see the docstring)."""
    return math.gcd(T, bm)


def _inputs(T, K, N, E, sizes, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, K)).astype(np.float32)
    w = (rng.standard_normal((E, K, N)) * 0.1).astype(np.float32)
    return x, w, np.asarray(sizes, np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("T,K,N,E,sizes,bm", CASES, ids=IDS)
def test_gmm_matches_jax(T, K, N, E, sizes, bm):
    x, w, gs = _inputs(T, K, N, E, sizes)
    got = gm.gmm(*_t(x, w, gs), block_m=bm, **JBLOCKS)
    want = jgm.gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs),
                   block_m=bm, **JBLOCKS)
    ragged = lax.ragged_dot(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs))
    live = sum(sizes)
    assert got.shape == (T, N) and got.dtype == torch.float32
    check_all_close(got[:live], np.asarray(want)[:live], name="gmm", **F32)
    check_all_close(got[:live], np.asarray(ragged)[:live], name="ragged",
                    **F32)
    assert not got[live:].any()


@pytest.mark.parametrize("T,K,N,E,sizes,bm", CASES, ids=IDS)
def test_gmm_trans_w_matches_jax(T, K, N, E, sizes, bm):
    x, w, gs = _inputs(T, K, N, E, sizes, seed=1)
    wt = np.ascontiguousarray(np.swapaxes(w, 1, 2))  # (E, N, K)
    got = gm.gmm(*_t(x, wt, gs), trans_w=True)
    want = jgm.gmm(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(gs),
                   trans_w=True, block_m=bm, **JBLOCKS)
    live = sum(sizes)
    check_all_close(got[:live], np.asarray(want)[:live], name="gmm trans_w",
                    **F32)
    check_all_close(got, gm.gmm(*_t(x, w, gs)), name="trans_w vs NN", **F32)


@pytest.mark.parametrize("T,K,N,E,sizes,bm", CASES, ids=IDS)
def test_tgmm_matches_jax(T, K, N, E, sizes, bm):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((T, K)).astype(np.float32)
    dy = rng.standard_normal((T, N)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    got = gm.tgmm(*_t(x, dy, gs), block_m=bm, **JBLOCKS)
    jgs = jnp.asarray(gs)
    want = jgm.tgmm(jnp.asarray(x), jnp.asarray(dy), jgs,
                    block_m=_jax_bm(T, bm), **JBLOCKS)
    want = jnp.where((jgs > 0)[:, None, None], want, 0.0)
    assert got.shape == (E, K, N)
    check_all_close(got, np.asarray(want), name="tgmm", **F32)
    empty = [e for e, s in enumerate(sizes) if s == 0]
    assert not got[empty].any()


def _loss_grads_jax(x, w, gs, fn):
    def loss(x, w):
        y = fn(x, w, gs)
        return jnp.sum(y * jnp.cos(y))

    return grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))


@pytest.mark.parametrize("T,K,N,E,sizes,bm", CASES, ids=IDS)
def test_grouped_matmul_grads_match_jax(T, K, N, E, sizes, bm):
    """The loss sum(y cos y) of tests/test_grouped_matmul.py: dx and dw of
    the port's VJP (gmm trans_w, tgmm) against JAX's Pallas VJP and the
    autodiff of lax.ragged_dot."""
    x, w, gs = _inputs(T, K, N, E, sizes, seed=3)
    xt, wt, gst = _t(x, w, gs)
    xt.requires_grad_()
    wt.requires_grad_()
    y = gm.grouped_matmul(xt, wt, gst, dict(block_m=bm, **JBLOCKS))
    dx, dw = torch.autograd.grad((y * torch.cos(y)).sum(), (xt, wt))
    jgs = jnp.asarray(gs)
    cfg = dict(block_m=_jax_bm(T, bm), **JBLOCKS)
    kx, kw = _loss_grads_jax(
        x, w, jgs, lambda x, w, g: jgm.grouped_matmul(x, w, g, cfg))
    rx, rw = _loss_grads_jax(x, w, jgs, lax.ragged_dot)
    live = sum(sizes)
    check_all_close(dx[:live], np.asarray(kx)[:live], name="dx", **GRAD)
    check_all_close(dx, np.asarray(rx), name="dx vs ragged", **GRAD)
    check_all_close(dw, np.asarray(kw), name="dw", **GRAD)
    check_all_close(dw, np.asarray(rw), name="dw vs ragged", **GRAD)


def test_grouped_matmul_vjp_empty_group():
    """An empty group's dw slab comes back zero (JAX's `where`)."""
    x, w, gs = _inputs(192, 128, 128, 3, [100, 0, 92])
    xt, wt, gst = _t(x, w, gs)
    wt.requires_grad_()
    (dw,) = torch.autograd.grad((gm.grouped_matmul(xt, wt, gst) ** 2).sum(),
                                (wt,))
    jgs = jnp.asarray(gs)
    cfg = dict(block_m=64, **JBLOCKS)
    jdw = grad(lambda w: jnp.sum(jgm.grouped_matmul(
        jnp.asarray(x), w, jgs, cfg) ** 2))(jnp.asarray(w))
    check_all_close(dw, np.asarray(jdw), name="dw", **GRAD)
    assert not dw[1].any()


def test_gmm_bf16_matches_jax():
    """bf16 inputs and output (f32 accumulation on both sides), at the
    bf16 tolerance (the outputs round to bf16)."""
    x, w, gs = _inputs(256, 256, 256, 4, [100, 28, 64, 64], seed=4)
    xb, wb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w))
    # the same bf16 values on both sides
    xt, wt = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in (xb, wb))
    got = gm.gmm(xt, wt, torch.from_numpy(gs))
    want = jgm.gmm(xb, wb, jnp.asarray(gs), block_m=128, **JBLOCKS)
    assert got.dtype == torch.bfloat16
    check_all_close(got.float(), np.asarray(want.astype(jnp.float32)),
                    dtype=torch.bfloat16, name="gmm bf16")


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_out_dtype(out_dtype):
    x, w, gs = (torch.from_numpy(a) for a in
                _inputs(64, 128, 128, 2, [30, 20]))
    assert gm.gmm(x, w, gs, out_dtype=out_dtype).dtype == out_dtype
    assert gm.tgmm(x, x, gs, out_dtype=out_dtype).dtype == out_dtype


def test_shape_checks_raise():
    x, w, gs = (torch.from_numpy(a) for a in
                _inputs(64, 128, 96, 2, [30, 20]))
    with pytest.raises(ValueError, match="do not match"):
        gm.gmm(x, w, gs, trans_w=True, block_m=64)
    with pytest.raises(ValueError, match="do not match"):
        gm.gmm(x, w, gs[:1])
    with pytest.raises(TypeError, match="integers"):
        gm.gmm(x, w, gs.float())
    with pytest.raises(ValueError, match="tgmm"):
        gm.tgmm(x, x[:10], gs)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _view_off(shape):
    """A contiguous bf16 view 2 bytes past its buffer's aligned base."""
    return torch.zeros(math.prod(shape) + 1, dtype=torch.bfloat16)[1:].view(
        shape)


# (x, dy, sizes, the bf16 tgmm kernel's slabs of each group as (first
# row, rows, path)): 64-row slabs from a group's first row, the last one
# keeping the rows left (the kernel zeros the others); groups of 63, 65
# and 1 rows off a 64-row boundary; sizes past T clamped; empty and
# negative groups; an operand TMA cannot take (K % 8, a misaligned view)
# copied in every slab
SLAB_CASES = {
    "tails": (lambda: (_bf16(330, 128), _bf16(330, 136)),
              [37, 63, 65, 1, 129, 20],
              [[(0, 37, "tma")], [(37, 63, "tma")],
               [(100, 64, "tma"), (164, 1, "tma")], [(165, 1, "tma")],
               [(166, 64, "tma"), (230, 64, "tma"), (294, 1, "tma")],
               [(295, 20, "tma")]]),
    "clamped at T": (lambda: (_bf16(150, 128), _bf16(150, 128)), [100, 100],
                     [[(0, 64, "tma"), (64, 36, "tma")],
                      [(100, 50, "tma")]]),
    "empty": (lambda: (_bf16(64, 128), _bf16(64, 128)), [0, -3, 64, 5],
              [[], [], [(0, 64, "tma")], []]),
    "K % 8": (lambda: (_bf16(200, 130), _bf16(200, 136)), [128, 72],
              [[(0, 64, "mixed"), (64, 64, "mixed")],
               [(128, 64, "mixed"), (192, 8, "mixed")]]),
    "misaligned": (lambda: (_view_off((128, 128)), _view_off((128, 136))),
                   [128], [[(0, 64, "copy"), (64, 64, "copy")]]),
}


@pytest.mark.parametrize("case", sorted(SLAB_CASES))
def test_tgmm_slab_plan(case):
    """gm.tgmm_slabs, the mirror of the bf16 tgmm launcher's rule and its
    slabs, from shapes, sizes and pointers; the plan's rows are exactly
    each group's rows, in order, in slabs of 64 but the last."""
    make, sizes, want = SLAB_CASES[case]
    x, dy = make()
    plan = gm.tgmm_slabs(x, dy, sizes)
    assert plan == want
    off, T = 0, x.shape[0]
    for size, slabs in zip(sizes, plan):
        s = min(off, T)
        off += max(size, 0)
        rows = [r for t0, n, _ in slabs for r in range(t0, t0 + n)]
        assert rows == list(range(s, min(off, T)))
        assert all(n == 64 for _, n, _ in slabs[:-1])
