"""The f32 tier of the port's grouped GEMM (#28 gmm NN and trans_w, #29
tgmm on split-TF32 products) on the CPU: the plain models of its order of
work (`gmm_split_ref`, `tgmm_split_ref`) against JAX's Pallas gmm/tgmm in
interpret mode over every case of tests/test_grouped_matmul.py, and
against the f64 grouped product within the split's bound; and the mirrors
of what csrc/grouped_matmul.cu's f32 launchers lay out: the scratch, W's
per-expert planes, the slab plan with its zeroed tails, the work items.
The kernels themselves run only on a card (tests/test_torch_kernels.py,
chip_smoke.py).

JAX's tgmm runs with a block_m that divides T (see
tests/test_torch_grouped_matmul.py and ROADMAP.md §3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_grouped_matmul import (CASES, F32, IDS, JBLOCKS, _inputs,
                                       _jax_bm, _t)
from tpukern.ops import grouped_matmul as jgm
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.ops import grouped_matmul as gm
from tpukern_torch.ops import split_tf32 as st


@pytest.mark.parametrize("trans_w", [False, True])
@pytest.mark.parametrize("T,K,N,E,sizes,bm", CASES, ids=IDS)
def test_gmm_split_model_matches_jax(T, K, N, E, sizes, bm, trans_w):
    """gmm_split_ref (NN and trans_w) against JAX's Pallas gmm on the live
    rows at the f32 tolerance; exact zeros past sum(group_sizes)."""
    x, w, gs = _inputs(T, K, N, E, sizes, seed=5)
    if trans_w:
        w = np.ascontiguousarray(np.swapaxes(w, 1, 2))  # (E, N, K)
    got = gm.gmm_split_ref(*_t(x, w, gs), trans_w=trans_w)
    want = jgm.gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs),
                   trans_w=trans_w, block_m=bm, **JBLOCKS)
    live = sum(sizes)
    assert got.shape == (T, N) and got.dtype == torch.float32
    check_all_close(got[:live], np.asarray(want)[:live],
                    name=f"gmm split model trans_w={trans_w}", **F32)
    assert not got[live:].any()


@pytest.mark.parametrize("T,K,N,E,sizes,bm", CASES, ids=IDS)
def test_tgmm_split_model_matches_jax(T, K, N, E, sizes, bm):
    """tgmm_split_ref against JAX's Pallas tgmm (its empty groups zeroed
    by the VJP's `where`) at the f32 tolerance; an empty group's slab is
    zero."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((T, K)).astype(np.float32)
    dy = rng.standard_normal((T, N)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    got = gm.tgmm_split_ref(*_t(x, dy, gs))
    jgs = jnp.asarray(gs)
    want = jgm.tgmm(jnp.asarray(x), jnp.asarray(dy), jgs,
                    block_m=_jax_bm(T, bm), **JBLOCKS)
    want = jnp.where((jgs > 0)[:, None, None], want, 0.0)
    assert got.shape == (E, K, N)
    check_all_close(got, np.asarray(want), name="tgmm split model", **F32)
    assert not got[[e for e, s in enumerate(sizes) if s == 0]].any()


@pytest.mark.parametrize("kind", ["gmm", "gmm trans_w", "tgmm"])
@pytest.mark.parametrize("T,K,N,E,sizes,bm", CASES, ids=IDS)
def test_split_models_within_their_bound_of_f64(T, K, N, E, sizes, bm,
                                                kind):
    """Each model within SPLIT_REL of Σ|a b| of the f64 grouped product
    (gmm_ref/tgmm_ref in f64), plus one f32 rounding of Σ|a b| for each
    slab's sum added (its slabs of 32 along the contraction); and nearer
    it than the plain loop in f32 reading TF32 inputs (one pass)."""
    x, w, gs = _t(*_inputs(T, K, N, E, sizes, seed=7))
    x = x * 1e3  # magnitudes far from 1
    if kind == "tgmm":
        b = torch.from_numpy(np.random.default_rng(8).standard_normal(
            (T, N)).astype(np.float32))
        model, ref = gm.tgmm_split_ref(x, b, gs), gm.tgmm_ref
        slabs = -(-max(sizes) // st.SLAB) + 1  # a head slab at most
    else:
        b = w.transpose(1, 2).contiguous() if kind == "gmm trans_w" else w
        tw = kind == "gmm trans_w"
        model = gm.gmm_split_ref(x, b, gs, trans_w=tw)

        def ref(x, b, gs, dtype):
            return gm.gmm_ref(x, b, gs, trans_w=tw, dtype=dtype)
        slabs = -(-K // st.SLAB)
    exact = ref(x, b, gs, dtype=torch.float64)
    terms = ref(x.abs(), b.abs(), gs, dtype=torch.float64)
    err = (model.double() - exact).abs()
    assert (err <= (st.SPLIT_REL + slabs * 2.0 ** -24) * terms).all()
    one = ref(st.tf32_truncate(x), st.tf32_truncate(b), gs,
              dtype=torch.float64)
    assert err.max() < (one - exact).abs().max() / 100


@pytest.mark.parametrize("T,N,K,E", [(1, 1, 1, 1), (256, 128, 128, 4),
                                     (192, 384, 257, 5), (8192, 14336, 4096,
                                                          8)])
def test_scratch_sizes(T, N, K, E):
    """gmm_scratch: x's planes (2, T, K4) and W's (E, 2, N, K4); tgmm_scratch
    (its K, N the product's): x^T's (2, K, T4) and dy^T's (2, N, T4); K4
    and T4 rounded up to 4; none without a contraction. At the Mixtral w1
    product W's planes are 3.76 GB, past 2^31 values: the launchers index
    them in int64."""
    k4, t4 = -(-K // 4) * 4, -(-T // 4) * 4
    assert gm.gmm_scratch(T, N, K, E) == 2 * T * k4 + E * 2 * N * k4
    assert gm.gmm_scratch(T, N, 0, E) == 0
    assert gm.tgmm_scratch(T, K, N) == 2 * K * t4 + 2 * N * t4
    assert gm.tgmm_scratch(0, K, N) == 0
    if T == 8192:
        assert 4 * 2 * E * N * k4 == 3758096384 > 2 ** 31


@pytest.mark.parametrize("trans_w", [False, True])
@pytest.mark.parametrize("E,K,N", [(1, 5, 7), (3, 33, 64), (4, 130, 17)])
def test_w_planes_are_each_experts_k_major_planes(E, K, N, trans_w):
    """gmm_w_planes_ref, the mirror of the one batched operand pass over W:
    (E, 2, N, K4), expert e's slice equal to split_planes_ref of W[e]
    (transposed in NN, as it is with trans_w) bit for bit, zeros past K;
    its hi plane is depth 2e of the (2E, N, K4) map, lo 2e + 1."""
    rng = np.random.default_rng(E * K * N)
    shape = (E, N, K) if trans_w else (E, K, N)
    w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    planes = gm.gmm_w_planes_ref(w, trans_w)
    k4 = -(-K // 4) * 4
    assert planes.shape == (E, 2, N, k4)
    flat = planes.reshape(2 * E, N, k4)  # the map's depth 2E
    for e in range(E):
        want = st.split_planes_ref(w[e], transpose=not trans_w)
        assert torch.equal(planes[e], want)
        hi, lo = st.split_tf32_ref(w[e] if trans_w else w[e].T)
        assert torch.equal(flat[2 * e, :, :K], hi)
        assert torch.equal(flat[2 * e + 1, :, :K], lo)
    assert not planes[..., K:].any()


# (T, sizes, the f32 tgmm kernel's slabs of each group as (first token,
# tokens, path) of the group's tokens each holds): 32-column slabs of
# x^T's and dy^T's planes from the group's first token rounded down to a
# multiple of 4 (TMA's 16-byte inner coordinates; an unaligned start
# raised an illegal instruction on the card), the first slab's columns
# before the group and the last one's past it zeroed in all four planes
F32_SLAB_CASES = {
    "tails": (330, [37, 63, 65, 1, 129, 20],
              [[(0, 32, "tma"), (32, 5, "tma")],
               [(37, 31, "tma"), (68, 32, "tma")],
               [(100, 32, "tma"), (132, 32, "tma"), (164, 1, "tma")],
               [(165, 1, "tma")],
               [(166, 30, "tma"), (196, 32, "tma"), (228, 32, "tma"),
                (260, 32, "tma"), (292, 3, "tma")],
               [(295, 20, "tma")]]),
    "clamped at T": (50, [40, 40], [[(0, 32, "tma"), (32, 8, "tma")],
                                    [(40, 10, "tma")]]),
    "empty": (64, [0, -3, 64, 5],
              [[], [], [(0, 32, "tma"), (32, 32, "tma")], []]),
}


@pytest.mark.parametrize("case", sorted(F32_SLAB_CASES))
def test_tgmm_f32_slab_plan(case):
    """gm.tgmm_slabs on f32 operands (any K, N: the planes are padded to
    whole 16-byte rows): the plan's tokens are each group's, in order;
    slab i of a group starting at token s loads the 32 columns from (s
    rounded down to 4) + 32 i, a 16-byte aligned column, and holds the
    group's tokens among them, the others zeroed (at most 3 before the
    group in the first slab); every slab between the first and the last
    is whole; the model sums exactly these slabs."""
    T, sizes, want = F32_SLAB_CASES[case]
    x, dy = torch.zeros(T, 130), torch.zeros(T, 7)
    plan = gm.tgmm_slabs(x, dy, sizes)
    assert plan == want
    off = 0
    for size, slabs in zip(sizes, plan):
        s = min(off, T)
        off += max(size, 0)
        tokens = [t for t0, n, _ in slabs for t in range(t0, t0 + n)]
        assert tokens == list(range(s, min(off, T)))
        for i, (t0, n, _) in enumerate(slabs):
            load = (s & ~3) + st.SLAB * i
            assert load % 4 == 0 and load <= t0 and t0 + n <= load + st.SLAB
            assert t0 - load <= (3 if i == 0 else 0)
        assert all(n == st.SLAB for _, n, _ in slabs[1:-1])


def test_tgmm_split_model_sums_only_the_groups_tokens():
    """NaN in every token past the groups (the last slab of the last
    group takes columns past its end, which the kernel zeros): the model,
    which sums only tgmm_slabs' tokens, stays finite and equals the model
    on the tokens cut at sum(group_sizes)."""
    T, sizes = 330, [37, 63, 65, 1, 129, 20]
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((T, 40)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((T, 24)).astype(np.float32))
    live = sum(sizes)
    x[live:], dy[live:] = float("nan"), float("nan")
    gs = torch.tensor(sizes, dtype=torch.int32)
    got = gm.tgmm_split_ref(x, dy, gs)
    assert torch.isfinite(got).all()
    assert torch.equal(got, gm.tgmm_split_ref(x[:live], dy[:live], gs))


def test_gmm_f32_items_read_planes_by_tma():
    """gm.gmm_items on f32 operands: the bf16 kernel's items (the same
    rows), each loading its planes by TMA whatever K and N (the planes'
    rows are padded to 16 bytes); the rows past the groups load
    nothing."""
    x, w = torch.zeros(540, 130), torch.zeros(5, 130, 17)
    sizes = [5, 1, 127, 129, 255]
    items = gm.gmm_items(x, w, sizes)
    bf = gm.gmm_items(x.bfloat16(), w.bfloat16(), sizes)
    assert [i[:3] for i in items] == [i[:3] for i in bf]
    assert {p for *_, p in items} == {"tma", None}
    assert items[-1] == (None, 517, 23, None)
