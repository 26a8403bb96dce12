"""The split-TF32 product of the port's f32 GEMM tier (#1-#3, #17 and the
f32 CE backward #14/#15) on the CPU: the split's plain version
(`split_tf32_ref`, which csrc/common.cuh `split_tf32` computes bit for
bit), its planes, the plain model of the product against an f64 product
and against JAX's `matmul` (interpret mode, as the JAX tests run it), the
mirrors of the layouts and the scratch that csrc/matmul.cu and
csrc/cross_entropy.cu use, and the f32 CE backward modelled on split
products laid out by that mirror. The kernels themselves run only on a
card (tests/test_torch_kernels.py, chip_smoke.py).
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.ops.matmul import matmul as jax_matmul
from tpukern_torch import _build
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.ops import cross_entropy as ce
from tpukern_torch.ops import split_tf32 as st

LOW13 = 0x1FFF


def _bits(x):
    return x.contiguous().view(torch.int32)


def _from_bits(values):
    return torch.tensor(values, dtype=torch.int64).to(torch.int32).view(
        torch.float32)


# finite values on every path of the rounding: ±0, subnormals (the
# smallest, one that rounds to a normal), ties (half a TF32 ulp, both
# signs), values just either side of a tie, the largest finite values
# (which would round past FLT_MAX) and the largest that does not
EDGES = {"zeros": [0x00000000, 0x80000000],
         "subnormals": [0x00000001, 0x80000001, 0x00001000, 0x007FFFFF,
                        0x807FF000],
         "ties": [0x3F801000, 0xBF801000, 0x3F803000, 0x00003000],
         "near ties": [0x3F800FFF, 0x3F801001, 0xBF800FFF],
         "near FLT_MAX": [0x7F7FFFFF, 0x7F7FF000, 0xFF7FF000, 0x7F7FEFFF,
                          0x7F7FE000]}
SPECIALS = {"inf": [0x7F800000, 0xFF800000],
            "nan": [0x7FC00000, 0x7F800001, 0xFFA00001, 0x7FFFFFFF]}


def _random(seed, scale, n=4096):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.standard_normal(n) * scale).astype(np.float32))


@pytest.mark.parametrize("scale", [1e-38, 1e-20, 1e-3, 1.0, 1e5, 1e30])
def test_split_of_random_values(scale):
    """hi's low 13 bits are zero, hi + lo == x bit for bit, and hi is x
    rounded to the nearest TF32 value: |lo| at most half a TF32 ulp of
    x's binade."""
    x = _random(int(np.log10(scale) + 50), scale)
    hi, lo = st.split_tf32_ref(x)
    assert not (_bits(hi) & LOW13).any()
    assert torch.equal(_bits(hi + lo), _bits(x))
    normal = x.abs() >= 2.0 ** -126
    ulp = torch.exp2(torch.floor(torch.log2(x.abs().double())) - 10)
    assert (lo.abs().double()[normal] <= ulp[normal] / 2).all()


@pytest.mark.parametrize("kind", list(EDGES))
def test_split_of_edge_values(kind):
    """±0 (lo keeps the sign, so hi + lo == x bit for bit), subnormals,
    ties (half away from zero), values either side of a tie, and values
    within half a TF32 ulp of FLT_MAX (truncated, not rounded to inf)."""
    x = _from_bits(EDGES[kind])
    hi, lo = st.split_tf32_ref(x)
    assert not (_bits(hi) & LOW13).any()
    assert torch.isfinite(hi).all() and torch.isfinite(lo).all()
    assert torch.equal(_bits(hi + lo), _bits(x))
    if kind == "ties":
        assert (hi.abs() > x.abs()).all()  # away from zero
    if kind == "near FLT_MAX":
        assert torch.equal(_bits(hi), _bits(x) & ~LOW13)


def test_split_of_ties_and_near_ties_rounds_to_nearest():
    """Just below a tie rounds down, at or above it rounds up (in
    magnitude), as cvt.rna.tf32.f32 does."""
    one = 0x3F800000
    for bits, up in ((one + 0x0FFF, False), (one + 0x1000, True),
                     (one + 0x1001, True), (one + 0x2FFF, False)):
        hi, _ = st.split_tf32_ref(_from_bits([bits]))
        want = (bits & ~LOW13) + (0x2000 if up else 0)
        assert _bits(hi).item() == want


@pytest.mark.parametrize("kind", list(SPECIALS))
def test_split_of_inf_and_nan(kind):
    """±inf keep hi = x; a NaN gets a NaN hi whose low 13 bits are zero
    (still NaN as the tensor core reads it); both keep lo = 0, so no inf
    - inf appears."""
    x = _from_bits(SPECIALS[kind])
    hi, lo = st.split_tf32_ref(x)
    assert not (_bits(hi) & LOW13).any()
    assert (lo == 0).all()
    if kind == "inf":
        assert torch.equal(_bits(hi), _bits(x))
    else:
        assert torch.isnan(hi).all()
        assert torch.isnan(st.tf32_truncate(hi)).all()
        assert torch.equal(_bits(hi) < 0, _bits(x) < 0)  # the sign kept


@pytest.mark.parametrize("bits", st.SPECIALS, ids=hex)
def test_split_of_the_cards_specials(bits):
    """Each value of split_tf32.SPECIALS, which the card's checks plant in
    the operand pass's input: hi's low 13 bits zero; a finite x gives hi +
    lo == x bit for bit, ±inf and NaN lo = 0."""
    x = _from_bits([bits])
    hi, lo = st.split_tf32_ref(x)
    assert not (_bits(hi) & LOW13).any()
    if torch.isfinite(x).all():
        assert torch.equal(_bits(hi + lo), _bits(x))
    else:
        assert (lo == 0).all()


def test_cards_specials_take_every_class():
    """split_tf32.SPECIALS holds a value of each class of EDGES and
    SPECIALS above."""
    kinds = {k for k, v in {**EDGES, **SPECIALS}.items()
             if set(v) & set(st.SPECIALS)}
    assert kinds == set(EDGES) | set(SPECIALS)


def test_truncate_clears_the_low_bits():
    x = _random(3, 1.0)
    t = st.tf32_truncate(x)
    assert torch.equal(_bits(t), _bits(x) & ~LOW13)
    assert ((x - t).abs() <= x.abs() * 2.0 ** -10).all()


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("R,C", [(1, 1), (5, 7), (33, 64), (17, 130)])
def test_planes_layout(R, C, transpose):
    """split_planes_ref: (2, rows, ld), hi then lo of x (or of x^T), each
    row padded with zeros to a multiple of 4 values (16 bytes); the
    wrapper on a CPU tensor returns the same planes."""
    x = torch.from_numpy(np.random.default_rng(R * C).standard_normal(
        (R, C)).astype(np.float32))
    planes = st.split_planes_ref(x, transpose)
    rows, n = (C, R) if transpose else (R, C)
    assert planes.shape == (2, rows, -(-n // 4) * 4)
    src = x.T if transpose else x
    hi, lo = st.split_tf32_ref(src)
    assert torch.equal(planes[0, :, :n], hi) and torch.equal(planes[1, :, :n],
                                                             lo)
    assert not planes[:, :, n:].any()
    assert torch.equal(st.split_tf32(x, transpose=transpose), planes)


def test_split_wrapper_takes_f32_matrices_only():
    with pytest.raises(TypeError):
        st.split_tf32(torch.zeros(4, 4, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        st.split_tf32(torch.zeros(4))


@pytest.mark.parametrize("passes", [0, 1, 2])
def test_launch_counting_passes_adds_the_launchers_count(monkeypatch,
                                                          passes):
    """launch_counting_passes hands the C entry point a host counter just
    before the stream and adds what the launcher wrote there to
    split_tf32.launches (a stand-in for the library writes it here)."""
    seen = []

    def launch(name, *args):
        seen.append((name, args))
        ctypes.c_int.from_address(args[-2]).value = passes

    monkeypatch.setattr(_build, "launch", launch)
    before = st.split_tf32.launches
    st.launch_counting_passes("tk_matmul", 1, 2, "stream")
    assert st.split_tf32.launches == before + passes
    (name, args), = seen
    assert name == "tk_matmul" and args[:2] == (1, 2)
    assert args[-1] == "stream" and isinstance(args[-2], int)


def test_c_entry_points_match_their_ctypes_signatures():
    """Every entry of _build.SIGNATURES has as many arguments as its C
    definition in csrc/capi.cu (ctypes would pass a call with one too few
    or too many without a word), those that count operand passes among
    them."""
    src = (Path(_build.__file__).parent / "csrc" / "capi.cu").read_text()
    arity = {m[1]: len([p for p in m[2].split(",") if p.strip()])
             for m in re.finditer(r"^int (tk_\w+)\(([^)]*)\)\s*\{", src,
                                  re.M)}
    assert {n: len(a) for n, a in _build.SIGNATURES.items()} == {
        n: arity.get(n) for n in _build.SIGNATURES}
    for name in ("tk_matmul", "tk_ce_bwd", "tk_split_tf32", "tk_gmm",
                 "tk_tgmm"):
        assert re.search(
            rf"int {name}\([^)]*int\* passes,\s*void\* stream\)", src)


def test_split_bound_is_the_derived_one():
    """SPLIT_REL: lo.lo (2^-22), and each lo's truncation (2^-21 of its
    operand) times the other's hi (at most 1 + 2^-11 times it)."""
    assert st.SPLIT_REL == 2.0 ** -22 + 2 * 2.0 ** -21 * (1 + 2.0 ** -11)


MATMUL_SHAPES = [(33, 47, 100), (64, 128, 513), (7, 300, 1024), (130, 5, 3)]


def _operands(M, N, K, trans_b, seed=0, scale=1.0):
    rng = np.random.default_rng(seed + M + N + K)
    a = rng.standard_normal((M, K)).astype(np.float32) * scale
    b = rng.standard_normal((N, K) if trans_b else (K, N)).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(b)


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("M,N,K", MATMUL_SHAPES)
def test_split_product_within_its_bound_of_f64(M, N, K, trans_b):
    """The plain model (f64 sums of the three TF32 products, rounded once
    to f32) is within SPLIT_REL of Σ|a b| of the exact product, plus the
    one rounding to f32; and it is closer to it than one TF32 product
    (a single pass keeps about 3 digits)."""
    a, b = _operands(M, N, K, trans_b, scale=1e3)
    bt = b.T if trans_b else b
    exact = a.double() @ bt.double()
    terms = a.abs().double() @ bt.abs().double()
    out = st.matmul_split_ref(a, b, trans_b=trans_b)
    assert out.dtype == torch.float32 and out.shape == (M, N)
    err = (out.double() - exact).abs()
    assert (err <= st.SPLIT_REL * terms + 2.0 ** -24 * exact.abs()).all()
    one = st.tf32_truncate(a).double() @ st.tf32_truncate(bt).double()
    assert err.max() < (one - exact).abs().max() / 100


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("M,N,K", MATMUL_SHAPES[:3])
def test_split_product_matches_jax_matmul(M, N, K, trans_b):
    """The model against JAX's f32 matmul (interpret mode) at the f32
    tolerance of tolerances.py."""
    a, b = _operands(M, N, K, trans_b, seed=1)
    a = a / K ** 0.5
    ref = jax_matmul(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                     trans_b=trans_b)
    check_all_close(st.matmul_split_ref(a, b, trans_b=trans_b),
                    np.asarray(ref), dtype=torch.float32,
                    name="split product vs JAX")


@pytest.mark.parametrize("trans_b", [False, True])
def test_matmul_mirror_makes_both_operands_k_major(trans_b):
    """matmul_transposed: A's planes as A is, B's transposed in NN only,
    so both are (2, rows, K4) with K along the rows, and the scratch is
    their size; a B split the other way does not contract."""
    M, N, K = 9, 13, 30
    a, b = _operands(M, N, K, trans_b, seed=2)
    t = st.matmul_transposed(trans_b)
    assert t == {"a": False, "b": not trans_b}
    pa, pb = st.split_planes_ref(a, t["a"]), st.split_planes_ref(b, t["b"])
    assert pa.shape == (2, M, 32) and pb.shape == (2, N, 32)
    assert pa.numel() + pb.numel() == st.matmul_scratch(M, N, K)
    assert st.matmul_scratch(M, N, 0) == 0
    wrong = st.split_planes_ref(b, not t["b"])
    assert wrong.shape[1] != N or wrong.shape[2] != 32


def _ce_split_model(x, w, targets, lse, g, chunk):
    """The f32 CE backward as its kernels compute it, in plain torch: for
    each vocab chunk, the scores from x's and W's chunk's planes, dlog in
    f32, split, then dx (+)= and dW[:, chunk] = split products, every
    operand laid out by CE_TRANSPOSED and read K-major."""
    lay = st.CE_TRANSPOSED
    N, V = x.shape[0], w.shape[1]
    planes_x = [st.split_planes_ref(x, tr) for tr in lay["x"]]
    dx, dw = None, torch.empty(w.shape)
    tgt = targets.long()[:, None]
    gk = torch.where(targets < 0, 0.0, g)[:, None]
    for v0 in range(0, V, chunk):
        wc = w[:, v0:v0 + chunk]
        planes_w = [st.split_planes_ref(wc, tr) for tr in lay["w"]]
        s = st.split_product_ref(planes_x[0], planes_w[0])
        cols = torch.arange(v0, v0 + wc.shape[1])
        dlog = (torch.exp(s - lse[:, None]) - (cols == tgt).float()) * gk
        planes_d = [st.split_planes_ref(dlog, tr) for tr in lay["dlog"]]
        part = st.split_product_ref(planes_d[0], planes_w[1])
        dx = part if dx is None else dx + part
        dw[:, v0:v0 + chunk] = st.split_product_ref(planes_x[1], planes_d[1])
    return dx, dw


@pytest.mark.parametrize("N,D,V,chunk", [(200, 64, 1001, 256),
                                         (129, 100, 257, 96),
                                         (64, 32, 300, 300)])
def test_ce_split_model_matches_the_plain_backward(N, D, V, chunk):
    """The f32 CE backward modelled on split products with CE_TRANSPOSED's
    layouts equals ce_bwd_ref (f32 sums) at 2e-5 of the largest
    gradient, and the scratch of each chunk is ce_scratch's."""
    rng = np.random.default_rng(N + V)
    x = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((D, V)) * 0.05).astype(
        np.float32))
    t = torch.from_numpy(rng.integers(0, V, N).astype(np.int32))
    t[::4] = -1
    g = torch.from_numpy(rng.random(N).astype(np.float32))
    _, lse = ce.fused_cross_entropy(x, w, t, return_lse=True)
    dx, dw = _ce_split_model(x, w, t, lse, g, chunk)
    rdx, rdw = ce.ce_bwd_ref(x, w, t, lse, g)
    for name, a, b in (("dx", dx, rdx), ("dW", dw, rdw)):
        check_all_close(a, b, rtol=2e-5, atol=2e-5 * b.abs().max().item(),
                        name=name)
    xs, ws, ds = st.ce_scratch(N, D, chunk)
    r4 = lambda n: -(-n // 4) * 4  # noqa: E731
    assert xs == 2 * N * r4(D) + 2 * D * r4(N)
    assert ws == sum(st.split_planes_ref(w[:, :chunk], tr).numel()
                     for tr in st.CE_TRANSPOSED["w"])
    assert ds == 2 * N * r4(chunk) + 2 * chunk * r4(N)


@pytest.mark.parametrize("M,N,K,want", [(2048, 8192, 2048, 1),
                                        (4096, 4096, 4096, 1),
                                        (333, 517, 1000, 4),
                                        (130, 300, 37, 1),
                                        (128, 128, 8192, 32),
                                        (64, 64, 16384, 32),
                                        (1, 1, 480, 1), (1, 1, 512, 2),
                                        (1100, 1100, 4096, 1)])
def test_matmul_splits_rule(M, N, K, want):
    """matmul_splits on 132 SMs: one split where the tiles fill half the
    SMs or K is under 16 slabs; else enough splits to fill the SMs, each
    at least 8 slabs, every split non-empty; the scratch grows by each
    split's partial tiles."""
    s = st.matmul_splits(M, N, K, 132)
    assert s == want
    slabs = -(-K // st.SLAB)
    per = -(-slabs // s)
    assert -(-slabs // per) == s and (s == 1 or per >= 8)
    tiles = -(-M // 128) * -(-N // 128)
    base = 2 * (M + N) * (-(-K // 4) * 4)
    assert st.matmul_scratch(M, N, K, s) == base + (
        s * tiles * 128 * 128 if s > 1 else 0)
