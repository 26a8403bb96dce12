"""The softmax family of the port (ops/softmax.py; kernels #33-#36, and #30
and #31 under softmax_global) and core/config.py against the JAX
package's.

Every registry variant runs on the same numpy inputs, at
tests/test_softmax.py's sizes and scale, through the JAX variant (its
Pallas kernels in interpret mode) and the port's (its plain version on
the CPU), at the tolerance of the variant's dtype (core.tolerances: f32
1e-5, bf16 2e-2, f16 2e-3); its rows sum to 1 as test_softmax.py asks.
#35 and #36's own plain versions (grid_stats_ref, grid_norm_ref) run
composed against JAX's online_softmax_grid at the same blocks, and the
two ew_call ops of softmax_global against JAX's ew_call with the
closures of tpukern/ops/softmax.py:201, 205. ops_bench.softmax_check,
the card's check of these kernels, passes the plain version and refuses
outputs that are zero, mis-scaled or short of a pack's or a partial's
mass.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpukern.ops  # noqa: F401
from torch_parity import assert_parity
from tpukern.core import config as jax_config
from tpukern.core import registry as jax_registry
from tpukern.ops import softmax as jax_sm
from tpukern.ops._ew import ew_call as jax_ew_call
from tpukern_torch.core import config, registry
from tpukern_torch.harness import ops_bench
from tpukern_torch.ops import softmax as sm
from tpukern_torch.ops._ew import ew_call

SHAPES = [(128, 512), (100, 130), (16, 2048)]
NAMES = sorted(registry.variants("softmax"))
_DT = {"bf16": "bfloat16", "f16": "float16"}


def _x(shape, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _dtype(name):
    """The variant's dtype by its name's tokens (bf16, f16, else f32)."""
    tokens = name.split("_")
    return next((_DT[t] for t in ("bf16", "f16") if t in tokens), "float32")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_variant_matches_jax(name, shape):
    x = _x(shape)
    assert_parity(jax_registry.get("softmax", name).fn,
                  registry.get("softmax", name).fn, x, dtype=_dtype(name),
                  name=name)
    out = registry.get("softmax", name).fn(torch.from_numpy(x))
    assert out.shape == shape and str(out.dtype) == f"torch.{_dtype(name)}"
    if name.endswith("_global"):
        np.testing.assert_allclose(out.double().sum().item(), 1.0, atol=1e-3)
    else:
        np.testing.assert_allclose(
            out.double().sum(-1).numpy(), 1.0,
            atol=0.05 if _dtype(name) == "bfloat16" else 1e-3)


def test_every_jax_variant_has_a_case():
    assert set(jax_registry.variants("softmax")) == set(NAMES)
    assert len(NAMES) == 10
    assert not [k for k in registry.PENDING if k[0] == "softmax"]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_grid_wide_row_matches_jax(dt):
    """online_softmax_grid streaming 8 column blocks in 2 row blocks, and
    #35 then #36 through their own plain versions at the same blocks."""
    x = _x((64, 4096), seed=1, scale=1.0)
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    kw = dict(block_rows=32, block_cols=512)

    def port(a):
        a = a.to(tdt)
        m, d = sm.grid_stats(a, **kw)
        assert m.shape == d.shape == (64, 8) and m.dtype == torch.float32
        return sm.grid_norm(a, m, d, **kw), sm.online_softmax_grid(a, **kw)

    def jax_fn(a):
        y = jax_sm.online_softmax_grid(a.astype(jdt), **kw)
        return y, y

    assert_parity(jax_fn, port, x, dtype=dt, name="online_softmax_grid")


@pytest.mark.parametrize("block_cols", [128, 500, 4096])
def test_grid_stats_ref_partials(block_cols):
    """#35's partials: per column block, m = max(NEG_BIG, the block's max)
    and d = sum(exp(x - m)); #36 merges them into the row's softmax."""
    x = torch.from_numpy(_x((5, 1300), seed=2))
    m, d = sm.grid_stats_ref(x, block_cols)
    ncb = -(-1300 // block_cols)
    assert m.shape == d.shape == (5, ncb)
    for j in range(m.shape[1]):
        blk = x[:, j * block_cols:(j + 1) * block_cols]
        assert torch.equal(m[:, j], blk.amax(-1))
        torch.testing.assert_close(d[:, j], torch.exp(
            blk - m[:, j:j + 1]).sum(-1), rtol=1e-6, atol=0)
    torch.testing.assert_close(sm.grid_norm_ref(x, m, d),
                               torch.softmax(x, -1), rtol=1e-5, atol=1e-6)


def test_global_softmax_matches_jax():
    x = _x((64, 256), seed=3, scale=2.0)
    assert_parity(jax_sm.softmax_global, sm.softmax_global, x,
                  dtype="float32", rtol=1e-4, atol=1e-6,
                  name="softmax_global")
    assert_parity(jax_sm._ref_global, sm.softmax_global_ref, x,
                  dtype="float32", rtol=1e-4, atol=1e-6,
                  name="softmax_global_ref")


@pytest.mark.parametrize("op,jax_op", [
    ("exp_sub",
     lambda a, m_: jnp.exp(a.astype(jnp.float32) - m_).astype(a.dtype)),
    ("div", lambda a, t_: (a.astype(jnp.float32) / t_).astype(a.dtype))])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_softmax_global_ew_ops_match_jax(op, jax_op, dt):
    """exp(a - s) and a / s with s a traced f32 scalar, in f32 rounded once
    to a's dtype: the two steps of softmax_global."""
    x = _x((63, 130), seed=4, scale=1.0)
    s = np.float32(1.7321 if op == "exp_sub" else 37.25)
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    assert_parity(
        lambda a, b: jax_ew_call(jax_op, a.astype(jdt), scalars=(b,)),
        lambda a, b: ew_call(op, a.to(tdt), scalars=(b,)), x, s, dtype=dt,
        name=f"{op} scalar")


def test_div_is_a_true_division():
    """a / s, not a * (1 / s): the two differ in the last bit for these."""
    a = torch.tensor([1.0, 3.0, 10.0, 7.0])
    s = torch.tensor(3.0)
    out = ew_call("div", a, scalars=(s,))
    assert torch.equal(out, a / s)
    assert not torch.equal(out, a * (1.0 / s))


def test_config_matches_jax():
    names = {str(d).removeprefix("torch.") for d in config.STORAGE_ONLY_DTYPES}
    assert names == set(jax_config.STORAGE_ONLY_DTYPES)
    for dt in (torch.float32, torch.bfloat16, torch.float16, torch.int8,
               torch.int32, torch.float8_e4m3fn, torch.float8_e5m2):
        name = str(dt).removeprefix("torch.")
        want = jnp.dtype(jax_config.kernel_dtype(jnp.dtype(name))).name
        assert str(config.kernel_dtype(dt)).removeprefix("torch.") == want
    x = torch.ones(3, dtype=torch.float16)
    assert config.to_kernel_dtype(x).dtype == torch.float32
    y = torch.ones(3, dtype=torch.bfloat16)
    assert config.to_kernel_dtype(y) is y


def _wrong(case, y):
    """y (a softmax) broken as a faulty kernel would break it."""
    if case == "zeros":
        return torch.zeros_like(y)
    if case == "half_scale":
        return (y.float() * 1.5).to(y.dtype)
    if case == "pack_missing_from_sum":  # d short of 4 f32 elements
        return (y.double() / (1 - y.double()[:, :4].sum(-1, keepdim=True))
                ).to(y.dtype)
    # d short of the last of 8 column blocks' partials
    return (y.double() / (1 - y.double()[:, -512:].sum(-1, keepdim=True))
            ).to(y.dtype)


# (dtype, shape, whole): the global softmax of 4096 x 16 (outputs about
# 1.5e-5, far below TOLS's atol), per-token rows of 4096 and 131072
@pytest.mark.parametrize("dt,shape,whole", [
    (torch.float32, (4096, 16), True), (torch.float32, (4, 4096), False),
    (torch.bfloat16, (4, 4096), False), (torch.float16, (4, 4096), False),
    (torch.float32, (2, 131072), False)], ids=str)
@pytest.mark.parametrize("case", ["plain", "zeros", "half_scale",
                                  "pack_missing_from_sum",
                                  "partial_missing"])
def test_softmax_check_refuses_wrong_outputs(case, dt, shape, whole):
    x = torch.from_numpy(_x(shape, seed=3, scale=1.0)).to(dt)
    y = sm.softmax_global_ref(x) if whole else sm.softmax_ref(x)
    out = y if case == "plain" else _wrong(case, y)
    ok, _, rule = ops_bench.softmax_check(out, y, dt, whole=whole)
    # 4 of 4096 elements' mass (about 1e-3) is under bf16's rounding
    want = case == "plain" or (case == "pack_missing_from_sum"
                               and dt == torch.bfloat16)
    assert ok == want, rule


def test_errors_and_cpu_dispatch():
    x = torch.from_numpy(_x((4, 9)))
    with pytest.raises(ValueError, match="2-D"):
        sm.softmax_per_token(x.reshape(-1))
    with pytest.raises(ValueError, match="block_rows"):
        sm.softmax_per_token(x, block_rows=0)
    with pytest.raises(ValueError, match="chunk"):
        sm.online_softmax_per_token(x, chunk=-1)
    with pytest.raises(ValueError, match="block_cols"):
        sm.online_softmax_grid(x, block_cols=0)
    launches = (sm.softmax_per_token.launches,
                sm.online_softmax_per_token.launches,
                sm.grid_stats.launches, sm.grid_norm.launches)
    for fn in (sm.softmax_per_token, sm.online_softmax_per_token,
               sm.online_softmax_grid):
        assert torch.equal(fn(x), sm.softmax_ref(x))
    assert launches == (sm.softmax_per_token.launches,
                        sm.online_softmax_per_token.launches,
                        sm.grid_stats.launches, sm.grid_norm.launches)


# (rows, cols, block_cols, itemsize, path, ncb): one tile, 3, the
# portable cluster's 8, 9 and the largest cluster's 16, one more than it
# holds, the sampling logits (256 tiles), tile rows of f32 past
# FUSED_ROW_BYTES_MAX and, in a cluster above 8, past
# FUSED_ROW_BYTES_WIDE, bf16 at the bench shape, fewer rows than a block
# holds
PLAN_CASES = [(300, 500, 512, 4, "cluster", 1),
              (1000, 1300, 512, 4, "cluster", 3),
              (129, 4001, 512, 4, "cluster", 8),
              (4095, 4097, 512, 4, "cluster", 9),
              (100, 8192, 512, 2, "cluster", 16),
              (100, 8193, 512, 4, "two", 17),
              (64, 131072, 512, 4, "two", 256),
              (8, 65536, 32768, 2, "two", 2),
              (8, 32768, 8192, 4, "cluster", 4),
              (8, 73728, 8192, 4, "two", 9),
              (4096, 4096, 512, 2, "cluster", 8),
              (7, 3, 512, 4, "cluster", 1)]


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_grid_plan_mirrors_the_rule(case):
    """grid_plan, csrc/softmax.cu fused_rows' mirror: the cluster kernel
    where a row's ncb tiles fit a cluster of 16 and a tile row of f32 (its
    exp(x - m)) fits 64 KiB (16 KiB in a cluster above 8), with
    FUSED_TILE_BYTES of x a tile (4 f32 rows of 512, 8 bf16 rows); else
    #35 then #36. Every tile of every row
    is owned by exactly one block of the launch, at one cluster a row
    block and with fewer clusters walking the row blocks."""
    rows, cols, bc, item, path, ncb = case
    plan = sm.grid_plan(rows, cols, block_cols=bc, itemsize=item)
    assert (plan.path, plan.ncb) == (path, ncb)
    if path == "cluster":
        assert plan.rows_a_block == min(
            max(sm.FUSED_TILE_BYTES // (plan.block_cols * item), 1),
            sm.FUSED_ROWS_MAX, rows)
    else:
        assert plan.rows_a_block == min(64, rows)
    for clusters in (None, 1, 5):
        owned = torch.zeros(rows, ncb, dtype=torch.int64)
        cols_seen = torch.zeros(cols, dtype=torch.int64)
        blocks = set()
        for b, r0, r1, c0, c1 in sm.grid_tiles(plan, rows, cols, clusters):
            assert c0 % plan.block_cols == 0 and c1 - c0 <= plan.block_cols
            assert r1 - r0 <= plan.rows_a_block and b % ncb == c0 // (
                plan.block_cols)
            owned[r0:r1, c0 // plan.block_cols] += 1
            blocks.add(b)
            if r0 == 0:
                cols_seen[c0:c1] += 1
        assert bool((owned == 1).all()) and bool((cols_seen == 1).all())
        n = plan.blocks // ncb
        if path == "cluster" and clusters:
            n = min(n, clusters)
        assert blocks == set(range(n * ncb))


def test_grid_plan_at_the_rules_edges():
    """The cluster path's edges, each way: 16 tiles of a row (a
    non-portable cluster) and not 17; a tile row of f32 of 16 KiB in a
    cluster above 8 and of 64 KiB in one of 8, not a byte more; 8 KiB of
    x a tile (4 f32 rows or 8 bf16 rows of 512), at most FUSED_ROWS_MAX
    rows and at most the array's."""
    def plan(rows, cols, bc=512, item=4):
        p = sm.grid_plan(rows, cols, block_cols=bc, itemsize=item)
        return p.path, p.ncb, p.rows_a_block
    assert sm.CLUSTER_LIMIT == 16 and sm.CLUSTER_PORTABLE == 8
    assert plan(64, 16 * 512) == ("cluster", 16, 4)
    assert plan(64, 16 * 512, item=2) == ("cluster", 16, 8)
    assert plan(64, 16 * 512 + 1) == ("two", 17, 64)
    assert plan(64, 9 * 4096, 4096) == ("cluster", 9, 1)
    assert plan(64, 9 * 4097, 4097) == ("two", 9, 64)
    assert plan(64, 8 * 16384, 16384) == ("cluster", 8, 1)
    assert plan(64, 8 * 16385, 16385) == ("two", 8, 64)
    assert plan(64, 1024, 64, 2) == ("cluster", 16, sm.FUSED_ROWS_MAX)
    assert plan(3, 4096) == ("cluster", 8, 3)


def _nan_rows_equal(a, b):
    """Equal NaN positions; the rest returned for a tolerance check."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    keep = ~np.isnan(b).any(-1)
    return a[keep], b[keep]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,cols,bc", [(40, 1000, 256), (24, 1000, 128),
                                          (16, 384, 384), (33, 1024, 128)])
def test_grid_fused_ref_matches_jax(rows, cols, bc, dt):
    """The cluster kernel's plain version (its partials merged in the
    order k = 0 ... ncb - 1) against JAX's online_softmax_grid (its tiles
    walked in order in interpret mode) at the same block_cols: columns no
    multiple of block_cols (JAX pads them to 128 lanes with NEG_BIG), one
    tile, and rows whose last tile (of several) or whose later half is
    -inf."""
    x = _x((rows, cols), seed=5)
    if cols > bc:
        x[3, (cols - 1) // bc * bc:] = -np.inf
    x[7, cols // 2:] = -np.inf
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    assert_parity(
        lambda a: jax_sm.online_softmax_grid(a.astype(jdt), block_rows=8,
                                             block_cols=bc),
        lambda a: sm.grid_fused_ref(a.to(tdt), bc), x, dtype=dt,
        name="grid_fused_ref")


def test_grid_fused_ref_rows_of_minus_inf():
    """A row of -inf: the plain version gives NaN (its tiles' partials
    (NEG_BIG, 0), then 0 / 0), as torch.softmax does and as JAX's
    online_softmax_grid does where cols is a multiple of 128 and of
    block_cols; the other rows agree. Where the padded width is no
    multiple of block_cols JAX gives NaN in every row, and where cols is
    no multiple of 128 it gives the -inf row 0 (its NEG_BIG padding
    counts exp(0) each): ROADMAP.md §3 open fault 4."""
    x = _x((16, 1536), seed=6)
    x[2] = -np.inf
    x[9, 1024:] = -np.inf
    xt = torch.from_numpy(x)
    ref = sm.grid_fused_ref(xt, 512)
    assert bool(ref[2].isnan().all()) and int(ref.isnan().sum()) == 1536
    assert torch.equal(ref.isnan(), torch.softmax(xt, -1).isnan())
    j = np.asarray(jax_sm.online_softmax_grid(jnp.asarray(x), block_rows=8,
                                              block_cols=512))
    a, b = _nan_rows_equal(ref.numpy(), j)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    # the reference's faults, recorded
    ragged = np.asarray(jax_sm.online_softmax_grid(
        jnp.asarray(x[:, :1152]), block_rows=8, block_cols=512))
    assert np.isnan(ragged).all()
    assert not sm.grid_fused_ref(xt[:, :1152], 512)[0].isnan().any()
    padded = np.asarray(jax_sm.online_softmax_grid(
        jnp.asarray(x[:, :1000]), block_rows=8, block_cols=256))
    assert (padded[2] == 0).all()
    assert bool(sm.grid_fused_ref(xt[:, :1000], 256)[2].isnan().all())


def test_grid_fused_ref_merge_order():
    """The cluster kernel's order, written out in f32: each tile's m_k
    (#35's) and e = exp(x - m_k), M the largest m_k, D the sum of d_k
    exp(m_k - M) in the order k = 0, 1, 2, the output e exp(m_k - M) / D:
    grid_fused_ref equals it bit for bit, and is within f32 rounding of
    grid_norm_ref's (all partials at once) and of torch.softmax."""
    x = torch.from_numpy(_x((9, 1300), seed=7))
    m, d = sm.grid_stats_ref(x, 512)
    M = m.amax(-1, keepdim=True)
    D = d[:, 0:1] * torch.exp(m[:, 0:1] - M)
    for k in (1, 2):
        D = D + d[:, k:k + 1] * torch.exp(m[:, k:k + 1] - M)
    out = sm.grid_fused_ref(x, 512)
    want = torch.cat([torch.exp(x[:, k * 512:(k + 1) * 512] - m[:, k:k + 1])
                      * (torch.exp(m[:, k:k + 1] - M) / D)
                      for k in range(3)], -1)
    assert torch.equal(out, want)
    torch.testing.assert_close(out, sm.grid_norm_ref(x, m, d), rtol=1e-5,
                               atol=1e-7)
    torch.testing.assert_close(out, torch.softmax(x, -1), rtol=1e-5,
                               atol=1e-7)


def test_grid_fused_cpu_dispatch_and_errors():
    x = torch.from_numpy(_x((6, 700), seed=8))
    n = (sm.grid_fused.launches, sm.grid_stats.launches,
         sm.grid_norm.launches)
    assert torch.equal(sm.grid_fused(x, block_cols=256),
                       sm.grid_fused_ref(x, 256))
    assert torch.equal(sm.online_softmax_grid(x, block_cols=256),
                       sm.softmax_ref(x))
    assert n == (sm.grid_fused.launches, sm.grid_stats.launches,
                 sm.grid_norm.launches)
    with pytest.raises(ValueError, match="block_cols"):
        sm.grid_fused(x, block_cols=0)
    with pytest.raises(ValueError, match="2-D"):
        sm.grid_fused(x.reshape(-1))
