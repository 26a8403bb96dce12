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
