"""The layer_norm family of the port (ops/layernorm.py, kernel #37) against
the JAX package's (tpukern/ops/layernorm.py).

Every registry variant runs on the same numpy inputs, at (40, 48) and
(63, 130), through the JAX variant (its Pallas kernel in interpret mode)
and the port's (its plain version on the CPU), at the tolerance of the
variant's dtype (core.tolerances: f32 1e-5, bf16 2e-2, f16 2e-3), with g
and b at their defaults, as the scalars 1.5 and 0.3, and as (K,) vectors.
The bf16 accumulator rounds mean and var after var is formed; the
one-pass variance's cliff (a large mean against a small spread) holds the
port's plain version to JAX's kernel and away from the two-pass
reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpukern.ops  # noqa: F401
import tpukern_torch.ops  # noqa: F401
from torch_parity import assert_parity
from tpukern.core import registry as jax_registry
from tpukern.ops import layernorm as jax_ln
from tpukern_torch.core import registry
from tpukern_torch.ops import layernorm

SHAPES = [(40, 48), (63, 130)]
NAMES = sorted(registry.variants("layer_norm"))
_DT = {"bf16": "bfloat16", "f16": "float16"}


def _dtype(name):
    return _DT.get(name.split("_")[2], "float32")


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("affine", ["default", "scalars", "vectors"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_variant_matches_jax(name, shape, affine):
    x = _randn(shape[0] * shape[1], *shape)
    jv, tv = jax_registry.get("layer_norm", name), registry.get("layer_norm",
                                                                name)
    if affine == "vectors":
        g = 1 + 0.1 * _randn(1, shape[1])
        b = 0.1 * _randn(2, shape[1])
        assert_parity(jv.fn, tv.fn, x, g, b, dtype=_dtype(name), name=name)
    else:
        kw = {} if affine == "default" else dict(g=1.5, b=0.3)
        assert_parity(lambda a: jv.fn(a, **kw), lambda a: tv.fn(a, **kw), x,
                      dtype=_dtype(name), name=name)
    out = tv.fn(torch.from_numpy(x))
    assert out.shape == shape and str(out.dtype) == f"torch.{_dtype(name)}"


def test_every_jax_variant_has_a_case():
    assert set(jax_registry.variants("layer_norm")) == set(NAMES)
    assert len(NAMES) == 8
    assert not [k for k in registry.PENDING if k[0] == "layer_norm"]


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_bf16_accumulator_rounds_mean_and_var(acc):
    """Rows m, m, m, m with m = 1 + 2^-9: var is formed from the unrounded
    mean (exactly 0), then mean rounds to 1.0 in bf16, so y = 2^-9 /
    sqrt(eps); in f32, y = 0. Rows s, -s, s, -s with s^2 = 1 + 2^-9 (mean
    0): var rounds to 1.0 in bf16, so with eps 0 y = x. JAX's kernel
    computes the same."""
    m = np.float32(1 + 2 ** -9)
    s = np.sqrt(m, dtype=np.float32)
    flat, spread = (np.array([[m, m, m, m]], np.float32),
                    np.array([[s, -s, s, -s]], np.float32))
    bf16 = acc == "bfloat16"
    for x, eps in ((flat, 1e-5), (spread, 0.0)):
        kw = dict(eps=eps, acc_dtype=getattr(torch, acc))
        assert_parity(lambda a: jax_ln.layer_norm(
            a, eps=eps, acc_dtype=getattr(jnp, acc)),
            lambda a: layernorm.layer_norm(a, **kw), x, dtype="float32",
            name=f"{acc} eps {eps}")
        y = layernorm.layer_norm(torch.from_numpy(x), **kw)
        if eps:
            want = 2 ** -9 / np.sqrt(np.float32(eps)) if bf16 else 0.0
            np.testing.assert_allclose(y.numpy(), want, rtol=1e-5)
        else:
            assert torch.equal(y, torch.from_numpy(x)) == bf16


def test_one_pass_variance_cliff():
    """Rows of 16 values from 299, 299.5, ..., 301: mean 300, spread about
    0.7, sums exact in f32 in any order. The port's plain version equals
    JAX's kernel (var = E[x^2] - mean^2, mean^2 rounded at 90000's ulp),
    and both are 1e-2 away from the two-pass reference, JAX's and the
    port's alike."""
    rng = np.random.default_rng(7)
    x = (300 + 0.5 * rng.integers(-2, 3, size=(64, 16))).astype(np.float32)
    assert_parity(lambda a: jax_ln.layer_norm(a), layernorm.layer_norm, x,
                  dtype="float32", name="one-pass")
    assert_parity(jax_ln.layer_norm_ref, layernorm.layer_norm_ref, x,
                  dtype="float32", name="two-pass")
    xt = torch.from_numpy(x)
    gap = (layernorm.layer_norm_plain(xt) - layernorm.layer_norm_ref(xt))
    assert gap.abs().max().item() > 1e-3


def test_plain_versions_on_the_affines():
    """g and b each a number or a vector, mixed; layer_norm_ref (two-pass)
    and layer_norm_plain agree off the cliff."""
    x = torch.from_numpy(_randn(5, 7, 33))
    g = torch.from_numpy(1 + 0.1 * _randn(6, 33))
    b = torch.from_numpy(0.1 * _randn(8, 33))
    for gg, bb in ((g, 0.3), (1.5, b), (g, b.bfloat16()), (1.5, 0.3)):
        torch.testing.assert_close(layernorm.layer_norm(x, gg, bb),
                                   layernorm.layer_norm_ref(x, gg, bb),
                                   rtol=1e-5, atol=1e-5)
    assert layernorm.layer_norm(x.reshape(7, 3, 11)).shape == (7, 3, 11)
