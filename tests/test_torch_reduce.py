"""Reductions and the dot product of the port (ops/reduce.py #31,
ops/dot_product.py #32) against the JAX package's and against the f64
sum, at tests/test_reduce.py's sizes and bounds (_REL).

The inputs are tests/test_reduce.py's: -1, -0.5, 0, 0.5 and 1, exact in
every dtype. Their sums are exact in f32 too, so every f32-accumulated
variant equals JAX's and f64's; the int32 ones are exact by type; the
bf16 accumulator (each add rounded to bf16 on the card; one f32 sum
rounded once in the plain version) is held to JAX and to f64 by _REL.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpukern.ops  # noqa: F401
from torch_parity import assert_parity, to_numpy
from tpukern.core import registry as jax_registry
from tpukern_torch.core import registry
from tpukern_torch.ops import dot_product, reduce

_REL = {"float32": 1e-5, "bfloat16": 3e-2, "float16": 1e-2, "int32": 0.0}
SUMS = [v[0] for v in reduce._SUM_VARIANTS]
MAXES = [v[0] for v in reduce._MAX_VARIANTS]
DOTS = [v[0] for v in dot_product._VARIANTS]


def _exact_vals(seed, shape):
    return np.random.default_rng(seed).choice(
        [-1.0, -0.5, 0.0, 0.5, 1.0], size=shape).astype(np.float32)


def _f64(out):
    return float(np.asarray(to_numpy(out), np.float64))


@pytest.mark.parametrize("sfx", SUMS)
def test_sum_variant_matches_jax_and_f64(sfx):
    x = _exact_vals(1, (300, 200))
    name = f"sum_{sfx}"
    acc = dict((s, a) for s, _, a in reduce._SUM_VARIANTS)[sfx]
    port = registry.get("reduce", name).fn(torch.from_numpy(x))
    jax_out = jax_registry.get("reduce", name).fn(jnp.asarray(x))
    assert port.shape == () and port.dtype == acc
    in_dt = dict((s, i) for s, i, _ in reduce._SUM_VARIANTS)[sfx]
    ref = float(torch.from_numpy(x).to(in_dt).double().sum())
    rel = _REL.get(str(acc).removeprefix("torch."), 3e-1)
    for got in (_f64(port), _f64(jax_out)):
        assert abs(got - ref) <= max(abs(ref) * rel, rel * 100)
    if acc != torch.bfloat16:  # exact sums: equal to JAX's
        assert _f64(port) == _f64(jax_out)


@pytest.mark.parametrize("sfx", MAXES)
def test_max_variant_matches_jax(sfx):
    x = _exact_vals(2, (100, 150))
    name = f"max_{sfx}"
    assert_parity(jax_registry.get("reduce", name).fn,
                  registry.get("reduce", name).fn, x, dtype="float32",
                  rtol=0, atol=0, name=name)


@pytest.mark.parametrize("sfx", DOTS)
def test_dot_variant_matches_jax_and_f64(sfx):
    a, b = _exact_vals(3, (200, 130)), _exact_vals(4, (200, 130))
    name = f"dot_{sfx}"
    err = assert_parity(jax_registry.get("dot_product", name).fn,
                        registry.get("dot_product", name).fn, a, b,
                        dtype="float32", rtol=0, atol=0, name=name)
    ref = (a.astype(np.float64) * b).sum()
    assert err == 0 and _f64(registry.get("dot_product", name).fn(
        torch.from_numpy(a), torch.from_numpy(b))) == ref


def test_every_jax_variant_has_a_case():
    assert {n for n in jax_registry.variants("reduce")} == {
        f"sum_{s}" for s in SUMS} | {f"max_{s}" for s in MAXES}
    assert set(jax_registry.variants("dot_product")) == {
        f"dot_{s}" for s in DOTS}


def test_errors():
    x = torch.ones(8)
    with pytest.raises(ValueError, match="dot_prod"):
        dot_product.dot_prod(x, torch.ones(9))
    assert reduce.max_all(torch.tensor([-3, 5, 2], dtype=torch.int8),
                          torch.int32).item() == 5
    assert reduce.sum_all(x.to(torch.float8_e5m2), torch.float16).dtype \
        == torch.float16
