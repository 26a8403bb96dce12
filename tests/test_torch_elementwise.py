"""The elementwise and activation families of the port (ops/_ew.py,
elementwise.py, activations.py; kernel #30) against the JAX package's.

Every registry variant of the eight families runs on the same numpy
inputs through the JAX variant (its Pallas kernel in interpret mode) and
the port's (its plain version on the CPU), at the tolerance of the
variant's dtype (core.tolerances: f32 1e-5, bf16 2e-2). add, mul and
relu are held bit for bit: JAX computes them on bf16 in bf16, the port in
f32 rounded once, which is the same correctly rounded result. The scalar
operand of ew_call against JAX's SMEM scalar.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpukern.ops  # noqa: F401
import tpukern_torch.ops  # noqa: F401
from torch_parity import assert_parity
from tpukern.core import registry as jax_registry
from tpukern.ops._ew import ew_call as jax_ew_call
from tpukern_torch.core import registry
from tpukern_torch.ops import _ew, activations, elementwise
from tpukern_torch.ops._ew import ew_call, ew_ref

EW_FAMILIES = ["elementwise", "relu", "elu", "gelu", "swish", "sigmoid",
               "hardswish", "hardshrink"]
# (256, 256): whole vectors at every width; (63, 130) = 8190 elements, no
# multiple of 4 or 8: the tails
SHAPES = [(256, 256), (63, 130)]
CASES = [(f, n) for f in EW_FAMILIES for n in sorted(registry.variants(f))]
EXACT = ("add", "mul", "relu")


def _dtype(name):
    return "bfloat16" if "bf16" in name else "float32"


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("family,name", CASES)
def test_variant_matches_jax(family, name, shape):
    rng = np.random.default_rng(7)
    nargs = 2 if family == "elementwise" else 1
    xs = [rng.standard_normal(shape).astype(np.float32)
          for _ in range(nargs)]
    exact = name.split("_")[0] in EXACT
    assert_parity(jax_registry.get(family, name).fn,
                  registry.get(family, name).fn, *xs, dtype=_dtype(name),
                  name=f"{family}.{name}",
                  **(dict(rtol=0, atol=0) if exact else {}))


def test_every_jax_variant_has_a_case():
    assert {(f, n) for f in EW_FAMILIES
            for n in jax_registry.variants(f)} == set(CASES)
    assert len(CASES) == 54


@pytest.mark.parametrize("op,jax_op", [
    ("add", lambda a, s: (a.astype(jnp.float32) + s).astype(a.dtype)),
    ("mul", lambda a, s: (a.astype(jnp.float32) * s).astype(a.dtype))])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_scalar_operand_matches_jax(op, jax_op, dt):
    """x op s with s a traced f32 scalar, in f32 and rounded to x's dtype
    (softmax_global's form): JAX's SMEM operand, the port's device-memory
    operand (a 0-d tensor)."""
    x = np.random.default_rng(3).standard_normal((63, 130)).astype(
        np.float32)
    s = np.float32(-0.7321)
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    assert_parity(
        lambda a, b: jax_ew_call(jax_op, a.astype(jdt), scalars=(b,)),
        lambda a, b: ew_call(op, a.to(tdt), scalars=(b,)), x, s, dtype=dt,
        name=f"{op} scalar")


def test_public_functions_and_errors():
    x = torch.randn(5, 7)
    y = torch.randn(5, 7)
    torch.testing.assert_close(elementwise.add(x, y), x + y)
    torch.testing.assert_close(elementwise.mul(x, y), x * y)
    for name in activations.ACTIVATIONS:
        torch.testing.assert_close(getattr(activations, name)(x),
                                   ew_ref(name, x))
    with pytest.raises(ValueError, match="operands"):
        ew_call("add", x)
    with pytest.raises(ValueError, match="operands"):
        ew_call("relu", x, y)
    with pytest.raises(ValueError, match="one shape"):
        ew_call("add", x, y[:, :3])
    with pytest.raises(ValueError, match="unknown op"):
        ew_call("tanh", x)


# n: empty, one element, a bf16 x1 block's span (256 threads x 8 packs)
# and f32 x1's (256 x 4), each +- 1, and the zoo's tail 4095 x 4097
PLAN_NS = [0, 1, 2047, 2048, 2049, 1023, 1025, 4095 * 4097]


@pytest.mark.parametrize("tier", [t[0] for t in _ew.EW_TIERS])
@pytest.mark.parametrize("n", PLAN_NS)
def test_ew_plan_covers_every_element_once(n, tier):
    """ew_elements, the mirror of csrc/elementwise.cu's thread-to-pack map
    (U packs a thread EW_THREADS * vec apart, one block a span, the
    straddling pack's tail element by element), writes every element of
    [0, n) exactly once, with 16 bytes of each operand a thread."""
    _, dt, vec = next(t for t in _ew.EW_TIERS if t[0] == tier)
    item = torch.empty((), dtype=dt).element_size()
    el = _ew.ew_elements(n, vec, item)
    u, span, blocks = _ew.ew_plan(n, vec, item)
    assert u * vec * item == max(16, vec * item)
    assert span == _ew.EW_THREADS * vec * u
    assert blocks * span >= n > (blocks - 1) * span or n == blocks == 0
    counts = torch.bincount(el, minlength=n)
    assert counts.numel() == n and bool((counts == 1).all())
