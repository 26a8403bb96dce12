"""The port's variant registry against the JAX package's: the progress
meter of the port (ROADMAP.md queue 1 item 1).

Every (family, name) of tpukern's registry is a tpukern_torch variant or
a core.registry.PENDING entry with its reason; the port has no name the
JAX registry lacks; every port variant has a plain version (`ref`). Each
port variant also runs on CPU inputs made by `inputs` of
tpukern_torch/harness/ops_bench.py (at a tiny size) and agrees with its
plain version by ops_bench's own check.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tpukern.ops  # noqa: F401  (fills the JAX registry)
import tpukern_torch.ops  # noqa: F401  (fills the port's)
from torch_parity import assert_parity
from tpukern.core import registry as jax_registry
from tpukern_torch.core import registry
from tpukern_torch.harness import ops_bench


def _names(reg):
    return {(f, n) for f in reg.families() for n in reg.variants(f)}


JAX_NAMES = _names(jax_registry)
PORT_NAMES = _names(registry)


def test_every_jax_variant_is_ported_or_pending():
    missing = JAX_NAMES - PORT_NAMES - set(registry.PENDING)
    assert not missing, f"neither ported nor pending: {sorted(missing)}"
    assert not PORT_NAMES & set(registry.PENDING), "ported and pending"
    # the meter: 198 of the JAX registry's 207 variants
    assert len(PORT_NAMES) == 198


def test_no_port_variant_outside_the_jax_registry():
    assert PORT_NAMES <= JAX_NAMES, sorted(PORT_NAMES - JAX_NAMES)
    assert set(registry.PENDING) <= JAX_NAMES, sorted(
        set(registry.PENDING) - JAX_NAMES)


def test_pending_reasons_name_the_roadmap():
    for key, reason in registry.PENDING.items():
        assert reason.strip() and "ROADMAP.md" in reason, key


@pytest.mark.parametrize("family", sorted(registry.families()))
def test_every_port_variant_has_a_plain_version(family):
    for name, v in registry.variants(family).items():
        assert callable(v.fn) and callable(v.ref), (family, name)
        assert (v.family, v.name) == (family, name)


@pytest.mark.parametrize("family", sorted(registry.families()))
def test_variants_on_cpu_agree_with_their_plain_versions(family):
    """Each variant on the CPU (its plain path) against its `ref` on the
    ops_bench inputs at a tiny size, by ops_bench.check."""
    gen = torch.Generator("cpu").manual_seed(0)
    for name, v in sorted(registry.variants(family).items()):
        args = ops_bench.inputs(family, name, ops_bench.TINY, gen)
        ok, err, rule = ops_bench.check(v, args)
        assert ok, f"{family}.{name}: {rule} missed ({err:.3e})"


def test_parity_helper_compares_at_the_dtype_tolerance():
    x = np.linspace(-1, 1, 64, dtype=np.float32)
    assert_parity(lambda a: a * 2, lambda a: a * 2, x, dtype="float32")
    with pytest.raises(AssertionError):
        assert_parity(lambda a: a * 2, lambda a: a * 2 + 1e-3, x,
                      dtype="float32")
    assert_parity(lambda a: a * 2, lambda a: a * 2 + 1e-3, x,
                  dtype="bfloat16")
    with pytest.raises(AssertionError):  # integers exactly
        assert_parity(lambda a: a + 1, lambda a: a + 2,
                      np.arange(4, dtype=np.int32), dtype="int32")


def _tf32(t):
    # round to nearest on TF32's 10 mantissa bits, as a TF32 mma reads
    bits = t.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("order,ok", [("rows in sequence", True),
                                      ("tf32 inputs", False)])
def test_grouped_matmul_check_holds_f32_rounding_not_tf32(order, ok):
    """ops_bench.check holds tgmm_f32 within TOLS plus its contraction
    slack: a product summing a 1024-row group in another f32 order
    passes, one that reads its inputs as TF32 misses."""
    v = registry.get("grouped_matmul", "tgmm_f32")
    gen = torch.Generator("cpu").manual_seed(0)
    x = torch.randn(2048, 24, generator=gen)
    dy = torch.randn(2048, 16, generator=gen)
    gs = torch.tensor([1024, 1024], dtype=torch.int32)

    def fn(x, dy, gs):
        if order == "tf32 inputs":
            return v.ref(_tf32(x), _tf32(dy), gs)
        out = torch.zeros(2, 24, 16)
        for e in range(2):
            for t in range(1024 * e, 1024 * (e + 1)):
                out[e] += torch.outer(x[t], dy[t])
        return out

    other = dataclasses.replace(v, fn=fn)
    good, err, rule = ops_bench.check(other, (x, dy, gs))
    assert good == ok, f"{order}: {rule} ({err:.3e})"
    assert err > 0
