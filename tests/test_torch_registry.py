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
from tpukern_torch.ops import split_tf32


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
    """ops_bench.check holds an f32 grouped variant off the split-TF32
    tier (the ragged-dot baseline, torch.matmul a group) within TOLS plus
    its contraction slack: a product summing each row's 1024 terms in
    sequence, another f32 order, passes; one that reads its inputs as
    TF32 misses. (The f32 gmm and tgmm, on split-TF32 products, are held
    to the accuracy gate: the next tests.)"""
    v = registry.get("grouped_matmul", "gmm_ragged_dot_xla")
    gen = torch.Generator("cpu").manual_seed(0)
    x = torch.randn(48, 1024, generator=gen)
    w = torch.randn(2, 1024, 16, generator=gen)
    gs = torch.tensor([24, 24], dtype=torch.int32)
    assert not ops_bench.runs_split_tf32(v, (x, w, gs))

    def fn(x, w, gs):
        if order == "tf32 inputs":
            return v.ref(_tf32(x), _tf32(w), gs)
        out = torch.zeros(48, 16)
        for e in range(2):
            for k in range(1024):
                out[24 * e:24 * (e + 1)] += torch.outer(
                    x[24 * e:24 * (e + 1), k], w[e, k])
        return out

    other = dataclasses.replace(v, fn=fn)
    good, err, rule = ops_bench.check(other, (x, w, gs))
    assert good == ok, f"{order}: {rule} ({err:.3e})"
    assert err > 0


def _dropped_cross_term(a, b):
    """a @ b with A_lo·B_hi left out of the split product."""
    (ah, _), (bh, bl) = split_tf32.split_tf32_ref(a), split_tf32.split_tf32_ref(
        b)
    return ah @ bh + ah @ bl


@pytest.mark.parametrize("order,ok", [("split-TF32 model", True),
                                      ("torch.matmul f32", True),
                                      ("one cross term dropped", False),
                                      ("tf32 inputs", False)])
@pytest.mark.parametrize("name", ["gmm_f32", "tgmm_f32"])
def test_grouped_f32_check_holds_split_tf32_not_tf32(name, order, ok):
    """ops_bench.check holds the f32 grouped products (#28/#29 on
    split-TF32 products) to the accuracy gate as matmul's: the largest
    error against the f64 grouped product at most SPLIT_GATE times the
    plain loop's (torch.matmul f32 a group). The f32 tier's plain model
    (gmm_split_ref, tgmm_split_ref) and the plain loop pass; the split
    without A_lo·B_hi and a product of TF32 inputs miss; the bound counts
    the operations as split-TF32 products."""
    from tpukern_torch.ops import grouped_matmul as gm

    v = registry.get("grouped_matmul", name)
    gen = torch.Generator("cpu").manual_seed(2)
    tg = name.startswith("tgmm")
    if tg:  # two groups of 1024 tokens: the contraction
        a, b = torch.randn(2048, 24, generator=gen), torch.randn(
            2048, 16, generator=gen)
        gs = torch.tensor([1024, 1000], dtype=torch.int32)
    else:  # rows of K = 1024 in two groups, 8 rows past them
        a, b = torch.randn(56, 1024, generator=gen), torch.randn(
            2, 1024, 16, generator=gen)
        gs = torch.tensor([24, 24], dtype=torch.int32)
    args = (a, b, gs)
    assert ops_bench.runs_split_tf32(v, args)
    assert ops_bench.work(v, args, v.ref(*args))[1] == ops_bench.SPLIT_TF32

    def fn(a, b, gs):
        if order == "tf32 inputs":
            return v.ref(_tf32(a), _tf32(b), gs)
        if order == "split-TF32 model":
            return (gm.tgmm_split_ref if tg else gm.gmm_split_ref)(a, b, gs)
        if order == "one cross term dropped":
            if tg:
                return torch.stack([_dropped_cross_term(a[s:s + n].T,
                                                        b[s:s + n])
                                    for s, n in ((0, 1024), (1024, 1000))])
            return torch.cat([_dropped_cross_term(a[24 * e:24 * (e + 1)],
                                                  b[e]) for e in range(2)]
                             + [torch.zeros(8, 16)])
        return v.ref(a, b, gs)

    other = dataclasses.replace(v, fn=fn)
    good, err, rule = ops_bench.check(other, args)
    assert good == ok, f"{name} {order}: {rule} ({err:.3e})"
    assert err > 0 or order == "torch.matmul f32"


@pytest.mark.parametrize("order,ok", [("split-TF32 model", True),
                                      ("torch.matmul f32", True),
                                      ("one cross term dropped", False),
                                      ("tf32 inputs", False)])
def test_matmul_f32_check_holds_split_tf32_not_tf32(order, ok):
    """ops_bench.check holds the split-TF32 f32 tier of matmul to the
    accuracy gate (ops_bench.split_gate): its largest error against the
    f64 product at most SPLIT_GATE times torch.matmul's in f32. The split
    product's plain model (5x closer to f64 than torch.matmul here) and
    torch.matmul itself pass; the split without A_lo·B_hi and a product
    that reads its inputs as TF32 (one pass) miss; the bound counts its
    operations as split-TF32 products."""
    v = registry.get("matmul", "sgemm_ksliced_f32")
    gen = torch.Generator("cpu").manual_seed(1)
    a, b = torch.randn(24, 1024, generator=gen), torch.randn(
        1024, 16, generator=gen)
    assert ops_bench.runs_split_tf32(v, (a, b))
    # the rule's other members: the f32 grouped products, not their bf16
    # variants (on the same f32 arguments) or the ragged-dot baseline
    g = (a, torch.randn(2, 1024, 16, generator=gen),
         torch.tensor([12, 12], dtype=torch.int32))
    runs = {n: ops_bench.runs_split_tf32(registry.get("grouped_matmul", n), g)
            for n in registry.variants("grouped_matmul")}
    assert runs == {"gmm_f32": True, "tgmm_f32": True, "gmm_bf16": False,
                    "gmm_ragged_dot_xla": False}
    assert ops_bench.work(v, (a, b), v.ref(a, b))[1] == ops_bench.SPLIT_TF32

    def fn(a, b):
        if order == "tf32 inputs":
            return v.ref(_tf32(a), _tf32(b))
        if order == "split-TF32 model":
            return split_tf32.matmul_split_ref(a, b)
        if order == "one cross term dropped":
            (ah, _), (bh, bl) = split_tf32.split_tf32_ref(
                a), split_tf32.split_tf32_ref(b)
            return ah @ bh + ah @ bl
        return torch.matmul(a, b)

    other = dataclasses.replace(v, fn=fn)
    good, err, rule = ops_bench.check(other, (a, b))
    assert good == ok, f"{order}: {rule} ({err:.3e})"
    assert err > 0
