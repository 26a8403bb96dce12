"""Reductions and the dot product of the port (ops/reduce.py #31,
ops/dot_product.py #32) against the JAX package's and against the f64
sum, at tests/test_reduce.py's sizes and bounds (_REL).

The inputs are tests/test_reduce.py's: -1, -0.5, 0, 0.5 and 1, exact in
every dtype. Their sums are exact in f32 too, so every f32-accumulated
variant equals JAX's and f64's; the int32 ones are exact by type; the
bf16 accumulator (each add rounded to bf16 on the card; one f32 sum
rounded once in the plain version) is held to JAX and to f64 by _REL.
`reduce.sum_bf16_in_order`, the card's bf16 accumulator in the kernel's
own order, is held to a scalar walk of csrc/reduce.cu's threads.
"""

import struct

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


def _bf16(v):
    """v rounded to f32, then to bf16 by round half to even: the kernel's
    round_bf16 of an f32 sum."""
    u = struct.unpack("<I", struct.pack("<f", v))[0]
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return struct.unpack("<f", struct.pack("<I", u))[0]


def _in_order_scalar(vals, vec):
    """csrc/reduce.cu's bf16-accumulator sum of vals (bf16 values), one
    thread at a time: G blocks of 256 threads, thread t's packs of vec
    elements t, t + 256 G, ..., then the tail element at t; each block's
    warp trees; pass 2's folds of the G partials and its tree."""
    n, nvec = len(vals), len(vals) // vec
    g = min(max(-(-n // (256 * vec * 8)), 1), 1024)

    def warp(lanes):
        for o in (16, 8, 4, 2, 1):
            lanes = [_bf16(lanes[i] + lanes[i ^ o]) for i in range(32)]
        return lanes[0]

    def block(v):
        return warp([warp(v[32 * k:32 * k + 32]) for k in range(8)]
                    + [0.0] * 24)

    acc = []
    for t in range(256 * g):
        a = 0.0
        for i in range(t, nvec, 256 * g):
            for j in range(vec):
                a = _bf16(a + vals[i * vec + j])
        if nvec * vec + t < n:
            a = _bf16(a + vals[nvec * vec + t])
        acc.append(a)
    part = [block(acc[256 * b:256 * b + 256]) for b in range(g)]
    folds = []
    for t in range(256):
        a = 0.0
        for i in range(t, g, 256):
            a = _bf16(a + part[i])
        folds.append(a)
    return block(folds)


# n: one block (a tail of 3 elements), and 4 blocks with threads of
# unequal shares and a tail; bf16 inputs (8 a pack) and f32 ones (4)
@pytest.mark.parametrize("n", [1, 4099, 49157])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=str)
def test_sum_bf16_in_order_matches_scalar_walk(dt, n):
    x = torch.from_numpy(3 * np.random.default_rng(n).standard_normal(
        n).astype(np.float32)).to(dt)
    vals = x.float().to(torch.bfloat16).float().tolist()
    out = reduce.sum_bf16_in_order(x)
    assert out.shape == () and out.dtype == torch.bfloat16
    assert out.item() == _in_order_scalar(vals, 16 // x.element_size())


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
