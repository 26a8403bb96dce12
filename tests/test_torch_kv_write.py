"""The serving path's quantized K/V write (ops/quant.py write_kv_quantized,
#20/#22 in one launch a layer on the card) against the JAX package on the
CPU: its plain twin equals JAX's _write_tokens_quantized for K and for V
(values bit for bit, scales equal) at a decode write, a verify write, a
write clamped at the pool's end and a ring write of more tokens than the
ring holds, with V a transposed view as the serving step makes it; and
models/serving.py _write_kv on a CPU cache equals the path it replaced
(quantize_int8 / quantize_fp8 over all rows, then the scatters) bit for
bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.models import serving as jax_serving
from tpukern_torch.models import serving
from tpukern_torch.ops import quant

TIERS = {"int8": (torch.int8, jnp.int8),
         "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# name -> (B, T, starts, ring, sinks): pools of 2 layers, Hkv 2, 4 pages
# of 8 slots a sequence (32), D 16; the clamped write starts 2 slots from
# the end (3 of its 5 tokens clamp onto the last slot), the ring write of
# 40 tokens passes its 30 rotating slots
CASES = {"decode": (3, 1, (0, 9, 31), False, 0),
         "verify": (2, 5, (3, 17), False, 0),
         "clamped tail": (2, 5, (3, 30), False, 0),
         "ring wrap": (2, 40, (5, 70), True, 2)}
L, HKV, PAGE, PPS, D = 2, 2, 8, 4, 16


def _case(name, dt, seed):
    """k (B, Hkv, T, D) contiguous, v a transposed (B, T, Hkv, D) view, of
    scale 3 with a row of zeros in each (its last token); the page table
    and starts."""
    B, T, starts, _, _ = CASES[name]
    rng = np.random.default_rng(seed)
    k = (3 * rng.standard_normal((B, HKV, T, D))).astype(np.float32)
    v = (3 * rng.standard_normal((B, T, HKV, D))).astype(np.float32)
    k[0, 0, -1] = 0  # the newest token: no ring write passes over it
    v[-1, -1, -1] = 0
    table = rng.permutation(B * PPS).astype(np.int32).reshape(B, PPS)
    kt = torch.from_numpy(k).to(DTYPES[dt])
    vt = torch.from_numpy(v).to(DTYPES[dt]).transpose(1, 2)
    return kt, vt, table, np.asarray(starts, np.int32)


def _pools(B, tdt):
    shape = (L, HKV, B * PPS, PAGE, D)
    return (torch.zeros(shape, dtype=tdt), torch.zeros(shape[:4]),
            torch.zeros(shape, dtype=tdt), torch.zeros(shape[:4]))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("name", list(CASES))
def test_write_kv_quantized_ref_matches_jax(name, tier, dt):
    """K and V written by the plain twin equal JAX's quantized write of
    each: pool bytes bit for bit, scales equal, at layer 1 of 2."""
    tdt, jdt = TIERS[tier]
    B, T, _, ring, sinks = CASES[name]
    k, v, table, start = _case(name, dt, len(name) + T)
    slots = serving._slots(torch.from_numpy(table), torch.from_numpy(start),
                           T, PAGE, ring=ring, sinks=sinks)
    if ring:
        assert slots[2] is not None  # a slot takes several tokens
    pools = _pools(B, tdt)
    quant.write_kv_quantized(k, v, *pools, 1, slots)
    for new, pages, scales in ((k, pools[0], pools[1]),
                               (v, pools[2], pools[3])):
        jp, js = jax_serving._write_tokens_quantized(
            jnp.zeros(pages.shape, jdt), jnp.zeros(scales.shape), 1,
            jnp.asarray(new.float().numpy()), jnp.asarray(table),
            jnp.asarray(start), ring=ring, sinks=sinks)
        np.testing.assert_array_equal(pages.view(torch.uint8).numpy(),
                                      np.asarray(jp).view(np.uint8))
        np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
    assert not pools[0][0].view(torch.uint8).any()  # layer 0 untouched
    assert (pools[1][1] == 1).any()  # the row of zeros: scale 1


def _pre_pr_write(cache, layer, k, v, slots):
    """The quantized write as _write_kv did it before the fused write:
    quantize_int8 / quantize_fp8 over all B * Hkv * T rows of K, then V,
    each followed by the two scatters of values and scales."""
    for pages, scales, new in ((cache.k_pages, cache.k_scales, k),
                               (cache.v_pages, cache.v_scales, v)):
        B, Hkv, T, D_ = new.shape
        qfn = (quant.quantize_int8 if pages.dtype == torch.int8
               else quant.quantize_fp8)
        vals, s = qfn(new.reshape(B * Hkv * T, D_))
        quant.scatter_slots(pages, layer, vals.reshape(B, Hkv, T, D_),
                            slots)
        quant.scatter_slots(scales, layer, s.reshape(B, Hkv, T), slots)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("name", list(CASES))
def test_write_kv_on_cpu_cache_equals_pre_pr_path(name, tier, dt):
    """serving._write_kv on a CPU cache of the quantized tier: the pools
    and scales of both layers equal the replaced path's bit for bit."""
    tdt, _ = TIERS[tier]
    B, T, _, ring, sinks = CASES[name]
    k, v, table, start = _case(name, dt, 7 * T)
    slots = serving._slots(torch.from_numpy(table), torch.from_numpy(start),
                           T, PAGE, ring=ring, sinks=sinks)
    caches = []
    for _ in range(2):
        kp, ks, vp, vs = _pools(B, tdt)
        z = torch.zeros(1)
        caches.append(serving.KVCache(
            k_pages=kp, v_pages=vp, page_table=torch.from_numpy(table),
            lengths=z, cos=z, sin=z, k_scales=ks, v_scales=vs, ring=ring))
    before = quant.write_kv_quantized.launches
    serving._write_kv(caches[0], 1, k, v, slots)
    _pre_pr_write(caches[1], 1, k, v, slots)
    for name_ in ("k_pages", "v_pages", "k_scales", "v_scales"):
        a, b = getattr(caches[0], name_), getattr(caches[1], name_)
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name_
    assert quant.write_kv_quantized.launches == before  # plain on the CPU


def test_write_kv_quantized_rejects_mismatches():
    """K and V of different shapes or dtypes, and float pools, raise."""
    k, v, table, start = _case("verify", "f32", 1)
    slots = serving._slots(torch.from_numpy(table), torch.from_numpy(start),
                           5, PAGE)
    pools = _pools(2, torch.int8)
    with pytest.raises(ValueError):
        quant.write_kv_quantized(k, v[:, :, :4], *pools, 1, slots)
    with pytest.raises(ValueError):
        quant.write_kv_quantized(k, v.to(torch.bfloat16), *pools, 1, slots)
    fl = (pools[0].float(), pools[1], pools[2].float(), pools[3])
    with pytest.raises(TypeError):
        quant.write_kv_quantized(k, v, *fl, 1, slots)
