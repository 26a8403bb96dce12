"""tpukern_torch's serving steps on the quantized KV tier (int8 and fp8
pools) against the JAX package's on the CPU: prefill, decode_step and
verify_step at the tests/test_serving.py config cut to one layer, f32
weights from the JAX init; pools and scales equal JAX's (the write bit
for bit on the same K; after the steps, values bit for bit but where an
f32 difference in K crosses a rounding boundary), logits to 1e-4. Then share_prefix, rollback and
init_cache's pv_int8 rule. The batchers on the tier are in
tests/test_torch_quantized_batchers.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.models import Config as JaxConfig
from tpukern.models import serving as jax_serving
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.models import Config, serving
from torch_serving_common import jax_and_port_params

SHAPE1 = dict(vocab=128, d_model=128, n_layers=1, n_heads=4, n_kv_heads=2,
              d_ff=256, max_seq=512)
JCFG1, CFG1 = JaxConfig(**SHAPE1), Config(**SHAPE1)
D = CFG1.head_dim
LOGITS = dict(rtol=1e-4, atol=1e-4)
# tier -> (port pool dtype, JAX pool dtype, Config.pv_int8)
TIERS = {"int8": (torch.int8, jnp.int8, False),
         "int8 pv_int8": (torch.int8, jnp.int8, True),
         "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn, False)}


@pytest.fixture(scope="module")
def model():
    """(JAX params, port params) of the one-layer model, and two prompts."""
    jparams, params = jax_and_port_params(JCFG1, 0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG1.vocab, n).astype(np.int32)
               for n in (17, 40)]
    return jparams, params, prompts


def _cfgs(tier):
    pv = TIERS[tier][2]
    return (dataclasses.replace(JCFG1, pv_int8=pv),
            dataclasses.replace(CFG1, pv_int8=pv))


def _caches(tier, jcfg, cfg, batch=2, pps=4, page=16):
    tdt, jdt, _ = TIERS[tier]
    jcache = jax_serving.init_cache(jcfg, batch, pps, page, dtype=jdt)
    cache = serving.init_cache(cfg, batch, pps, page, dtype=tdt,
                               device="cpu")
    assert cache.quantized and cache.k_scales.shape == (1, 2, batch * pps,
                                                       page)
    return jcache, cache


def _check_pools(cache, jcache, what):
    """Scales to f32 rounding; values bit for bit on the live columns but
    for at most 0.1% one step apart: K and V come from the projections'
    sums in another order than XLA's, so a value within an f32 rounding
    of a rounding boundary may round the other way (the write itself is
    held bit for bit in test_write_tokens_quantized_matches_jax)."""
    assert (cache.lengths.numpy() == np.asarray(jcache.lengths)).all(), what
    assert (cache.page_table.numpy() == np.asarray(jcache.page_table)).all()
    for name in ("k_pages", "v_pages"):
        out = getattr(cache, name)
        ref = np.asarray(getattr(jcache, name))[..., :D]
        if out.dtype == torch.int8:
            out, ref = out.numpy().astype(np.int32), ref.astype(np.int32)
        else:  # e4m3 codes: neighbours differ by one
            out = out.view(torch.uint8).numpy().astype(np.int32)
            ref = ref.view(np.uint8).astype(np.int32)
        diff = np.abs(out - ref)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (
            f"{what} {name}: {(diff > 0).sum()} values differ, max {diff.max()}")
    for name in ("k_scales", "v_scales"):
        np.testing.assert_allclose(getattr(cache, name).numpy(),
                                   np.asarray(getattr(jcache, name)),
                                   rtol=1e-6, err_msg=f"{what} {name}")


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_write_tokens_quantized_matches_jax(dtype):
    """The quantized write on the same K: values bit for bit and scales
    equal, at the pool's end too (T=5 from length 62 of 64 clamps three
    tokens onto the last slot; the last token wins, as in JAX)."""
    tdt, jdt, _ = TIERS[dtype]
    rng = np.random.default_rng(4)
    new = (3 * rng.standard_normal((2, 2, 5, D))).astype(np.float32)
    table = np.arange(8, dtype=np.int32).reshape(2, 4)
    start = np.array([3, 62], np.int32)
    pages = torch.zeros(1, 2, 8, 16, D, dtype=tdt)
    scales = torch.zeros(1, 2, 8, 16)
    slots = serving._slots(torch.from_numpy(table), torch.from_numpy(start),
                           5, 16)
    serving._write_tokens_quantized(pages, scales, 0, torch.from_numpy(new),
                                    slots)
    jpages, jscales = jax_serving._write_tokens_quantized(
        jnp.zeros((1, 2, 8, 16, D), jdt), jnp.zeros((1, 2, 8, 16)), 0,
        jnp.asarray(new), jnp.asarray(table), jnp.asarray(start))
    np.testing.assert_array_equal(pages.view(torch.uint8).numpy(),
                                  np.asarray(jpages).view(np.uint8))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    assert scales[0, 0, 0, 3] > 0 and scales[0, 1, 7, 15] > 0


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_steps_match_jax(model, tier):
    """prefill of two 21-token prompts (page 16 x 4), a decode_step, then
    a verify_step of 3 tokens: logits, lengths, pools and scales."""
    jparams, params, _ = model
    jcfg, cfg = _cfgs(tier)
    rng = np.random.default_rng(len(tier))
    prompt = rng.integers(0, cfg.vocab, (2, 21)).astype(np.int32)
    jcache, cache = _caches(tier, jcfg, cfg)
    jlogits, jcache = jax_serving.prefill(jparams, jcfg, jnp.asarray(prompt),
                                          jcache)
    logits, cache = serving.prefill(params, cfg, torch.from_numpy(prompt),
                                    cache)
    check_all_close(logits, np.asarray(jlogits), name="prefill", **LOGITS)
    _check_pools(cache, jcache, "prefill")
    tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    jlogits, jcache = jax_serving.decode_step(jparams, jcfg, jnp.asarray(tok),
                                              jcache)
    logits, cache = serving.decode_step(params, cfg, torch.from_numpy(tok),
                                        cache)
    check_all_close(logits, np.asarray(jlogits), name="decode", **LOGITS)
    _check_pools(cache, jcache, "decode")
    toks = rng.integers(0, cfg.vocab, (2, 3)).astype(np.int32)
    jlogits, jcache = jax_serving.verify_step(jparams, jcfg,
                                              jnp.asarray(toks), jcache)
    logits, cache = serving.verify_step(params, cfg, torch.from_numpy(toks),
                                        cache)
    assert logits.shape == (2, 3, cfg.vocab)
    check_all_close(logits, np.asarray(jlogits), name="verify", **LOGITS)
    _check_pools(cache, jcache, "verify")


@pytest.mark.parametrize("tier", ["int8", "fp8"])
def test_share_prefix_and_rollback_keep_scales(model, tier):
    """prefill_prefix into slot 0, share_prefix of 21 positions into slots
    1 and 2 (a full page aliased, the partial page's 5 rows copied with
    their scales), then rollback: all equal JAX's."""
    jparams, params, _ = model
    jcfg, cfg = _cfgs(tier)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, 30).astype(
        np.int32)
    jcache, cache = _caches(tier, jcfg, cfg, batch=3)
    jlog, jcache = jax_serving.prefill_prefix(jparams, jcfg,
                                              jnp.asarray(prompt), jcache)
    log, cache = serving.prefill_prefix(params, cfg, torch.from_numpy(prompt),
                                        cache)
    check_all_close(log, np.asarray(jlog), name="prefill_prefix", **LOGITS)
    jcache = jax_serving.share_prefix(jcache, 0, [1, 2], 21)
    cache = serving.share_prefix(cache, 0, [1, 2], 21)
    _check_pools(cache, jcache, "share_prefix")
    src, dst = int(cache.page_table[0, 1]), int(cache.page_table[1, 1])
    assert src != dst and (cache.k_scales[:, :, dst, :5]
                           == cache.k_scales[:, :, src, :5]).all()
    new = np.array([30, 18, 21], np.int32)
    jcache = jax_serving.rollback(jcache, new)
    cache = serving.rollback(cache, new)
    assert cache.quantized
    _check_pools(cache, jcache, "rollback")


def test_init_cache_dtypes():
    """pv_int8 needs int8 pools (ValueError, as JAX's init_cache); the
    1-byte pools carry (L, Hkv, P, page) f32 scales and half the bytes of
    bf16 pools."""
    pv = dataclasses.replace(CFG1, pv_int8=True)
    for dt in (torch.bfloat16, torch.float32, torch.float8_e4m3fn):
        with pytest.raises(ValueError, match="pv_int8"):
            serving.init_cache(pv, 2, 4, 16, dtype=dt, device="cpu")
    with pytest.raises(TypeError):
        serving.init_cache(CFG1, 2, 4, 16, dtype=torch.float16, device="cpu")
    c8 = serving.init_cache(pv, 2, 4, 16, dtype=torch.int8, device="cpu")
    c16 = serving.init_cache(CFG1, 2, 4, 16, device="cpu")
    assert c8.k_scales.dtype == torch.float32 and not c16.quantized
    assert 2 * c8.k_pages.nbytes == c16.k_pages.nbytes


def test_jax_setup_is_cpu():
    assert jax.default_backend() == "cpu"
