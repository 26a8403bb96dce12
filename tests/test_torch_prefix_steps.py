"""tpukern_torch's verify_step, prefill_prefix/share_prefix/rollback and
the featured (window, sinks, softcap) decode and verify steps against the
JAX package on the CPU (the model and tolerances of
tests/torch_serving_common.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.models import serving as jax_serving
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.models import serving
from torch_serving_common import (CFG, F32, JCFG,  # noqa: F401 (setup)
                                  SERVE_FEATURES, caches, check_cache, setup)


@pytest.mark.parametrize("T", [1, 5])
def test_verify_step_matches_jax(setup, T):
    """A prefill of two prompts, then verify_step of T tokens: logits at
    every position, lengths and the written pages."""
    jparams, params, _ = setup
    rng = np.random.default_rng(T)
    prompt = rng.integers(0, CFG.vocab, (2, 21)).astype(np.int32)
    toks = rng.integers(0, CFG.vocab, (2, T)).astype(np.int32)
    jcache, cache = caches(2, 4, 16)
    _, jcache = jax_serving.prefill(jparams, JCFG, jnp.asarray(prompt), jcache)
    _, cache = serving.prefill(params, CFG, torch.from_numpy(prompt), cache)
    jlogits, jcache = jax_serving.verify_step(jparams, JCFG, jnp.asarray(toks),
                                              jcache)
    logits, cache = serving.verify_step(params, CFG, torch.from_numpy(toks),
                                        cache)
    assert logits.shape == (2, T, CFG.vocab) and logits.dtype == torch.float32
    check_all_close(logits, np.asarray(jlogits), name="verify logits", **F32)
    check_cache(cache, jcache, "verify")


@pytest.mark.parametrize("prefix_len", [16, 21])
def test_prefill_prefix_share_prefix_rollback(setup, prefix_len):
    """prefill_prefix into slot 0, share_prefix into slots 1 and 2 (one
    full page, and a partial page copied when prefix_len is 21), then
    rollback: logits, table, pages and lengths equal JAX's."""
    jparams, params, _ = setup
    prompt = np.random.default_rng(1).integers(0, CFG.vocab, 30).astype(
        np.int32)
    jcache, cache = caches(3, 4, 16)
    jlog, jcache = jax_serving.prefill_prefix(jparams, JCFG,
                                              jnp.asarray(prompt), jcache)
    log, cache = serving.prefill_prefix(params, CFG, torch.from_numpy(prompt),
                                        cache)
    check_all_close(log, np.asarray(jlog), name="prefill_prefix", **F32)
    check_cache(cache, jcache, "prefill_prefix")
    jcache = jax_serving.share_prefix(jcache, 0, [1, 2], prefix_len)
    cache = serving.share_prefix(cache, 0, [1, 2], prefix_len)
    check_cache(cache, jcache, "share_prefix")
    assert (cache.page_table[1:, :prefix_len // 16]
            == cache.page_table[0, :prefix_len // 16]).all()
    new = np.array([30, prefix_len - 3, prefix_len], np.int32)
    jcache = jax_serving.rollback(jcache, new)
    cache = serving.rollback(cache, new)
    check_cache(cache, jcache, "rollback")
    with pytest.raises(ValueError):
        serving.share_prefix(cache, 1, [1, 2], prefix_len)


@pytest.mark.parametrize("feat", sorted(SERVE_FEATURES))
def test_featured_decode_matches_jax(setup, feat):
    """decode_step logits with the window, sinks and softcap on flat
    pools, past the window: 2 steps after a 21-token prompt, then a
    verify_step."""
    jparams, params, _ = setup
    jcfg = dataclasses.replace(JCFG, **SERVE_FEATURES[feat])
    cfg = dataclasses.replace(CFG, **SERVE_FEATURES[feat])
    prompt = np.random.default_rng(2).integers(0, CFG.vocab, (2, 21)).astype(
        np.int32)
    jcache, cache = caches(2, 4, 16)
    jlogits, jcache = jax_serving.prefill(jparams, jcfg, jnp.asarray(prompt),
                                          jcache)
    logits, cache = serving.prefill(params, cfg, torch.from_numpy(prompt),
                                    cache)
    check_all_close(logits, np.asarray(jlogits), name="prefill", **F32)
    for i in range(2):
        tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
        jlogits, jcache = jax_serving.decode_step(jparams, jcfg,
                                                  jnp.asarray(tok), jcache)
        logits, cache = serving.decode_step(params, cfg,
                                            torch.from_numpy(tok), cache)
        check_all_close(logits, np.asarray(jlogits), name=f"decode {i}",
                        **F32)
    toks = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)[:, None]
    jlogits, _ = jax_serving.verify_step(jparams, jcfg, jnp.asarray(toks),
                                         jcache)
    logits, _ = serving.verify_step(params, cfg, torch.from_numpy(toks),
                                    cache)
    check_all_close(logits, np.asarray(jlogits), name="verify", **F32)
