"""What the serving-feature tests of tpukern_torch share (imported by
tests/test_torch_prefix_*.py and tests/test_torch_sampled_serving.py).

The model is tests/test_torch_serving.py's (vocab 128, d 128, 2 layers,
4/2 heads, d_ff 256) with the JAX init's weights, f32 weights and f32
pools on both sides, so logits agree to 2e-5 (sums in another order) and
greedy streams agree token for token. JAX pools carry D padded to 128
lanes, so pools are compared on [..., :D].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.models import Config as JaxConfig
from tpukern.models import serving as jax_serving
from tpukern.models.transformer import init_params as jax_init_params
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.models import Config, params_from_jax, serving

SHAPE = dict(vocab=128, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=256, max_seq=512)
DRAFT = dict(vocab=128, d_model=64, n_layers=1, n_heads=2, n_kv_heads=2,
             d_ff=128, max_seq=512)
JCFG, CFG = JaxConfig(**SHAPE), Config(**SHAPE)
JDRAFT, CDRAFT = JaxConfig(**DRAFT), Config(**DRAFT)
F32 = dict(rtol=2e-5, atol=2e-5)
# the serving window, sinks and softcap of the featured stream tests
SERVE_FEATURES = {"window+sinks+softcap": dict(window=16, sinks=2,
                                               softcap=0.5),
                  "window": dict(window=12)}


def jax_and_port_params(cfg, key):
    jparams = jax_init_params(cfg, jax.random.key(key))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def setup():
    """(JAX params, port params, the three prompts of tests/test_batcher.py)"""
    jparams, params = jax_and_port_params(JCFG, 0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab, n).astype(np.int32)
               for n in (17, 40, 9)]
    return jparams, params, prompts


@pytest.fixture(scope="module")
def draft():
    return jax_and_port_params(JDRAFT, 7)


def caches(batch, pps, page):
    jcache = jax_serving.init_cache(JCFG, batch, pps, page, dtype=jnp.float32)
    cache = serving.init_cache(CFG, batch, pps, page, dtype=torch.float32,
                               device="cpu")
    return jcache, cache


def check_cache(cache, jcache, what):
    D = CFG.head_dim
    assert (cache.lengths.numpy() == np.asarray(jcache.lengths)).all(), what
    assert (cache.page_table.numpy() == np.asarray(jcache.page_table)).all()
    for name in ("k_pages", "v_pages"):
        check_all_close(getattr(cache, name),
                        np.asarray(getattr(jcache, name))[..., :D],
                        name=f"{what} {name}", **F32)


def streams(out):
    return {k: [int(t) for t in v] for k, v in out.items()}
