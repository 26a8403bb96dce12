"""The tpukern_torch serving path against the JAX package on CPU.

The config of tests/test_serving.py (vocab 128, d 128, 2 layers, 4/2
heads, d_ff 256) with the JAX init's weights, converted by
params_from_jax. f32 weights and f32 pools on both sides, so logits agree
to 2e-5 (sums taken in another order) and greedy token streams agree
exactly.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.models import Config as JaxConfig
from tpukern.models import serving as jax_serving
from tpukern.models.batcher import ContinuousBatcher as JaxBatcher
from tpukern.models.transformer import init_params as jax_init_params
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.models import (Config, ContinuousBatcher,
                                  SpeculativeBatcher, params_from_jax)
from tpukern_torch.models import serving

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = dict(vocab=128, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=256, max_seq=512)
JCFG, CFG = JaxConfig(**SHAPE), Config(**SHAPE)
F32 = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def setup():
    jparams = jax_init_params(JCFG, jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, CFG.vocab, (2, 48)).astype(np.int32)
    return jparams, params, prompt


def _prefill_both(jparams, params, prompt):
    jcache = jax_serving.init_cache(JCFG, 2, pages_per_seq=2, page_size=128,
                                    dtype=jnp.float32)
    jlogits, jcache = jax_serving.prefill(jparams, JCFG, jnp.asarray(prompt),
                                          jcache)
    cache = serving.init_cache(CFG, 2, 2, 128, dtype=torch.float32,
                               device="cpu")
    logits, cache = serving.prefill(params, CFG, torch.from_numpy(prompt),
                                    cache)
    return (jlogits, jcache), (logits, cache)


def test_params_from_jax_keeps_layout(setup):
    jparams, params, _ = setup
    assert params["layers"][0]["wq"].shape == (128, 128)
    np.testing.assert_array_equal(params["layers"][1]["w1"].numpy(),
                                  np.asarray(jparams["layers"][1]["w1"]))


def test_prefill_matches_jax(setup):
    """Logits, lengths and the written K/V pages (JAX pools carry D padded
    to 128 lanes; the port's carry D)."""
    (jlogits, jcache), (logits, cache) = _prefill_both(*setup)
    check_all_close(logits, np.asarray(jlogits), name="prefill logits", **F32)
    assert (cache.lengths.numpy() == np.asarray(jcache.lengths)).all()
    D = CFG.head_dim
    for name in ("k_pages", "v_pages"):
        check_all_close(getattr(cache, name),
                        np.asarray(getattr(jcache, name))[..., :D],
                        name=name, **F32)


def test_decode_steps_match_jax(setup):
    jparams, params, prompt = setup
    (jlogits, jcache), (logits, cache) = _prefill_both(*setup)
    tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    for i in range(3):
        jlogits, jcache = jax_serving.decode_step(jparams, JCFG,
                                                  jnp.asarray(tok), jcache)
        logits, cache = serving.decode_step(params, CFG, torch.from_numpy(tok),
                                            cache)
        check_all_close(logits, np.asarray(jlogits), name=f"decode {i}", **F32)
        tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    assert (cache.lengths.numpy() == np.asarray(jcache.lengths)).all()


def test_write_tokens_matches_jax_at_the_pool_end():
    """Writes that run past a sequence's pages clamp to its last slot,
    where the last token wins, as in the JAX scan."""
    rng = np.random.default_rng(2)
    page, pps, L, Hkv, D, T = 4, 2, 2, 2, 8, 5
    table = np.array([[3, 0], [1, 2]], np.int32)
    start = np.array([1, 6], np.int32)   # sequence 1 runs past slot 7
    new = rng.standard_normal((2, Hkv, T, D)).astype(np.float32)
    pages = np.zeros((L, Hkv, 4, page, D), np.float32)
    ref = jax_serving._write_tokens(jnp.asarray(pages), 1, jnp.asarray(new),
                                    jnp.asarray(table), jnp.asarray(start))
    out = torch.from_numpy(pages.copy())
    serving._write_tokens(out, 1, torch.from_numpy(new),
                          torch.from_numpy(table), torch.from_numpy(start))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_batcher_streams_equal_jax(setup):
    """2 slots, 3 requests (the third admitted mid-stream), f32 pools: the
    greedy token streams equal the JAX ContinuousBatcher's."""
    jparams, params, _ = setup
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab, n).astype(np.int32)
               for n in (17, 40, 9)]
    kw = dict(n_slots=2, pages_per_seq=2, page_size=128, max_new_tokens=6,
              prompt_buckets=(64,))
    ref = JaxBatcher(jparams, JCFG, cache_dtype=jnp.float32, **kw).run(
        list(enumerate(prompts)))
    out = ContinuousBatcher(params, CFG, cache_dtype=torch.float32, **kw).run(
        list(enumerate(prompts)))
    assert set(out) == {0, 1, 2}
    assert {k: [int(t) for t in v] for k, v in ref.items()} == out


def test_generate_equals_batcher(setup):
    """generate (prefill + decode_step loop) and a one-slot batcher give
    the same greedy tokens."""
    _, params, prompt = setup
    out = serving.generate(params, CFG, torch.from_numpy(prompt[:1]),
                           n_steps=4, pages_per_seq=2,
                           cache_dtype=torch.float32)
    cb = ContinuousBatcher(params, CFG, n_slots=1, pages_per_seq=2,
                           max_new_tokens=4, cache_dtype=torch.float32)
    assert cb.run([("a", prompt[0])])["a"] == out[0].tolist()


def test_unported_serving_options_raise(setup):
    _, params, _ = setup
    # the int8 tier and ring pools are ported (tests/test_torch_quantized_
    # serving.py, tests/test_torch_ring.py): a ring without a window
    # raises ValueError, as JAX asserts; MoE serving is not ported
    for cls in (ContinuousBatcher, SpeculativeBatcher):
        args = (params, CFG) if cls is ContinuousBatcher else (
            params, CFG, params, CFG)
        with pytest.raises(ValueError, match="window"):
            cls(*args, 2, 2, ring=True)
        moe = dataclasses.replace(CFG, n_experts=2)
        margs = (params, moe) if cls is ContinuousBatcher else (
            params, moe, params, moe)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cls(*margs, 2, 2)


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py's module-level imports,
    load without jax or the JAX package (tpukern)."""
    import tpukern_torch
    pkg = os.path.dirname(tpukern_torch.__file__)
    mods = sorted(
        "tpukern_torch." + os.path.relpath(os.path.join(d, f), pkg)[:-3]
        .replace(os.sep, ".").removesuffix(".__init__")
        for d, _, files in os.walk(pkg) for f in files if f.endswith(".py"))
    assert "tpukern_torch.models.speculative" in mods
    code = ("import importlib, runpy, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tpukern')]\n"
            "sys.exit(f'imported {bad}' if bad else 0)\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   env=dict(os.environ, PYTHONPATH=ROOT))


def test_chip_smoke_fails_without_gpu():
    """On a host without a CUDA device chip_smoke.py exits non-zero and
    prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
