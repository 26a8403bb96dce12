"""Chunked prefill, the prefix cache and greedy speculative decoding of
tpukern_torch, and the window, sinks and softcap of its serving path,
against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do; the port takes its kernels' plain versions (CPU tensors). The model
is tests/test_torch_serving.py's (vocab 128, d 128, 2 layers, 4/2 heads,
d_ff 256) with the JAX init's weights, f32 weights and f32 pools on both
sides, so logits agree to 2e-5 (sums in another order) and greedy streams
agree token for token. JAX pools carry D padded to 128 lanes, so pools
are compared on [..., :D].
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.models import Config as JaxConfig
from tpukern.models import serving as jax_serving
from tpukern.models.batcher import ContinuousBatcher as JaxBatcher
from tpukern.models.batcher import SpeculativeBatcher as JaxSpecBatcher
from tpukern.models.speculative import (
    speculative_generate as jax_speculative_generate)
from tpukern.models.transformer import init_params as jax_init_params
from tpukern.ops import paged_attention as jax_pa
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.models import (Config, ContinuousBatcher,
                                  SpeculativeBatcher, params_from_jax,
                                  serving, speculative_generate)
from tpukern_torch.ops import paged_attention as pa

SHAPE = dict(vocab=128, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=256, max_seq=512)
DRAFT = dict(vocab=128, d_model=64, n_layers=1, n_heads=2, n_kv_heads=2,
             d_ff=128, max_seq=512)
JCFG, CFG = JaxConfig(**SHAPE), Config(**SHAPE)
JDRAFT, CDRAFT = JaxConfig(**DRAFT), Config(**DRAFT)
F32 = dict(rtol=2e-5, atol=2e-5)
# the masks of the serving kernels: a window shorter than the prompts,
# with and without sinks, and a softcap that bends the scores
FEATURES = {"plain": {}, "window": dict(window=7),
            "window+sinks": dict(window=7, sinks=3),
            "softcap": dict(softcap=0.5),
            "all": dict(window=9, sinks=2, softcap=0.5)}
SERVE_FEATURES = {"window+sinks+softcap": dict(window=16, sinks=2,
                                               softcap=0.5),
                  "window": dict(window=12)}


def _params(cfg, key):
    jparams = jax_init_params(cfg, jax.random.key(key))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def setup():
    jparams, params = _params(JCFG, 0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab, n).astype(np.int32)
               for n in (17, 40, 9)]
    return jparams, params, prompts


@pytest.fixture(scope="module")
def draft():
    return _params(JDRAFT, 7)


def _paged_inputs(B, Hq, Hkv, T, D, page, pps, lengths, seed):
    rng = np.random.default_rng(seed)
    P = B * pps
    q = rng.standard_normal((B, Hq, T, D)).astype(np.float32)
    k, v = (rng.standard_normal((Hkv, P, page, D)).astype(np.float32)
            for _ in range(2))
    table = rng.permutation(P).reshape(B, pps).astype(np.int32)
    return q, k, v, np.asarray(lengths, np.int32), table


@pytest.mark.parametrize("feat", sorted(FEATURES))
@pytest.mark.parametrize("T", [1, 5, 8, 13])
@pytest.mark.parametrize("D", [32, 64])
def test_paged_prefill_matches_jax(D, T, feat):
    """B=2, Hq 4/Hkv 2, page 16 x 4 from a shuffled pool, lengths with
    partial last pages (the second a full pool)."""
    args = _paged_inputs(2, 4, 2, T, D, 16, 4, [T + 19, 64], seed=T * D)
    kw = FEATURES[feat]
    ref = jax_pa.paged_prefill_attention(*map(jnp.asarray, args),
                                         pages_per_block=2, **kw)
    out = pa.paged_prefill_attention(*map(torch.from_numpy, args), **kw)
    check_all_close(out, np.asarray(ref), name=f"T{T} D{D} {feat}", **F32)


@pytest.mark.parametrize("feat", sorted(FEATURES))
def test_paged_decode_features_match_jax(feat):
    """The decode kernel's window, sinks and softcap, against JAX's."""
    q, k, v, lengths, table = _paged_inputs(3, 4, 2, 1, 64, 16, 4,
                                            [5, 40, 64], seed=3)
    kw = FEATURES[feat]
    args = (q[:, :, 0], k, v, lengths, table)
    ref = jax_pa.paged_attention(*map(jnp.asarray, args), pages_per_block=1,
                                 **kw)
    out = pa.paged_attention(*map(torch.from_numpy, args), **kw)
    check_all_close(out, np.asarray(ref), name=feat, **F32)


def test_paged_options_raise():
    q, k, v, lengths, table = map(torch.from_numpy, _paged_inputs(
        1, 4, 2, 3, 32, 16, 2, [8], seed=0))
    for fn, qq in ((pa.paged_prefill_attention, q),
                   (pa.paged_attention, q[:, :, 0])):
        for kw in (dict(ring=True), dict(alibi_slopes=torch.ones(4))):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                fn(qq, k, v, lengths, table, **kw)
        for kw in (dict(window=0), dict(sinks=2), dict(softcap=0.0)):
            with pytest.raises(ValueError):
                fn(qq, k, v, lengths, table, **kw)


def _caches(batch, pps, page):
    jcache = jax_serving.init_cache(JCFG, batch, pps, page, dtype=jnp.float32)
    cache = serving.init_cache(CFG, batch, pps, page, dtype=torch.float32,
                               device="cpu")
    return jcache, cache


def _check_cache(cache, jcache, what):
    D = CFG.head_dim
    assert (cache.lengths.numpy() == np.asarray(jcache.lengths)).all(), what
    assert (cache.page_table.numpy() == np.asarray(jcache.page_table)).all()
    for name in ("k_pages", "v_pages"):
        check_all_close(getattr(cache, name),
                        np.asarray(getattr(jcache, name))[..., :D],
                        name=f"{what} {name}", **F32)


@pytest.mark.parametrize("T", [1, 5])
def test_verify_step_matches_jax(setup, T):
    """A prefill of two prompts, then verify_step of T tokens: logits at
    every position, lengths and the written pages."""
    jparams, params, _ = setup
    rng = np.random.default_rng(T)
    prompt = rng.integers(0, CFG.vocab, (2, 21)).astype(np.int32)
    toks = rng.integers(0, CFG.vocab, (2, T)).astype(np.int32)
    jcache, cache = _caches(2, 4, 16)
    _, jcache = jax_serving.prefill(jparams, JCFG, jnp.asarray(prompt), jcache)
    _, cache = serving.prefill(params, CFG, torch.from_numpy(prompt), cache)
    jlogits, jcache = jax_serving.verify_step(jparams, JCFG, jnp.asarray(toks),
                                              jcache)
    logits, cache = serving.verify_step(params, CFG, torch.from_numpy(toks),
                                        cache)
    assert logits.shape == (2, T, CFG.vocab) and logits.dtype == torch.float32
    check_all_close(logits, np.asarray(jlogits), name="verify logits", **F32)
    _check_cache(cache, jcache, "verify")


@pytest.mark.parametrize("prefix_len", [16, 21])
def test_prefill_prefix_share_prefix_rollback(setup, prefix_len):
    """prefill_prefix into slot 0, share_prefix into slots 1 and 2 (one
    full page, and a partial page copied when prefix_len is 21), then
    rollback: logits, table, pages and lengths equal JAX's."""
    jparams, params, _ = setup
    prompt = np.random.default_rng(1).integers(0, CFG.vocab, 30).astype(
        np.int32)
    jcache, cache = _caches(3, 4, 16)
    jlog, jcache = jax_serving.prefill_prefix(jparams, JCFG,
                                              jnp.asarray(prompt), jcache)
    log, cache = serving.prefill_prefix(params, CFG, torch.from_numpy(prompt),
                                        cache)
    check_all_close(log, np.asarray(jlog), name="prefill_prefix", **F32)
    _check_cache(cache, jcache, "prefill_prefix")
    jcache = jax_serving.share_prefix(jcache, 0, [1, 2], prefix_len)
    cache = serving.share_prefix(cache, 0, [1, 2], prefix_len)
    _check_cache(cache, jcache, "share_prefix")
    assert (cache.page_table[1:, :prefix_len // 16]
            == cache.page_table[0, :prefix_len // 16]).all()
    new = np.array([30, prefix_len - 3, prefix_len], np.int32)
    jcache = jax_serving.rollback(jcache, new)
    cache = serving.rollback(cache, new)
    _check_cache(cache, jcache, "rollback")
    with pytest.raises(ValueError):
        serving.share_prefix(cache, 1, [1, 2], prefix_len)


def _streams(out):
    return {k: [int(t) for t in v] for k, v in out.items()}


@pytest.mark.parametrize("chunk", [8, 13])
def test_chunked_prefill_streams_equal_jax(setup, chunk):
    """ContinuousBatcher(chunked_prefill=C) over tests/test_batcher.py's
    three requests: equal to JAX's streams and to unchunked admission."""
    jparams, params, prompts = setup
    kw = dict(n_slots=2, pages_per_seq=2, page_size=128, max_new_tokens=4,
              prompt_buckets=(64,))
    reqs = list(enumerate(prompts))
    ref = JaxBatcher(jparams, JCFG, cache_dtype=jnp.float32,
                     chunked_prefill=chunk, **kw).run(reqs)
    out = ContinuousBatcher(params, CFG, cache_dtype=torch.float32,
                            chunked_prefill=chunk, **kw).run(reqs)
    plain = ContinuousBatcher(params, CFG, cache_dtype=torch.float32,
                              **kw).run(reqs)
    assert set(out) == {0, 1, 2}
    assert out == _streams(ref) == plain


def test_prefix_cache_streams_equal_jax(setup):
    """prefix_cache=True over tests/test_batcher.py's shared-prefix
    prompts: equal to JAX's streams and to the batcher without the cache,
    and the second request aliases the base prompt's two full pages."""
    jparams, params, _ = setup
    rng = np.random.default_rng(31)
    base = rng.integers(0, CFG.vocab, 40).astype(np.int32)
    prompts = [base,
               np.concatenate([base, [5, 9, 11]]).astype(np.int32),
               np.concatenate([base[:24], [7] * 10]).astype(np.int32)]
    kw = dict(n_slots=2, pages_per_seq=4, page_size=16, max_new_tokens=5,
              prompt_buckets=(64,))
    reqs = list(enumerate(prompts))
    ref = JaxBatcher(jparams, JCFG, cache_dtype=jnp.float32,
                     prefix_cache=True, **kw).run(reqs)
    cb = ContinuousBatcher(params, CFG, cache_dtype=torch.float32,
                           prefix_cache=True, **kw)
    out = cb.run(reqs)
    plain = ContinuousBatcher(params, CFG, cache_dtype=torch.float32,
                              **kw).run(reqs)
    assert out == _streams(ref) == plain
    t = cb.cache.page_table.numpy()
    assert (t[1, :2] == t[0, :2]).all()


@pytest.mark.parametrize("gamma,n_new", [(3, 10), (1, 4)])
def test_speculative_generate_equals_jax_and_greedy(setup, draft, gamma,
                                                    n_new):
    """tests/test_speculative.py's cases: the JAX function's bf16 pools on
    both sides; the stream equals JAX's and target-only greedy generate,
    and a self-draft accepts every proposal."""
    jparams, params, _ = setup
    jdraft, cdraft = draft
    prompt = np.random.default_rng(0).integers(0, CFG.vocab, (1, 24)).astype(
        np.int32)
    kw = dict(gamma=gamma, pages_per_seq=2, page_size=128)
    ref = jax_speculative_generate(jparams, JCFG, jdraft, JDRAFT,
                                   jnp.asarray(prompt), n_new, **kw)
    out, stats = speculative_generate(params, CFG, cdraft, CDRAFT,
                                      torch.from_numpy(prompt), n_new,
                                      return_stats=True, **kw)
    greedy = serving.generate(params, CFG, torch.from_numpy(prompt), n_new,
                              pages_per_seq=2)
    assert out.tolist() == np.asarray(ref).tolist() == greedy.tolist()
    assert stats.rounds >= 1 and stats.drafted >= stats.accepted
    _, self_stats = speculative_generate(params, CFG, params, CFG,
                                         torch.from_numpy(prompt), n_new,
                                         return_stats=True, **kw)
    assert self_stats.acceptance_rate == 1.0
    assert self_stats.rounds == -(-n_new // (gamma + 1))


def test_speculative_batcher_equals_jax(setup, draft):
    """tests/test_batcher.py's SpeculativeBatcher case (2 slots, the third
    request admitted mid-stream, gamma 3), f32 pools on both sides: equal
    to JAX's streams and to ContinuousBatcher's."""
    jparams, params, prompts = setup
    jdraft, cdraft = draft
    kw = dict(n_slots=2, pages_per_seq=2, gamma=3, page_size=128,
              max_new_tokens=6, prompt_buckets=(64,))
    reqs = list(enumerate(prompts))
    ref = JaxSpecBatcher(jparams, JCFG, jdraft, JDRAFT,
                         cache_dtype=jnp.float32, **kw).run(reqs)
    out = SpeculativeBatcher(params, CFG, cdraft, CDRAFT,
                             cache_dtype=torch.float32, **kw).run(reqs)
    del kw["gamma"]
    plain = ContinuousBatcher(params, CFG, cache_dtype=torch.float32,
                              **kw).run(reqs)
    assert set(out) == {0, 1, 2}
    assert out == _streams(ref) == plain


@pytest.mark.parametrize("eos", [False, True])
def test_speculative_batcher_self_draft(setup, eos):
    """Draft == target: every slot accepts gamma + 1 tokens per round, so
    6 tokens take 2 rounds; with EOS at the third token the stream stops
    there, as JAX's does."""
    jparams, params, prompts = setup
    kw = dict(n_slots=2, pages_per_seq=2, gamma=3, page_size=128,
              max_new_tokens=6, prompt_buckets=(64,))
    plain = ContinuousBatcher(params, CFG, cache_dtype=torch.float32,
                              **{k: v for k, v in kw.items() if k != "gamma"})
    ref = plain.run(list(enumerate(prompts[:2])))
    if eos:
        kw["eos_id"] = ref[0][2]
    sb = SpeculativeBatcher(params, CFG, params, CFG,
                            cache_dtype=torch.float32, **kw)
    jsb = JaxSpecBatcher(jparams, JCFG, jparams, JCFG,
                         cache_dtype=jnp.float32, **kw)
    for b in (sb, jsb):
        b.add_request(0, prompts[0])
        b.add_request(1, prompts[1])
    steps = 0
    while sb.active.any():
        sb.step()
        jsb.step()
        steps += 1
    assert sb.finished == _streams(jsb.finished)
    if eos:
        assert sb.finished[0] == ref[0][:3]
    else:
        assert sb.finished == ref and steps == 2


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
    jcache, cache = _caches(2, 4, 16)
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


@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("feat", sorted(SERVE_FEATURES))
def test_featured_batcher_streams_equal_jax(setup, feat, chunk):
    """ContinuousBatcher with the window, sinks and softcap on flat pools
    (and chunked admission through the featured prefix kernel): the
    greedy streams equal JAX's."""
    jparams, params, prompts = setup
    kw = dict(n_slots=2, pages_per_seq=2, page_size=128, max_new_tokens=6,
              prompt_buckets=(64,), chunked_prefill=chunk)
    reqs = list(enumerate(prompts))
    ref = JaxBatcher(jparams, dataclasses.replace(JCFG, **SERVE_FEATURES[feat]),
                     cache_dtype=jnp.float32, **kw).run(reqs)
    out = ContinuousBatcher(params, dataclasses.replace(
        CFG, **SERVE_FEATURES[feat]), cache_dtype=torch.float32, **kw).run(
        reqs)
    assert set(out) == {0, 1, 2}
    assert out == _streams(ref)
