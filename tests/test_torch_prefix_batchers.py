"""The greedy streams of tpukern_torch's batchers with chunked prefill,
the prefix cache, speculative decoding and the serving window, sinks and
softcap, against the JAX package's on the CPU (the model of
tests/torch_serving_common.py; f32 pools unless a case says otherwise).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.models.batcher import ContinuousBatcher as JaxBatcher
from tpukern.models.batcher import SpeculativeBatcher as JaxSpecBatcher
from tpukern.models.speculative import (
    speculative_generate as jax_speculative_generate)
from tpukern_torch.models import (ContinuousBatcher, SpeculativeBatcher,
                                  serving, speculative_generate)
from torch_serving_common import (CDRAFT, CFG, JCFG, JDRAFT,  # noqa: F401
                                  SERVE_FEATURES, draft, setup, streams)


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
    assert out == streams(ref) == plain


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
    assert out == streams(ref) == plain
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
    assert out == streams(ref) == plain


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
    assert sb.finished == streams(jsb.finished)
    if eos:
        assert sb.finished[0] == ref[0][:3]
    else:
        assert sb.finished == ref and steps == 2


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
    assert out == streams(ref)
