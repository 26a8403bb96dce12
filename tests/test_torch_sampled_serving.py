"""Sampled decoding in tpukern_torch's serving path on the CPU: generate,
ContinuousBatcher and both speculative paths with greedy=False, on the
model of tests/torch_serving_common.py with f32 pools. The cases mirror
tests/test_batcher.py:175-227, 359-375 and tests/test_speculative.py:
114-150. Streams of random draws cannot equal JAX's (other generators),
so they are held to what must hold of any draw: they finish, stay in the
vocabulary, repeat per seed, collapse to the greedy stream at top_k=1 or
a temperature of 1e-4, and a self-draft accepts every proposal; top_k=1
generate also equals JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.models import serving as jax_serving
from tpukern_torch.models import (ContinuousBatcher, SpeculativeBatcher,
                                  generate, speculative_generate,
                                  speculative_sample_generate)
from tpukern_torch.models import batcher as batcher_mod
from torch_serving_common import (CDRAFT, CFG, JCFG,  # noqa: F401 (fixtures)
                                  draft, setup)

N_NEW = 6
KW = dict(n_slots=2, pages_per_seq=2, page_size=128, max_new_tokens=N_NEW,
          prompt_buckets=(64,), cache_dtype=torch.float32)


def _prompt(n=24):
    return torch.from_numpy(np.random.default_rng(0).integers(
        0, CFG.vocab, (1, n)).astype(np.int32))


def _in_vocab(streams):
    return all(0 <= t < CFG.vocab for toks in streams for t in toks)


def test_generate_top_k_1_is_greedy_and_equals_jax(setup):
    """top_k=1 keeps only the argmax: the sampled path (thresholds, then
    the gumbel pass) emits the greedy stream, as JAX's does."""
    jparams, params, _ = setup
    prompt = _prompt()
    kw = dict(n_steps=8, pages_per_seq=2)
    greedy = generate(params, CFG, prompt, cache_dtype=torch.float32, **kw)
    out = generate(params, CFG, prompt, greedy=False, top_k=1, seed=3,
                   cache_dtype=torch.float32, **kw)
    ref = jax_serving.generate(jparams, JCFG, jnp.asarray(prompt.numpy()),
                               greedy=False, top_k=1, key=jax.random.key(3),
                               cache_dtype=jnp.float32, **kw)
    assert out.dtype == torch.int32 and out.shape == (1, 8)
    assert out.tolist() == greedy.tolist() == np.asarray(ref).tolist()


@pytest.mark.parametrize("kw", [dict(), dict(temperature=0.7, top_p=0.9),
                                dict(temperature=1.2, min_p=0.05)],
                         ids=["multinomial", "top_p", "min_p"])
def test_generate_sampled_repeats_per_seed(setup, kw):
    _, params, _ = setup
    prompt = torch.cat([_prompt(), _prompt().flip(1)])

    def run(seed):
        return generate(params, CFG, prompt, 8, pages_per_seq=2,
                        greedy=False, seed=seed, cache_dtype=torch.float32,
                        **kw)

    a = run(5)
    assert a.shape == (2, 8) and _in_vocab(a.tolist())
    assert a.tolist() == run(5).tolist()


def test_batcher_topk_sampling(setup):
    """tests/test_batcher.py:359-375: sampled decode under top-k, 3
    requests on 2 slots; every run finishes, stays in range and repeats
    per seed."""
    _, params, prompts = setup

    def run(seed):
        cb = ContinuousBatcher(params, CFG, greedy=False, temperature=0.9,
                               top_k=8, seed=seed, **KW)
        return cb.run(list(enumerate(prompts)))

    a = run(11)
    assert set(a) == {0, 1, 2} and all(len(v) == N_NEW for v in a.values())
    assert _in_vocab(a.values())
    assert a == run(11)


def test_batcher_top_k_1_equals_greedy(setup):
    _, params, prompts = setup
    reqs = list(enumerate(prompts))
    greedy = ContinuousBatcher(params, CFG, **KW).run(reqs)
    assert ContinuousBatcher(params, CFG, greedy=False, top_k=1, seed=2,
                             **KW).run(reqs) == greedy


def test_batcher_dispatch_as_jax(setup, monkeypatch):
    """sample (the kernels) runs only with top_k, top_p or min_p set;
    temperature alone draws with torch.multinomial (batcher.py:328-342)."""
    _, params, prompts = setup
    calls = []
    real = batcher_mod.sample

    def counted(*a, **k):
        calls.append(k)
        return real(*a, **k)

    monkeypatch.setattr(batcher_mod, "sample", counted)
    reqs = list(enumerate(prompts[:2]))
    out = ContinuousBatcher(params, CFG, greedy=False, temperature=0.8,
                            **KW).run(reqs)
    assert not calls and _in_vocab(out.values())
    for kw in (dict(top_p=0.9), dict(min_p=0.05)):
        ContinuousBatcher(params, CFG, greedy=False, temperature=0.8,
                          **kw, **KW).run(reqs)
        assert calls and all(c["temperature"] == 0.8 for c in calls)
        calls.clear()
    with pytest.raises(ValueError):
        ContinuousBatcher(params, CFG, greedy=False, temperature=0.0, **KW)


def test_speculative_batcher_sampled_self_draft(setup):
    """tests/test_batcher.py:175-195: draft == target makes p/q = 1 at
    every position, so every round accepts all gamma drafts: 6 tokens in
    2 rounds of gamma + 1 = 4."""
    _, params, prompts = setup
    sb = SpeculativeBatcher(params, CFG, params, CFG, gamma=3, greedy=False,
                            temperature=1.0, **KW)
    sb.add_request(0, prompts[0])
    sb.add_request(1, prompts[1])
    steps = 0
    while sb.active.any():
        sb.step()
        steps += 1
    assert steps == 2 and sb.stats.acceptance_rate == 1.0
    assert all(len(sb.finished[i]) == N_NEW for i in (0, 1))
    assert _in_vocab(sb.finished.values())


def test_speculative_batcher_sampled_deterministic(setup, draft):
    _, params, prompts = setup
    _, cdraft = draft

    def run():
        sb = SpeculativeBatcher(params, CFG, cdraft, CDRAFT, gamma=2,
                                greedy=False, temperature=0.9, seed=5,
                                accept_seed=5, **dict(KW, max_new_tokens=4))
        return sb.run(list(enumerate(prompts)))

    a = run()
    assert set(a) == {0, 1, 2} and _in_vocab(a.values())
    assert a == run()


def test_speculative_batcher_sampled_low_temp_matches_greedy(setup, draft):
    """T -> 0 puts every distribution on its argmax: the sampled
    acceptance emits the greedy streams, with a self-draft and with a
    1-layer draft."""
    _, params, prompts = setup
    _, cdraft = draft
    reqs = list(enumerate(prompts))
    ref = ContinuousBatcher(params, CFG, **KW).run(reqs)
    for dp, dc in ((params, CFG), (cdraft, CDRAFT)):
        sb = SpeculativeBatcher(params, CFG, dp, dc, gamma=3, greedy=False,
                                temperature=1e-4, **KW)
        assert sb.run(reqs) == ref


def test_speculative_sample_generate_self_draft_accepts_everything(setup):
    _, params, _ = setup
    out, stats = speculative_sample_generate(
        params, CFG, params, CFG, _prompt(), 10, gamma=3, temperature=1.0,
        seed=3, pages_per_seq=2, return_stats=True,
        cache_dtype=torch.float32)
    assert stats.acceptance_rate == 1.0 and stats.rounds == 3
    assert out.shape == (1, 10) and _in_vocab(out.tolist())


def test_speculative_sample_generate_deterministic_per_seed(setup, draft):
    _, params, _ = setup
    _, cdraft = draft

    def run(seed):
        return speculative_sample_generate(
            params, CFG, cdraft, CDRAFT, _prompt(), 6, gamma=2, seed=seed,
            pages_per_seq=2, cache_dtype=torch.float32).tolist()

    assert run(11) == run(11)


def test_speculative_sample_generate_low_temperature_tracks_greedy(setup,
                                                                   draft):
    _, params, _ = setup
    _, cdraft = draft
    kw = dict(gamma=2, pages_per_seq=2, cache_dtype=torch.float32)
    ref = speculative_generate(params, CFG, cdraft, CDRAFT, _prompt(), 6,
                               **kw)
    out = speculative_sample_generate(params, CFG, cdraft, CDRAFT, _prompt(),
                                      6, temperature=1e-4, seed=0, **kw)
    assert out.tolist() == ref.tolist()
    with pytest.raises(ValueError):
        speculative_sample_generate(params, CFG, cdraft, CDRAFT, _prompt(),
                                    6, temperature=0.0, **kw)
