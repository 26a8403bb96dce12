"""tpukern_torch's batchers, generate and both speculative functions on
the quantized KV tier (int8 and fp8 pools) on the CPU, at the one-layer
model of tests/test_torch_quantized_serving.py: tests/test_batcher.py's
int8 runs (first tokens equal the bf16 tier's, deterministic, complete)
on every tier, chunked, prefix-cache and sampled admission, and the
greedy int8 + pv_int8 streams equal to JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.models.batcher import ContinuousBatcher as JaxBatcher
from tpukern_torch.models import (ContinuousBatcher, SpeculativeBatcher,
                                  serving, speculative_generate,
                                  speculative_sample_generate)
from test_torch_quantized_serving import (CFG1, TIERS, _cfgs,  # noqa: F401
                                          model)
from torch_serving_common import streams


def _batcher_kw(tier):
    return dict(n_slots=2, pages_per_seq=2, page_size=128, max_new_tokens=4,
                prompt_buckets=(64,), cache_dtype=TIERS[tier][0])


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_quantized_batcher(model, tier):
    """tests/test_batcher.py's int8 run on every tier: the first token of
    each request equals the bf16 tier's (it comes from the unquantized
    prefill), the streams are complete and repeat."""
    _, params, prompts = model
    _, cfg = _cfgs(tier)
    reqs = list(enumerate(prompts))
    f16 = ContinuousBatcher(params, CFG1, **dict(
        _batcher_kw(tier), cache_dtype=torch.bfloat16)).run(reqs)
    cb = ContinuousBatcher(params, cfg, **_batcher_kw(tier))
    assert cb.cache.quantized
    f8 = cb.run(reqs)
    assert set(f8) == set(f16) == {0, 1}
    for i in f16:
        assert f8[i][0] == f16[i][0] and len(f8[i]) == len(f16[i])
    assert ContinuousBatcher(params, cfg, **_batcher_kw(tier)).run(reqs) == f8


def test_int8_pv_int8_streams_equal_jax(model):
    """Greedy int8 + pv_int8 streams of the port's ContinuousBatcher equal
    JAX's (f32 weights): the same quantized writes, the same kernels'
    functions and the same length-aware pages_per_block."""
    jparams, params, prompts = model
    jcfg, cfg = _cfgs("int8 pv_int8")
    kw = dict(n_slots=2, pages_per_seq=4, page_size=16, max_new_tokens=5,
              prompt_buckets=(48,))
    reqs = list(enumerate(prompts))
    ref = JaxBatcher(jparams, jcfg, cache_dtype=jnp.int8, **kw).run(reqs)
    out = ContinuousBatcher(params, cfg, cache_dtype=torch.int8, **kw).run(
        reqs)
    assert out == streams(ref)


@pytest.mark.parametrize("tier", ["int8", "fp8"])
def test_quantized_admission_paths(model, tier):
    """Chunked admission (chunks of 16), the prefix cache and sampled
    decoding on the quantized tier: complete, in range and repeatable;
    greedy chunked and prefix-cache streams start with the whole-prompt
    admission's first token."""
    _, params, prompts = model
    base = prompts[1]
    reqs = [(0, base), (1, np.concatenate([base, [5, 9, 11]]).astype(
        np.int32))]
    kw = dict(n_slots=2, pages_per_seq=4, page_size=16, max_new_tokens=4,
              prompt_buckets=(64,), cache_dtype=TIERS[tier][0])
    whole = ContinuousBatcher(params, CFG1, **kw).run(reqs)
    for extra in (dict(chunked_prefill=16), dict(prefix_cache=True),
                  dict(greedy=False, temperature=0.8, top_k=20, seed=3)):
        runs = [ContinuousBatcher(params, CFG1, **extra, **kw).run(reqs)
                for _ in range(2)]
        assert runs[0] == runs[1] and set(runs[0]) == {0, 1}
        for rid, toks in runs[0].items():
            assert len(toks) == 4 and all(0 <= t < CFG1.vocab for t in toks)
            if "greedy" not in extra:
                assert toks[0] == whole[rid][0]


@pytest.mark.parametrize("tier", ["int8", "fp8"])
def test_quantized_speculative(model, tier):
    """tests/test_batcher.py's int8 SpeculativeBatcher run (the target as
    its own draft, both caches quantized, deterministic and complete), and
    generate, speculative_generate and speculative_sample_generate on the
    tier; the greedy self-draft accepts every proposal, so its stream is
    generate's."""
    _, params, prompts = model
    dt = TIERS[tier][0]

    def run():
        sb = SpeculativeBatcher(params, CFG1, params, CFG1, gamma=2,
                                **_batcher_kw(tier))
        assert sb.cache.quantized and sb.dcache.quantized
        assert sb.dcache.k_pages.dtype == dt
        return sb.run(list(enumerate(prompts)))

    a, b = run(), run()
    assert set(a) == {0, 1} and a == b
    assert all(len(v) == 4 and all(0 <= t < CFG1.vocab for t in v)
               for v in a.values())
    prompt = torch.from_numpy(prompts[0][None])
    gen = serving.generate(params, CFG1, prompt, 6, pages_per_seq=2,
                           cache_dtype=dt)
    spec, st = speculative_generate(params, CFG1, params, CFG1, prompt, 6,
                                    gamma=2, pages_per_seq=2,
                                    return_stats=True, cache_dtype=dt)
    assert spec.tolist() == gen.tolist() and st.acceptance_rate == 1.0
    out, st = speculative_sample_generate(params, CFG1, params, CFG1, prompt,
                                          6, gamma=2, temperature=0.8,
                                          seed=1, pages_per_seq=2,
                                          return_stats=True, cache_dtype=dt)
    assert out.shape == (1, 6) and ((out >= 0) & (out < CFG1.vocab)).all()
    assert st.accepted == st.drafted  # a self-draft is always accepted
