"""tpukern_torch's w8a16 serving tier (serving.quantize_model_weights and
the projections through ops/matmul_w8a16.py) against the JAX package's
on the CPU, at the model of tests/torch_serving_common.py with f32
weights: the quantized tree bit for bit, the prefill, decode_step and
verify_step logits to 2e-5 (sums in another order), greedy streams of
generate, both batchers and the int8 KV tier token for token; and the
training path's refusal of w8a16 params.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.models import serving as jax_serving
from tpukern.models.batcher import ContinuousBatcher as JaxBatcher
from tpukern.models.batcher import SpeculativeBatcher as JaxSpecBatcher
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.models import (ContinuousBatcher, SpeculativeBatcher,
                                  forward, make_train_step, param_leaves,
                                  params_from_jax, params_to, serving)
from torch_serving_common import (CDRAFT, CFG, F32, JCFG,  # noqa: F401
                                  JDRAFT, caches, draft, setup, streams)

PROJ = serving.W8A16_WEIGHTS


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def qsetup(setup):
    """(JAX w8a16 params, port w8a16 params, prompts)"""
    jparams, params, prompts = setup
    return (jax_serving.quantize_model_weights(jparams),
            serving.quantize_model_weights(params), prompts)


def _same(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a, b), what


def test_quantized_tree(setup, qsetup):
    _, params, _ = setup
    _, qparams, _ = qsetup
    for name in PROJ:
        leaf = qparams["layers"][0][name]
        assert set(leaf) == {"q", "s"}
        assert leaf["q"].dtype == torch.int8
        assert leaf["s"].dtype == torch.float32
        assert leaf["s"].shape == (params["layers"][0][name].shape[1],)
    assert qparams["head"]["q"].shape == params["head"].shape
    for name in ("embed", "lnf"):
        assert qparams[name] is params[name]
    assert qparams["layers"][1]["ln2"] is params["layers"][1]["ln2"]
    # params_to casts float leaves; a w8a16 pair keeps int8 q and f32 s
    bf = params_to(qparams, torch.bfloat16)
    assert bf["embed"].dtype == torch.bfloat16
    assert bf["layers"][0]["ln1"].dtype == torch.bfloat16
    _same(bf["layers"][0]["wq"]["q"], qparams["layers"][0]["wq"]["q"], "q")
    _same(bf["head"]["s"], qparams["head"]["s"], "s")
    # every leaf once: embed, 2 norms + 6 pairs a layer, lnf, the head pair
    assert len(param_leaves(qparams)) == 1 + CFG.n_layers * 14 + 1 + 2


def test_params_from_jax_quantized(qsetup):
    """JAX's quantized tree converted equals the port's quantization of the
    converted float tree, bit for bit."""
    jq, qparams, _ = qsetup
    conv = params_from_jax(_np(jq))
    for li in range(CFG.n_layers):
        for name in PROJ:
            for part in ("q", "s"):
                _same(conv["layers"][li][name][part],
                      qparams["layers"][li][name][part], f"{li} {name}")
    for part in ("q", "s"):
        _same(conv["head"][part], qparams["head"][part], "head")


@pytest.mark.parametrize("T", [48, 80])
def test_steps_match_jax(qsetup, T):
    """prefill (B * T = 96 rows: the kernel's function; 160: the dequant
    dot), three decode steps (4 rows) and a verify_step of 4 tokens."""
    jq, _, _ = qsetup
    qparams = params_from_jax(_np(jq))
    rng = np.random.default_rng(T)
    prompt = rng.integers(0, CFG.vocab, (2, T)).astype(np.int32)
    jcache, cache = caches(2, 2, 128)
    jl, jcache = jax_serving.prefill(jq, JCFG, jnp.asarray(prompt), jcache)
    tl, cache = serving.prefill(qparams, CFG, torch.from_numpy(prompt), cache)
    check_all_close(tl, np.asarray(jl), name=f"prefill T{T}", **F32)
    for i in range(3):
        tok = rng.integers(0, CFG.vocab, 2).astype(np.int32)
        jl, jcache = jax_serving.decode_step(jq, JCFG, jnp.asarray(tok),
                                             jcache)
        tl, cache = serving.decode_step(qparams, CFG, torch.from_numpy(tok),
                                        cache)
        check_all_close(tl, np.asarray(jl), name=f"decode {i}", **F32)
    cont = rng.integers(0, CFG.vocab, (2, 4)).astype(np.int32)
    jl, _ = jax_serving.verify_step(jq, JCFG, jnp.asarray(cont), jcache)
    tl, _ = serving.verify_step(qparams, CFG, torch.from_numpy(cont), cache)
    check_all_close(tl, np.asarray(jl), name="verify", **F32)


def test_generate_streams_equal_jax(qsetup):
    jq, qparams, prompts = qsetup
    prompt = prompts[1][None]
    ref = jax_serving.generate(jq, JCFG, jnp.asarray(prompt), n_steps=6,
                               pages_per_seq=2, cache_dtype=jnp.float32)
    out = serving.generate(qparams, CFG, torch.from_numpy(prompt), n_steps=6,
                           pages_per_seq=2, cache_dtype=torch.float32)
    assert out.tolist() == np.asarray(ref).tolist()


def test_batcher_streams_equal_jax(qsetup):
    jq, qparams, prompts = qsetup
    kw = dict(n_slots=2, pages_per_seq=2, page_size=128, max_new_tokens=5,
              prompt_buckets=(64,))
    reqs = list(enumerate(prompts))
    jref = JaxBatcher(jq, JCFG, cache_dtype=jnp.float32, **kw).run(reqs)
    got = ContinuousBatcher(qparams, CFG, cache_dtype=torch.float32,
                            **kw).run(reqs)
    assert set(got) == {0, 1, 2} and got == streams(jref)


def test_int8_kv_streams_equal_jax(qsetup):
    """w8a16 weights over int8 KV pools: the JAX batcher's streams."""
    jq, qparams, prompts = qsetup
    kw = dict(n_slots=2, pages_per_seq=4, page_size=16, max_new_tokens=5,
              prompt_buckets=(48,))
    reqs = list(enumerate(prompts))
    ref = JaxBatcher(jq, JCFG, cache_dtype=jnp.int8, **kw).run(reqs)
    out = ContinuousBatcher(qparams, CFG, cache_dtype=torch.int8,
                            **kw).run(reqs)
    assert out == streams(ref)


def test_speculative_batcher_w8a16(qsetup, draft):
    """A w8a16 target with a w8a16 draft: JAX's streams, and the target's
    own greedy streams (ContinuousBatcher)."""
    jq, qparams, prompts = qsetup
    jdraft, tdraft = draft
    jqd = jax_serving.quantize_model_weights(jdraft)
    qd = serving.quantize_model_weights(tdraft)
    kw = dict(n_slots=2, pages_per_seq=2, page_size=128, max_new_tokens=6,
              prompt_buckets=(64,))
    reqs = list(enumerate(prompts))
    ref = JaxSpecBatcher(jq, JCFG, jqd, JDRAFT, gamma=3,
                         cache_dtype=jnp.float32, **kw).run(reqs)
    out = SpeculativeBatcher(qparams, CFG, qd, CDRAFT, gamma=3,
                             cache_dtype=torch.float32, **kw).run(reqs)
    plain = ContinuousBatcher(qparams, CFG, cache_dtype=torch.float32,
                              **kw).run(reqs)
    assert out == streams(ref) == plain


def test_training_refuses_w8a16(qsetup):
    _, qparams, _ = qsetup
    tokens = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="serving-only"):
        forward(qparams, tokens, CFG)
    step = make_train_step(CFG, torch.optim.SGD([torch.zeros(1)], lr=0.1))
    with pytest.raises(ValueError, match="serving-only"):
        step(qparams, tokens, tokens)
