"""The tpukern_torch training step against the JAX package on CPU.

A 2-layer config (vocab 128, d 128, 4/2 heads, d_ff 256) with the JAX
init's weights, converted by params_from_jax, and tokens from a numpy
seed. Both sides run in f32: the JAX side its Pallas kernels in interpret
mode, the port its plain versions inside the same autograd Functions that
launch the kernels on a card. Tolerance 2e-5, as in
tests/test_torch_ops.py (sums taken in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpukern.models import Config as JaxConfig
from tpukern.models import forward as jax_forward
from tpukern.models import init_params as jax_init_params
from tpukern.models import loss_fn as jax_loss_fn
from tpukern.models import make_train_step as jax_make_train_step
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.models import (Config, forward, loss_fn, make_train_step,
                                  param_leaves, params_from_jax)

SHAPE = dict(vocab=128, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=256, max_seq=64)
JCFG, CFG = JaxConfig(**SHAPE), Config(**SHAPE)
F32 = dict(rtol=2e-5, atol=2e-5)
LR = 0.5


def _named(params):
    """{'embed': t, 'layers.0.ln1': t, ...} of a JAX or port param tree,
    in param_leaves order."""
    out = {"embed": params["embed"]}
    for i, lp in enumerate(params["layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in lp.items()})
    return out | {k: params[k] for k in ("lnf", "head")}


def _trainable(jparams):
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    for t in param_leaves(params):
        t.requires_grad_()
    return params


@pytest.fixture(scope="module")
def setup():
    jparams = jax_init_params(JCFG, jax.random.key(0))
    rng = np.random.default_rng(0)
    tokens, targets = (rng.integers(0, CFG.vocab, (2, 64)).astype(np.int32)
                       for _ in range(2))
    return jparams, tokens, targets


def test_forward_logits_match_jax(setup):
    jparams, tokens, _ = setup
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    logits = forward(params, torch.from_numpy(tokens), CFG)
    ref = jax_forward(jparams, jnp.asarray(tokens), JCFG)
    assert logits.dtype == torch.float32 and logits.shape == (2, 64, 128)
    check_all_close(logits, np.asarray(ref), name="logits", **F32)
    hn = forward(params, torch.from_numpy(tokens), CFG, return_hidden=True)
    jhn = jax_forward(jparams, jnp.asarray(tokens), JCFG, return_hidden=True)
    check_all_close(hn, np.asarray(jhn), name="hidden", **F32)


def _loss_and_grads_match(jparams, tokens, targets, jcfg, cfg):
    params = _trainable(jparams)
    loss = loss_fn(params, torch.from_numpy(tokens),
                   torch.from_numpy(targets), cfg)
    grads = torch.autograd.grad(loss, param_leaves(params))
    jloss, jgrads = jax.value_and_grad(jax_loss_fn)(
        jparams, jnp.asarray(tokens), jnp.asarray(targets), jcfg)
    check_all_close(loss.detach(), np.asarray(jloss), name="loss", **F32)
    assert all(a is b for a, b in zip(_named(params).values(),
                                      param_leaves(params)))
    named = dict(zip(_named(params), grads))
    jnamed = _named(jgrads)
    assert named.keys() == jnamed.keys()
    assert len(named) == 3 + 8 * cfg.n_layers
    for name, g in named.items():
        check_all_close(g, np.asarray(jnamed[name]), name=name, **F32)


def test_loss_and_every_gradient_match_jax(setup):
    _loss_and_grads_match(*setup, JCFG, CFG)


def test_entry_config_matches_jax():
    """The model of __graft_entry__.entry() (vocab 1024, d 512, 2 layers,
    8/4 heads, d_ff 1024, S 256) with its JAX weights: the logits of
    entry()'s own function, then the next-token loss and every gradient."""
    import __graft_entry__

    fn, (jparams, jtokens) = __graft_entry__.entry()
    shape = dict(vocab=1024, d_model=512, n_layers=2, n_heads=8,
                 n_kv_heads=4, d_ff=1024, max_seq=256)
    tokens = np.array(jtokens)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    check_all_close(forward(params, torch.from_numpy(tokens),
                            Config(**shape)),
                    np.asarray(fn(jparams, jtokens)), name="logits", **F32)
    _loss_and_grads_match(jparams, tokens, np.roll(tokens, -1, axis=1),
                          JaxConfig(**shape), Config(**shape))


def test_sgd_step_matches_jax(setup):
    """One step with plain SGD on both sides, compared on the params (a
    first Adam step is about lr·sign(g), which flips on near-zero grads)."""
    jparams, tokens, targets = setup
    params = _trainable(jparams)
    step = make_train_step(CFG, torch.optim.SGD(param_leaves(params), lr=LR))
    loss = step(params, torch.from_numpy(tokens), torch.from_numpy(targets))
    tx = optax.sgd(LR)
    jnew, _, jloss = jax_make_train_step(JCFG, tx)(
        jparams, tx.init(jparams), jnp.asarray(tokens), jnp.asarray(targets))
    check_all_close(loss, np.asarray(jloss), name="loss", **F32)
    jnamed = _named(jnew)
    for name, p in _named(params).items():
        check_all_close(p.detach(), np.asarray(jnamed[name]), name=name, **F32)


def _one_sgd_step(jparams, tokens, targets, cfg, accum_steps=1):
    params = _trainable(jparams)
    opt = torch.optim.SGD(param_leaves(params), lr=LR)
    loss = make_train_step(cfg, opt, accum_steps)(
        params, torch.from_numpy(tokens), torch.from_numpy(targets))
    return loss, params


@pytest.mark.parametrize("variant", ["accum_steps=2", "remat"])
def test_variant_equals_plain_step(setup, variant):
    """accum_steps=2 averages two microbatches' grads into the full-batch
    grad; remat recomputes each layer in the backward pass. Either gives
    the plain step's loss and params."""
    jparams, tokens, targets = setup
    ref_loss, ref = _one_sgd_step(jparams, tokens, targets, CFG)
    if variant == "remat":
        loss, params = _one_sgd_step(jparams, tokens, targets,
                                     dataclasses.replace(CFG, remat=True))
    else:
        loss, params = _one_sgd_step(jparams, tokens, targets, CFG, 2)
    check_all_close(loss, ref_loss, name="loss", **F32)
    ref_named = _named(ref)
    for name, p in _named(params).items():
        check_all_close(p.detach(), ref_named[name].detach(), name=name, **F32)


# window and softcap that cut the 64-token sequences: the band of 24 keys
# and a cap of 30 on the attention logits (the Gemma-2 style training
# configuration at this size)
FEATURED = dict(window=24, softcap=30.0)


def test_featured_logits_loss_and_every_gradient_match_jax(setup):
    """Config.window and Config.softcap: logits, then the loss and every
    gradient through the featured forward and the two-kernel backward."""
    jparams, tokens, targets = setup
    jcfg = dataclasses.replace(JCFG, **FEATURED)
    cfg = dataclasses.replace(CFG, **FEATURED)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    logits = forward(params, torch.from_numpy(tokens), cfg)
    ref = jax_forward(jparams, jnp.asarray(tokens), jcfg)
    check_all_close(logits, np.asarray(ref), name="logits", **F32)
    plain = forward(params, torch.from_numpy(tokens), CFG)
    assert not torch.allclose(logits, plain, rtol=1e-3, atol=1e-3)
    _loss_and_grads_match(jparams, tokens, targets, jcfg, cfg)


def test_featured_sgd_step_matches_jax(setup):
    """One SGD step with window and softcap on both sides."""
    jparams, tokens, targets = setup
    jcfg = dataclasses.replace(JCFG, **FEATURED)
    loss, params = _one_sgd_step(jparams, tokens, targets,
                                 dataclasses.replace(CFG, **FEATURED))
    tx = optax.sgd(LR)
    jnew, _, jloss = jax_make_train_step(jcfg, tx)(
        jparams, tx.init(jparams), jnp.asarray(tokens), jnp.asarray(targets))
    check_all_close(loss, np.asarray(jloss), name="loss", **F32)
    jnamed = _named(jnew)
    for name, p in _named(params).items():
        check_all_close(p.detach(), np.asarray(jnamed[name]), name=name, **F32)


def test_sinks_forward_matches_jax(setup):
    """Config.sinks (inference-only) with a window: forward() through the
    forward kernel, on params that do not require grad."""
    jparams, tokens, _ = setup
    kw = dict(window=16, sinks=4)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    logits = forward(params, torch.from_numpy(tokens),
                     dataclasses.replace(CFG, **kw))
    ref = jax_forward(jparams, jnp.asarray(tokens),
                      dataclasses.replace(JCFG, **kw))
    check_all_close(logits, np.asarray(ref), name="logits", **F32)


def test_sinks_in_training_raise(setup):
    """Differentiating through sinks fails loudly, as in JAX: the backward
    kernels do not carry the sink mask."""
    jparams, tokens, targets = setup
    params = _trainable(jparams)
    cfg = dataclasses.replace(CFG, window=16, sinks=4)
    with pytest.raises(NotImplementedError, match="inference-only"):
        loss_fn(params, torch.from_numpy(tokens), torch.from_numpy(targets),
                cfg)
    with torch.no_grad():
        loss = loss_fn(params, torch.from_numpy(tokens),
                       torch.from_numpy(targets), cfg)
    assert torch.isfinite(loss)


@pytest.mark.parametrize("field,value", [("n_experts", 4)])
def test_unported_training_options_raise(setup, field, value):
    jparams, tokens, targets = setup
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    cfg = dataclasses.replace(CFG, **{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        loss_fn(params, torch.from_numpy(tokens), torch.from_numpy(targets),
                cfg)


def test_mesh_axes_raise(setup):
    jparams, tokens, _ = setup
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    for kw in (dict(tp_size=2), dict(tp_axis="tp"), dict(sp_axis="sp"),
               dict(ep_axis="ep")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            forward(params, torch.from_numpy(tokens), CFG, **kw)


def test_train_step_needs_trainable_params(setup):
    jparams, tokens, targets = setup
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    step = make_train_step(CFG, torch.optim.SGD(param_leaves(params), lr=LR))
    with pytest.raises(ValueError, match="require grad"):
        step(params, torch.from_numpy(tokens), torch.from_numpy(targets))
