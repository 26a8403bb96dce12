"""The fused LM-head cross-entropy of tpukern_torch against the JAX
package on CPU, and the training step with Config.fused_loss.

Inputs come from a numpy seed and go through both sides. The JAX side
runs its Pallas kernels in interpret mode (conftest forces the CPU
platform); the port side takes the plain PyTorch versions, as its
wrappers do for CPU tensors, inside the same autograd Function that
launches the kernels on a card. Everything is f32, tolerance 2e-5, as in
tests/test_torch_train_ops.py (sums are taken in another order).
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpukern.models import Config as JaxConfig
from tpukern.models import init_params as jax_init_params
from tpukern.models import loss_fn as jax_loss_fn
from tpukern.models import make_train_step as jax_make_train_step
from tpukern.ops import cross_entropy as jce
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.models import (Config, init_params, loss_fn,
                                  make_train_step, param_leaves,
                                  params_from_jax, serving)
from tpukern_torch.ops import cross_entropy as ce
from tpukern_torch.ops import split_tf32 as st

F32 = dict(rtol=2e-5, atol=2e-5)
SHAPES = [(256, 128, 1024), (200, 128, 1000)]  # tiles and tails in N and V
# tests/test_torch_train.py's 2-layer config
SHAPE = dict(vocab=128, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=256, max_seq=64)
JCFG = JaxConfig(**SHAPE, fused_loss=True)
CFG = Config(**SHAPE, fused_loss=True)
LR = 0.5


def _inputs(N, D, V, seed=0):
    """x, w (f32) and int32 targets with a quarter of them -1."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.05).astype(np.float32)
    t = rng.integers(0, V, N).astype(np.int32)
    t[rng.permutation(N)[:N // 4]] = -1
    return x, w, t


@pytest.mark.parametrize("N,D,V", SHAPES)
def test_fused_loss_and_lse_match_jax(N, D, V):
    x, w, t = _inputs(N, D, V)
    loss = ce.fused_cross_entropy(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(t).long())
    loss2, lse = ce.fused_cross_entropy(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(t),
        return_lse=True)
    jloss, jlse = jce.fused_cross_entropy(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(t), return_lse=True)
    assert loss.dtype == lse.dtype == torch.float32 and loss.shape == (N,)
    assert not lse.requires_grad
    check_all_close(loss, np.asarray(jloss), name="loss", **F32)
    check_all_close(loss2, np.asarray(jloss), name="loss", **F32)
    check_all_close(lse, np.asarray(jlse), name="lse", **F32)
    assert (loss[torch.from_numpy(t) < 0] == 0).all()


@pytest.mark.parametrize("N,D,V", SHAPES)
def test_fused_grads_match_jax(N, D, V):
    """dx and dW of the mean loss through _FusedCE against jax.grad;
    ignored rows get exactly-zero dx."""
    x, w, t = _inputs(N, D, V, seed=1)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    ce.fused_cross_entropy(xt, wt, torch.from_numpy(t)).mean().backward()

    def mean_loss(x, w):
        return jnp.mean(jce.fused_cross_entropy(x, w, jnp.asarray(t)))

    jdx, jdw = jax.grad(mean_loss, (0, 1))(jnp.asarray(x), jnp.asarray(w))
    check_all_close(xt.grad, np.asarray(jdx), name="dx", **F32)
    check_all_close(wt.grad, np.asarray(jdw), name="dW", **F32)
    assert (xt.grad[torch.from_numpy(t) < 0] == 0).all()


def test_plain_backward_equals_autograd():
    """ce_bwd_ref, the kernel's plain version, against torch.autograd of
    cross_entropy_ref, with a per-token cotangent."""
    x, w, t = _inputs(200, 64, 1000, seed=2)
    g = np.random.default_rng(3).standard_normal(200).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    tt = torch.from_numpy(t)
    dx, dw = torch.autograd.grad(ce.cross_entropy_ref(xt, wt, tt),
                                 (xt, wt), torch.from_numpy(g))
    _, lse = ce.fused_cross_entropy(xt, wt, tt, return_lse=True)
    rdx, rdw = ce.ce_bwd_ref(xt.detach(), wt.detach(), tt, lse,
                             torch.from_numpy(g))
    check_all_close(rdx, dx, name="dx", **F32)
    check_all_close(rdw, dw, name="dW", **F32)


@pytest.mark.parametrize("N,D,V", SHAPES)
def test_chunked_matches_jax(N, D, V):
    x, w, t = _inputs(N, D, V, seed=4)
    out = ce.chunked_cross_entropy(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(t), chunk=256)
    ref = jce.chunked_cross_entropy(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(t), chunk=256)
    check_all_close(out, np.asarray(ref), name="chunked", **F32)


def test_bf16_inputs_keep_their_dtypes():
    """bf16 x and w: f32 losses, gradients in the inputs' dtypes, values
    at the bf16 row of _TOLS against the f32 plain version."""
    x, w, t = _inputs(64, 32, 300, seed=5)
    xb = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wb = torch.from_numpy(w).to(torch.bfloat16).requires_grad_()
    loss = ce.fused_cross_entropy(xb, wb, torch.from_numpy(t))
    loss.sum().backward()
    assert loss.dtype == torch.float32
    assert xb.grad.dtype == wb.grad.dtype == torch.bfloat16
    ref = ce.cross_entropy_ref(xb.detach(), wb.detach(), torch.from_numpy(t))
    check_all_close(loss, ref, name="loss", **F32)


def test_bad_targets_raise():
    x, w, _ = _inputs(8, 16, 40)
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    with pytest.raises(ValueError, match="vocab"):
        ce.fused_cross_entropy(x, w, torch.full((8,), 40))
    with pytest.raises(ValueError, match="shape"):
        ce.fused_cross_entropy(x, w, torch.zeros(4, 2, dtype=torch.long))
    with pytest.raises(ValueError, match="vs w"):
        ce.fused_cross_entropy(x, w.T.contiguous(), torch.zeros(8))


@pytest.mark.parametrize("N,V,sms", [(2048, 32768, 132), (200, 1000, 132),
                                     (1, 5, 132), (70000, 129, 8)])
def test_vocab_splits_cover_every_tile(N, V, sms):
    """The forward's split: every split has a tile, every tile a split."""
    n_split, tps = ce.splits(N, V, sms)
    n_vt = -(-V // ce.TILE)
    assert (n_split - 1) * tps < n_vt <= n_split * tps


@pytest.mark.parametrize("N,V", [(2048, 32768), (200, 1000), (1, 5),
                                 (129, 257), (300, 1024), (70000, 256)])
def test_bf16_forward_partials_cover_every_tile(N, V):
    """The bf16 forward writes one partial for each 256-column vocab tile
    (cdiv(V, 256) of them, a tile each), whatever the SM count; f32 keeps
    splits()."""
    for sms in (8, 132):
        n_split, tps = ce.fwd_splits(N, V, torch.bfloat16, sms)
        assert (n_split, tps) == (-(-V // 256), 1)
        assert (n_split - 1) * ce.TILE_BF16 < V <= n_split * ce.TILE_BF16
        assert ce.fwd_splits(N, V, torch.float32, sms) == ce.splits(N, V,
                                                                     sms)


@pytest.mark.parametrize("use_exp2", [False, True])
@pytest.mark.parametrize("N,D,V", [(200, 64, 1000), (129, 100, 257),
                                   (300, 128, 1024)])
def test_tiled_forward_matches_jax(N, D, V, use_exp2):
    """ce_fwd_tiled_ref, the bf16 forward's order (a partial for each
    256-column tile, merged as ce_combine_kernel merges them), in f32
    against JAX's fused loss and lse (interpret mode) and _ce_ref: N not a
    multiple of the 128-row tile, V a tail tile, a quarter of the targets
    ignored and some in the last, partial tile."""
    x, w, t = _inputs(N, D, V, seed=N + D)
    t[1::7] = np.arange(V - 1, V - 1 - len(t[1::7]), -1) % V
    xt, wt, tt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(t)
    assert (tt >= V // 256 * 256).any() or V % 256 == 0
    loss, lse = ce.ce_fwd_tiled_ref(xt, wt, tt, use_exp2=use_exp2)
    jloss, jlse = jce.fused_cross_entropy(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(t), use_exp2=use_exp2,
                                          return_lse=True)
    check_all_close(loss, np.asarray(jloss), name="loss vs jax", **F32)
    check_all_close(lse, np.asarray(jlse), name="lse vs jax", **F32)
    rloss, rlse = ce._ce_ref(xt, wt, tt)
    check_all_close(loss, rloss, name="loss vs ref", **F32)
    check_all_close(lse, rlse, name="lse vs ref", **F32)
    assert (loss[tt < 0] == 0).all()


# (N, D, V): chip_smoke.py's training head (one chunk), a longer batch
# (four), shapes whose budget falls below a tile (chunks of 8 columns)
# or below 8, and V % 8 != 0
@pytest.mark.parametrize("N,D,V", [(2048, 2048, 32768), (8192, 2048, 32768),
                                   (200, 128, 1000), (129, 100, 257),
                                   (100000, 8, 1000), (4096, 64, 1001),
                                   (7, 3, 5), (1, 1, 1)])
def test_bwd_vocab_chunk_fits_and_covers(N, D, V):
    """The bf16 backward's chunk: its scratch (N rows of the chunk
    rounded up to 8 values) fits in D·V values wherever a chunk of 8
    does, a chunk below V is a multiple of 8 (its first column on a
    16-byte boundary), and the chunks are non-empty and cover V."""
    c = ce.bwd_vocab_chunk(N, D, V)
    assert 1 <= c <= V
    if N * 8 <= D * V:
        assert N * (-(-c // 8) * 8) <= D * V
    if c < V:
        assert c % 8 == 0 and (c % 256 == 0 or c < 256)
    starts = list(range(0, V, c))
    widths = [min(c, V - v0) for v0 in starts]
    assert min(widths) > 0 and sum(widths) == V


@pytest.mark.parametrize("N,D,V,chunk", [(200, 64, 1001, 256),
                                         (129, 100, 257, 96),
                                         (256, 128, 1024, 1024)])
def test_chunked_backward_matches_jax(N, D, V, chunk):
    """ce_bwd_chunked_ref, the bf16 backward's order (dlog a vocab chunk
    at a time, dx summed over the chunks in f32), in f32 against JAX's
    fused gradients (interpret mode) and against ce_bwd_ref: V not a
    multiple of the chunk, V % 8 != 0, a quarter of the targets
    ignored."""
    x, w, t = _inputs(N, D, V, seed=N + V)
    g = torch.full((N,), 1.0 / N)
    xt, wt, tt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(t)
    _, lse = ce.fused_cross_entropy(xt, wt, tt, return_lse=True)
    dx, dw = ce.ce_bwd_chunked_ref(xt, wt, tt, lse, g, chunk)

    def mean_loss(x, w):
        return jnp.mean(jce.fused_cross_entropy(x, w, jnp.asarray(t)))

    jdx, jdw = jax.grad(mean_loss, (0, 1))(jnp.asarray(x), jnp.asarray(w))
    check_all_close(dx, np.asarray(jdx), name="dx", **F32)
    check_all_close(dw, np.asarray(jdw), name="dW", **F32)
    rdx, rdw = ce.ce_bwd_ref(xt, wt, tt, lse, g)
    check_all_close(dx, rdx, name="dx vs ref", **F32)
    check_all_close(dw, rdw, name="dW vs ref", **F32)
    assert (dx[tt < 0] == 0).all()


@pytest.mark.parametrize("N,D,V", [(2048, 2048, 32768), (8192, 2048, 32768),
                                   (200, 128, 1000), (129, 100, 257),
                                   (100000, 8, 1000), (4096, 64, 1001),
                                   (7, 3, 5), (1, 1, 1)])
def test_bwd_vocab_chunk_f32_fits_and_covers(N, D, V):
    """The f32 backward's chunk: the split-TF32 scratch of W's chunk and
    of dlog (split_tf32.ce_scratch) fits in 2·D·V values wherever a chunk
    of 8 does, a chunk below V is a multiple of 8 (of 256 from 256 on),
    the chunks are non-empty and cover V, and the 7bish head takes 8192
    columns (four chunks)."""
    c = ce.bwd_vocab_chunk_f32(N, D, V)
    assert 1 <= c <= V
    if 8 * 2 * (N + D) <= D * V:
        _, ws, ds = st.ce_scratch(N, D, c)
        assert ws + ds <= 2 * D * V + 64 * (N + D)  # rows rounded to 4
    if c < V:
        assert c % 8 == 0 and (c % 256 == 0 or c < 256)
    starts = list(range(0, V, c))
    widths = [min(c, V - v0) for v0 in starts]
    assert min(widths) > 0 and sum(widths) == V
    if (N, D, V) == (2048, 2048, 32768):
        assert c == 8192


@pytest.mark.parametrize("use_exp2", [False, True])
@pytest.mark.parametrize("N,D,V", [(200, 128, 1000), (129, 100, 257),
                                   (256, 64, 1024)])
def test_f32_chunked_backward_matches_jax_vjp(N, D, V, use_exp2):
    """ce_bwd_chunked_ref at the f32 backward's own chunk
    (bwd_vocab_chunk_f32: 6, 5 and 4 chunks here), the f32 kernels' order
    (dlog a vocab chunk at a time in f32, dx summed over the chunks),
    against the VJP of JAX's f32 _fused_ce_core (interpret mode) under a
    random cotangent, in both of JAX's exp tiers, a quarter of the
    targets ignored."""
    x, w, t = _inputs(N, D, V, seed=3 * N + V)
    g = np.random.default_rng(N).random(N).astype(np.float32)
    xt, wt, tt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(t)
    _, lse = ce.fused_cross_entropy(xt, wt, tt, return_lse=True)
    chunk = ce.bwd_vocab_chunk_f32(N, D, V)
    assert chunk < V
    dx, dw = ce.ce_bwd_chunked_ref(xt, wt, tt, lse, torch.from_numpy(g),
                                   chunk)
    _, vjp = jax.vjp(lambda x, w: jce.fused_cross_entropy(
        x, w, jnp.asarray(t), use_exp2=use_exp2), jnp.asarray(x),
        jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    check_all_close(dx, np.asarray(jdx), name="dx", **F32)
    check_all_close(dw, np.asarray(jdw), name="dW", **F32)
    assert (dx[tt < 0] == 0).all()


def test_chunked_backward_rounds_dlog_as_the_ref():
    """With bf16 inputs the chunked order rounds dlog to bf16 as
    ce_bwd_ref does: the two agree at the bf16 tolerance relative to
    the largest gradient (a dlog near a rounding boundary may round the
    other way where the scores' sums differ in order)."""
    x, w, t = _inputs(129, 100, 257, seed=9)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    tt = torch.from_numpy(t)
    g = torch.rand(129, generator=torch.Generator().manual_seed(0))
    _, lse = ce.fused_cross_entropy(xb, wb, tt, return_lse=True)
    for a, b, name in zip(ce.ce_bwd_chunked_ref(xb, wb, tt, lse, g, 96),
                          ce.ce_bwd_ref(xb, wb, tt, lse, g), ("dx", "dW")):
        check_all_close(a, b, rtol=2e-2, atol=2e-2 * b.abs().max().item(),
                        name=name)


@pytest.fixture(scope="module")
def setup():
    jparams = jax_init_params(JCFG, jax.random.key(0))
    rng = np.random.default_rng(0)
    tokens, targets = (rng.integers(0, CFG.vocab, (2, 64)).astype(np.int32)
                       for _ in range(2))
    return jparams, tokens, targets


def _trainable(jparams):
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    for t in param_leaves(params):
        t.requires_grad_()
    return params


def _loss_and_grads(params, tokens, targets, cfg):
    loss = loss_fn(params, torch.from_numpy(tokens),
                   torch.from_numpy(targets), cfg)
    return loss.detach(), torch.autograd.grad(loss, param_leaves(params))


def _jax_leaves(tree):
    return ([tree["embed"]] + [w for lp in tree["layers"]
                               for w in lp.values()]
            + [tree["lnf"], tree["head"]])


def test_fused_loss_fn_matches_jax(setup):
    """The loss and every gradient of loss_fn with fused_loss=True, with
    the JAX init's weights, against JAX's loss_fn with fused_loss=True."""
    jparams, tokens, targets = setup
    loss, grads = _loss_and_grads(_trainable(jparams), tokens, targets, CFG)
    jloss, jgrads = jax.value_and_grad(jax_loss_fn)(
        jparams, jnp.asarray(tokens), jnp.asarray(targets), JCFG)
    check_all_close(loss, np.asarray(jloss), name="loss", **F32)
    jleaves = _jax_leaves(jgrads)
    assert len(grads) == len(jleaves) == 3 + 8 * CFG.n_layers
    for i, (g, jg) in enumerate(zip(grads, jleaves)):
        check_all_close(g, np.asarray(jg), name=f"leaf {i}", **F32)


def test_fused_loss_fn_equals_unfused(setup):
    """The same loss and gradients as the port's unfused log-softmax."""
    jparams, tokens, targets = setup
    params = _trainable(jparams)
    loss, grads = _loss_and_grads(params, tokens, targets, CFG)
    uloss, ugrads = _loss_and_grads(
        params, tokens, targets, dataclasses.replace(CFG, fused_loss=False))
    check_all_close(loss, uloss, name="loss", **F32)
    for i, (g, ug) in enumerate(zip(grads, ugrads)):
        check_all_close(g, ug, name=f"leaf {i}", **F32)


def test_fused_sgd_step_matches_jax(setup):
    """One make_train_step SGD step with fused_loss on both sides,
    compared on the new params."""
    jparams, tokens, targets = setup
    params = _trainable(jparams)
    step = make_train_step(CFG, torch.optim.SGD(param_leaves(params), lr=LR))
    loss = step(params, torch.from_numpy(tokens), torch.from_numpy(targets))
    tx = optax.sgd(LR)
    jnew, _, jloss = jax_make_train_step(JCFG, tx)(
        jparams, tx.init(jparams), jnp.asarray(tokens), jnp.asarray(targets))
    check_all_close(loss, np.asarray(jloss), name="loss", **F32)
    for i, (p, jp) in enumerate(zip(param_leaves(params), _jax_leaves(jnew))):
        check_all_close(p.detach(), np.asarray(jp), name=f"leaf {i}", **F32)


@pytest.mark.parametrize("variant", ["accum_steps=2", "remat"])
def test_fused_variant_equals_plain_step(setup, variant):
    """accum_steps=2 and remat=True with fused_loss give the plain fused
    step's loss and params."""
    jparams, tokens, targets = setup

    def one_step(cfg, accum_steps=1):
        params = _trainable(jparams)
        opt = torch.optim.SGD(param_leaves(params), lr=LR)
        loss = make_train_step(cfg, opt, accum_steps)(
            params, torch.from_numpy(tokens), torch.from_numpy(targets))
        return loss, params

    ref_loss, ref = one_step(CFG)
    if variant == "remat":
        loss, params = one_step(dataclasses.replace(CFG, remat=True))
    else:
        loss, params = one_step(CFG, 2)
    check_all_close(loss, ref_loss, name="loss", **F32)
    for i, (p, rp) in enumerate(zip(param_leaves(params), param_leaves(ref))):
        check_all_close(p.detach(), rp.detach(), name=f"leaf {i}", **F32)


@pytest.mark.parametrize("fn", [init_params, serving.init_cache])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_init_params_on_cpu_when_asked():
    params = init_params(Config(**SHAPE), torch.Generator().manual_seed(0),
                         device="cpu")
    assert all(t.device.type == "cpu" for t in param_leaves(params))
    assert params["head"].shape == (SHAPE["d_model"], SHAPE["vocab"])


def test_init_params_rejects_a_generator_elsewhere():
    with pytest.raises(ValueError, match="generator on cpu"):
        init_params(Config(**SHAPE), torch.Generator().manual_seed(0),
                    device="cuda")
