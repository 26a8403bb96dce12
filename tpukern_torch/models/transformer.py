"""The decoder (tpukern/models/transformer.py): its configuration and
parameters, and the single-device training path `forward` -> `loss_fn`
-> `make_train_step`, which runs the kernels through ops/trainable.py.

Parameters are a plain dict with the JAX package's tree: embed (V, d),
layers (a list of dicts with ln1, wq, wk, wv, wo, ln2, and w1, w2 or,
with Config.n_experts, a dict moe = {router, w1, w2}), lnf (d,) and head
(d, V). Projections keep the (d_in, d_out) layout, so `h @ w` means the
same on both sides. Config.n_experts runs each layer's FFN through
models/moe.py's capacity dispatch (moe_block_topk: top moe_top_k experts
a token, moe_capacity_factor), as JAX's trainer does. Config.fused_loss
runs the LM head and its loss through ops/cross_entropy.py's fused
kernels; Config.window and Config.softcap run attention through the
featured forward and the two-kernel backward. Config.sinks is
inference-only, as in the JAX package: forward() runs the forward kernel
with it, and differentiating through it raises NotImplementedError. Not
ported here: the tp/sp/ep mesh axes (NotImplementedError naming
ROADMAP.md queue 1 item 13).

A w8a16 tree (serving.quantize_model_weights: int8 {"q", "s"} pairs) is
serving-only, as in the JAX package: forward and the train step raise
ValueError for it; params_from_jax, params_to and param_leaves walk its
pairs.

init_params builds on the card unless the caller passes device="cpu";
params_from_jax is a conversion and gives CPU tensors. The training path
runs on the device of its params and tokens: a CPU tensor takes every
kernel's plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from tpukern_torch.models.moe import init_moe_params, moe_block_topk
from tpukern_torch.ops.attention import flash_attention
from tpukern_torch.ops.cross_entropy import fused_cross_entropy
from tpukern_torch.ops.trainable import (flash_attention_trainable, matmul_t,
                                         rms_norm_t, rope_t)


@dataclasses.dataclass(frozen=True)
class Config:
    vocab: int = 2048
    d_model: int = 256
    n_layers: int = 2
    n_heads: int = 8
    n_kv_heads: int = 4
    d_ff: int = 1024
    max_seq: int = 256
    param_dtype: Any = torch.float32
    # the fields below keep the JAX Config's shape; serving raises
    # NotImplementedError for n_experts (the JAX package's serving has no
    # MoE path)
    n_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 2.0
    fused_loss: bool = False
    remat: bool = False
    window: Any = None
    softcap: Any = None
    sinks: Any = None
    pv_int8: bool = False

    @property
    def head_dim(self):
        return self.d_model // self.n_heads


def init_params(cfg: Config, generator: torch.Generator, device="cuda"):
    """Random weights, normal * 0.02 in cfg.param_dtype, norm gains 1, on
    `device` (the card unless the caller asks for "cpu").

    The same distribution as the JAX init_params, drawn from `generator`,
    which must live on `device` (ValueError otherwise), so not the same
    numbers: parity tests convert JAX weights with params_from_jax
    instead."""
    device = torch.device(device)
    gdev = generator.device
    if gdev.type != device.type or (device.index is not None
                                    and gdev.index != device.index):
        raise ValueError(f"generator on {gdev}, params on {device}: make "
                         f"the generator with torch.Generator(device=...)")
    dt = cfg.param_dtype

    def w(*shape):
        return (torch.randn(shape, generator=generator, device=device)
                * 0.02).to(dt)

    def ones():
        return torch.ones(cfg.d_model, dtype=dt, device=device)

    Dh = cfg.head_dim

    def layer():
        lp = dict(ln1=ones(),
                  wq=w(cfg.d_model, cfg.n_heads * Dh),
                  wk=w(cfg.d_model, cfg.n_kv_heads * Dh),
                  wv=w(cfg.d_model, cfg.n_kv_heads * Dh),
                  wo=w(cfg.n_heads * Dh, cfg.d_model),
                  ln2=ones())
        if cfg.n_experts:
            lp["moe"] = init_moe_params(generator, cfg.d_model, cfg.d_ff,
                                        cfg.n_experts, dtype=dt,
                                        device=device)
        else:
            lp.update(w1=w(cfg.d_model, cfg.d_ff), w2=w(cfg.d_ff, cfg.d_model))
        return lp

    layers = [layer() for _ in range(cfg.n_layers)]
    return dict(embed=w(cfg.vocab, cfg.d_model), layers=layers, lnf=ones(),
                head=w(cfg.d_model, cfg.vocab))


def params_from_jax(tree) -> dict[str, Any]:
    """The JAX params tree, given as numpy arrays, as CPU tensors of the
    same dtypes and layout. numpy has no bf16: convert bf16 leaves to f32
    on the JAX side (`np.asarray(x.astype(jnp.float32))`) and cast back
    with `.to(torch.bfloat16)` here if wanted. A nested dict (a layer's
    moe weights, or a w8a16 pair {"q": int8, "s": f32} of JAX's
    quantize_model_weights) stays such a dict."""
    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x))

    return dict(embed=leaf(tree["embed"]),
                layers=[{k: leaf(v) for k, v in lp.items()}
                        for lp in tree["layers"]],
                lnf=leaf(tree["lnf"]), head=leaf(tree["head"]))


def _is_w8a16(x):
    """A w8a16 pair: a dict with the keys q and s (every other dict of
    the tree, a layer's moe, holds weights)."""
    return isinstance(x, dict) and x.keys() == {"q", "s"}


def params_to(params, *args, **kwargs):
    """params with every tensor converted by Tensor.to(*args, **kwargs),
    a layer's moe dict included, except that a w8a16 pair {"q", "s"} only
    moves: q stays int8 and s f32."""
    def to(x):
        if _is_w8a16(x):
            return {k: v.to(torch.empty(0, device=v.device)
                            .to(*args, **kwargs).device)
                    for k, v in x.items()}
        if isinstance(x, dict):
            return {k: to(v) for k, v in x.items()}
        return x.to(*args, **kwargs)

    return dict(embed=to(params["embed"]),
                layers=[{k: to(v) for k, v in lp.items()}
                        for lp in params["layers"]],
                lnf=to(params["lnf"]), head=to(params["head"]))


def param_leaves(params) -> list[torch.Tensor]:
    """The parameter tensors in a fixed order (embed, each layer's in
    insertion order, lnf, head; a nested dict gives its own in insertion
    order: a moe dict router, w1, w2, a w8a16 pair q, then s): what an
    optimizer is built over."""
    def flat(x):
        if isinstance(x, dict):
            return [t for v in x.values() for t in flat(v)]
        return [x]

    return ([params["embed"]]
            + [t for lp in params["layers"] for w in lp.values()
               for t in flat(w)]
            + [params["lnf"], *flat(params["head"])])


def _check_trainable(params):
    """w8a16 weights are a serving tier (JAX's quantize_model_weights):
    the training path takes full-precision weights only. A layer's moe
    dict is not such a pair."""
    def pairs(x):
        if _is_w8a16(x):
            return True
        return isinstance(x, dict) and any(pairs(v) for v in x.values())

    if pairs(params["head"]) or any(pairs(lp) for lp in params["layers"]):
        raise ValueError("w8a16 params (quantize_model_weights) are "
                         "serving-only: forward and the train step take "
                         "full-precision weights")


def _check_forward(cfg: Config, tp_size=1, tp_axis=None, sp_axis=None,
                   ep_axis=None):
    if tp_size != 1 or any(a is not None for a in (tp_axis, sp_axis,
                                                   ep_axis)):
        raise NotImplementedError("not ported yet: tp/sp/ep mesh axes: "
                                  "ROADMAP.md queue 1 item 13")


def _attn_block(h, lp, cfg: Config):
    B, S, d = h.shape
    Dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    h2 = h.reshape(B * S, d)

    def to_heads(x, nh):
        # (B*S, nh*Dh) -> (B*nh*S, Dh) rows for one batched RoPE call
        x = x.reshape(B, S, nh, Dh).transpose(1, 2).reshape(B * nh * S, Dh)
        return rope_t(x, S).reshape(B, nh, S, Dh)

    q = to_heads(matmul_t(h2, lp["wq"]), hq)
    k = to_heads(matmul_t(h2, lp["wk"]), hkv)
    v = matmul_t(h2, lp["wv"]).reshape(B, S, hkv, Dh).transpose(1, 2)
    if cfg.sinks is not None:
        # an inference-only mask (tpukern/models/transformer.py:180-184):
        # the forward kernel, which has no backward
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise NotImplementedError(
                "Config.sinks is inference-only in the JAX package: the "
                "backward kernels do not carry the sink mask; run forward() "
                "under torch.no_grad()")
        o = flash_attention(q, k, v, causal=True, window=cfg.window,
                            sinks=cfg.sinks, softcap=cfg.softcap)
    else:
        o = flash_attention_trainable(q, k, v, True, None, cfg.window,
                                      cfg.softcap)
    o = o.transpose(1, 2).reshape(B * S, hq * Dh)
    return matmul_t(o, lp["wo"]).reshape(B, S, d)


def _mlp_block(h, lp):
    B, S, d = h.shape
    u = matmul_t(h.reshape(B * S, d), lp["w1"])
    u = torch.nn.functional.gelu(u, approximate="tanh")  # jax.nn.gelu
    return matmul_t(u, lp["w2"]).reshape(B, S, d)


def _moe_block(h, lp, cfg: Config):
    """The routed FFN of JAX's trainer: capacity dispatch over the
    layer's moe weights (models/moe.py moe_block_topk)."""
    B, S, d = h.shape
    y = moe_block_topk(h.reshape(B * S, d), lp["moe"], k=cfg.moe_top_k,
                       capacity_factor=cfg.moe_capacity_factor)
    return y.reshape(B, S, d)


def _layer(h, lp, cfg: Config):
    B, S, d = h.shape
    hn = rms_norm_t(h.reshape(B * S, d), lp["ln1"]).reshape(h.shape)
    h = h + _attn_block(hn, lp, cfg)
    hn = rms_norm_t(h.reshape(B * S, d), lp["ln2"]).reshape(h.shape)
    if cfg.n_experts:
        return h + _moe_block(hn, lp, cfg)
    return h + _mlp_block(hn, lp)


def forward(params, tokens, cfg: Config, tp_size: int = 1, tp_axis=None,
            sp_axis=None, ep_axis=None, return_hidden=False):
    """tokens (B, S) int -> logits (B, S, vocab) f32; with return_hidden
    the final-norm hidden states (B*S, d) instead.

    cfg.remat recomputes each layer in the backward pass
    (torch.utils.checkpoint) instead of keeping its activations. The
    mesh arguments keep the JAX signature; anything but their defaults
    raises NotImplementedError. w8a16 params (serving-only) raise
    ValueError."""
    _check_forward(cfg, tp_size, tp_axis, sp_axis, ep_axis)
    _check_trainable(params)
    B, S = tokens.shape
    h = params["embed"][tokens]
    for lp in params["layers"]:
        if cfg.remat:
            h = checkpoint(_layer, h, lp, cfg, use_reentrant=False)
        else:
            h = _layer(h, lp, cfg)
    hn = rms_norm_t(h.reshape(B * S, -1), params["lnf"])
    if return_hidden:
        return hn
    logits = matmul_t(hn, params["head"]).reshape(B, S, cfg.vocab)
    return logits.float()


def loss_fn(params, tokens, targets, cfg: Config):
    """Mean next-token NLL over all B·S tokens (transformer.py:258-273).

    cfg.fused_loss: the final hidden states and the head go through
    fused_cross_entropy, so the (B·S, vocab) logits are never formed;
    otherwise the head GEMM and an unfused log-softmax. The mean counts
    ignored tokens (target < 0, fused path only) as 0, as jnp.mean does."""
    if cfg.fused_loss:
        hn = forward(params, tokens, cfg, return_hidden=True)
        return fused_cross_entropy(hn, params["head"],
                                   targets.reshape(-1)).mean()
    logp = torch.log_softmax(forward(params, tokens, cfg), dim=-1)
    return -logp.gather(-1, targets[..., None].long()).mean()


def _accum_grads(grad_of_batch, tokens, targets, accum_steps):
    """Split the batch into accum_steps microbatches, run grad_of_batch on
    each and average: the grad of the full-batch mean loss (equal
    microbatch sizes) at 1/accum_steps of the activation memory."""
    B = tokens.shape[0]
    if B % accum_steps:
        raise ValueError(f"batch {B} does not split into {accum_steps} "
                         "microbatches")
    loss, grads = grad_of_batch(tokens[:B // accum_steps],
                                targets[:B // accum_steps])
    grads = list(grads)
    for i in range(1, accum_steps):
        mb = slice(i * B // accum_steps, (i + 1) * B // accum_steps)
        l_i, g_i = grad_of_batch(tokens[mb], targets[mb])
        loss = loss + l_i
        for acc, g in zip(grads, g_i):
            acc.add_(g)
    inv = 1.0 / accum_steps
    return loss * inv, [g * inv for g in grads]


def make_train_step(cfg: Config, optimizer, accum_steps=1):
    """Single-device train step(params, tokens, targets) -> loss.

    `optimizer` is a torch.optim.Optimizer over param_leaves(params),
    whose tensors require grad. The step computes the loss and its grads
    (averaged over accum_steps microbatches), stores the grads in each
    leaf's .grad, applies the optimizer in place and returns the loss."""

    def step(params, tokens, targets):
        _check_trainable(params)
        leaves = param_leaves(params)
        if not all(p.requires_grad for p in leaves):
            raise ValueError("every parameter must require grad "
                             "(p.requires_grad_() on param_leaves(params))")

        def gb(tok, tgt):
            loss = loss_fn(params, tok, tgt, cfg)
            return loss.detach(), torch.autograd.grad(loss, leaves)

        if accum_steps > 1:
            loss, grads = _accum_grads(gb, tokens, targets, accum_steps)
        else:
            loss, grads = gb(tokens, targets)
        for p, g in zip(leaves, grads):
            p.grad = g
        optimizer.step()
        return loss

    return step
