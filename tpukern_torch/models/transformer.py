"""The decoder's configuration and parameters (tpukern/models/transformer.py).

Parameters are a plain dict with the JAX package's tree: embed (V, d),
layers (a list of dicts with ln1, wq, wk, wv, wo, ln2, w1, w2), lnf (d,)
and head (d, V). Projections keep the (d_in, d_out) layout, so `h @ w`
means the same on both sides. The training forward, loss and step are
not ported yet (ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


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
    # the fields below keep the JAX Config's shape; the serving port
    # raises NotImplementedError when any of them is set
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


def init_params(cfg: Config, generator: torch.Generator, device=None):
    """Random weights, normal * 0.02 in cfg.param_dtype, norm gains 1.

    The same distribution as the JAX init_params, drawn from `generator`
    (which must live on `device`), so not the same numbers: parity tests
    convert JAX weights with params_from_jax instead."""
    dt = cfg.param_dtype

    def w(*shape):
        return (torch.randn(shape, generator=generator, device=device)
                * 0.02).to(dt)

    def ones():
        return torch.ones(cfg.d_model, dtype=dt, device=device)

    if cfg.n_experts:
        raise NotImplementedError("MoE layers: ROADMAP.md queue 1 item 11")
    Dh = cfg.head_dim
    layers = [dict(ln1=ones(),
                   wq=w(cfg.d_model, cfg.n_heads * Dh),
                   wk=w(cfg.d_model, cfg.n_kv_heads * Dh),
                   wv=w(cfg.d_model, cfg.n_kv_heads * Dh),
                   wo=w(cfg.n_heads * Dh, cfg.d_model),
                   ln2=ones(),
                   w1=w(cfg.d_model, cfg.d_ff),
                   w2=w(cfg.d_ff, cfg.d_model))
              for _ in range(cfg.n_layers)]
    return dict(embed=w(cfg.vocab, cfg.d_model), layers=layers, lnf=ones(),
                head=w(cfg.d_model, cfg.vocab))


def params_from_jax(tree) -> dict[str, Any]:
    """The JAX params tree, given as numpy arrays, as CPU tensors of the
    same dtypes and layout. numpy has no bf16: convert bf16 leaves to f32
    on the JAX side (`np.asarray(x.astype(jnp.float32))`) and cast back
    with `.to(torch.bfloat16)` here if wanted."""
    def leaf(x):
        return torch.from_numpy(np.array(x))

    return dict(embed=leaf(tree["embed"]),
                layers=[{k: leaf(v) for k, v in lp.items()}
                        for lp in tree["layers"]],
                lnf=leaf(tree["lnf"]), head=leaf(tree["head"]))


def params_to(params, *args, **kwargs):
    """params with every tensor converted by Tensor.to(*args, **kwargs)."""
    return dict(embed=params["embed"].to(*args, **kwargs),
                layers=[{k: v.to(*args, **kwargs) for k, v in lp.items()}
                        for lp in params["layers"]],
                lnf=params["lnf"].to(*args, **kwargs),
                head=params["head"].to(*args, **kwargs))
