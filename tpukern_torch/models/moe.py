"""Mixture-of-experts feed-forward blocks (tpukern/models/moe.py).

Three tiers on one parameter dict {router (d, E), w1 (E, d, d_ff),
w2 (E, d_ff, d)}, each expert a two-matrix GELU FFN:

- moe_block (dense dispatch): every expert runs on every token under its
  top-1 routing mask. No capacity and no drops; FLOPs scale with E x T.
  The correctness oracle.
- moe_block_topk (capacity dispatch, the trainer's path): top-k routing
  into C = expert_capacity(T, E, k, cf) slots an expert by one-hot
  dispatch and combine einsums (f32, plain torch as they are XLA's in
  JAX), then one matmul_t (the GEMM kernel) per expert. Assignments past
  an expert's capacity are dropped; round i's choices take slots before
  round i + 1's.
- moe_block_dropless (token groups): each token repeated k times, the
  T·k rows sorted by expert (a stable argsort) and the FFN run as two
  ragged products over the group sizes: with use_kernel through
  grouped_matmul (#28 forward, #28 trans_w and #29 backward), otherwise
  through plain ragged products (gmm_ref), which stand for
  lax.ragged_dot. No drops, whatever the skew.

Beside them: the shared expert, the router z-loss and the load-balance
loss. The counterparts of JAX's XLA ops: lax.top_k -> torch.topk (ties
in no fixed order, where lax.top_k takes the lower index), jnp.argsort
-> torch.argsort(stable=True), jnp.bincount(length=E) ->
torch.bincount(minlength=E), .at[].add -> index_add (on CUDA in no fixed
order; with k <= 2 each row sums at most two terms onto 0, which rounds
alike in either order), jax.nn.gelu -> gelu(approximate="tanh").

Single device only: the ep mesh axis (JAX's all_to_all over "ep") and
moe_param_specs are sharding, ROADMAP.md queue 1 item 13; a non-None
ep_axis or an ep_size other than 1 raises NotImplementedError.
"""

import math

import torch
import torch.nn.functional as F

from tpukern_torch.ops.grouped_matmul import gmm_ref, grouped_matmul
from tpukern_torch.ops.trainable import matmul_t

_EP = "the ep mesh axis: ROADMAP.md queue 1 item 13"


def _check_ep(ep_axis=None, ep_size=1):
    if ep_axis is not None or ep_size != 1:
        raise NotImplementedError(f"not ported yet: {_EP}")


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _randn(generator, shape, device):
    return torch.randn(shape, generator=generator, device=device) * 0.02


def init_moe_params(generator, d_model, d_ff, n_experts,
                    dtype=torch.float32, device="cuda"):
    """router (d, E), w1 (E, d, d_ff), w2 (E, d_ff, d): normal * 0.02 in
    `dtype` on `device` (the card unless the caller asks for "cpu"),
    drawn from `generator`, which lives on `device`. JAX's distribution,
    not its numbers: parity tests convert JAX weights instead."""
    return dict(
        router=_randn(generator, (d_model, n_experts), device).to(dtype),
        w1=_randn(generator, (n_experts, d_model, d_ff), device).to(dtype),
        w2=_randn(generator, (n_experts, d_ff, d_model), device).to(dtype))


def _router_probs(x, params, E):
    logits = x @ params["router"][:, :E]                  # (T, E)
    return torch.softmax(logits.float(), dim=-1)


def _topk(probs, k, renorm):
    topk_p, topk_e = torch.topk(probs, k, dim=-1)         # (T, k)
    if renorm and k > 1:
        topk_p = topk_p / topk_p.sum(-1, keepdim=True)
    return topk_p, topk_e


def _one_hot(idx, n):
    """f32 one-hot rows; an index outside [0, n) gives a zero row, as
    jax.nn.one_hot does."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).float()


def moe_block(x, params, ep_axis=None, ep_size=1):
    """Dense-dispatch tier: x (T, d) -> (T, d). Top-1 (switch) routing,
    no capacity limit, no token dropping."""
    _check_ep(ep_axis, ep_size)
    E = params["w1"].shape[0]
    probs = _router_probs(x, params, E)
    choice = probs.argmax(-1)
    gate = probs.max(-1).values[:, None].to(x.dtype)      # (T, 1)
    out = torch.zeros_like(x)
    for e in range(E):
        mask = (choice == e)[:, None].to(x.dtype)
        h = _gelu(matmul_t(x, params["w1"][e]))
        out = out + mask * matmul_t(h, params["w2"][e])
    return out * gate


def expert_capacity(n_tokens, n_experts, k=1, capacity_factor=1.25):
    """Static per-expert slot count: C = ceil(k * T * cf / E), rounded up
    to a multiple of 8."""
    c = math.ceil(k * n_tokens * capacity_factor / n_experts)
    return max(8, -(-c // 8) * 8)


def moe_dispatch(x, params, *, k=1, capacity_factor=1.25, e_total=None,
                 renorm=True):
    """Route x (T, d) into capacity slots.

    Returns (x_slots (E, C, d), combine (T, E, C) f32): x_slots[e, c] is
    the c-th token accepted by expert e (zeros for empty slots); combine
    carries the gate weight of each (token, expert, slot) assignment and
    is zero for dropped (over-capacity) assignments."""
    T, d = x.shape
    E = e_total or params["w1"].shape[0]
    C = expert_capacity(T, E, k=k, capacity_factor=capacity_factor)
    topk_p, topk_e = _topk(_router_probs(x, params, E), k, renorm)

    combine = x.new_zeros((T, E, C), dtype=torch.float32)
    counts = x.new_zeros((1, E), dtype=torch.float32)
    for i in range(k):
        m = _one_hot(topk_e[:, i], E)                                # (T, E)
        # zero-based queue position of each token within its expert; the
        # earlier rounds' choices come first through `counts`
        pos = torch.cumsum(m, dim=0) - m + counts
        pos_i = (pos * m).sum(1)                                     # (T,)
        counts = counts + m.sum(0, keepdim=True)
        g = topk_p[:, i] * (pos_i < C).float()                       # (T,)
        slot = _one_hot(pos_i.long(), C)                             # (T, C)
        combine = combine + (g[:, None, None] * m[:, :, None]
                             * slot[:, None, :])
    dispatch = (combine > 0).to(x.dtype)                             # (T, E, C)
    return torch.einsum("tec,td->ecd", dispatch, x), combine


def moe_block_topk(x, params, *, k=1, capacity_factor=1.25, ep_axis=None,
                   renorm=True):
    """Capacity-dispatch tier: x (T, d) -> (T, d) through moe_dispatch,
    one matmul_t GELU FFN per expert on its C slots, and the combine."""
    _check_ep(ep_axis)
    E = params["w1"].shape[0]
    x_slots, combine = moe_dispatch(x, params, k=k,
                                    capacity_factor=capacity_factor,
                                    e_total=E, renorm=renorm)
    y_slots = torch.stack([
        matmul_t(_gelu(matmul_t(x_slots[e], params["w1"][e])),
                 params["w2"][e]) for e in range(E)])
    out = torch.einsum("tec,ecd->td", combine, y_slots.float())
    return out.to(x.dtype)


def _ragged_dot(x, w, group_sizes):
    """The plain ragged product (lax.ragged_dot): gmm_ref in x's dtype."""
    return gmm_ref(x, w, group_sizes).to(torch.promote_types(x.dtype,
                                                             w.dtype))


def moe_block_dropless(x, params, *, k=1, renorm=True, use_kernel=False):
    """Dropless (token-group) tier: x (T, d) -> (T, d), no capacity limit
    and no dropped tokens. use_kernel runs both expert products through
    grouped_matmul (#28/#29); otherwise plain ragged products."""
    T, d = x.shape
    E = params["w1"].shape[0]
    topk_p, topk_e = _topk(_router_probs(x, params, E), k, renorm)

    expert_flat = topk_e.reshape(-1)                         # (T*k,)
    gate_flat = topk_p.reshape(-1)
    order = torch.argsort(expert_flat, stable=True)
    token_of = order // k                                    # source row
    xs = x[token_of]                                         # (T*k, d)
    group_sizes = torch.bincount(expert_flat, minlength=E).to(torch.int32)

    mm = grouped_matmul if use_kernel else _ragged_dot
    h = _gelu(mm(xs, params["w1"], group_sizes))
    ys = mm(h.to(x.dtype), params["w2"], group_sizes)

    w = gate_flat[order].float()[:, None]                    # (T*k, 1)
    out = x.new_zeros((T, d), dtype=torch.float32).index_add(
        0, token_of, ys.float() * w)
    return out.to(x.dtype)


def init_shared_expert(generator, d_model, d_ff, dtype=torch.float32,
                       device="cuda"):
    """DeepSeek-style always-on shared expert: a dense FFN beside the
    routed experts, w1 (d, d_ff) and w2 (d_ff, d)."""
    return dict(w1=_randn(generator, (d_model, d_ff), device).to(dtype),
                w2=_randn(generator, (d_ff, d_model), device).to(dtype))


def shared_expert(x, sp):
    """Dense FFN applied to every token; add to the routed output."""
    return matmul_t(_gelu(matmul_t(x, sp["w1"])), sp["w2"])


def router_z_loss(x, params, e_total=None):
    """Router z-loss (ST-MoE): mean logsumexp(logits)^2."""
    E = e_total or params["w1"].shape[0]
    logits = (x @ params["router"][:, :E]).float()
    return torch.mean(torch.logsumexp(logits, dim=-1) ** 2)


def aux_load_balance_loss(x, params, ep_size=1):
    """Switch-transformer load-balance loss: E * sum_e f_e * p_e (the
    share of tokens whose top-1 is e times e's mean router
    probability)."""
    _check_ep(ep_size=ep_size)
    E = params["w1"].shape[0]
    probs = _router_probs(x, params, E)
    frac = _one_hot(probs.argmax(-1), E).mean(0)
    return E * torch.sum(frac * probs.mean(0))
