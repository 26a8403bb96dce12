"""tpukern_torch's models/moe.py against the JAX package on CPU.

Each tier on JAX's init_moe_params weights (d 64, d_ff 128, 8 experts),
converted through numpy, and 32 tokens from a numpy seed: the dense tier,
capacity dispatch at k 1 and 2 with and without drops, the dropless tier
with use_kernel both ways (the port's grouped_matmul runs its plain
versions here; JAX's its interpret-mode Pallas kernels), a router rigged
to one expert, the shared expert, the z-loss and the load-balance loss:
values, and the gradients of sum(out²) for router, w1 and w2. Each
routed test first asserts that both sides chose the same experts
(torch.topk orders ties in no fixed way, lax.top_k takes the lower
index), then compares. f32 at 2e-5 for values and 2e-4 for gradients
(tests/test_grouped_matmul.py's tolerances; sums run in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.models import moe as jmoe
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.models import moe

D, FF, E, T = 64, 128, 8, 32
F32 = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)
NAMES = ("router", "w1", "w2")


@pytest.fixture(scope="module")
def setup():
    jparams = jmoe.init_moe_params(jax.random.key(0), D, FF, E)
    x = np.random.default_rng(0).standard_normal((T, D)).astype(np.float32)
    return {k: np.asarray(v) for k, v in jparams.items()}, x


def _torch(params, x):
    p = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in
         params.items()}
    return p, torch.from_numpy(np.array(x))


def _jax(params, x):
    return {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x)


def _same_routing(params, x, k):
    """Both sides' top-k experts of every token are equal."""
    jp, jx = _jax(params, x)
    jprobs = jax.nn.softmax(jnp.dot(jx, jp["router"]), axis=-1)
    _, je = jax.lax.top_k(jprobs, k)
    p, tx = _torch(params, x)
    probs = torch.softmax(tx @ p["router"].detach(), dim=-1)
    assert torch.equal(torch.topk(probs, k).indices,
                       torch.from_numpy(np.array(je)).long())


def _check(params, x, port_fn, jax_fn, grads=True):
    """port_fn(params, x) against jax_fn: value, then the gradients of
    sum(out²) for every weight."""
    p, tx = _torch(params, x)
    out = port_fn(p, tx)
    jp, jx = _jax(params, x)
    jout = jax_fn(jp, jx)
    check_all_close(out.detach(), np.asarray(jout), name="out", **F32)
    if not grads:
        return out
    g = torch.autograd.grad((out ** 2).sum(), [p[n] for n in NAMES])
    jg = jax.grad(lambda q: jnp.sum(jax_fn(q, jx) ** 2))(jp)
    for name, gi in zip(NAMES, g):
        check_all_close(gi, np.asarray(jg[name]), name=name, **GRAD)
    return out


def test_moe_block_matches_jax(setup):
    params, x = setup
    _check(params, x, lambda p, x: moe.moe_block(x, p),
           lambda p, x: jmoe.moe_block(x, p))


@pytest.mark.parametrize("T_,E_,k,cf", [(32, 8, 1, 1.25), (64, 8, 2, 2.0),
                                        (4096, 8, 2, 2.0), (7, 3, 1, 0.25)])
def test_expert_capacity_matches_jax(T_, E_, k, cf):
    assert moe.expert_capacity(T_, E_, k, cf) == jmoe.expert_capacity(
        T_, E_, k, cf)


@pytest.mark.parametrize("k,cf", [(1, 1.0), (2, 2.0), (2, 0.5)])
def test_moe_dispatch_matches_jax(setup, k, cf):
    """The slots and the combine tensor, with drops at cf 0.5 and 1.0."""
    params, x = setup
    _same_routing(params, x, k)
    p, tx = _torch(params, x)
    slots, combine = moe.moe_dispatch(tx, p, k=k, capacity_factor=cf)
    jp, jx = _jax(params, x)
    jslots, jcombine = jmoe.moe_dispatch(jx, jp, k=k, capacity_factor=cf)
    assert slots.shape == jslots.shape and combine.shape == jcombine.shape
    check_all_close(slots.detach(), np.asarray(jslots), name="slots", **F32)
    check_all_close(combine.detach(), np.asarray(jcombine), name="combine",
                    **F32)
    assert torch.equal(combine.detach() > 0,
                       torch.from_numpy(np.asarray(jcombine) > 0))


@pytest.mark.parametrize("k,cf,n", [(1, 8.0, T), (2, 8.0, T), (1, 0.5, 128),
                                    (2, 1.0, T)])
def test_topk_matches_jax(setup, k, cf, n):
    """Capacity dispatch on n tokens: cf 8 keeps every assignment, cf 0.5
    and 1.0 drop some (the test asserts that they do; C has a floor of 8
    slots, so k = 1 drops only on more tokens)."""
    params, x = setup
    if n != T:
        x = np.random.default_rng(5).standard_normal((n, D)).astype(
            np.float32)
    _same_routing(params, x, k)
    p, tx = _torch(params, x)
    _, combine = moe.moe_dispatch(tx, p, k=k, capacity_factor=cf)
    kept = int((combine > 0).sum())
    assert kept == n * k if cf == 8.0 else kept < n * k
    _check(params, x,
           lambda p, x: moe.moe_block_topk(x, p, k=k, capacity_factor=cf),
           lambda p, x: jmoe.moe_block_topk(x, p, k=k, capacity_factor=cf))


def test_capacity_drops_tokens(setup):
    """A router rigged to expert 0: the first C tokens go through, the
    rest are dropped to zero rows, on both sides."""
    params, x = setup
    rigged = dict(params, router=np.zeros_like(params["router"]))
    rigged["router"][0, 0] = 100.0
    xx = np.abs(x) + 0.1
    out = _check(rigged, xx, lambda p, x: moe.moe_block_topk(
        x, p, k=1, capacity_factor=0.25), lambda p, x: jmoe.moe_block_topk(
            x, p, k=1, capacity_factor=0.25), grads=False)
    C = moe.expert_capacity(T, E, k=1, capacity_factor=0.25)
    norms = out.detach().norm(dim=-1)
    assert C < T and (norms[:C] > 0).all() and not norms[C:].any()


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_dropless_matches_jax(setup, k, use_kernel):
    params, x = setup
    _same_routing(params, x, k)
    _check(params, x,
           lambda p, x: moe.moe_block_dropless(x, p, k=k,
                                               use_kernel=use_kernel),
           lambda p, x: jmoe.moe_block_dropless(x, p, k=k,
                                                use_kernel=use_kernel))


@pytest.mark.parametrize("k", [1, 2])
def test_dropless_kernel_tier_equals_plain(setup, k):
    """use_kernel=True (grouped_matmul) against the plain ragged products:
    values and gradients."""
    params, x = setup
    p, tx = _torch(params, x)
    outs = [moe.moe_block_dropless(tx, p, k=k, use_kernel=u)
            for u in (True, False)]
    check_all_close(outs[0].detach(), outs[1].detach(), name="out", **F32)
    gk, gr = (torch.autograd.grad((o ** 2).sum(), [p[n] for n in NAMES])
              for o in outs)
    for name, a, b in zip(NAMES, gk, gr):
        check_all_close(a, b, name=name, **GRAD)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_dropless_skewed_router_matches_jax(setup, use_kernel):
    """Every token routed to expert 3: the dropless tier keeps all of
    them (a capacity tier would drop most)."""
    params, x = setup
    rigged = dict(params, router=np.zeros_like(params["router"]))
    rigged["router"][0, 3] = 100.0
    xx = np.abs(x) + 0.1
    out = _check(rigged, xx,
                 lambda p, x: moe.moe_block_dropless(x, p, k=1,
                                                     use_kernel=use_kernel),
                 lambda p, x: jmoe.moe_block_dropless(x, p, k=1,
                                                      use_kernel=use_kernel))
    assert (out.detach().norm(dim=-1) > 0).all()


def test_shared_expert_matches_jax(setup):
    _, x = setup
    sp = {k: np.asarray(v) for k, v in
          jmoe.init_shared_expert(jax.random.key(1), D, FF).items()}
    tsp = {k: torch.from_numpy(np.array(v)).requires_grad_()
           for k, v in sp.items()}
    out = moe.shared_expert(torch.from_numpy(x), tsp)
    jsp = {k: jnp.asarray(v) for k, v in sp.items()}
    jout = jmoe.shared_expert(jnp.asarray(x), jsp)
    assert out.shape == jout.shape
    check_all_close(out.detach(), np.asarray(jout), name="out", **F32)
    g = torch.autograd.grad((out ** 2).sum(), [tsp["w1"], tsp["w2"]])
    jg = jax.grad(lambda q: jnp.sum(jmoe.shared_expert(jnp.asarray(x), q)
                                    ** 2))(jsp)
    for name, gi in zip(("w1", "w2"), g):
        check_all_close(gi, np.asarray(jg[name]), name=name, **GRAD)


@pytest.mark.parametrize("loss", ["router_z_loss", "aux_load_balance_loss"])
def test_router_losses_match_jax(setup, loss):
    """The z-loss and the load-balance loss: value and router gradient."""
    params, x = setup
    p, tx = _torch(params, x)
    val = getattr(moe, loss)(tx, p)
    jp, jx = _jax(params, x)
    jfn = getattr(jmoe, loss)
    check_all_close(val.detach(), np.asarray(jfn(jx, jp)), name=loss, **F32)
    (g,) = torch.autograd.grad(val, [p["router"]])
    jg = jax.grad(lambda q: jfn(jx, q))(jp)
    check_all_close(g, np.asarray(jg["router"]), name="router", **GRAD)


def test_init_moe_params():
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe_params(gen, D, FF, E, dtype=torch.bfloat16,
                            device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in p.items()} == {
        "router": ((D, E), torch.bfloat16), "w1": ((E, D, FF), torch.bfloat16),
        "w2": ((E, FF, D), torch.bfloat16)}
    assert 0.015 < p["w1"].float().std() < 0.025
    sp = moe.init_shared_expert(gen, D, FF, device="cpu")
    assert sp["w1"].shape == (D, FF) and sp["w2"].shape == (FF, D)


def test_ep_axis_raises(setup):
    params, x = setup
    p, tx = _torch(params, x)
    for call in (lambda: moe.moe_block(tx, p, ep_axis="ep", ep_size=2),
                 lambda: moe.moe_block_topk(tx, p, ep_axis="ep"),
                 lambda: moe.aux_load_balance_loss(tx, p, ep_size=2)):
        with pytest.raises(NotImplementedError, match="item 13"):
            call()
