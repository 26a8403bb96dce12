"""The featured attention of tpukern_torch against the JAX package on CPU:
the sliding window (with sinks), the logit softcap and segment ids, in
the forward, in the two-kernel backward and through the autograd
Function.

Inputs come from a numpy seed and go through both sides in f32. The JAX
side runs its Pallas kernels in interpret mode (conftest forces the CPU
platform), with 64-row blocks where a test passes them so that several
blocks run and the out-of-band ones are skipped; the port side takes the
plain PyTorch versions, as its wrappers do for CPU tensors. Tolerance:
f32 2e-5, as in tests/test_torch_ops.py and tests/test_torch_train_ops.py
(both sides compute in f32; sums are taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.ops.attention import flash_attention as jax_flash_attention
from tpukern.ops.attention import (flash_attention_trainable as
                                   jax_flash_attention_trainable)
from tpukern.ops.attention_bwd import (flash_attention_bwd as
                                       jax_flash_attention_bwd)
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.ops import attention, attention_bwd
from tpukern_torch.ops.trainable import flash_attention_trainable

F32 = dict(rtol=2e-5, atol=2e-5)
S = 200  # not a multiple of the 64-row blocks: tails on both axes
# name -> the masks: a window whose band straddles the 64-row block
# edges, the window with sinks, a softcap that bends the scores (scaled
# scores of N(0, 1) inputs reach about 4), and segments with a padding
# segment (the last 40 queries have an id no key has)
FEATURES = {
    "window": dict(window=50),
    "window+sinks": dict(window=50, sinks=5),
    "softcap": dict(softcap=3.0),
    "segments": dict(segments=True),
    "window+softcap+segments": dict(window=50, softcap=3.0, segments=True),
}


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _segments(B, n):
    """(q_seg, kv_seg) as numpy int32 (B, n): three packed sequences of
    60, 100 and n - 160 tokens, the last one a query-only padding id."""
    q_seg = np.repeat(np.array([0, 1, 2], np.int32), [60, 100, n - 160])
    kv_seg = np.where(q_seg == 2, 3, q_seg).astype(np.int32)
    return np.tile(q_seg, (B, 1)), np.tile(kv_seg, (B, 1))


def _kwargs(feat, B, n):
    """(JAX kwargs, port kwargs, numpy q_seg or None) of a FEATURES entry."""
    kw = {k: v for k, v in feat.items() if k != "segments"}
    if not feat.get("segments"):
        return kw, dict(kw), None
    q_seg, kv_seg = _segments(B, n)
    return (dict(kw, segment_ids=(jnp.asarray(q_seg), jnp.asarray(kv_seg))),
            dict(kw, segment_ids=(torch.from_numpy(q_seg),
                                  torch.from_numpy(kv_seg))), q_seg)


@pytest.mark.parametrize("name", sorted(FEATURES))
def test_forward_matches_jax(name):
    """o on every row and lse on the rows that see a key, GQA group 2.
    A row that sees no key outputs 0 on both sides; its lse is an
    artefact of the mask value in JAX and -inf in the plain version."""
    rng = np.random.default_rng(len(name))
    q = _randn(rng, 2, 4, S, 64)
    k, v = _randn(rng, 2, 2, S, 64), _randn(rng, 2, 2, S, 64)
    jkw, tkw, q_seg = _kwargs(FEATURES[name], 2, S)
    o, lse = attention.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                       causal=True, return_stats=True, **tkw)
    jo, jlse = jax_flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                   return_stats=True, block_q=64, block_k=64,
                                   **jkw)
    check_all_close(o, np.asarray(jo), name=f"{name} o", **F32)
    seen = np.ones(S, bool) if q_seg is None else q_seg[0] != 2
    check_all_close(lse[..., seen], np.asarray(jlse)[..., seen],
                    name=f"{name} lse", **F32)
    if q_seg is not None:
        assert not o[..., ~seen, :].any()


def test_forward_segments_noncausal_cross_lengths():
    """Segments without causal, 200 queries over 230 keys."""
    rng = np.random.default_rng(5)
    q, k, v = _randn(rng, 1, 2, S, 32), _randn(rng, 1, 2, 230, 32), _randn(
        rng, 1, 2, 230, 32)
    q_seg = _segments(1, S)[0]
    kv_seg = np.concatenate([_segments(1, S)[1], np.full((1, 30), 1,
                                                         np.int32)], 1)
    out = attention.flash_attention(
        *map(torch.from_numpy, (q, k, v)),
        segment_ids=(torch.from_numpy(q_seg), torch.from_numpy(kv_seg)))
    ref = jax_flash_attention(*map(jnp.asarray, (q, k, v)), block_q=64,
                              block_k=64, segment_ids=(jnp.asarray(q_seg),
                                                       jnp.asarray(kv_seg)))
    check_all_close(out, np.asarray(ref), name="segments non-causal", **F32)


@pytest.mark.parametrize("name,D", [
    ("window", 64), ("softcap", 64), ("segments", 64),
    ("window+softcap+segments", 64), ("window+softcap+segments", 128)])
def test_bwd_matches_jax_two_kernel(name, D):
    """dq, dk, dv of the port's two-kernel backward against JAX's
    (fused=False, 64-row blocks) on the same q, k, v, o, lse and do
    (sinks are forward-only)."""
    rng = np.random.default_rng(D + len(name))
    q, k, v, do = (_randn(rng, 1, 3, S, D) for _ in range(4))
    jkw, tkw, _ = _kwargs(FEATURES[name], 1, S)
    jo, jlse = jax_flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                   return_stats=True, **jkw)
    o, lse = np.array(jo), np.array(jlse)
    out = attention_bwd.flash_attention_bwd(
        *map(torch.from_numpy, (q, k, v, o, lse, do)), causal=True, **tkw)
    ref = jax_flash_attention_bwd(*map(jnp.asarray, (q, k, v, o, lse, do)),
                                  causal=True, fused=False, block_q=64,
                                  block_k=64, **jkw)
    for grad, a, b in zip(("dq", "dk", "dv"), out, ref):
        check_all_close(a, np.asarray(b), name=f"{name} D{D} {grad}", **F32)


@pytest.mark.parametrize("D", [64, 128])
def test_bwd_two_kernel_path_equals_default(D):
    """With no feature, fused=False takes the two kernels and gives the
    default (fused) backward and JAX's default, at D 64 and 128."""
    rng = np.random.default_rng(31 + D)
    q, k, v, do = (_randn(rng, 2, 2, 130, D) for _ in range(4))
    jo, jlse = jax_flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                   return_stats=True)
    o, lse = np.array(jo), np.array(jlse)
    args = tuple(map(torch.from_numpy, (q, k, v, o, lse, do)))
    out = attention_bwd.flash_attention_bwd(*args, causal=True, fused=False)
    default = attention_bwd.flash_attention_bwd(*args, causal=True)
    ref = jax_flash_attention_bwd(*map(jnp.asarray, (q, k, v, o, lse, do)),
                                  causal=True)
    for grad, a, b, c in zip(("dq", "dk", "dv"), out, default, ref):
        check_all_close(a, b, name=f"{grad} vs default", **F32)
        check_all_close(a, np.asarray(c), name=f"{grad} vs JAX", **F32)


@pytest.mark.parametrize("name", ["window+softcap", "segments"])
def test_trainable_grads_match_jax(name):
    """dq, dk, dv through the autograd Function with GQA group 2 (dK/dV
    summed over the group) against jax.vjp of JAX's trainable."""
    rng = np.random.default_rng(41 + len(name))
    n, D, Hkv = 96, 64, 2
    q, cot = _randn(rng, 1, 2 * Hkv, n, D), _randn(rng, 1, 2 * Hkv, n, D)
    k, v = _randn(rng, 1, Hkv, n, D), _randn(rng, 1, Hkv, n, D)
    if name == "segments":
        q_seg = np.repeat(np.array([[0, 1, 2]], np.int32), [30, 50, 16], 1)
        kv_seg = np.where(q_seg == 2, 3, q_seg).astype(np.int32)
        jfeat = (None, None, (jnp.asarray(q_seg), jnp.asarray(kv_seg)))
        tfeat = (None, None, (torch.from_numpy(q_seg),
                              torch.from_numpy(kv_seg)))
    else:
        jfeat = tfeat = (24, 4.0, None)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention_trainable(*ts, True, None, *tfeat)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(cot))
    jout, vjp = jax.vjp(
        lambda *t: jax_flash_attention_trainable(*t, True, None, *jfeat),
        *map(jnp.asarray, (q, k, v)))
    check_all_close(out.detach(), np.asarray(jout), name=f"{name} o", **F32)
    for grad, a, b in zip(("dq", "dk", "dv"), grads, vjp(jnp.asarray(cot))):
        check_all_close(a, np.asarray(b), name=f"{name} {grad}", **F32)


def test_feature_asserts_raise():
    """JAX's asserts on the masks, as ValueErrors."""
    q = torch.zeros(1, 2, 8, 32)
    lse = torch.zeros(1, 2, 8)
    for kw in (dict(window=4), dict(window=0, causal=True),
               dict(sinks=2, causal=True), dict(softcap=-1.0),
               dict(softcap=30.0, alibi_slopes=torch.ones(2))):
        with pytest.raises(ValueError):
            attention.flash_attention(q, q, q, **kw)
    for kw in (dict(window=4, fused=True), dict(softcap=30.0, fused=True),
               dict(window=4, causal=False)):
        with pytest.raises(ValueError):
            attention_bwd.flash_attention_bwd(q, q, q, q, lse, q,
                                              **{"causal": True, **kw})
