"""The training slice's ops of tpukern_torch against the JAX package on CPU.

Inputs come from a numpy seed and go through both sides. The JAX side runs
its Pallas kernels in interpret mode (conftest forces the CPU platform);
the port side takes the plain PyTorch versions, as its wrappers do for CPU
tensors, inside the same autograd Functions that launch the kernels on a
card. Tolerance: f32 2e-5, as in tests/test_torch_ops.py (both sides
compute in f32; sums are taken in another order).
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
from tpukern.ops.matmul import matmul as jax_matmul
from tpukern.ops.rope import rope_batched as jax_rope_batched
from tpukern.ops.trainable import matmul_t as jax_matmul_t
from tpukern.ops.trainable import rms_norm_t as jax_rms_norm_t
from tpukern.ops.trainable import rope_t as jax_rope_t
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.ops import attention, attention_bwd, matmul, rope
from tpukern_torch.ops.trainable import (flash_attention_trainable,
                                         matmul_t, rms_norm_t, rope_t)

F32 = dict(rtol=2e-5, atol=2e-5)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _torch_grads(fn, inputs, cot):
    """Grads of sum(fn(*inputs) * cot) w.r.t. the inputs (numpy arrays)."""
    ts = [torch.from_numpy(x).requires_grad_() for x in inputs]
    out = fn(*ts)
    return out, torch.autograd.grad(out, ts, torch.from_numpy(cot))


def _jax_grads(fn, inputs, cot):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, inputs))
    return out, vjp(jnp.asarray(cot))


def _close_all(ts, js, name):
    for i, (t, j) in enumerate(zip(ts, js)):
        check_all_close(t, np.asarray(j), name=f"{name}[{i}]", **F32)


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("M,N,K", [(77, 130, 45), (40, 96, 600)])
def test_matmul_matches_jax(M, N, K, trans_b):
    """acc_in_out (the training mode) with M, N, K off every tile, and
    K past JAX's 512 block so its masked K tail runs."""
    rng = np.random.default_rng(M + N + K)
    a = _randn(rng, M, K) / np.float32(np.sqrt(K))  # outputs of unit scale
    b = _randn(rng, N, K) if trans_b else _randn(rng, K, N)
    out = matmul.matmul(torch.from_numpy(a), torch.from_numpy(b),
                        trans_b=trans_b, acc_in_out=True)
    ref = jax_matmul(jnp.asarray(a), jnp.asarray(b), trans_b=trans_b,
                     acc_in_out=True)
    assert out.dtype == torch.float32 and out.shape == (M, N)
    check_all_close(out, np.asarray(ref), name="matmul", **F32)


@pytest.mark.parametrize("kw,want", [(dict(), torch.bfloat16),
                                     (dict(acc_in_out=True), torch.float32),
                                     (dict(acc_in_out=True,
                                           out_dtype=torch.bfloat16),
                                      torch.bfloat16)])
def test_matmul_out_dtypes(kw, want):
    """The output dtype of the three epilogues for bf16 inputs, as JAX's
    (matmul.py:76-79); values at the bf16 row of _TOLS."""
    rng = np.random.default_rng(3)
    a, b = _randn(rng, 24, 40), _randn(rng, 40, 16)
    out = matmul.matmul(torch.from_numpy(a).bfloat16(),
                        torch.from_numpy(b).bfloat16(), **kw)
    jkw = dict(kw)
    if "out_dtype" in jkw:
        jkw["out_dtype"] = jnp.bfloat16
    ref = jax_matmul(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
                     **jkw)
    assert out.dtype == want
    assert str(ref.dtype) == str(want).removeprefix("torch.")
    check_all_close(out.float(), np.asarray(ref.astype(jnp.float32)),
                    dtype=want, name="matmul bf16")


def test_matmul_t_grads_match_jax():
    rng = np.random.default_rng(7)
    a, b, cot = _randn(rng, 33, 70), _randn(rng, 70, 50), _randn(rng, 33, 50)
    out, grads = _torch_grads(matmul_t, (a, b), cot)
    jout, jgrads = _jax_grads(jax_matmul_t, (a, b), cot)
    check_all_close(out.detach(), np.asarray(jout), name="matmul_t", **F32)
    _close_all(grads, jgrads, "matmul_t grads")


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("S,D", [(64, 32), (100, 128)])
def test_rope_batched_matches_jax(S, D, sign):
    rng = np.random.default_rng(S + D)
    x = _randn(rng, 3 * S, D)
    out = rope.rope_batched(torch.from_numpy(x), S, sign)
    ref = jax_rope_batched(jnp.asarray(x), S, sign=sign)
    # angle = pos * exp(...): one ulp of exp grows with pos (up to 99)
    check_all_close(out, np.asarray(ref), name="rope_batched", rtol=2e-5,
                    atol=1e-4)


def test_rope_t_grads_match_jax():
    rng = np.random.default_rng(11)
    S, D = 48, 64
    x, cot = _randn(rng, 2 * S, D), _randn(rng, 2 * S, D)
    out, grads = _torch_grads(lambda t: rope_t(t, S), (x,), cot)
    jout, jgrads = _jax_grads(lambda t: jax_rope_t(t, S), (x,), cot)
    check_all_close(out.detach(), np.asarray(jout), rtol=2e-5, atol=1e-4)
    check_all_close(grads[0], np.asarray(jgrads[0]), rtol=2e-5, atol=1e-4)


def test_rms_norm_t_grads_match_jax():
    rng = np.random.default_rng(13)
    x, cot = _randn(rng, 24, 96), _randn(rng, 24, 96)
    g = (1 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    out, grads = _torch_grads(rms_norm_t, (x, g), cot)
    jout, jgrads = _jax_grads(jax_rms_norm_t, (x, g), cot)
    check_all_close(out.detach(), np.asarray(jout), **F32)
    _close_all(grads, jgrads, "rms_norm_t grads")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,D", [(64, 64), (100, 128)])
def test_flash_attention_lse_matches_jax(S, D, causal):
    rng = np.random.default_rng(S * D)
    q = _randn(rng, 1, 4, S, D)
    k, v = _randn(rng, 1, 2, S, D), _randn(rng, 1, 2, S, D)
    o, lse = attention.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                       causal=causal, return_stats=True)
    jo, jlse = jax_flash_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=causal, return_stats=True)
    assert lse.dtype == torch.float32 and lse.shape == (1, 4, S)
    check_all_close(o, np.asarray(jo), name="o", **F32)
    check_all_close(lse, np.asarray(jlse), name="lse", **F32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,D", [(64, 64), (100, 128), (130, 64)])
def test_flash_attention_bwd_matches_jax(S, D, causal):
    """The fused backward (JAX's default at these shapes) on the same q,
    k, v, o, lse and do; S = 100 and 130 leave a tail."""
    rng = np.random.default_rng(S + D + causal)
    q, k, v, do = (_randn(rng, 2, 2, S, D) for _ in range(4))
    jo, jlse = jax_flash_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=causal, return_stats=True)
    o, lse = np.array(jo), np.array(jlse)
    out = attention_bwd.flash_attention_bwd(
        *map(torch.from_numpy, (q, k, v, o, lse, do)), causal=causal)
    ref = jax_flash_attention_bwd(*map(jnp.asarray, (q, k, v, o, lse, do)),
                                  causal=causal)
    _close_all(out, ref, f"flash_attention_bwd S{S} D{D}")


def test_flash_attention_bwd_cross_lengths_match_jax():
    """Non-causal with Sq != Skv: 100 queries over 130 keys."""
    rng = np.random.default_rng(23)
    q, do = _randn(rng, 1, 2, 100, 64), _randn(rng, 1, 2, 100, 64)
    k, v = _randn(rng, 1, 2, 130, 64), _randn(rng, 1, 2, 130, 64)
    jo, jlse = jax_flash_attention(*map(jnp.asarray, (q, k, v)),
                                   return_stats=True)
    o, lse = np.array(jo), np.array(jlse)
    out = attention_bwd.flash_attention_bwd(
        *map(torch.from_numpy, (q, k, v, o, lse, do)))
    ref = jax_flash_attention_bwd(*map(jnp.asarray, (q, k, v, o, lse, do)))
    _close_all(out, ref, "flash_attention_bwd Sq100 Skv130")


@pytest.mark.parametrize("group", [1, 2, 4])
def test_flash_attention_trainable_grads_match_jax(group):
    """dq, dk, dv through the autograd Function, GQA summed over groups."""
    rng = np.random.default_rng(17 + group)
    S, D, Hkv = 80, 64, 2
    q, cot = _randn(rng, 1, Hkv * group, S, D), _randn(rng, 1, Hkv * group,
                                                       S, D)
    k, v = _randn(rng, 1, Hkv, S, D), _randn(rng, 1, Hkv, S, D)
    out, grads = _torch_grads(
        lambda *t: flash_attention_trainable(*t, True, None), (q, k, v), cot)
    jout, jgrads = _jax_grads(
        lambda *t: jax_flash_attention_trainable(*t, True, None), (q, k, v),
        cot)
    check_all_close(out.detach(), np.asarray(jout), name="o", **F32)
    _close_all(grads, jgrads, f"flash_attention_trainable g{group}")


@pytest.mark.parametrize("feat", [{}, dict(window=30)], ids=str)
def test_flash_attention_trainable_passes_kv_heads_as_they_are(monkeypatch,
                                                               feat):
    """The trainable's backward hands flash_attention_bwd the 2 KV heads as
    they are, not repeated over the group of 4: the fused kernel walks the
    group inside (the featured path repeats them within
    flash_attention_bwd); the gradients still match JAX's."""
    from tpukern_torch.ops import trainable

    seen = []

    def spy(q, k, v, *args, **kw):
        seen.append((q.shape[1], k.shape[1], v.shape[1]))
        return attention_bwd.flash_attention_bwd(q, k, v, *args, **kw)

    monkeypatch.setattr(trainable, "flash_attention_bwd", spy)
    rng = np.random.default_rng(31)
    q, cot = _randn(rng, 1, 8, 70, 32), _randn(rng, 1, 8, 70, 32)
    k, v = _randn(rng, 1, 2, 70, 32), _randn(rng, 1, 2, 70, 32)
    _, grads = _torch_grads(
        lambda *t: flash_attention_trainable(*t, True, None, **feat),
        (q, k, v), cot)
    _, jgrads = _jax_grads(
        lambda *t: jax_flash_attention_trainable(*t, True, None, **feat),
        (q, k, v), cot)
    assert seen == [(8, 2, 2)]
    _close_all(grads, jgrads, f"trainable {feat}")


def test_flash_attention_bwd_rejects_bad_shapes():
    """KV heads that do not divide the query heads, and causal with Sq !=
    Skv, raise; a GQA group (one KV head for two query heads) is taken."""
    q = torch.zeros(1, 2, 8, 32)
    kv3 = torch.zeros(1, 3, 8, 32)
    with pytest.raises(ValueError, match="bad shapes"):
        attention_bwd.flash_attention_bwd(q, kv3, kv3, q,
                                          torch.zeros(1, 2, 8), q)
    dq, dk, dv = attention_bwd.flash_attention_bwd(
        q, q[:, :1], q[:, :1], q, torch.zeros(1, 2, 8), q)
    assert dq.shape == q.shape and dk.shape == dv.shape == (1, 1, 8, 32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attention_bwd.flash_attention_bwd(q, q[:, :, :4], q[:, :, :4], q,
                                          torch.zeros(1, 2, 8), q,
                                          causal=True)
