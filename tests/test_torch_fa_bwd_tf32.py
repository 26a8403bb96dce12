"""The fused f32 flash-attention backward's order of work, on CPU: the plain
walk `flash_attention_bwd_tf32_ref` (tpukern_torch/ops/attention_bwd.py)
that the split-TF32 wgmma kernel of csrc/flash_attention_bwd.cu
computes, against the JAX package's fused backward and against the plain
`flash_attention_bwd_ref`.

The walk takes each tile of 32 keys of a KV head through the query heads
of its GQA group and their tiles of 64 rows from the causal frontier on:
S, dP, dQ += dS K (keys in the fragment order, `split_tf32.key_order`),
dV^T += dO^T P and dK^T += Q^T dS, every product split-TF32 in fresh f32
sums each 32 values of its contraction; dK and dV summed over the group in
the walk. JAX's `flash_attention_bwd` takes one KV head a query head, so
its side gets K and V repeated over each group and its dK and dV summed
back (as JAX's own trainable does, attention.py:1001-1047). Inputs come
from a numpy seed; the JAX side runs its Pallas kernels in interpret mode
(conftest forces the CPU platform). Tolerance 2e-5: both sides in f32,
the split products within 1.25 2^-20 of each product, sums in another
order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.ops.attention import flash_attention as jax_flash_attention
from tpukern.ops.attention_bwd import (flash_attention_bwd as
                                       jax_flash_attention_bwd)
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.ops import attention_bwd

F32 = dict(rtol=2e-5, atol=2e-5)
SHAPES = [(77, 32), (200, 64), (300, 128)]


def _case(seed, group, S, D, causal, Hkv=2):
    """Numpy q, k, v, do and JAX's o, lse (forward on K, V repeated) and
    JAX's dq, dk, dv with dk, dv summed over each group."""
    rng = np.random.default_rng(seed)
    Hq = Hkv * group
    q, do = (rng.standard_normal((1, Hq, S, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, Hkv, S, D)).astype(np.float32)
            for _ in range(2))
    kr, vr = (np.repeat(t, group, axis=1) for t in (k, v))
    jo, jlse = jax_flash_attention(*map(jnp.asarray, (q, kr, vr)),
                                   causal=causal, return_stats=True)
    o, lse = np.array(jo), np.array(jlse)
    jdq, jdk, jdv = (np.asarray(t) for t in jax_flash_attention_bwd(
        *map(jnp.asarray, (q, kr, vr, o, lse, do)), causal=causal))
    fold = (1, Hkv, group, S, D)
    return ((q, k, v, o, lse, do),
            (jdq, jdk.reshape(fold).sum(2), jdv.reshape(fold).sum(2)))


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,D", SHAPES)
def test_tf32_bwd_walk_matches_jax(S, D, causal, group):
    """dq, dk, dv of the walk on 2 KV heads, GQA groups 1, 2 and 4,
    lengths off the 32-key and 64-row tiles, against JAX's fused backward
    and flash_attention_bwd_ref."""
    args, jax_grads = _case(S * D + group + causal, group, S, D, causal)
    targs = tuple(map(torch.from_numpy, args))
    out = attention_bwd.flash_attention_bwd_tf32_ref(*targs, causal=causal)
    ref = attention_bwd.flash_attention_bwd_ref(*targs, causal=causal)
    for name, a, j, r in zip(("dq", "dk", "dv"), out, jax_grads, ref):
        assert a.dtype == torch.float32 and a.shape == r.shape
        check_all_close(a, j, name=f"{name} vs jax", **F32)
        check_all_close(a, r, name=f"{name} vs ref", **F32)


@pytest.mark.parametrize("group", [2, 4])
def test_gqa_wrapper_sums_the_group_as_jax(group):
    """flash_attention_bwd on the KV heads as they are (the plain version
    on CPU): the same dq, dk, dv as JAX's backward on K and V repeated,
    dK and dV summed over each group."""
    args, jax_grads = _case(group, group, 130, 64, True)
    out = attention_bwd.flash_attention_bwd(*map(torch.from_numpy, args),
                                            causal=True)
    assert out[1].shape == out[2].shape == (1, 2, 130, 64)
    for name, a, j in zip(("dq", "dk", "dv"), out, jax_grads):
        check_all_close(a, j, name=name, **F32)
