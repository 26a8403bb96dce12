"""The fused bf16 flash-attention backward's order of work, on CPU: the
plain walk `flash_attention_bwd_bf16_ref` (tpukern_torch/ops/
attention_bwd.py) that the bf16 wgmma kernel of
csrc/flash_attention_bwd_bf16.cu computes, against the JAX package's
fused backward in bf16 and against the plain `flash_attention_bwd_ref`.

The walk takes each tile of 64 keys of a KV head through the query heads
of its GQA group and their tiles of 64 rows from the causal frontier on:
S and dP from the bf16 values in f32, P rounded to bf16 for dV += P^T dO,
dS rounded to bf16 for dK += dS^T Q and dQ += dS K (as JAX's
`_bwd_fused_kernel` rounds them); dK and dV summed over the group in the
walk. JAX's `flash_attention_bwd` takes one KV head a query head, so its
side gets K and V repeated over each group and its dK and dV summed back
(as JAX's own trainable does, attention.py:1001-1047). Inputs come from
a numpy seed, rounded to bf16 on both sides; the JAX side runs its Pallas
kernels in interpret mode (conftest forces the CPU platform). Tolerance:
the _TOLS bf16 row (both round P, dS and the outputs to bf16; the sums
run in other orders).
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

# (S, D, GQA group): every length, head dim and group of the tier's
# cases, each length off the 64-key and 64-row tiles
CASES = [(77, 32, 1), (200, 64, 2), (300, 128, 4)]


def _case(seed, group, S, D, causal, Hkv=2):
    """q, k, v, do in bf16 (torch) and JAX's o, lse (its bf16 forward on
    K, V repeated) and JAX's bf16 dq, dk, dv with dk, dv summed over each
    group in f32."""
    rng = np.random.default_rng(seed)
    Hq = Hkv * group
    q, do = (torch.from_numpy(rng.standard_normal((1, Hq, S, D))
                              .astype(np.float32)).bfloat16()
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, Hkv, S, D))
                             .astype(np.float32)).bfloat16()
            for _ in range(2))

    def jx(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    kr, vr = (jx(t.repeat_interleave(group, dim=1)) for t in (k, v))
    jo, jlse = jax_flash_attention(jx(q), kr, vr, causal=causal,
                                   return_stats=True)
    jdq, jdk, jdv = (np.asarray(t, np.float32) for t in
                     jax_flash_attention_bwd(jx(q), kr, vr, jo, jlse, jx(do),
                                             causal=causal))
    o = torch.from_numpy(np.asarray(jo, np.float32)).bfloat16()
    lse = torch.from_numpy(np.array(jlse, np.float32))
    fold = (1, Hkv, group, S, D)
    return ((q, k, v, o, lse, do),
            (jdq, jdk.reshape(fold).sum(2), jdv.reshape(fold).sum(2)))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,D,group", CASES)
def test_bf16_bwd_walk_matches_jax(S, D, group, causal):
    """dq, dk, dv of the walk on 2 KV heads against JAX's bf16 fused
    backward and flash_attention_bwd_ref, in bf16."""
    args, jax_grads = _case(S + D + group + causal, group, S, D, causal)
    out = attention_bwd.flash_attention_bwd_bf16_ref(*args, causal=causal)
    ref = attention_bwd.flash_attention_bwd_ref(*args, causal=causal)
    for name, a, j, r in zip(("dq", "dk", "dv"), out, jax_grads, ref):
        assert a.dtype == torch.bfloat16 and a.shape == r.shape
        check_all_close(a.float(), j, dtype=torch.bfloat16,
                        name=f"{name} vs jax")
        check_all_close(a.float(), r.float(), dtype=torch.bfloat16,
                        name=f"{name} vs ref")


def test_bf16_walk_rounds_p_and_ds():
    """The walk rounds P and dS to bf16 before their products, as JAX's
    kernel does: nearer JAX's dv and dk than the f32 recompute of
    flash_attention_bwd_ref (which keeps P and dS in f32)."""
    args, (jdq, jdk, jdv) = _case(5, 2, 200, 64, True)
    out = attention_bwd.flash_attention_bwd_bf16_ref(*args, causal=True)
    ref = attention_bwd.flash_attention_bwd_ref(*args, causal=True)
    for i, j in ((1, jdk), (2, jdv)):
        walk = np.abs(out[i].float().numpy() - j).mean()
        plain = np.abs(ref[i].float().numpy() - j).mean()
        assert walk < plain, (i, walk, plain)
