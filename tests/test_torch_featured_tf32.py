"""The featured two-kernel backward's f32 order of work and its GQA, on
CPU: the plain walks `flash_attention_dq_tf32_ref` (#9) and
`flash_attention_dkv_tf32_ref` (#10), the orders of work of
csrc/flash_attention_featured_tf32.cu's two kernels, and the GQA plain
versions `flash_attention_dq_ref` and
`flash_attention_dkv_ref`, against the JAX package's two-kernel backward
(`flash_attention_bwd(..., fused=False)`).

#9 takes each tile of 64 query rows of a query head through the tiles of
32 keys of its KV head that meet the band; #10 each tile of 32 keys of a
KV head through the query heads of its group and their tiles of 64 rows
in the band; both with every product split-TF32 in fresh f32 sums each 32
values of its contraction (S and dP each 8 values of D below D 128). JAX's backward takes one KV head a query head,
so its side gets K and V repeated over each group and its dK and dV summed
back. Inputs come from a numpy seed; the JAX side runs its Pallas kernels
in interpret mode (conftest forces the CPU platform) with 64-row blocks.
Tolerance 2e-5: both sides in f32, the split products within 1.25 2^-20 of
each product, sums in another order.
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
# name -> the masks, as tests/test_torch_featured_attention.py's FEATURES
# (sinks are forward-only): a window whose band straddles the tiles, a
# softcap that bends the scores, segments with a query-only padding id
FEATURES = {
    "window": dict(window=50),
    "softcap": dict(softcap=3.0),
    "segments": dict(segments=True),
    "window+softcap+segments": dict(window=50, softcap=3.0, segments=True),
    "none": dict(),
}
# (S, D) by GQA group: lengths off the 32-key and 64-row tiles
SHAPES = {1: (200, 32), 2: (150, 64), 4: (77, 128)}


def _segments(B, n):
    """(q_seg, kv_seg) numpy int32 (B, n): packed sequences of 40%, 40%
    and 20% of n, the last one a query-only padding id."""
    a = 2 * n // 5
    q_seg = np.repeat(np.array([0, 1, 2], np.int32), [a, a, n - 2 * a])
    kv_seg = np.where(q_seg == 2, 3, q_seg).astype(np.int32)
    return np.tile(q_seg, (B, 1)), np.tile(kv_seg, (B, 1))


def _case(name, group, seed, B=1, Hkv=2):
    """The port's arguments (q, k, v, do, lse, di) as torch tensors and
    kwargs, and JAX's (dq, dk, dv) with dk, dv summed over each group."""
    S, D = SHAPES[group]
    rng = np.random.default_rng(seed)
    Hq = Hkv * group
    q, do = (rng.standard_normal((B, Hq, S, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
            for _ in range(2))
    feat = dict(FEATURES[name])
    jkw, tkw = dict(feat), dict(feat)
    if feat.get("segments"):
        del jkw["segments"], tkw["segments"]
        q_seg, kv_seg = _segments(B, S)
        jkw["segment_ids"] = (jnp.asarray(q_seg), jnp.asarray(kv_seg))
        tkw["segment_ids"] = (torch.from_numpy(q_seg),
                              torch.from_numpy(kv_seg))
    kr, vr = (np.repeat(t, group, axis=1) for t in (k, v))
    jo, jlse = jax_flash_attention(*map(jnp.asarray, (q, kr, vr)),
                                   causal=True, return_stats=True, **jkw)
    o, lse = np.array(jo), np.array(jlse)
    jdq, jdk, jdv = (np.asarray(t) for t in jax_flash_attention_bwd(
        *map(jnp.asarray, (q, kr, vr, o, lse, do)), causal=True,
        fused=False, block_q=64, block_k=64, **jkw))
    fold = (B, Hkv, group, S, D)
    di = (o * do).sum(-1)
    args = tuple(map(torch.from_numpy, (q, k, v, do, lse, di)))
    return (args, tkw,
            (jdq, jdk.reshape(fold).sum(2), jdv.reshape(fold).sum(2)))


@pytest.mark.parametrize("group", sorted(SHAPES))
@pytest.mark.parametrize("name", sorted(FEATURES))
def test_f32_walks_match_jax(name, group):
    """dq of #9's walk and dk, dv of #10's at each feature set, GQA groups
    1, 2 and 4 on 2 KV heads, D 32/64/128, lengths off the tiles, against
    JAX's two-kernel backward and against the GQA plain versions."""
    args, kw, jax_grads = _case(name, group, 7 * group + len(name))
    out = (attention_bwd.flash_attention_dq_tf32_ref(*args, causal=True,
                                                     **kw),
           *attention_bwd.flash_attention_dkv_tf32_ref(*args, causal=True,
                                                       **kw))
    ref = (attention_bwd.flash_attention_dq_ref(*args, causal=True, **kw),
           *attention_bwd.flash_attention_dkv_ref(*args, causal=True, **kw))
    for grad, a, j, r in zip(("dq", "dk", "dv"), out, jax_grads, ref):
        assert a.dtype == torch.float32 and a.shape == r.shape
        assert torch.isfinite(a).all()
        check_all_close(a, j, name=f"{name} {grad} walk vs jax", **F32)
        check_all_close(a, r, name=f"{name} {grad} walk vs ref", **F32)


@pytest.mark.parametrize("group", [2, 4])
@pytest.mark.parametrize("name", ["window+softcap+segments", "none"])
def test_gqa_plain_versions_match_jax(name, group):
    """flash_attention_dq and flash_attention_dkv on the KV heads as they
    are (the plain versions on CPU; dK and dV at Hkv heads) and
    flash_attention_bwd(fused=False), against JAX's on K and V repeated."""
    args, kw, jax_grads = _case(name, group, 3 + group, B=2)
    dq = attention_bwd.flash_attention_dq(*args, causal=True, **kw)
    dk, dv = attention_bwd.flash_attention_dkv(*args, causal=True, **kw)
    assert dk.shape == dv.shape == args[1].shape
    for grad, a, j in zip(("dq", "dk", "dv"), (dq, dk, dv), jax_grads):
        check_all_close(a, j, name=f"{name} {grad}", **F32)


def test_padding_rows_have_zero_gradients():
    """With segments, the queries of the padding id see no key: #9's walk
    gives them dq 0, and their dO reaches no dk or dv."""
    args, kw, _ = _case("segments", 2, 11)
    q_seg = kw["segment_ids"][0][0]
    dq = attention_bwd.flash_attention_dq_tf32_ref(*args, causal=True, **kw)
    assert not dq[..., q_seg == 2, :].any()
    do = args[3].clone()
    do[..., q_seg == 2, :] = 1e3
    moved = attention_bwd.flash_attention_dkv_tf32_ref(
        *args[:3], do, *args[4:], causal=True, **kw)
    for a, b in zip(moved, attention_bwd.flash_attention_dkv_tf32_ref(
            *args, causal=True, **kw)):
        assert torch.equal(a, b)
