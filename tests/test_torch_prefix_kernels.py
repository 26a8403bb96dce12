"""The paged kernels' plain versions in tpukern_torch (the prefix prefill
#24 and the decode kernel #23, with window, sinks and softcap) against
the JAX package's interpret-mode kernels on the CPU: in f32 to 2e-5, and
on bf16 pools at the _TOLS bf16 tolerance, where both sides round P to
bf16 before the P V product.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.ops import paged_attention as jax_pa
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.ops import paged_attention as pa
from torch_serving_common import F32

# the masks of the serving kernels: a window shorter than the prompts,
# with and without sinks, and a softcap that bends the scores
FEATURES = {"plain": {}, "window": dict(window=7),
            "window+sinks": dict(window=7, sinks=3),
            "softcap": dict(softcap=0.5),
            "all": dict(window=9, sinks=2, softcap=0.5)}


def _paged_inputs(B, Hq, Hkv, T, D, page, pps, lengths, seed):
    rng = np.random.default_rng(seed)
    P = B * pps
    q = rng.standard_normal((B, Hq, T, D)).astype(np.float32)
    k, v = (rng.standard_normal((Hkv, P, page, D)).astype(np.float32)
            for _ in range(2))
    table = rng.permutation(P).reshape(B, pps).astype(np.int32)
    return q, k, v, np.asarray(lengths, np.int32), table


@pytest.mark.parametrize("feat", sorted(FEATURES))
@pytest.mark.parametrize("T", [1, 5, 8, 13])
@pytest.mark.parametrize("D", [32, 64])
def test_paged_prefill_matches_jax(D, T, feat):
    """B=2, Hq 4/Hkv 2, page 16 x 4 from a shuffled pool, lengths with
    partial last pages (the second a full pool)."""
    args = _paged_inputs(2, 4, 2, T, D, 16, 4, [T + 19, 64], seed=T * D)
    kw = FEATURES[feat]
    ref = jax_pa.paged_prefill_attention(*map(jnp.asarray, args),
                                         pages_per_block=2, **kw)
    out = pa.paged_prefill_attention(*map(torch.from_numpy, args), **kw)
    check_all_close(out, np.asarray(ref), name=f"T{T} D{D} {feat}", **F32)


@pytest.mark.parametrize("feat", sorted(FEATURES))
def test_paged_decode_features_match_jax(feat):
    """The decode kernel's window, sinks and softcap, against JAX's."""
    q, k, v, lengths, table = _paged_inputs(3, 4, 2, 1, 64, 16, 4,
                                            [5, 40, 64], seed=3)
    kw = FEATURES[feat]
    args = (q[:, :, 0], k, v, lengths, table)
    ref = jax_pa.paged_attention(*map(jnp.asarray, args), pages_per_block=1,
                                 **kw)
    out = pa.paged_attention(*map(torch.from_numpy, args), **kw)
    check_all_close(out, np.asarray(ref), name=feat, **F32)


def test_paged_options_raise():
    q, k, v, lengths, table = map(torch.from_numpy, _paged_inputs(
        1, 4, 2, 3, 32, 16, 2, [8], seed=0))
    for fn, qq in ((pa.paged_prefill_attention, q),
                   (pa.paged_attention, q[:, :, 0])):
        # ring pools and ALiBi are ported: JAX's asserts as ValueErrors
        for kw in (dict(ring=True), dict(ring=True, window=33),
                   dict(alibi_slopes=torch.ones(4), softcap=1.0)):
            with pytest.raises(ValueError):
                fn(qq, k, v, lengths, table, **kw)
        for kw in (dict(window=0), dict(sinks=2), dict(softcap=0.0)):
            with pytest.raises(ValueError):
                fn(qq, k, v, lengths, table, **kw)


def _bf16(*arrays):
    """numpy f32 arrays rounded to bf16: (jax arrays, torch tensors)."""
    ts = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    return [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in ts], ts


@pytest.mark.parametrize("T", [1, 5])
def test_paged_bf16_rounds_p_as_jax(T):
    """bf16 pools: the decode (#23, T = 1) and prefix (#24) plain versions
    round P to bf16 before the P V product as JAX's _decode_kernel and
    _prefix_kernel do, and agree with them at the bf16 tolerance. Lengths
    of 1, a partial page and a full pool; the scores are scaled up so
    that P spreads over several tokens and its rounding shows. Fewer
    outputs differ from JAX's than with P kept in f32 (the same inputs as
    f32 pools, output rounded to bf16)."""
    q, k, v, lengths, table = _paged_inputs(3, 4, 2, T, 64, 16, 4,
                                            [T, T + 22, 64], seed=11 + T)
    q *= 2.0
    (jq, jk, jv), (tq, tk, tv) = _bf16(q, k, v)
    idx = (jnp.asarray(lengths), jnp.asarray(table))
    tidx = (torch.from_numpy(lengths), torch.from_numpy(table))
    if T == 1:
        ref = jax_pa.paged_attention(jq[:, :, 0], jk, jv, *idx,
                                     pages_per_block=1)
        fn, tq = pa.paged_attention, tq[:, :, 0]
    else:
        ref = jax_pa.paged_prefill_attention(jq, jk, jv, *idx,
                                             pages_per_block=2)
        fn = pa.paged_prefill_attention
    out = fn(tq, tk, tv, *tidx)
    f32_p = fn(tq.float(), tk.float(), tv.float(), *tidx).to(torch.bfloat16)
    ref = torch.from_numpy(np.asarray(ref, np.float32))
    assert out.dtype == torch.bfloat16
    check_all_close(out.float(), ref, dtype=torch.bfloat16, name=f"bf16 T{T}")
    assert ((out.float() != ref).sum()
            < (f32_p.float() != ref).sum()), f"bf16 T{T}"
