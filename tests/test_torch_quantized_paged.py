"""The quantized paged kernels' plain versions in tpukern_torch
(paged_prefill_quantized_ref for #24, paged_attention_quantized_ref for
#23) against the JAX package's paged_prefill_attention_quantized and
paged_attention_quantized in interpret mode on the CPU.

The same numpy-seeded q and pools go to both sides, quantized by the port
(quantize_pages); the JAX copy is zero-padded to 128 columns, as JAX's
pools are (zero columns change neither absmax nor a dot). q in f32 is
held to 1e-5, q in bf16 to the _TOLS bf16 row (both sides round
p * v_scale to bf16 before the P V product, against running maxima
that differ). pv_int8 quantizes p per block of page * pages_per_block
tokens, so it runs at two pages_per_block. Shapes are tiny: these JAX
kernels are slow in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.ops import paged_attention as jax_pa
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.ops import paged_attention as pa

B, HQ, HKV, D, PAGE, PPS = 2, 4, 2, 32, 16, 4
JAX_DTYPES = {torch.int8: jnp.int8, torch.float8_e4m3fn: jnp.float8_e4m3fn}
# (pool dtype, q_int8, pv_int8, pages_per_block)
TIERS = {"int8": ("int8", False, False, 2),
         "int8 q_int8": ("int8", True, False, 2),
         "int8 pv_int8 ppb1": ("int8", False, True, 1),
         "int8 pv_int8 ppb2": ("int8", False, True, 2),
         "int8 q_int8 pv_int8 ppb1": ("int8", True, True, 1),
         "fp8": ("fp8", False, False, 2)}
QDTYPES = {"f32": (torch.float32, jnp.float32, dict(rtol=1e-5, atol=1e-5)),
           "bf16": (torch.bfloat16, jnp.bfloat16, {})}


def _inputs(T, seed, lengths):
    rng = np.random.default_rng(seed)
    P = B * PPS
    q = rng.standard_normal((B, HQ, T, D)).astype(np.float32)
    k, v = (rng.standard_normal((HKV, P, PAGE, D)).astype(np.float32)
            for _ in range(2))
    table = rng.permutation(P).reshape(B, PPS).astype(np.int32)
    return q, k, v, np.asarray(lengths, np.int32), table


def _pools(k, v, dtype):
    """The port's quantized pools and scales, and JAX's padded copies."""
    kq, ks = pa.quantize_pages(torch.from_numpy(k), dtype)
    vq, vs = pa.quantize_pages(torch.from_numpy(v), dtype)

    def jax_pool(x):
        arr = jnp.asarray(x.float().numpy())
        arr = jnp.pad(arr, ((0, 0), (0, 0), (0, 0), (0, 128 - D)))
        return arr.astype(JAX_DTYPES[x.dtype])

    port = (kq, ks, vq, vs)
    jax = (jax_pool(kq), jnp.asarray(ks.numpy()), jax_pool(vq),
           jnp.asarray(vs.numpy()))
    return port, jax


def _run(T, tier, qdt, seed, lengths, decode=False, **feat):
    dtype, q_int8, pv_int8, ppb = TIERS[tier]
    tdt, jdt, tol = QDTYPES[qdt]
    q, k, v, lengths, table = _inputs(T, seed, lengths)
    port, jax = _pools(k, v, dtype)
    qt = torch.from_numpy(q).to(tdt)
    jq = jnp.asarray(qt.float().numpy()).astype(jdt)
    if decode:
        qt, jq = qt[:, :, 0], jq[:, :, 0]
    kw = dict(pages_per_block=ppb, q_int8=q_int8, pv_int8=pv_int8, **feat)
    jfn = (jax_pa.paged_attention_quantized if decode
           else jax_pa.paged_prefill_attention_quantized)
    fn = (pa.paged_attention_quantized if decode
          else pa.paged_prefill_attention_quantized)
    ref = jfn(jq, *jax, jnp.asarray(lengths), jnp.asarray(table), **kw)
    out = fn(qt, *port, torch.from_numpy(lengths), torch.from_numpy(table),
             **kw)
    assert out.dtype == tdt and out.shape == qt.shape
    check_all_close(out.float(), np.asarray(ref, np.float32), dtype=tdt,
                    name=f"{tier} {qdt} T{T}", **tol)
    return out


@pytest.mark.parametrize("qdt", sorted(QDTYPES))
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_quantized_prefix_matches_jax(tier, qdt):
    """#24's function: T=5 new tokens, lengths with a partial last page
    and a full pool."""
    _run(5, tier, qdt, seed=len(tier), lengths=[24, 64])


@pytest.mark.parametrize("qdt", sorted(QDTYPES))
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_quantized_decode_matches_jax(tier, qdt):
    """#23's function: one token per sequence."""
    _run(1, tier, qdt, seed=3 + len(tier), lengths=[37, 64], decode=True)


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("tier", ["int8 q_int8 pv_int8 ppb1", "fp8"])
def test_quantized_window_softcap_matches_jax(tier, decode):
    """The window, sinks and softcap on the quantized tier."""
    _run(1 if decode else 5, tier, "f32", seed=11, lengths=[40, 60],
         decode=decode, window=9, sinks=2, softcap=0.5)


def test_pv_int8_depends_on_the_block():
    """pv_int8 quantizes p per block of page * pages_per_block tokens: the
    two partitions give different outputs (each equal to JAX's above)."""
    a = _run(5, "int8 pv_int8 ppb1", "f32", seed=5, lengths=[24, 64])
    b = _run(5, "int8 pv_int8 ppb2", "f32", seed=5, lengths=[24, 64])
    assert (a - b).abs().max() > 1e-6


def test_quantized_options_raise():
    q, k, v, lengths, table = _inputs(1, 0, [5, 9])
    (kq, ks, vq, vs), _ = _pools(k, v, "fp8")
    args = (torch.from_numpy(q[:, :, 0]), kq, ks, vq, vs,
            torch.from_numpy(lengths), torch.from_numpy(table))
    for kw in (dict(q_int8=True), dict(pv_int8=True),
               dict(pages_per_block=3)):
        with pytest.raises(ValueError):
            pa.paged_attention_quantized(*args, **kw)
    # ring pools and ALiBi are ported: JAX's asserts as ValueErrors
    for kw in (dict(ring=True), dict(ring=True, window=PAGE * PPS + 1),
               dict(alibi_slopes=torch.ones(HQ), softcap=1.0)):
        with pytest.raises(ValueError):
            pa.paged_attention_quantized(*args, **kw)
