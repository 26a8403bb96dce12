"""tpukern_torch's ring pools and ALiBi against the JAX package's on the
CPU.

Ring pools (init_cache(ring=True)): the wrapped write slots (float and
quantized, a write longer than the ring, sinks) bit for bit; the paged
kernels' plain versions (#23, #24 and their quantized instances) on rings
wrapped more than once, with sinks and a window at its ring limit,
against JAX's interpret-mode kernels; the serving steps, generate and
both batchers over rings against JAX's (f32 logits to 2e-5, greedy
streams token for token), with an inactive slot whose dead decode writes
wrap. ALiBi on all four kernel instances against JAX's. Then the
ValueErrors where JAX asserts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.models import serving as jax_serving
from tpukern.models.batcher import ContinuousBatcher as JaxBatcher
from tpukern.models.batcher import SpeculativeBatcher as JaxSpecBatcher
from tpukern.ops import paged_attention as jax_pa
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.models import ContinuousBatcher, SpeculativeBatcher, serving
from tpukern_torch.ops import paged_attention as pa
from torch_serving_common import (CDRAFT, CFG, F32, JCFG,  # noqa: F401
                                  JDRAFT, check_cache, draft, setup, streams)

B, HQ, HKV, D, PAGE, PPS = 2, 4, 2, 32, 16, 4
S = PAGE * PPS  # 64 ring slots a sequence
JAX_QDT = {torch.int8: jnp.int8, torch.float8_e4m3fn: jnp.float8_e4m3fn}
# the kernels' ring cases: lengths that wrapped the ring twice and not at
# all, with and without sinks, windows at their ring limit
RING_CASES = {"limit": dict(window=S, lengths=[150, 9]),
              "sinks limit": dict(window=S - 4, sinks=4, lengths=[150, 70]),
              "sinks narrow": dict(window=20, sinks=3, lengths=[131, 66])}
SLOPES = 2.0 ** (-np.arange(1, HQ + 1, dtype=np.float32))


def _inputs(T, lengths, seed):
    rng = np.random.default_rng(seed)
    P = B * PPS
    q = rng.standard_normal((B, HQ, T, D)).astype(np.float32)
    k, v = (rng.standard_normal((HKV, P, PAGE, D)).astype(np.float32)
            for _ in range(2))
    table = rng.permutation(P).reshape(B, PPS).astype(np.int32)
    return q, k, v, np.asarray(lengths, np.int32), table


def _feat(case, T):
    """The case's kernel options, its window narrowed by T - 1 so that
    window + T - 1 stays at the ring's limit."""
    kw = dict(RING_CASES[case])
    kw.pop("lengths")
    kw["window"] -= T - 1
    return kw


def _float_run(T, dt, lengths, seed, **kw):
    """#24 (or #23 at T = 0: one token, the decode kernel) on both sides."""
    decode = T == 0
    q, k, v, lengths, table = _inputs(max(T, 1), lengths, seed)
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    ts = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    js = [jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dt == "bf16" else jnp.float32) for t in ts]
    if decode:
        ts[0], js[0] = ts[0][:, :, 0], js[0][:, :, 0]
    jfn = jax_pa.paged_attention if decode else jax_pa.paged_prefill_attention
    fn = pa.paged_attention if decode else pa.paged_prefill_attention
    jkw = dict(kw)
    if "alibi_slopes" in kw:
        jkw["alibi_slopes"] = jnp.asarray(kw["alibi_slopes"].numpy())
    ref = jfn(*js, jnp.asarray(lengths), jnp.asarray(table),
              pages_per_block=2, **jkw)
    out = fn(*ts, torch.from_numpy(lengths), torch.from_numpy(table), **kw)
    check_all_close(out.float(), np.asarray(ref, np.float32), dtype=tdt,
                    name=f"T{T} {dt} {kw}", **(F32 if dt == "f32" else {}))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(RING_CASES))
@pytest.mark.parametrize("T", [0, 5])
def test_ring_kernels_match_jax(T, case, dt):
    """paged_attention (T = 0) and paged_prefill_attention (T = 5) on
    rings wrapped twice (150 tokens on 64 slots) and once."""
    _float_run(T, dt, RING_CASES[case]["lengths"], seed=T + len(case),
               ring=True, **_feat(case, max(T, 1)))


def _quant_run(T, dtype, lengths, seed, **kw):
    decode = T == 0
    q, k, v, lengths, table = _inputs(max(T, 1), lengths, seed)
    kq, ks = pa.quantize_pages(torch.from_numpy(k), dtype)
    vq, vs = pa.quantize_pages(torch.from_numpy(v), dtype)

    def jax_pool(x):  # JAX's pools carry D padded to 128 lanes
        arr = jnp.pad(jnp.asarray(x.float().numpy()),
                      ((0, 0), (0, 0), (0, 0), (0, 128 - D)))
        return arr.astype(JAX_QDT[x.dtype])

    int8 = dtype == "int8"
    opts = dict(pages_per_block=1, q_int8=int8, pv_int8=int8, **kw)
    jopts = dict(opts)
    if "alibi_slopes" in kw:
        jopts["alibi_slopes"] = jnp.asarray(kw["alibi_slopes"].numpy())
    tq, jq = torch.from_numpy(q), jnp.asarray(q)
    if decode:
        tq, jq = tq[:, :, 0], jq[:, :, 0]
    jfn = (jax_pa.paged_attention_quantized if decode
           else jax_pa.paged_prefill_attention_quantized)
    fn = (pa.paged_attention_quantized if decode
          else pa.paged_prefill_attention_quantized)
    ref = jfn(jq, jax_pool(kq), jnp.asarray(ks.numpy()), jax_pool(vq),
              jnp.asarray(vs.numpy()), jnp.asarray(lengths),
              jnp.asarray(table), **jopts)
    out = fn(tq, kq, ks, vq, vs, torch.from_numpy(lengths),
             torch.from_numpy(table), **opts)
    check_all_close(out, np.asarray(ref), name=f"T{T} {dtype} {kw}",
                    rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("case", sorted(RING_CASES))
@pytest.mark.parametrize("T", [0, 5])
def test_quantized_ring_kernels_match_jax(T, case, dtype):
    """The quantized instances on wrapped rings: int8 with q_int8 and
    pv_int8 (one page a block), and fp8."""
    _quant_run(T, dtype, RING_CASES[case]["lengths"], seed=7 + T + len(case),
               ring=True, **_feat(case, max(T, 1)))


@pytest.mark.parametrize("feat", ["alibi", "alibi+window+ring"])
@pytest.mark.parametrize("T", [0, 5])
def test_alibi_matches_jax(T, feat):
    """ALiBi on #23, #24 and their quantized instances (int8 and fp8),
    alone on a flat pool and with a window on a wrapped ring."""
    slopes = torch.from_numpy(SLOPES)
    if feat == "alibi":
        kw, lengths = dict(alibi_slopes=slopes), [40, 64]
    else:
        kw = dict(alibi_slopes=slopes, window=S - max(T, 1) + 1, ring=True)
        lengths = [150, 70]
    _float_run(T, "f32", lengths, seed=21 + T, **kw)
    for dtype in ("int8", "fp8"):
        _quant_run(T, dtype, lengths, seed=23 + T, **kw)


@pytest.mark.parametrize("sinks", [0, 3])
@pytest.mark.parametrize("T,start", [(1, [70, 5]), (7, [60, 0]),
                                     (40, [2, 100])])
def test_ring_writes_match_jax(T, start, sinks):
    """The wrapped write slots of _slots: a decode token past the ring, a
    write that wraps mid-way and one longer than the ring's R = 32 -
    sinks slots (the newest token of each slot wins, as in JAX's token by
    token writes); float pools and the int8 and fp8 quantized writes."""
    rng = np.random.default_rng(T + sinks)
    page, pps, L, Hkv, d = 8, 4, 2, 2, 8
    table = np.array([[3, 0, 6, 5], [1, 2, 7, 4]], np.int32)
    start = np.asarray(start, np.int32)
    new = rng.standard_normal((2, Hkv, T, d)).astype(np.float32)
    pages = np.zeros((L, Hkv, 8, page, d), np.float32)
    ref = jax_serving._write_tokens(jnp.asarray(pages), 1, jnp.asarray(new),
                                    jnp.asarray(table), jnp.asarray(start),
                                    ring=True, sinks=sinks)
    out = torch.from_numpy(pages.copy())
    serving._write_tokens(out, 1, torch.from_numpy(new),
                          torch.from_numpy(table), torch.from_numpy(start),
                          ring=True, sinks=sinks)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    slots = serving._slots(torch.from_numpy(table), torch.from_numpy(start),
                           T, page, ring=True, sinks=sinks)
    for tdt in JAX_QDT:
        qp = torch.zeros(L, Hkv, 8, page, d, dtype=tdt)
        qs = torch.zeros(L, Hkv, 8, page)
        serving._write_tokens_quantized(qp, qs, 0, torch.from_numpy(new),
                                        slots)
        jp, js = jax_serving._write_tokens_quantized(
            jnp.zeros((L, Hkv, 8, page, d), JAX_QDT[tdt]),
            jnp.zeros((L, Hkv, 8, page)), 0, jnp.asarray(new),
            jnp.asarray(table), jnp.asarray(start), ring=True, sinks=sinks)
        np.testing.assert_array_equal(qp.view(torch.uint8).numpy(),
                                      np.asarray(jp).view(np.uint8))
        np.testing.assert_array_equal(qs.numpy(), np.asarray(js))


# ----------------------------------------------------------------- serving

RING_SERVE = {"window": dict(window=32), "window+sinks": dict(window=24,
                                                              sinks=4)}


def _ring_caches(cfg, jcfg, dtype="f32"):
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "int8": (torch.int8, jnp.int8)}[dtype]
    jcache = jax_serving.init_cache(jcfg, 2, 3, 16, dtype=jdt, ring=True)
    cache = serving.init_cache(cfg, 2, 3, 16, dtype=tdt, device="cpu",
                               ring=True)
    assert cache.ring and cache.ring_tokens == jcache.ring_tokens == 48
    return jcache, cache


@pytest.mark.parametrize("feat", sorted(RING_SERVE))
def test_ring_steps_match_jax(setup, feat):
    """prefill of 40 tokens into 48-slot rings, 14 decode steps (both
    slots wrap), then 4 steps with slot 1 inactive (its dead writes land
    on the slot of position length - R, outside the window), 2 with both
    active, and a verify_step of 4 tokens: logits, lengths and pools."""
    jparams, params, _ = setup
    cfg = dataclasses.replace(CFG, **RING_SERVE[feat])
    jcfg = dataclasses.replace(JCFG, **RING_SERVE[feat])
    jcache, cache = _ring_caches(cfg, jcfg)
    rng = np.random.default_rng(len(feat))
    prompt = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    jl, jcache = jax_serving.prefill(jparams, jcfg, jnp.asarray(prompt),
                                     jcache)
    tl, cache = serving.prefill(params, cfg, torch.from_numpy(prompt), cache)
    check_all_close(tl, np.asarray(jl), name="prefill", **F32)
    jstep = jax.jit(lambda p, t, c, a: jax_serving.decode_step(
        p, jcfg, t, c, active=a))
    for i in range(20):
        act = np.array([True, not 14 <= i < 18])
        tok = rng.integers(0, cfg.vocab, 2).astype(np.int32)
        jl, jcache = jstep(jparams, jnp.asarray(tok), jcache,
                           jnp.asarray(act))
        tl, cache = serving.decode_step(params, cfg, torch.from_numpy(tok),
                                        cache, active=torch.from_numpy(act))
        check_all_close(tl[act], np.asarray(jl)[act], name=f"decode {i}",
                        **F32)
    check_cache(cache, jcache, "decode")
    assert cache.lengths.tolist() == [60, 56]
    cont = rng.integers(0, cfg.vocab, (2, 4)).astype(np.int32)
    jl, jcache = jax_serving.verify_step(jparams, jcfg, jnp.asarray(cont),
                                         jcache)
    tl, cache = serving.verify_step(params, cfg, torch.from_numpy(cont),
                                    cache)
    check_all_close(tl, np.asarray(jl), name="verify", **F32)
    check_cache(cache, jcache, "verify")


def test_ring_prefill_longer_than_the_ring(setup):
    """A 60-token prompt into 48-slot rings with sinks: the prefill's
    writes wrap (the newest token of each slot wins), then generate's
    greedy stream from it equals JAX's."""
    jparams, params, _ = setup
    kw = dict(window=24, sinks=4)
    cfg, jcfg = (dataclasses.replace(c, **kw) for c in (CFG, JCFG))
    jcache, cache = _ring_caches(cfg, jcfg)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, (2, 60))
    prompt = prompt.astype(np.int32)
    jl, jcache = jax_serving.prefill(jparams, jcfg, jnp.asarray(prompt),
                                     jcache)
    tl, cache = serving.prefill(params, cfg, torch.from_numpy(prompt), cache)
    check_all_close(tl, np.asarray(jl), name="prefill", **F32)
    check_cache(cache, jcache, "prefill")
    ref = jax_serving.generate(jparams, jcfg, jnp.asarray(prompt), n_steps=5,
                               pages_per_seq=3, page_size=16,
                               cache_dtype=jnp.float32, ring=True)
    out = serving.generate(params, cfg, torch.from_numpy(prompt), n_steps=5,
                           pages_per_seq=3, page_size=16,
                           cache_dtype=torch.float32, ring=True)
    assert out.tolist() == np.asarray(ref).tolist()


def _ring_batcher_kw(n_new=24):
    return dict(n_slots=2, pages_per_seq=3, page_size=16,
                max_new_tokens=n_new, prompt_buckets=(48,))


def test_ring_batcher_streams_equal_jax(setup):
    """tests/test_batcher.py:378's property and JAX's streams: window 32
    over 48-slot rings, 40-token prompts + 24 new tokens wrap the ring;
    the streams equal JAX's ring batcher's and the port's on flat pools
    of 2 pages of 128."""
    jparams, params, prompts = setup
    cfg = dataclasses.replace(CFG, window=32)
    jcfg = dataclasses.replace(JCFG, window=32)
    reqs = list(enumerate(prompts))
    ref = JaxBatcher(jparams, jcfg, cache_dtype=jnp.float32, ring=True,
                     **_ring_batcher_kw()).run(reqs)
    cb = ContinuousBatcher(params, cfg, cache_dtype=torch.float32, ring=True,
                           **_ring_batcher_kw())
    assert cb.cache.ring and cb.max_len == cfg.max_seq
    out = cb.run(reqs)
    flat = ContinuousBatcher(params, cfg, cache_dtype=torch.float32,
                             n_slots=2, pages_per_seq=2, page_size=128,
                             max_new_tokens=24, prompt_buckets=(48,)).run(reqs)
    assert set(out) == {0, 1, 2} and out == streams(ref) == flat


def test_int8_ring_batcher_streams_equal_jax(setup):
    jparams, params, prompts = setup
    cfg = dataclasses.replace(CFG, window=32)
    jcfg = dataclasses.replace(JCFG, window=32)
    reqs = list(enumerate(prompts))
    ref = JaxBatcher(jparams, jcfg, cache_dtype=jnp.int8, ring=True,
                     **_ring_batcher_kw(12)).run(reqs)
    out = ContinuousBatcher(params, cfg, cache_dtype=torch.int8, ring=True,
                            **_ring_batcher_kw(12)).run(reqs)
    assert out == streams(ref)


def test_speculative_batcher_on_a_ring(setup, draft):
    """A ring target with a flat draft pool (whose writes clamp past its
    48 tokens, as JAX's): the streams equal ContinuousBatcher's on the
    ring and JAX's SpeculativeBatcher's."""
    jparams, params, prompts = setup
    jdraft, tdraft = draft
    cfg = dataclasses.replace(CFG, window=32)
    jcfg = dataclasses.replace(JCFG, window=32)
    reqs = list(enumerate(prompts))
    sb = SpeculativeBatcher(params, cfg, tdraft, CDRAFT, gamma=3,
                            cache_dtype=torch.float32, ring=True,
                            **_ring_batcher_kw(16))
    assert sb.cache.ring and not sb.dcache.ring
    out = sb.run(reqs)
    ref = JaxSpecBatcher(jparams, jcfg, jdraft, JDRAFT, gamma=3,
                         cache_dtype=jnp.float32, ring=True,
                         **_ring_batcher_kw(16)).run(reqs)
    plain = ContinuousBatcher(params, cfg, cache_dtype=torch.float32,
                              ring=True, **_ring_batcher_kw(16)).run(reqs)
    assert out == plain == streams(ref)


def test_ring_and_alibi_value_errors(setup):
    """JAX's asserts, as ValueErrors."""
    _, params, _ = setup
    wcfg = dataclasses.replace(CFG, window=32, sinks=4)
    with pytest.raises(ValueError, match="window"):
        serving.init_cache(CFG, 2, 4, 16, device="cpu", ring=True)
    with pytest.raises(ValueError, match="capacity"):
        serving.init_cache(wcfg, 2, 2, 16, device="cpu", ring=True)
    cache = serving.init_cache(wcfg, 2, 4, 16, device="cpu", ring=True)
    with pytest.raises(ValueError, match="non-ring"):
        serving.share_prefix(cache, 0, [1], 20)
    kw = dict(n_slots=2, pages_per_seq=4, page_size=16, ring=True)
    for bad in (dict(prefix_cache=True), dict(chunked_prefill=16),
                dict(prompt_buckets=(128,))):
        with pytest.raises(ValueError):
            ContinuousBatcher(params, wcfg, **kw, **bad)
    q, k, v, lengths, table = map(torch.from_numpy, _inputs(5, [9, 70], 0))
    slopes = torch.from_numpy(SLOPES)
    for fn, qq, T in ((pa.paged_prefill_attention, q, 5),
                      (pa.paged_attention, q[:, :, 0], 1)):
        for bad in (dict(ring=True),                        # no window
                    dict(ring=True, window=S - T + 2),      # past the ring
                    dict(ring=True, window=S - T - 1, sinks=3),
                    dict(alibi_slopes=slopes, softcap=0.5),
                    dict(alibi_slopes=slopes[:2])):
            with pytest.raises(ValueError):
                fn(qq, k, v, lengths, table, **bad)
        fn(qq, k, v, lengths, table, ring=True, window=S - T + 1)  # limit
