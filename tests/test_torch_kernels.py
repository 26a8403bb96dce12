"""The hand-written CUDA kernels of tpukern_torch against their plain
PyTorch versions. Every test needs an NVIDIA GPU (marker `cuda`) and
skips without one. This file imports no JAX, so it also runs on a GPU
host without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(--noconftest: tests/conftest.py imports jax). Tolerances: the _TOLS
bf16 row for bf16; 1e-4 for f32, since CUDA's exp/rsqrt and the
summation order differ from PyTorch's in the last bits.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpukern_torch.core.feature_sets import FEATURE_SETS, feature_kwargs
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.harness import ops_bench
from tpukern_torch.models import (Config, ContinuousBatcher, init_params,
                                  loss_fn, param_leaves, params_to)
from tpukern_torch.core import registry
from tpukern_torch.ops import (_ew, attention, attention_bwd, cross_entropy,
                               dot_product, embedding, gemv, histogram,
                               layernorm, matmul, nms, paged_attention,
                               reduce, rmsnorm, rope, softmax, split_tf32,
                               trainable, transpose)
from tpukern_torch.parallel import Mesh, ring_kernels

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
F32 = dict(rtol=1e-4, atol=1e-4)
WRAPPERS = {"rms_norm": rmsnorm.rms_norm, "rope_cached": rope.rope_cached,
            "flash_attention": attention.flash_attention,
            "paged_attention": paged_attention.paged_attention}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _cases(dev, dt):
    """op -> (kernel call, plain call, args) at small, ragged shapes."""
    g = torch.Generator(device=dev).manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    cos, sin = rope.make_cos_sin(256, 64, device=dev)
    pos = torch.randint(0, 256, (48,), generator=g, device=dev)
    table = torch.randperm(12, generator=g, device=dev).reshape(3, 4)
    lengths = torch.tensor([0, 17, 64], dtype=torch.int32, device=dev)
    return {
        "rms_norm": (rmsnorm.rms_norm, rmsnorm.rms_norm_ref,
                     (r(33, 200), 1 + r(200))),
        "rope_cached": (rope.rope_cached, rope.rope_cached_ref,
                        (r(48, 64), cos[pos], sin[pos])),
        "flash_attention": (
            lambda *a: attention.flash_attention(*a, causal=True),
            lambda *a: attention.attention_ref(*a, causal=True),
            (r(2, 4, 100, 64), r(2, 2, 100, 64), r(2, 2, 100, 64))),
        "paged_attention": (
            paged_attention.paged_attention,
            paged_attention.paged_attention_ref,
            (r(3, 4, 64), r(2, 12, 16, 64), r(2, 12, 16, 64), lengths,
             table.to(torch.int32))),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("op", sorted(WRAPPERS))
def test_kernel_matches_plain(cuda, op, dt):
    kernel, plain, args = _cases(cuda, DTYPES[dt])[op]
    before = WRAPPERS[op].launches
    out = kernel(*args)
    torch.cuda.synchronize()
    assert WRAPPERS[op].launches == before + 1
    check_all_close(out.float(), plain(*args).float(), dtype=DTYPES[dt],
                    name=op, **(F32 if dt == "f32" else {}))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 300])
def test_flash_attention_tails(cuda, S, D):
    """Lengths around the 64-row tile, every supported head dim, GQA 2."""
    g = torch.Generator(device=cuda).manual_seed(S * D)
    q, k, v = (torch.randn((1, h, S, D), generator=g, device=cuda)
               .to(torch.bfloat16) for h in (4, 2, 2))
    for causal in (True, False):
        check_all_close(attention.flash_attention(q, k, v, causal=causal),
                        attention.attention_ref(q, k, v, causal=causal),
                        name=f"S{S} D{D} causal={causal}")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("D,group", [(32, 8), (64, 1), (128, 2)])
def test_paged_attention_head_dims(cuda, D, group, dt):
    """Every head dim and dtype the kernel is built for, groups 1 to 8, a
    shuffled table and lengths around the 64-token tile."""
    g = torch.Generator(device=cuda).manual_seed(D + group)
    kp, vp = (torch.randn((2, 12, 32, D), generator=g, device=cuda)
              .to(DTYPES[dt]) for _ in range(2))
    q = torch.randn((4, 2 * group, D), generator=g, device=cuda).to(DTYPES[dt])
    table = torch.randperm(12, generator=g, device=cuda).reshape(4, 3)
    lengths = torch.tensor([63, 64, 65, 96], dtype=torch.int32, device=cuda)
    args = (q, kp, vp, lengths, table.to(torch.int32))
    check_all_close(paged_attention.paged_attention(*args).float(),
                    paged_attention.paged_attention_ref(*args).float(),
                    dtype=DTYPES[dt], **(F32 if dt == "f32" else {}))


@pytest.mark.cuda
def test_paged_attention_length_past_the_pool(cuda):
    """An inactive slot at the pool's end decodes with length pool + 1:
    the kernel attends the whole pool, as the masked plain version does."""
    g = torch.Generator(device=cuda).manual_seed(1)
    kp, vp = (torch.randn((2, 8, 16, 64), generator=g, device=cuda)
              for _ in range(2))
    q = torch.randn((2, 4, 64), generator=g, device=cuda)
    table = torch.arange(8, dtype=torch.int32, device=cuda).reshape(2, 4)
    lengths = torch.tensor([65, 5], dtype=torch.int32, device=cuda)
    args = (q, kp, vp, lengths, table)
    check_all_close(paged_attention.paged_attention(*args),
                    paged_attention.paged_attention_ref(*args), **F32)


@pytest.mark.cuda
def test_misaligned_input(cuda):
    """A contiguous view that starts off a 16-byte boundary is copied
    before the kernel's 16-byte loads."""
    flat = torch.randn(33 * 200 + 1, device=cuda).to(torch.bfloat16)
    x = flat[1:].view(33, 200)
    g = torch.ones(200, device=cuda, dtype=torch.bfloat16)
    check_all_close(rmsnorm.rms_norm(x, g), rmsnorm.rms_norm_ref(x, g))


@pytest.mark.cuda
def test_unsupported_shapes_raise(cuda):
    q = torch.zeros(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        attention.flash_attention(q, q, q, causal=True)
    kp = torch.zeros(2, 4, 16, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        paged_attention.paged_attention(
            q[:, :, 0], kp, kp, torch.ones(1, dtype=torch.int32, device=cuda),
            torch.zeros(1, 4, dtype=torch.int32, device=cuda))
    with pytest.raises(TypeError):
        rmsnorm.rms_norm(torch.zeros(2, 8, device=cuda, dtype=torch.float16),
                         torch.ones(8, device=cuda, dtype=torch.float16))


@pytest.mark.cuda
def test_batcher_on_kernels_equals_plain(cuda):
    """The serving path through the kernels (f32 weights and pools) gives
    the same greedy streams as the plain path on the CPU."""
    cfg = Config(vocab=128, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                 d_ff=256, max_seq=512)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (17, 40, 9)]
    kw = dict(n_slots=2, pages_per_seq=2, page_size=128, max_new_tokens=6,
              prompt_buckets=(64,), cache_dtype=torch.float32)
    ref = ContinuousBatcher(params, cfg, **kw).run(list(enumerate(prompts)))
    counts = {n: w.launches for n, w in WRAPPERS.items()}
    out = ContinuousBatcher(params_to(params, cuda), cfg, **kw).run(
        list(enumerate(prompts)))
    assert out == ref
    assert all(w.launches > counts[n] for n, w in WRAPPERS.items())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("mode", ["out", "accio", "dual"])
@pytest.mark.parametrize("M,N,K", [(77, 130, 45), (130, 257, 300),
                                   (256, 128, 64)])
def test_matmul_modes_and_tails(cuda, M, N, K, mode, trans_b, dt):
    """The three epilogues (out dtype, f32 accumulator, f32 + bf16 copy),
    NN and TN, with M, N and K on and off the tiles (bf16 128 x 256 x 64,
    f32 128 x 128 x 32)."""
    g = torch.Generator(device=cuda).manual_seed(M + N + K)
    a = torch.randn((M, K), generator=g, device=cuda).to(DTYPES[dt])
    b = torch.randn((N, K) if trans_b else (K, N), generator=g,
                    device=cuda).to(DTYPES[dt])
    kw = dict(out=dict(), accio=dict(acc_in_out=True),
              dual=dict(acc_in_out=True, out_dtype=torch.bfloat16))[mode]
    before = matmul.matmul.launches
    out = matmul.matmul(a, b, trans_b=trans_b, **kw)
    torch.cuda.synchronize()
    assert matmul.matmul.launches == before + 1
    want = {"out": DTYPES[dt], "accio": torch.float32,
            "dual": torch.bfloat16}[mode]
    assert out.dtype == want and out.shape == (M, N)
    ref = matmul.matmul_ref(a, b, trans_b=trans_b)
    check_all_close(out.float(), ref, dtype=want, name=f"matmul {mode}",
                    **(F32 if want == torch.float32 else {}))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("N,S,D", [(3, 100, 64), (2, 1024, 128)])
def test_rope_batched(cuda, N, S, D, sign, dt):
    """Angles computed in the kernel up to pos 1023 (about 1e3 rad)."""
    g = torch.Generator(device=cuda).manual_seed(S + D)
    x = torch.randn((N * S, D), generator=g, device=cuda).to(DTYPES[dt])
    before = rope.rope_batched.launches
    out = rope.rope_batched(x, S, sign)
    torch.cuda.synchronize()
    assert rope.rope_batched.launches == before + 1
    check_all_close(out.float(), rope.rope_batched_ref(x, S, sign).float(),
                    dtype=DTYPES[dt], **(F32 if dt == "f32" else {}))
    back = rope.rope_batched(out.float(), S, -sign)
    check_all_close(back, x.float(), dtype=DTYPES[dt],
                    **(F32 if dt == "f32" else {}))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,D", [(64, 64), (100, 128), (130, 32)])
def test_flash_attention_lse(cuda, S, D, causal, dt):
    """return_stats: the f32 natural-log lse of both tiers, GQA 2."""
    g = torch.Generator(device=cuda).manual_seed(S * D)
    q, k, v = (torch.randn((2, h, S, D), generator=g, device=cuda)
               .to(DTYPES[dt]) for h in (4, 2, 2))
    o, lse = attention.flash_attention(q, k, v, causal=causal,
                                       return_stats=True)
    ro, rlse = attention.attention_ref(q, k, v, causal=causal,
                                       return_stats=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, 4, S)
    check_all_close(lse, rlse, rtol=1e-4, atol=1e-4, name="lse")
    check_all_close(o.float(), ro.float(), dtype=DTYPES[dt],
                    **(F32 if dt == "f32" else {}))


def _bwd_inputs(dev, B, H, S, D, dt, causal, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((B, H, S, D), generator=g, device=dev)
                   .to(dt) for _ in range(4))
    o, lse = attention.attention_ref(q, k, v, causal=causal,
                                     return_stats=True)
    return q, k, v, o, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,D", [(64, 64), (100, 128), (130, 64),
                                 (77, 32)])
def test_flash_attention_bwd(cuda, S, D, causal, dt):
    """dq, dk, dv against the recompute-from-lse einsums, tails included
    (a missed mask shows as a wrong dK on the last tile only)."""
    args = _bwd_inputs(cuda, 2, 3, S, D, DTYPES[dt], causal, S + D)
    before = attention_bwd.flash_attention_bwd.launches
    out = attention_bwd.flash_attention_bwd(*args, causal=causal)
    torch.cuda.synchronize()
    assert attention_bwd.flash_attention_bwd.launches == before + 1
    ref = attention_bwd.flash_attention_bwd_ref(*args, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), out, ref):
        assert a.dtype == DTYPES[dt]
        check_all_close(a.float(), b.float(), dtype=DTYPES[dt], name=name,
                        **(F32 if dt == "f32" else {}))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_bwd_cross_lengths(cuda, dt):
    """Non-causal with Sq != Skv (130 queries over 77 keys and 77 over
    130): tails on both axes at once."""
    g = torch.Generator(device=cuda).manual_seed(5)
    for Sq, Skv in ((130, 77), (77, 130)):
        q, do = (torch.randn((1, 2, Sq, 64), generator=g, device=cuda)
                 .to(DTYPES[dt]) for _ in range(2))
        k, v = (torch.randn((1, 2, Skv, 64), generator=g, device=cuda)
                .to(DTYPES[dt]) for _ in range(2))
        o, lse = attention.attention_ref(q, k, v, return_stats=True)
        out = attention_bwd.flash_attention_bwd(q, k, v, o, lse, do)
        ref = attention_bwd.flash_attention_bwd_ref(q, k, v, o, lse, do)
        for name, a, b in zip(("dq", "dk", "dv"), out, ref):
            check_all_close(a.float(), b.float(), dtype=DTYPES[dt],
                            name=f"{name} Sq{Sq} Skv{Skv}",
                            **(F32 if dt == "f32" else {}))


def _gqa_inputs(dev, B, Hq, Hkv, Sq, Skv, D, dt, causal, seed, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn((B, Hq, Sq, D), generator=g, device=dev)
             .mul(scale).to(dt) for _ in range(2))
    k, v = (torch.randn((B, Hkv, Skv, D), generator=g, device=dev)
            .mul(scale).to(dt) for _ in range(2))
    o, lse = attention.attention_ref(q, k, v, causal=causal,
                                     return_stats=True)
    return q, k, v, o, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("group", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,D", [(64, 64), (100, 128), (130, 64),
                                 (77, 32)])
def test_flash_attention_bwd_gqa(cuda, S, D, causal, group, dt):
    """GQA inside the fused backward (both tiers): 2 KV heads for 2 *
    group query heads, one launch, against the plain version (K, V
    repeated, dK, dV summed over each group); the f32 tier's dk and dv (no
    atomics) bit-equal on a second call."""
    args = _gqa_inputs(cuda, 2, 2 * group, 2, S, S, D, DTYPES[dt], causal,
                       S + D + group)
    before = attention_bwd.flash_attention_bwd.launches
    out = attention_bwd.flash_attention_bwd(*args, causal=causal)
    again = attention_bwd.flash_attention_bwd(*args, causal=causal)
    torch.cuda.synchronize()
    assert attention_bwd.flash_attention_bwd.launches == before + 2
    ref = attention_bwd.flash_attention_bwd_ref(*args, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), out, ref):
        assert a.dtype == DTYPES[dt] and a.shape == b.shape
        check_all_close(a.float(), b.float(), dtype=DTYPES[dt], name=name,
                        **(F32 if dt == "f32" else {}))
    if dt == "f32":
        assert torch.equal(out[1], again[1]) and torch.equal(out[2], again[2])


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,D", [(64, 64), (100, 128), (130, 64), (77, 32),
                                 (300, 128)])
def test_flash_attention_bwd_bf16_order(cuda, S, D, causal, group):
    """The bf16 wgmma kernel against its plain order of work
    (flash_attention_bwd_bf16_ref: P and dS rounded to bf16 alike), GQA
    inside, at the bf16 tolerance; dk and dv bit-equal on a second call;
    its own launch count; no f32 copy of q, k, v or do (dk and dv come
    back in bf16 as the kernel wrote them)."""
    args = _gqa_inputs(cuda, 2, 2 * group, 2, S, S, D, torch.bfloat16,
                       causal, S + D + group)
    before = attention_bwd.flash_attention_bwd.bf16_launches
    out = attention_bwd.flash_attention_bwd(*args, causal=causal)
    again = attention_bwd.flash_attention_bwd(*args, causal=causal)
    torch.cuda.synchronize()
    assert attention_bwd.flash_attention_bwd.bf16_launches == before + 2
    ref = attention_bwd.flash_attention_bwd_bf16_ref(*args, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), out, ref):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        check_all_close(a.float(), b.float(), dtype=torch.bfloat16,
                        name=name)
    assert torch.equal(out[1], again[1]) and torch.equal(out[2], again[2])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_bwd_gqa_cross_lengths(cuda, dt):
    """Non-causal GQA 2 with Sq != Skv (130 queries over 77 keys and 77
    over 130)."""
    for Sq, Skv in ((130, 77), (77, 130)):
        args = _gqa_inputs(cuda, 1, 4, 2, Sq, Skv, 64, DTYPES[dt], False,
                           Sq)
        out = attention_bwd.flash_attention_bwd(*args)
        ref = attention_bwd.flash_attention_bwd_ref(*args)
        for name, a, b in zip(("dq", "dk", "dv"), out, ref):
            check_all_close(a.float(), b.float(), dtype=DTYPES[dt],
                            name=f"{name} Sq{Sq} Skv{Skv}",
                            **(F32 if dt == "f32" else {}))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_attention_f32_tails_are_finite(cuda, D):
    """The f32 tier's last, partial tiles (S 77: 13 of 64 query rows, 13
    of 32 keys) with scores of size 10: the rows and keys past S load as
    zeros and P, dS are selected to 0 there, so every output is finite and
    equal to the plain version's."""
    args = _gqa_inputs(cuda, 1, 4, 2, 77, 77, D, torch.float32, True, D,
                       scale=10 ** 0.5)
    o, lse = attention.flash_attention(*args[:3], causal=True,
                                       return_stats=True)
    grads = attention_bwd.flash_attention_bwd(*args, causal=True)
    refs = attention_bwd.flash_attention_bwd_ref(*args, causal=True)
    torch.cuda.synchronize()
    for t in (o, lse, *grads):
        assert torch.isfinite(t).all()
    scale = max(r.abs().max().item() for r in refs)
    for name, a, b in zip(("dq", "dk", "dv"), grads, refs):
        check_all_close(a / scale, b / scale, name=name, **F32)
    check_all_close(o, args[3], name="o", **F32)


@pytest.mark.cuda
def test_flash_attention_f32_is_deterministic(cuda):
    """The f32 forward (no atomics) gives the same bits on a second call,
    with lse and the featured masks, GQA 4."""
    q, k, v = _gqa_inputs(cuda, 1, 8, 2, 300, 300, 128, torch.float32, True,
                          7)[:3]
    for kw in ({}, dict(window=50, sinks=4, softcap=30.0)):
        a = attention.flash_attention(q, k, v, causal=True,
                                      return_stats=True, **kw)
        b = attention.flash_attention(q, k, v, causal=True,
                                      return_stats=True, **kw)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_flash_attention_f32_split_tf32_gate(cuda):
    """The accuracy gate of the f32 tiers (split-TF32) at a tail shape (B
    1, Hq 4, Hkv 2, S 300, D 128, causal): o, lse, dq, dk and dv against
    an f64 evaluation, at most SPLIT_GATE times the plain f32 version's
    error (cuBLAS, TF32 off)."""
    from tpukern_torch.harness import fa_train_times

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        g = torch.Generator(device=cuda).manual_seed(300)
        rows = fa_train_times.gate_rows(g, (1, 4, 2, 300, 128, True))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for name, err, plain in rows:
        assert err <= split_tf32.SPLIT_GATE * plain, (name, err, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [2, 4])
def test_flash_attention_trainable_gqa_on_kernels(cuda, group):
    """dq, dk, dv through flash_attention_trainable on the card (the f32
    forward and the fused backward with the group walked inside) against
    the same function on the CPU (the plain versions)."""
    args = _gqa_inputs("cpu", 1, 2 * group, 2, 150, 150, 64, torch.float32,
                       True, group)
    q, k, v, _, _, do = args
    grads = {}
    for dev in ("cpu", cuda):
        ts = [t.to(dev).requires_grad_() for t in (q, k, v)]
        o = trainable.flash_attention_trainable(*ts, True)
        grads[str(dev)] = torch.autograd.grad(o, ts, do.to(dev))
    for name, a, b in zip(("dq", "dk", "dv"), grads["cuda"], grads["cpu"]):
        check_all_close(a.cpu(), b, name=name, **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_train_loss_and_grads_on_kernels_equal_plain(cuda, dt):
    """loss_fn and every gradient through the kernels against the same
    function on the CPU, where every wrapper takes its plain version. f32
    params at the f32 tolerance. bf16 params (the GEMMs still write f32,
    and both sides round the grads to bf16): the loss to 1e-4 and each
    gradient to a relative RMS error of 1e-2, one bf16 rounding being
    2**-9 of a value."""
    cfg = Config(vocab=128, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                 d_ff=256, max_seq=64, param_dtype=DTYPES[dt])
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    tok, tgt = (torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64)))
                for _ in range(2))
    grads = {}
    for dev in ("cpu", cuda):
        p = params_to(params, dev, copy=True)
        leaves = param_leaves(p)
        for t in leaves:
            t.requires_grad_()
        loss = loss_fn(p, tok.to(dev), tgt.to(dev), cfg)
        grads[str(dev)] = [loss] + list(torch.autograd.grad(loss, leaves))
    counts = [matmul.matmul.launches, rope.rope_batched.launches,
              attention_bwd.flash_attention_bwd.launches]
    assert all(n > 0 for n in counts)
    pairs = list(zip(grads["cuda"], grads["cpu"]))
    if dt == "f32":
        for i, (a, b) in enumerate(pairs):
            check_all_close(a, b, name=f"leaf {i - 1}", **F32)
        return
    check_all_close(pairs[0][0], pairs[0][1], rtol=1e-4, atol=1e-4)
    for i, (a, b) in enumerate(pairs[1:]):
        assert a.dtype == b.dtype == torch.bfloat16
        rel = ((a.cpu().float() - b.float()).norm() / b.float().norm()).item()
        assert rel <= 1e-2, f"leaf {i}: relative RMS error {rel:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("use_exp2", [False, True])
@pytest.mark.parametrize("N,D,V", [(200, 128, 1000), (256, 64, 1024),
                                   (129, 100, 257)])
def test_cross_entropy_kernels(cuda, N, D, V, use_exp2, dt):
    """The forward (loss, lse: two launches) and the backward (dx, dW:
    three launches a vocab chunk, of bwd_vocab_chunk_f32 columns in f32,
    bwd_vocab_chunk in bf16) against the plain versions
    on the same inputs, tails in N and V, D off the 8-element vector
    width, a quarter of the targets ignored. The forward sums in f32 on
    both sides (bf16 inputs are exact in f32), so loss and lse are held
    at the f32 tolerance; dx and dW relative to their largest value,
    since the kernels and the plain GEMMs sum in different orders. With
    bf16 inputs both sides round dlog to bf16 before the products, and a
    dlog that lies near a rounding boundary may round the other way on
    one side: one bf16 step (at most 2**-7 of it) moves an output by up
    to 2**-7 of the largest, hence the bf16 tolerance there. bf16 also
    runs at a forced chunk of 96 columns (3 to 11 chunks, against
    ce_bwd_chunked_ref too), and a second call gives the same bits (no
    atomics, in either dtype). f32 also launches the split-TF32 operand
    pass on x once and on each chunk of W, in the backward and in the
    forward (one launch a chunk of bwd_vocab_chunk_f32). The forward
    writes fwd_splits' partials (bf16: one a 256-column vocab tile; f32:
    one a 128-column tile of each chunk), is held to ce_fwd_tiled_ref (its
    order) too, and repeats bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(N + D + V)
    x = torch.randn((N, D), generator=g, device=cuda).to(DTYPES[dt])
    w = (torch.randn((D, V), generator=g, device=cuda) / D ** 0.5
         ).to(DTYPES[dt])
    t = torch.randint(0, V, (N,), generator=g, device=cuda,
                      dtype=torch.int32)
    t[::4] = -1
    cot = torch.rand(N, generator=g, device=cuda)
    before = (cross_entropy.ce_fwd.launches, cross_entropy.ce_bwd.launches,
              split_tf32.split_tf32.launches)
    loss, lse = cross_entropy.ce_fwd(x, w, t, use_exp2)
    dx, dw = cross_entropy.ce_bwd(x, w, t, lse, cot, use_exp2)
    torch.cuda.synchronize()
    chunk = (cross_entropy.bwd_vocab_chunk_f32 if dt == "f32"
             else cross_entropy.bwd_vocab_chunk)(N, D, V)
    chunks = -(-V // chunk)
    # the f32 forward runs on the backward's chunks: a launch and an
    # operand pass each, one more pass on x, in each direction
    fwd = chunks if dt == "f32" else 1
    splits = 2 * (1 + chunks) if dt == "f32" else 0
    assert (cross_entropy.ce_fwd.launches, cross_entropy.ce_bwd.launches,
            split_tf32.split_tf32.launches) == (
                before[0] + fwd + 1, before[1] + 3 * chunks,
                before[2] + splits)
    rloss, rlse = cross_entropy._ce_ref(x, w, t)
    rdx, rdw = cross_entropy.ce_bwd_ref(x, w, t, rlse, cot)
    check_all_close(loss, rloss, name="loss", **F32)
    check_all_close(lse, rlse, name="lse", **F32)
    n_split, fchunk = cross_entropy.fwd_splits(N, D, V, DTYPES[dt])
    assert fchunk == (V if dt == "bf16" else chunk)
    tile = 256 if dt == "bf16" else 128
    assert n_split == sum(-(-min(fchunk, V - v0) // tile)
                          for v0 in range(0, V, fchunk))
    tloss, tlse = cross_entropy.ce_fwd_tiled_ref(
        x, w, t, tile=tile, use_exp2=use_exp2, chunk=fchunk)
    check_all_close(loss, tloss, name="loss vs tiled", **F32)
    check_all_close(lse, tlse, name="lse vs tiled", **F32)
    again = cross_entropy.ce_fwd(x, w, t, use_exp2)
    assert torch.equal(again[0], loss) and torch.equal(again[1], lse)
    tol = 1e-4 if dt == "f32" else 2e-2
    outs = [("", dx, dw, rdx, rdw)]
    c96 = cross_entropy.ce_bwd(x, w, t, lse, cot, use_exp2, vocab_chunk=96)
    outs += [(" chunk 96", *c96, rdx, rdw),
             (" chunk 96 vs chunked", *c96,
              *cross_entropy.ce_bwd_chunked_ref(x, w, t, rlse, cot, 96))]
    again = cross_entropy.ce_bwd(x, w, t, lse, cot, use_exp2)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)
    for tag, a_dx, a_dw, b_dx, b_dw in outs:
        for name, a, b in (("dx", a_dx, b_dx), ("dW", a_dw, b_dw)):
            assert a.dtype == torch.float32 and a.shape == b.shape
            check_all_close(a, b, rtol=tol, atol=tol * b.abs().max().item(),
                            name=name + tag)
    assert (loss[t < 0] == 0).all() and (dx[t < 0] == 0).all()


def _ce_fwd_f64(x, w, t):
    """(loss, lse) in f64 from the same inputs (the function both f32
    sides round)."""
    logits = x.double() @ w.double()
    lse = torch.logsumexp(logits, dim=-1)
    tl = logits.gather(-1, t.long().clamp(min=0)[:, None])[:, 0]
    return torch.where(t < 0, 0.0, lse - tl), lse


@pytest.mark.cuda
@pytest.mark.parametrize("use_exp2", [False, True])
@pytest.mark.parametrize("N,D,V", [(2048, 2048, 32768), (300, 203, 1000)])
def test_cross_entropy_f32_forward_gate(cuda, N, D, V, use_exp2):
    """The f32 forward on split-TF32 products against an f64 product and
    log-sum-exp: loss and lse at most SPLIT_GATE (2) times the error of
    the plain f32 version (torch.matmul in f32, TF32 off), at the 7bish
    training head (4 chunks of 8192 columns) and at a tail (D % 8 and
    V % 128 not 0, N no tile multiple), 5% of the targets ignored."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(N + D + V)
    x = torch.randn((N, D), generator=g, device=cuda)
    w = torch.randn((D, V), generator=g, device=cuda) / D ** 0.5
    t = torch.randint(0, V, (N,), generator=g, device=cuda,
                      dtype=torch.int32)
    t[torch.rand(N, generator=g, device=cuda) < 0.05] = -1
    out = cross_entropy.ce_fwd(x, w, t, use_exp2)
    ref = cross_entropy._ce_ref(x, w, t)
    exact = _ce_fwd_f64(x, w, t)
    for name, o, r, e in zip(("loss", "lse"), out, ref, exact):
        err = (o.double() - e).abs().max().item()
        rerr = (r.double() - e).abs().max().item()
        assert torch.isfinite(o).all() and o.shape == (N,)
        assert err <= split_tf32.SPLIT_GATE * rerr, (
            f"{name}: {err:.3e} against the plain f32 version's {rerr:.3e}")
    assert (out[0][t < 0] == 0).all()


@pytest.mark.cuda
def test_fused_loss_on_kernels_equals_unfused(cuda):
    """loss_fn with fused_loss on the card (init_params' default device)
    equals the unfused loss_fn, loss and every gradient."""
    cfg = Config(vocab=300, d_model=128, n_layers=2, n_heads=4,
                 n_kv_heads=2, d_ff=256, max_seq=64, fused_loss=True)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    leaves = param_leaves(params)
    assert all(t.is_cuda for t in leaves)
    for t in leaves:
        t.requires_grad_()
    rng = np.random.default_rng(0)
    tok, tgt = (torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64))).to(cuda)
                for _ in range(2))
    before = cross_entropy.ce_bwd.launches
    out = {}
    for fused in (True, False):
        c = Config(**{**cfg.__dict__, "fused_loss": fused})
        loss = loss_fn(params, tok, tgt, c)
        out[fused] = [loss] + list(torch.autograd.grad(loss, leaves))
    n = 2 * 64  # tokens: B 2, S 64
    chunk = cross_entropy.bwd_vocab_chunk_f32(n, cfg.d_model, cfg.vocab)
    assert cross_entropy.ce_bwd.launches == before + 3 * -(-cfg.vocab // chunk)
    for i, (a, b) in enumerate(zip(out[True], out[False])):
        check_all_close(a, b, name=f"leaf {i - 1}", **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("S,D", [(100, 64), (200, 128), (77, 32)])
@pytest.mark.parametrize("name", sorted(FEATURE_SETS))
def test_flash_attention_features(cuda, name, S, D, dt):
    """The forward's window, sinks, softcap and segments (GQA 2, lengths
    off the tiles): o on every row, lse on the rows that see a key."""
    g = torch.Generator(device=cuda).manual_seed(S + D)
    q, k, v = (torch.randn((2, h, S, D), generator=g, device=cuda)
               .to(DTYPES[dt]) for h in (4, 2, 2))
    kw, seen = feature_kwargs(name, 2, S, cuda)
    before = attention.flash_attention.launches
    o, lse = attention.flash_attention(q, k, v, causal=True,
                                       return_stats=True, **kw)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == before + 1
    ro, rlse = attention.attention_ref(q, k, v, causal=True,
                                       return_stats=True, **kw)
    check_all_close(o.float(), ro.float(), dtype=DTYPES[dt], name=name,
                    **(F32 if dt == "f32" else {}))
    check_all_close(lse[..., seen], rlse[..., seen], rtol=1e-4, atol=1e-4,
                    name=f"{name} lse")
    assert not o[..., ~seen, :].any()


FA_TILES = [None, *sorted(attention.FWD_CONFIGS)]


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", FA_TILES, ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [300, 512])
def test_flash_attention_bf16_tiles(cuda, S, causal, tiles):
    """The bf16 kernel at each tile shape (FWD_TILES; None: the rule's,
    fwd_tiles), D 128, GQA 2: against attention_tiled_ref at the same
    tiles (its order of work: P rounded to bf16 at the same points) and
    attention_ref, and a second call gives the same bits."""
    g = torch.Generator(device=cuda).manual_seed(S + causal)
    q, k, v = (torch.randn((1, h, S, 128), generator=g, device=cuda)
               .to(torch.bfloat16) for h in (4, 2, 2))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    rows, keys, _ = tiles or attention.fwd_tiles(1, 4, S, sms)
    old = attention.FWD_TILES
    attention.FWD_TILES = tiles
    try:
        before = attention.flash_attention.launches
        o = attention.flash_attention(q, k, v, causal=causal)
        again = attention.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
    finally:
        attention.FWD_TILES = old
    assert attention.flash_attention.launches == before + 2
    assert torch.equal(o, again)
    check_all_close(o.float(), attention.attention_tiled_ref(
        q, k, v, causal=causal, block_q=rows, block_k=keys).float(),
        dtype=torch.bfloat16, name="vs tiled")
    check_all_close(o.float(), attention.attention_ref(
        q, k, v, causal=causal).float(), dtype=torch.bfloat16, name="vs ref")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [2, 40])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_attention_bf16_matches_tiled_walk(cuda, D, B):
    """Each head dim's two rule instances (B 2: 64-row blocks in one wave;
    B 40: 128-row blocks), lse and features on and off, against the plain
    walk of their tiles, S 200 (tails), GQA 2."""
    g = torch.Generator(device=cuda).manual_seed(D)
    q, k, v = (torch.randn((B, h, 200, D), generator=g, device=cuda)
               .to(torch.bfloat16) for h in (4, 2, 2))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    rows, keys, _ = attention.fwd_tiles(B, 4, 200, sms)
    assert (rows == 64) == (B == 2)
    for kw in ({}, dict(window=37, sinks=5, softcap=3.0)):
        o, lse = attention.flash_attention(q, k, v, causal=True,
                                           return_stats=True, **kw)
        to, tlse = attention.attention_tiled_ref(
            q, k, v, causal=True, return_stats=True, block_q=rows,
            block_k=keys, **kw)
        check_all_close(o.float(), to.float(), dtype=torch.bfloat16,
                        name=f"o {kw}")
        check_all_close(lse, tlse, rtol=1e-4, atol=1e-4, name=f"lse {kw}")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_no_keys(cuda, dt):
    """Zero keys (non-causal): every row sees none and outputs 0."""
    q = torch.randn((1, 4, 70, 64), device=cuda).to(DTYPES[dt])
    k = v = torch.zeros((1, 2, 0, 64), device=cuda, dtype=DTYPES[dt])
    o = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert o.shape == q.shape and not o.any()


@pytest.mark.cuda
def test_flash_attention_serving_s4096(cuda):
    """The 7bish prefill heads (H 16/8, D 128, causal) at S 4096: 64
    query tiles, the longest walk 64 KV tiles; against attention_ref."""
    g = torch.Generator(device=cuda).manual_seed(4096)
    q, k, v = (torch.randn((1, h, 4096, 128), generator=g, device=cuda)
               .to(torch.bfloat16) for h in (16, 8, 8))
    o = attention.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    check_all_close(o.float(), attention.attention_ref(
        q, k, v, causal=True).float(), dtype=torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_wide_window_is_causal(cuda, dt):
    """The featured instance with a window as long as the sequence gives
    the serving instance's causal result."""
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn((1, h, 300, 128), generator=g, device=cuda)
               .to(DTYPES[dt]) for h in (4, 2, 2))
    check_all_close(
        attention.flash_attention(q, k, v, causal=True, window=300).float(),
        attention.flash_attention(q, k, v, causal=True).float(),
        dtype=DTYPES[dt], **(F32 if dt == "f32" else {}))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("S,D,Hkv", [(100, 64, 3), (200, 128, 1),
                                     (77, 32, 3), (130, 64, 1)])
@pytest.mark.parametrize("name", ["window", "softcap", "segments",
                                  "window+softcap+segments", "none"])
def test_flash_attention_featured_bwd(cuda, name, S, D, Hkv, dt):
    """flash_attention_dq and flash_attention_dkv (one launch each, no
    fused launch) against the plain backward with the same masks, on the
    forward's own o and lse, 3 query heads on Hkv KV heads (GQA inside the
    kernels at Hkv 1); "none" is fused=False with no feature. A second
    call gives the same bits."""
    kw = dict() if name == "none" else feature_kwargs(name, 2, S, cuda)[0]
    g = torch.Generator(device=cuda).manual_seed(S * D)
    q, do = (torch.randn((2, 3, S, D), generator=g, device=cuda)
             .to(DTYPES[dt]) for _ in range(2))
    k, v = (torch.randn((2, Hkv, S, D), generator=g, device=cuda)
            .to(DTYPES[dt]) for _ in range(2))
    o, lse = attention.attention_ref(q, k, v, causal=True, return_stats=True,
                                     **kw)
    counts = (attention_bwd.flash_attention_dq.launches,
              attention_bwd.flash_attention_dkv.launches,
              attention_bwd.flash_attention_bwd.launches)
    out = attention_bwd.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                            fused=False, **kw)
    torch.cuda.synchronize()
    assert (attention_bwd.flash_attention_dq.launches,
            attention_bwd.flash_attention_dkv.launches,
            attention_bwd.flash_attention_bwd.launches) == (
                counts[0] + 1, counts[1] + 1, counts[2])
    ref = attention_bwd.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                causal=True, **kw)
    again = attention_bwd.flash_attention_bwd(q, k, v, o, lse, do,
                                              causal=True, fused=False, **kw)
    for grad, a, b, c in zip(("dq", "dk", "dv"), out, ref, again):
        assert a.dtype == DTYPES[dt] and a.shape == b.shape
        assert torch.equal(a, c), f"{name} {grad}: a second call differs"
        check_all_close(a.float(), b.float(), dtype=DTYPES[dt],
                        name=f"{name} {grad}", **(F32 if dt == "f32" else {}))


@pytest.mark.cuda
def test_featured_bwd_noncontiguous_inputs(cuda):
    """v and do as transposed views (the layout the training step hands
    the backward): the wrappers' contiguous copies must outlive the
    launch, or dK/dV may be allocated over them."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k = (torch.randn((1, 4, 500, 128), generator=g, device=cuda)
            for _ in range(2))
    v, do = (torch.randn((1, 500, 4, 128), generator=g, device=cuda)
             .transpose(1, 2) for _ in range(2))
    kw = dict(causal=True, window=200, softcap=30.0)
    o, lse = attention.attention_ref(q, k, v, return_stats=True, **kw)
    for _ in range(3):
        out = attention_bwd.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        ref = attention_bwd.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
        for grad, a, b in zip(("dq", "dk", "dv"), out, ref):
            check_all_close(a, b, name=grad, **F32)


@pytest.mark.cuda
def test_featured_bwd_is_deterministic(cuda):
    """Each output of the two-kernel backward has one owner: two runs are
    bit for bit equal."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn((2, 4, 300, 128), generator=g, device=cuda)
                   for _ in range(4))
    o, lse = attention.flash_attention(q, k, v, causal=True, window=100,
                                       softcap=30.0, return_stats=True)
    runs = [attention_bwd.flash_attention_bwd(q, k, v, o, lse, do,
                                              causal=True, window=100,
                                              softcap=30.0)
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_featured_train_on_kernels_equals_plain(cuda):
    """loss_fn with Config.window and Config.softcap and every gradient
    through the kernels against the same function on the CPU; the
    backward takes the two featured kernels, never the fused one."""
    cfg = Config(vocab=128, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                 d_ff=256, max_seq=64, window=24, softcap=30.0)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    tok, tgt = (torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64)))
                for _ in range(2))
    counts = (attention_bwd.flash_attention_dq.launches,
              attention_bwd.flash_attention_bwd.launches)
    grads = {}
    for dev in ("cpu", cuda):
        p = params_to(params, dev, copy=True)
        leaves = param_leaves(p)
        for t in leaves:
            t.requires_grad_()
        loss = loss_fn(p, tok.to(dev), tgt.to(dev), cfg)
        grads[str(dev)] = [loss] + list(torch.autograd.grad(loss, leaves))
    assert attention_bwd.flash_attention_dq.launches == counts[0] + 2
    assert attention_bwd.flash_attention_bwd.launches == counts[1]
    for i, (a, b) in enumerate(zip(grads["cuda"], grads["cpu"])):
        check_all_close(a, b, name=f"leaf {i - 1}", **F32)


def _paged_case(dev, dt, B, Hq, Hkv, T, D, page, pps, lengths, seed):
    """q (B, Hq, T, D) and pools of B * pps pages behind a shuffled
    table, on dev in dt."""
    g = torch.Generator(device=dev).manual_seed(seed)
    P = B * pps
    q = torch.randn((B, Hq, T, D), generator=g, device=dev).to(dt)
    kp, vp = (torch.randn((Hkv, P, page, D), generator=g, device=dev).to(dt)
              for _ in range(2))
    table = torch.randperm(P, generator=g, device=dev).reshape(B, pps)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, lengths, table.to(torch.int32)


PREFIX_CASES = {
    # chip_smoke.py's timed shapes: a 256-token chunk over a 900-token
    # prefix, and a gamma = 4 verification whose last length passes the
    # pool (the clamp)
    "chunk": (1, 16, 8, 256, 128, 128, 8, [900]),
    "verify": (4, 16, 8, 5, 128, 128, 8, [6, 133, 705, 1029]),
    "D32 T7": (3, 8, 1, 7, 32, 16, 4, [7, 30, 64]),
    "D64 T70": (2, 4, 2, 70, 64, 16, 8, [70, 128]),
    "D128 T1": (3, 4, 4, 1, 128, 16, 4, [1, 33, 64]),
    # lengths on the edges of prefill_splits' 3 splits of 64 slots: 0,
    # 1, chunk - 1, chunk, chunk + 1, the pool's end and past it
    "split edges": (7, 8, 2, 5, 64, 16, 12, [0, 1, 63, 64, 65, 192, 201]),
}
PREFIX_FEATURES = {"none": {}, "window": dict(window=40),
                   "window+sinks": dict(window=40, sinks=5),
                   "softcap": dict(softcap=2.0),
                   "all": dict(window=100, sinks=3, softcap=2.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("feat", sorted(PREFIX_FEATURES))
@pytest.mark.parametrize("case", sorted(PREFIX_CASES))
def test_paged_prefill_matches_plain(cuda, case, feat, dt):
    """#24 against paged_prefill_ref and paged_prefill_split_ref (its
    split order): every head dim, groups 1 to 8, T of 1, 5, 7, 70 and
    256, shuffled tables, lengths on and off the pages, on the splits'
    edges and past the pool, with and without the window, sinks and
    softcap; one launch a call, and a second call gives the same bits."""
    args = _paged_case(cuda, DTYPES[dt], *PREFIX_CASES[case], seed=len(case))
    kw = PREFIX_FEATURES[feat]
    if case == "split edges":
        assert paged_attention.prefill_splits(
            7, 8, 2, 5, 192, DTYPES[dt]) == (64, 3)
    before = paged_attention.paged_prefill_attention.launches
    out = paged_attention.paged_prefill_attention(*args, **kw)
    torch.cuda.synchronize()
    assert paged_attention.paged_prefill_attention.launches == before + 1
    for name, ref in (("", paged_attention.paged_prefill_ref),
                      (" split", paged_attention.paged_prefill_split_ref)):
        check_all_close(out.float(), ref(*args, **kw).float(),
                        dtype=DTYPES[dt], name=f"{case} {feat}{name}",
                        **(F32 if dt == "f32" else {}))
    assert torch.equal(out, paged_attention.paged_prefill_attention(*args,
                                                                    **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("feat", sorted(PREFIX_FEATURES))
def test_paged_decode_features_match_plain(cuda, feat, dt):
    """#23's featured instance against the plain version: the serving
    shape's lengths (one past the pool) and a short band."""
    q, kp, vp, lengths, table = _paged_case(
        cuda, DTYPES[dt], 4, 16, 8, 1, 128, 128, 8, [1, 129, 700, 1025],
        seed=7)
    args = (q[:, :, 0], kp, vp, lengths, table)
    kw = PREFIX_FEATURES[feat]
    out = paged_attention.paged_attention(*args, **kw)
    check_all_close(out.float(),
                    paged_attention.paged_attention_ref(*args, **kw).float(),
                    dtype=DTYPES[dt], name=feat,
                    **(F32 if dt == "f32" else {}))


@pytest.mark.cuda
def test_paged_prefill_wide_window_is_plain(cuda):
    """A window longer than every sequence gives the plain instance's
    result."""
    args = _paged_case(cuda, torch.bfloat16, *PREFIX_CASES["verify"], seed=2)
    assert torch.equal(
        paged_attention.paged_prefill_attention(*args, window=4096),
        paged_attention.paged_prefill_attention(*args))


@pytest.mark.cuda
def test_paged_unsupported_shapes_raise(cuda):
    """A head dim of 96 or a GQA group of 16 raises on a CUDA tensor."""
    for Hq, D in ((4, 96), (16, 64)):
        q, kp, vp, lengths, table = _paged_case(
            cuda, torch.bfloat16, 1, Hq, 1, 3, D, 16, 2, [5], seed=0)
        with pytest.raises(ValueError, match="group|head dim"):
            paged_attention.paged_prefill_attention(q, kp, vp, lengths, table)
        with pytest.raises(ValueError, match="group|head dim"):
            paged_attention.paged_attention(q[:, :, 0], kp, vp, lengths,
                                            table)


@pytest.mark.cuda
def test_serving_features_on_kernels_equal_plain(cuda):
    """Chunked admission, the prefix cache and SpeculativeBatcher, with
    and without a window, sinks and softcap, through the kernels (f32
    weights and pools): the same greedy streams as the plain path on the
    CPU, and the prefix kernel launched."""
    from tpukern_torch.models import SpeculativeBatcher

    base = Config(vocab=128, d_model=128, n_layers=2, n_heads=4,
                  n_kv_heads=2, d_ff=256, max_seq=512)
    params = init_params(base, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    shared = rng.integers(0, base.vocab, 40).astype(np.int32)
    prompts = [shared, np.concatenate([shared, [5, 9, 11]]).astype(np.int32),
               rng.integers(0, base.vocab, 9).astype(np.int32)]
    kw = dict(n_slots=2, pages_per_seq=4, page_size=16, max_new_tokens=6,
              prompt_buckets=(64,), cache_dtype=torch.float32)
    for cfg in (base, Config(**{**base.__dict__, "window": 16, "sinks": 2,
                                "softcap": 0.5})):
        for make in (
                lambda p: ContinuousBatcher(p, cfg, chunked_prefill=8, **kw),
                lambda p: ContinuousBatcher(p, cfg, prefix_cache=True, **kw),
                lambda p: SpeculativeBatcher(p, cfg, p, cfg, gamma=3, **kw)):
            ref = make(params).run(list(enumerate(prompts)))
            before = paged_attention.paged_prefill_attention.launches
            out = make(params_to(params, cuda)).run(list(enumerate(prompts)))
            assert out == ref
            assert paged_attention.paged_prefill_attention.launches > before


# ------------------------------------------------- sampling (#26, #27)

def _sample_logits(dev, B, V, dt, seed, scale=3.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((B, V), generator=g, device=dev) * scale).to(dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,V", [(4, 32768), (3, 1000), (2, 128256),
                                 (8192, 16)])
def test_sample_kernel_greedy_and_noise(cuda, B, V, dt):
    """#26 in greedy mode and with input noise and top-k thresholds:
    indices equal the plain twin's (first index on ties)."""
    from tpukern_torch.ops import sampling

    x = _sample_logits(cuda, B, V, DTYPES[dt], B + V)
    before = sampling._stream_sample.launches
    np.testing.assert_array_equal(sampling.greedy_sample(x).cpu().numpy(),
                                  torch.argmax(x.float(), -1).cpu().numpy())
    g = torch.Generator(device=cuda).manual_seed(1)
    noise = -torch.log(-torch.log(torch.rand((B, V), generator=g,
                                             device=cuda)))
    thr = sampling._bisect_threshold_ref(x, mode="count", kk=min(50, V))
    kw = dict(inv_temp=1 / 0.7, gumbel=True, thresholds=thr, noise=noise)
    np.testing.assert_array_equal(
        sampling._stream_sample(x, 0, **kw).cpu().numpy(),
        sampling._stream_sample_ref(x, 0, **kw).cpu().numpy())
    assert sampling._stream_sample.launches == before + 2


@pytest.mark.cuda
def test_sample_kernel_ties(cuda):
    """Ties inside one block's columns and across two blocks (columns 5
    and 3000 of 2048-column blocks), and -0 against +0."""
    from tpukern_torch.ops import sampling

    x = torch.zeros((4, 5000), device=cuda)
    x[0, [5, 3000]] = 2.0
    x[1, [4095, 4096]] = 7.0
    x[2, :] = -0.0
    x[2, 3] = 0.0
    np.testing.assert_array_equal(sampling.greedy_sample(x).cpu().numpy(),
                                  [5, 4095, 0, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("V", [1000, 32768])
def test_sample_kernel_philox_equals_plain(cuda, V):
    """In-kernel noise: the plain twin computes the same Philox bits, so
    the draws are equal except where the two best perturbed scores lie
    within 1e-5 (log's last bits may differ); the same seed repeats."""
    from tpukern_torch.ops import sampling

    B, T = 64, 0.8
    x = _sample_logits(cuda, B, V, torch.float32, V)
    out = sampling.sample(x, 1234, temperature=T)
    ref = sampling._stream_sample_ref(x, 1234, inv_temp=1 / T, gumbel=True)
    assert (sampling.sample(x, 1234, temperature=T) == out).all()
    score = x * (1 / T) + sampling._gumbel(1234, B, V, cuda)
    top2 = torch.topk(score, 2, dim=-1).values
    near = (top2[:, 0] - top2[:, 1]) < 1e-5
    assert ((out == ref) | near).all()


@pytest.mark.cuda
def test_sample_kernel_frequencies(cuda):
    """8192 rows of one 16-wide row through the in-kernel noise: each
    token's frequency within a 3-sigma band of softmax(x / T)."""
    from tpukern_torch.ops import sampling

    V, N, T = 16, 8192, 0.8
    base = _sample_logits(cuda, 1, V, torch.float32, 3, scale=1.5)
    got = sampling.sample(base.expand(N, V).contiguous(), 7, temperature=T)
    freq = torch.bincount(got.long(), minlength=V).double() / N
    probs = torch.softmax(base[0].double() / T, -1)
    tol = 3 * torch.sqrt(probs * (1 - probs) / N) + 2e-3
    assert ((freq - probs).abs() < tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("V", [1000, 32768, 128256])
def test_threshold_kernel(cuda, V):
    """#27 count mode: bit-equal to the twin (the k-th largest value, ties
    included); mass mode: the kept sets differ by at most the boundary
    token, of mass < 1e-4; both are data values and repeat run to run."""
    from tpukern_torch.ops import sampling

    x = _sample_logits(cuda, 4, V, torch.float32, V)
    x[1, :20] = x[1].max()  # a 21-way tie at the top
    before = dict(count=sampling._bisect_threshold.count_launches,
                  mass=sampling._bisect_threshold.mass_launches)
    for k in (1, 8, 21, 50, 1000):
        out = sampling.topk_threshold(x, k)
        np.testing.assert_array_equal(
            out.cpu().numpy(),
            sampling._bisect_threshold_ref(x, mode="count", kk=k).cpu().numpy())
        assert (out == torch.topk(x, k).values[:, -1]).all()
    for p, T in ((0.1, 1.0), (0.9, 0.8), (0.999, 1.0)):
        out = sampling.topp_threshold(x, p, T)
        assert (out == sampling.topp_threshold(x, p, T)).all()
        ref = sampling._bisect_threshold_ref(x, mode="mass", pp=p,
                                             inv_temp=1 / T)
        probs = torch.softmax(x.double() / T, -1)
        for r in range(4):
            assert (x[r] == out[r]).any()
            differ = (x[r] >= out[r]) ^ (x[r] >= ref[r])
            assert int(differ.sum()) <= 1
            assert float(probs[r][differ].sum()) < 1e-4
    assert sampling._bisect_threshold.count_launches == before["count"] + 5
    assert sampling._bisect_threshold.mass_launches == before["mass"] + 6


@pytest.mark.cuda
def test_paged_attention_bf16_rounds_p(cuda):
    """#23's bf16 instance rounds P to bf16 for the P V sum, as the plain
    version now does: closer to it than to P kept in f32."""
    g = torch.Generator(device=cuda).manual_seed(5)
    kp, vp = (torch.randn((8, 32, 128, 128), generator=g, device=cuda)
              .to(torch.bfloat16) for _ in range(2))
    q = (2 * torch.randn((4, 16, 128), generator=g, device=cuda)).to(
        torch.bfloat16)
    table = torch.randperm(32, generator=g, device=cuda).reshape(4, 8)
    lengths = torch.tensor([1, 129, 700, 1024], dtype=torch.int32,
                           device=cuda)
    args = (q, kp, vp, lengths, table.to(torch.int32))
    out = paged_attention.paged_attention(*args).float()
    ref = paged_attention.paged_attention_ref(*args).float()
    f32_p = paged_attention.paged_attention_ref(
        *(t.float() for t in args[:3]), *args[3:]).to(torch.bfloat16).float()
    check_all_close(out, ref, dtype=torch.bfloat16)
    assert (out != ref).sum() < (out != f32_p).sum()


# #23 split-KV: lengths at the split edges (0, 1, chunk - 1, chunk, chunk +
# 1, the pool's end and past it) over three splits of DECODE_CHUNK slots;
# every featured option; the ring wrapped past its slots
SPLIT_FEATURES = {"none": {}, "window+sinks": dict(window=40, sinks=5),
                  "softcap": dict(softcap=2.0),
                  "ring": dict(ring=True, window=300, sinks=4),
                  "alibi": dict(alibi=True),
                  "ring+alibi": dict(ring=True, window=200, alibi=True)}


def _split_case(dev, dt, feat, seed):
    c = paged_attention.DECODE_CHUNK
    pps = 3 * c // 16
    S = 16 * pps
    kw = dict(SPLIT_FEATURES[feat])
    lengths = [0, 1, c - 1, c, c + 1, S, S + 9]
    if kw.get("ring"):
        lengths = [3 * S + 5, 1, c - 1, c + 1, S, S + 9, 2 * S + c]
    q, kp, vp, lens, table = _paged_case(dev, dt, len(lengths), 8, 2, 1, 64,
                                         16, pps, lengths, seed)
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = 2.0 ** -torch.arange(1, 9, device=dev,
                                                  dtype=torch.float32)
    return (q[:, :, 0], kp, vp, lens, table), kw


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("feat", sorted(SPLIT_FEATURES))
def test_paged_decode_split_matches_refs(cuda, feat, dt):
    """#23 split-KV against paged_attention_split_ref (its order) and
    paged_attention_ref (the final max), one launch a call, zeros at
    length 0 (f32: 1e-4; bf16: the _TOLS bf16 row, P's rounding)."""
    args, kw = _split_case(cuda, DTYPES[dt], feat, seed=len(feat))
    assert paged_attention.decode_splits(args[4].shape[1], 16) == 3
    before = paged_attention.paged_attention.launches
    out = paged_attention.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert paged_attention.paged_attention.launches == before + 1
    tol = F32 if dt == "f32" else {}
    for name, ref in (("split", paged_attention.paged_attention_split_ref),
                      ("final max", paged_attention.paged_attention_ref)):
        check_all_close(out.float(), ref(*args, **kw).float(),
                        dtype=DTYPES[dt], name=f"{feat} {name}", **tol)
    if not kw.get("ring"):
        assert not out[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_paged_decode_split_is_bit_stable(cuda, dt):
    """Two calls in a row, and a call after one of another shape, give
    the same bits: the merge's order is fixed and the ticket counters are
    back at zero after each call."""
    from tpukern_torch import _build

    args, kw = _split_case(cuda, DTYPES[dt], "window+sinks", seed=3)
    fn = paged_attention.paged_attention
    first = fn(*args, **kw)
    second = fn(*args, **kw)
    q, kp, vp, lengths, table = _paged_case(
        cuda, DTYPES[dt], 4, 16, 8, 1, 128, 128, 8, [1, 129, 700, 1024],
        seed=4)
    fn(q[:, :, 0], kp, vp, lengths, table)
    third = fn(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, third)
    stream = _build.stream(args[0])
    assert not _build.tickets(args[0].device, stream, 1).any()


# ------------------------------------- the quantized tier (#20-#22, #23/#24)

@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("S,K", [(32, 128), (4096, 128), (33, 100), (5, 24)])
def test_quantize_kernels_equal_plain(cuda, S, K, dt):
    """#20 (round to nearest) and #22 bit for bit against quantize_ref and
    quantize_fp8_ref (true divisions, round half to even), #21 against
    dequantize_ref; rows of zeros and odd widths (element loads)."""
    from tpukern_torch.ops import quant

    g = torch.Generator(device=cuda).manual_seed(S + K)
    x = (3 * torch.randn((S, K), generator=g, device=cuda)).to(DTYPES[dt])
    x[0] = 0
    counts = (quant.quantize_int8.launches, quant.quantize_fp8.launches,
              quant.dequantize_int8.launches)
    for fn, ref in ((quant.quantize_int8, quant.quantize_ref),
                    (quant.quantize_fp8, quant.quantize_fp8_ref)):
        (v, s), (rv, rs) = fn(x), ref(x)
        assert v.dtype == rv.dtype and torch.equal(v.view(torch.uint8),
                                                   rv.view(torch.uint8))
        assert torch.equal(s, rs)
    v, s = quant.quantize_int8(x)
    for out in (torch.float32, torch.bfloat16):
        assert torch.equal(quant.dequantize_int8(v, s, out),
                           quant.dequantize_ref(v, s, out))
    torch.cuda.synchronize()
    assert (quant.quantize_int8.launches, quant.quantize_fp8.launches,
            quant.dequantize_int8.launches) == (counts[0] + 2, counts[1] + 1,
                                                counts[2] + 2)


@pytest.mark.cuda
def test_quantize_stochastic_kernel(cuda):
    """#20's stochastic mode by its distribution (tests/test_quant.py's
    midpoint test): 50.5 draws 50 or 51 with mean 50.5; a seed repeats,
    seeds differ."""
    from tpukern_torch.ops import quant

    x = torch.full((64, 128), 0.505, device=cuda)
    x[:, 0] = 1.27
    draws = torch.stack([quant.quantize_int8(x, seed=s, stochastic=True)[0]
                         for s in range(16)])[:, :, 1:].float()
    assert set(draws.unique().tolist()) <= {50.0, 51.0}
    assert abs(draws.mean().item() - 50.5) < 0.02
    again = quant.quantize_int8(x, seed=3, stochastic=True)[0][:, 1:].float()
    assert torch.equal(again, draws[3]) and not torch.equal(draws[3],
                                                            draws[4])


# tier -> (pool dtype, q_int8, pv_int8, pages_per_block)
QUANT_TIERS = {"int8": ("int8", False, False, 8),
               "int8 q_int8": ("int8", True, False, 8),
               "int8 pv_int8 ppb1": ("int8", False, True, 1),
               "int8 q_int8 pv_int8 ppb8": ("int8", True, True, 8),
               "fp8": ("fp8", False, False, 4)}
# f32: the kernels take a running max where the plain versions take the
# final one; with pv_int8 a p * v_scale within an f32 rounding of a
# rounding boundary then quantizes one step apart, which moves an output
# by at most amax / (127 l), so those tiers hold f32 to 2e-3
QUANT_F32 = dict(rtol=1e-4, atol=1e-4)
QUANT_F32_PV = dict(rtol=2e-3, atol=2e-3)
# lengths 0 and 3 < T = 5: rows (and a whole decode row) that see nothing,
# where no page block runs and the output is 0
QUANT_CASES = {**PREFIX_CASES, "short": (3, 4, 2, 5, 64, 16, 4, [0, 3, 40])}


def _quantized_case(dev, dt, tier, case, seed):
    q, kp, vp, lengths, table = _paged_case(dev, dt, *QUANT_CASES[case],
                                            seed=seed)
    dtype, q_int8, pv_int8, ppb = QUANT_TIERS[tier]
    ppb = min(ppb, table.shape[1])
    kq, ks = paged_attention.quantize_pages(kp.float(), dtype)
    vq, vs = paged_attention.quantize_pages(vp.float(), dtype)
    kw = dict(pages_per_block=ppb, q_int8=q_int8, pv_int8=pv_int8)
    return (q, kq, ks, vq, vs, lengths, table), kw


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["chunk", "verify", "D32 T7", "D64 T70",
                                  "short"])
@pytest.mark.parametrize("tier", sorted(QUANT_TIERS))
def test_paged_quantized_matches_plain(cuda, tier, case, dt):
    """#24's and #23's quantized instances against their plain versions,
    on the chunk and verification shapes of chip_smoke.py, small ones and
    lengths of 0 and below T; decode on the same pools at the prefix's
    last token."""
    args, kw = _quantized_case(cuda, DTYPES[dt], tier, case, len(case))
    tol = ({} if dt == "bf16" else
           QUANT_F32_PV if kw["pv_int8"] else QUANT_F32)
    fn = paged_attention.paged_prefill_attention_quantized
    before = fn.launches
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = paged_attention.paged_prefill_quantized_ref(*args, **kw)
    check_all_close(out.float(), ref.float(), dtype=DTYPES[dt],
                    name=f"prefix {tier} {case}", **tol)
    dargs = (args[0][:, :, -1], *args[1:])
    out = paged_attention.paged_attention_quantized(*dargs, **kw)
    ref = paged_attention.paged_attention_quantized_ref(*dargs, **kw)
    check_all_close(out.float(), ref.float(), dtype=DTYPES[dt],
                    name=f"decode {tier} {case}", **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("feat", ["window+sinks", "softcap", "all"])
@pytest.mark.parametrize("tier", ["int8 q_int8 pv_int8 ppb8", "fp8"])
def test_paged_quantized_features(cuda, tier, feat):
    """The window, sinks and softcap on the quantized instances."""
    args, kw = _quantized_case(cuda, torch.float32, tier, "verify", 3)
    kw.update(PREFIX_FEATURES[feat])
    tol = QUANT_F32_PV if kw["pv_int8"] else QUANT_F32
    for fn, ref, a in (
            (paged_attention.paged_prefill_attention_quantized,
             paged_attention.paged_prefill_quantized_ref, args),
            (paged_attention.paged_attention_quantized,
             paged_attention.paged_attention_quantized_ref,
             (args[0][:, :, 0], *args[1:]))):
        check_all_close(fn(*a, **kw).float(), ref(*a, **kw).float(),
                        name=f"{tier} {feat}", **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [None, 64, 256])
@pytest.mark.parametrize("tier", sorted(QUANT_TIERS))
def test_paged_quantized_split_order(cuda, tier, chunk):
    """The split-KV kernel against its plain order of work
    (paged_prefill_quantized_split_ref and the decode one) at the rule's
    split and at forced ones (QUANT_CHUNK; a pv_int8 split rounds up to
    whole page blocks), on the verification shape and its decode; a
    second call gives the same bits (the splits merge in a fixed
    order)."""
    args, kw = _quantized_case(cuda, torch.float32, tier, "verify", 7)
    tol = QUANT_F32_PV if kw["pv_int8"] else QUANT_F32
    keep = paged_attention.QUANT_CHUNK
    try:
        paged_attention.QUANT_CHUNK = chunk
        for fn, ref, a in (
                (paged_attention.paged_prefill_attention_quantized,
                 paged_attention.paged_prefill_quantized_split_ref, args),
                (paged_attention.paged_attention_quantized,
                 paged_attention.paged_attention_quantized_split_ref,
                 (args[0][:, :, -1], *args[1:]))):
            out = fn(*a, **kw)
            check_all_close(out, ref(*a, **kw), name=f"{tier} {chunk}",
                            **tol)
            assert torch.equal(out, fn(*a, **kw))
    finally:
        paged_attention.QUANT_CHUNK = keep


@pytest.mark.cuda
def test_quantized_serving_on_kernels_equals_plain(cuda):
    """ContinuousBatcher (chunked admission) and SpeculativeBatcher on int8,
    int8 + pv_int8 and fp8 pools through the kernels (f32 weights): the
    greedy streams of the plain path on the CPU; the quantized instances
    and #20/#22 launch, the float instances do not."""
    from tpukern_torch.models import SpeculativeBatcher
    from tpukern_torch.ops import quant

    base = Config(vocab=128, d_model=128, n_layers=2, n_heads=4,
                  n_kv_heads=2, d_ff=256, max_seq=512)
    params = init_params(base, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, base.vocab, n).astype(np.int32)
               for n in (40, 9, 23)]
    for dt, pv in ((torch.int8, False), (torch.int8, True),
                   (torch.float8_e4m3fn, False)):
        cfg = Config(**{**base.__dict__, "pv_int8": pv})
        kw = dict(n_slots=2, pages_per_seq=4, page_size=16, max_new_tokens=6,
                  prompt_buckets=(64,), cache_dtype=dt)
        for make in (
                lambda p: ContinuousBatcher(p, cfg, chunked_prefill=8, **kw),
                lambda p: SpeculativeBatcher(p, cfg, p, cfg, gamma=3, **kw)):
            ref = make(params).run(list(enumerate(prompts)))
            ops = (paged_attention.paged_attention,
                   paged_attention.paged_prefill_attention,
                   paged_attention.paged_attention_quantized,
                   paged_attention.paged_prefill_attention_quantized,
                   quant.quantize_int8, quant.quantize_fp8)
            before = [op.launches for op in ops]
            out = make(params_to(params, cuda)).run(list(enumerate(prompts)))
            grew = [op.launches > b for op, b in zip(ops, before)]
            assert out == ref
            assert grew[:4] == [False, False, True, True]
            assert grew[4] == (dt == torch.int8) and grew[5] != grew[4]


# ------------------------------------------------ w8a16 GEMM (#25)

# (M, N, K): the 7bish decode shapes (wk/wv, wq/wo, w1, w2, the head), a
# verification, a whole 128-token prefill, forced prefill sizes, a K tail
# and an N that is no tile (nor 16-byte) multiple; then M at the edges of
# the bf16 kernel's token tiles (1, 2, 4, 8, 16 tiles of 8)
W8A16_SHAPES = [(4, 1024, 2048), (4, 2048, 2048), (4, 8192, 2048),
                (4, 2048, 8192), (1, 32768, 2048), (20, 2048, 2048),
                (128, 8192, 2048), (256, 2048, 2048), (2048, 1024, 512),
                (7, 1000, 200), (3, 136, 8192),
                # each token-tile instance and its edges at the 7bish widths
                (1, 1024, 2048), (8, 2048, 2048), (9, 8192, 2048),
                (16, 2048, 8192), (33, 2048, 2048), (64, 8192, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("M,N,K", W8A16_SHAPES)
def test_matmul_w8a16_matches_plain(cuda, M, N, K, dt):
    """The kernel (forced at every M) against matmul_w8a16_ref, bit for
    bit on a second call (the split-K partials are summed in slice order,
    whichever block finishes last)."""
    from tpukern_torch.ops import matmul_w8a16 as w8
    g = torch.Generator(device=cuda).manual_seed(M + N + K)
    x = torch.randn((M, K), generator=g, device=cuda).to(DTYPES[dt])
    w = torch.randn((K, N), generator=g, device=cuda) * 0.02
    q, s = w8.quantize_weights(w)
    before = w8.matmul_w8a16.launches
    out = w8.matmul_w8a16(x, q, s, force_kernel=True)
    again = w8.matmul_w8a16(x, q, s, force_kernel=True)
    torch.cuda.synchronize()
    assert w8.matmul_w8a16.launches == before + 2
    assert out.dtype == x.dtype and torch.equal(out, again)
    ref = w8.matmul_w8a16_ref(x, q, s)
    check_all_close(out.float(), ref.float(), dtype=DTYPES[dt],
                    name=f"w8a16 {M}x{N}x{K} {dt}",
                    **(F32 if dt == "f32" else {}))
    f32 = w8.matmul_w8a16(x, q, s, out_dtype=torch.float32, force_kernel=True)
    check_all_close(f32, w8.matmul_w8a16_ref(x, q, s, out_dtype=torch.float32),
                    name="f32 out", **F32)


# ------------------------------------------------ ring pools and ALiBi

# (B, Hq, Hkv, T, D, page, pps, lengths, window, sinks): rings of 64 and
# 1024 slots wrapped more than once, sinks, windows at the ring's limit
RING_CASES = {"small": (2, 4, 2, 5, 32, 16, 4, [150, 9], 60, 0),
              "sinks": (3, 8, 2, 5, 64, 16, 4, [150, 70, 5], 56, 4),
              "serve": (4, 16, 8, 5, 128, 128, 5, [600, 1500, 2900, 640],
                        632, 4)}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_paged_ring_matches_plain(cuda, case, alibi, dt):
    """#24 (T = 5) and #23 (each sequence's last token) on wrapped rings,
    with and without ALiBi, against their plain versions; ring_launches
    counts the launches."""
    *shape, window, sinks = RING_CASES[case]
    q, kp, vp, lengths, table = _paged_case(cuda, DTYPES[dt], *shape,
                                            seed=len(case))
    kw = dict(ring=True, window=window, sinks=sinks)
    if alibi:
        kw["alibi_slopes"] = 2.0 ** -torch.arange(
            1, q.shape[1] + 1, device=cuda, dtype=torch.float32)
    tol = F32 if dt == "f32" else {}
    fn = paged_attention.paged_prefill_attention
    before = fn.ring_launches
    out = fn(q, kp, vp, lengths, table, **kw)
    torch.cuda.synchronize()
    assert fn.ring_launches == before + 1
    ref = paged_attention.paged_prefill_ref(q, kp, vp, lengths, table, **kw)
    check_all_close(out.float(), ref.float(), dtype=DTYPES[dt],
                    name=f"prefix {case}", **tol)
    kw["window"] += 4  # one token: the decode limit is ring - sinks
    args = (q[:, :, -1], kp, vp, lengths, table)
    check_all_close(paged_attention.paged_attention(*args, **kw).float(),
                    paged_attention.paged_attention_ref(*args, **kw).float(),
                    dtype=DTYPES[dt], name=f"decode {case}", **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("case", sorted(RING_CASES))
@pytest.mark.parametrize("tier", ["int8", "int8 pv_int8 ppb1",
                                  "int8 q_int8 pv_int8 ppb8", "fp8"])
def test_paged_quantized_ring_matches_plain(cuda, tier, case, alibi):
    """The quantized instances on the same rings, f32 q."""
    *shape, window, sinks = RING_CASES[case]
    q, kp, vp, lengths, table = _paged_case(cuda, torch.float32, *shape,
                                            seed=len(case) + 1)
    dtype, q_int8, pv_int8, ppb = QUANT_TIERS[tier]
    kq, ks = paged_attention.quantize_pages(kp, dtype)
    vq, vs = paged_attention.quantize_pages(vp, dtype)
    kw = dict(pages_per_block=1 if ppb == 1 else table.shape[1],
              q_int8=q_int8, pv_int8=pv_int8, ring=True, window=window,
              sinks=sinks)
    if alibi:
        kw["alibi_slopes"] = 2.0 ** -torch.arange(
            1, q.shape[1] + 1, device=cuda, dtype=torch.float32)
    tol = QUANT_F32_PV if pv_int8 else QUANT_F32
    args = (q, kq, ks, vq, vs, lengths, table)
    check_all_close(
        paged_attention.paged_prefill_attention_quantized(*args, **kw),
        paged_attention.paged_prefill_quantized_ref(*args, **kw),
        name=f"prefix {tier} {case}", **tol)
    kw["window"] += 4
    dargs = (q[:, :, -1], *args[1:])
    check_all_close(
        paged_attention.paged_attention_quantized(*dargs, **kw),
        paged_attention.paged_attention_quantized_ref(*dargs, **kw),
        name=f"decode {tier} {case}", **tol)


@pytest.mark.cuda
def test_w8a16_and_ring_serving_on_kernels_equal_plain(cuda):
    """w8a16 params and ring pools (window 24, sinks 4, 48 slots; the
    streams wrap) through the kernels: the greedy streams of the plain
    path on the CPU, with #25 and the ring instances launched."""
    from tpukern_torch.models import SpeculativeBatcher, serving
    from tpukern_torch.ops import matmul_w8a16 as w8

    cfg = Config(vocab=128, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                 d_ff=256, max_seq=512, window=24, sinks=4)
    params = serving.quantize_model_weights(
        init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (40, 9, 23)]
    kw = dict(n_slots=2, pages_per_seq=3, page_size=16, max_new_tokens=20,
              prompt_buckets=(48,), cache_dtype=torch.float32, ring=True)
    for make in (lambda p: ContinuousBatcher(p, cfg, **kw),
                 lambda p: SpeculativeBatcher(p, cfg, p, cfg, gamma=3, **kw)):
        ref = make(params).run(list(enumerate(prompts)))
        before = (w8.matmul_w8a16.launches,
                  paged_attention.paged_attention.ring_launches
                  + paged_attention.paged_prefill_attention.ring_launches)
        out = make(params_to(params, cuda)).run(list(enumerate(prompts)))
        after = (w8.matmul_w8a16.launches,
                 paged_attention.paged_attention.ring_launches
                 + paged_attention.paged_prefill_attention.ring_launches)
        assert out == ref
        assert after[0] > before[0] and after[1] > before[1]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("mode", ["out", "accio", "dual"])
@pytest.mark.parametrize("M,N,K", [(130, 257, 8192), (77, 300, 64),
                                   (77, 130, 0)])
def test_matmul_ring_wraps_one_slab_and_none(cuda, M, N, K, mode, trans_b,
                                             dt):
    """The bf16 ring: K 8192 wraps the 4 stages of 64-wide slabs 32 times,
    K 64 is one slab, K 0 has none (zeros); every epilogue, NN and TN, in
    both dtypes. A is scaled by 1/sqrt(K) so every output is of unit
    size, as the contraction's rounding is for f32's 1e-4."""
    g = torch.Generator(device=cuda).manual_seed(M + N + K)
    a = (torch.randn((M, K), generator=g, device=cuda)
         / max(K, 1) ** 0.5).to(DTYPES[dt])
    b = torch.randn((N, K) if trans_b else (K, N), generator=g,
                    device=cuda).to(DTYPES[dt])
    kw = dict(out=dict(), accio=dict(acc_in_out=True),
              dual=dict(acc_in_out=True, out_dtype=torch.bfloat16))[mode]
    before = matmul.matmul.launches
    out = matmul.matmul(a, b, trans_b=trans_b, **kw)
    torch.cuda.synchronize()
    assert matmul.matmul.launches == before + 1
    assert out.shape == (M, N) and torch.isfinite(out).all()
    if K == 0:
        assert not out.any()
    check_all_close(out.float(), matmul.matmul_ref(a, b, trans_b=trans_b),
                    dtype=out.dtype, name=f"matmul K {K} {mode}",
                    **(F32 if out.dtype == torch.float32 else {}))


# (M, N, K) and the bf16 load path of matmul's kernel: NN takes A by TMA
# where K % 8 == 0 and B where N % 8 == 0; TN takes both by K % 8 (its B
# is (N, K)), so it is never mixed. One tile; M and N edges with a K tail
# past the last slab; A copied; B copied; both copied.
MATMUL_PATHS = {
    False: [((128, 128, 64), "tma"), ((200, 264, 1000), "tma"),
            ((96, 130, 256), "mixed"), ((70, 136, 100), "mixed"),
            ((130, 257, 300), "copy")],
    True: [((128, 128, 64), "tma"), ((200, 264, 1000), "tma"),
           ((70, 136, 100), "copy"), ((130, 257, 300), "copy")]}


def _matmul_paths():
    return dict(matmul.matmul.path_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["out", "accio", "dual"])
@pytest.mark.parametrize("trans_b,mnk,path", [
    (tb, mnk, path) for tb, cases in MATMUL_PATHS.items()
    for mnk, path in cases], ids=str)
def test_matmul_load_paths(cuda, trans_b, mnk, path, mode):
    """Each bf16 shape on the load path the launcher takes for each
    operand, counted once in matmul.path_launches by tma_operands' mirror
    of its rule, in every epilogue, against the plain version."""
    M, N, K = mnk
    g = torch.Generator(device=cuda).manual_seed(M + N + K)
    a = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    b = torch.randn((N, K) if trans_b else (K, N), generator=g,
                    device=cuda).to(torch.bfloat16)
    kw = dict(out=dict(), accio=dict(acc_in_out=True),
              dual=dict(acc_in_out=True, out_dtype=torch.bfloat16))[mode]
    before = _matmul_paths()
    out = matmul.matmul(a, b, trans_b=trans_b, **kw)
    torch.cuda.synchronize()
    want = dict(before)
    want[path] += 1
    assert _matmul_paths() == want
    check_all_close(out.float(), matmul.matmul_ref(a, b, trans_b=trans_b),
                    dtype=out.dtype, name=f"matmul {path} {mode}",
                    **(F32 if out.dtype == torch.float32 else {}))


def _padded(t, rows, cols):
    """t in the top-left corner of a (rows, cols) matrix of zeros."""
    out = t.new_zeros((rows, cols))
    out[:t.shape[0], :t.shape[1]] = t
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["out", "accio"])
@pytest.mark.parametrize("case", ["K 1001 NN", "K 1001 TN", "N 1001 NN"])
def test_matmul_copy_path_equals_tma_bit_for_bit(cuda, case, mode):
    """The producer's copy writes each slab in TMA's swizzled layout, with
    zeros past the matrix where TMA fills zeros, and the same wgmmas run:
    K 1001 (A copied, and a TN B) against the same operands padded with
    zero columns (and rows of an NN B) to K 1008 (both by TMA), and an NN
    B of N 1001 (copied) against it padded to N 1008, give the same bits
    (the first 1001 columns)."""
    M, N, K = (200, 264, 1001) if case.startswith("K") else (200, 1001, 256)
    trans_b = case.endswith("TN")
    g = torch.Generator(device=cuda).manual_seed(len(case))
    a = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    b = torch.randn((N, K) if trans_b else (K, N), generator=g,
                    device=cuda).to(torch.bfloat16)
    if case.startswith("K"):
        ap = _padded(a, M, 1008)
        bp = _padded(b, N, 1008) if trans_b else _padded(b, 1008, N)
    else:
        ap, bp = a, _padded(b, K, 1008)
    assert matmul.load_path(matmul.tma_operands(ap, bp)) == "tma"
    assert matmul.load_path(matmul.tma_operands(a, b)) != "tma"
    kw = dict(out=dict(), accio=dict(acc_in_out=True))[mode]
    before = _matmul_paths()
    out = matmul.matmul(a, b, trans_b=trans_b, **kw)
    ref = matmul.matmul(ap, bp, trans_b=trans_b, **kw)[:, :N]
    torch.cuda.synchronize()
    assert _matmul_paths()["tma"] == before["tma"] + 1
    assert torch.equal(out, ref)
    check_all_close(out.float(), matmul.matmul_ref(a, b, trans_b=trans_b),
                    dtype=out.dtype, name=f"matmul {case}",
                    **(F32 if out.dtype == torch.float32 else {}))


def _split_inputs(g, R, C, cuda):
    """Normals times 3 with split_tf32.SPECIALS (the values on each of
    the pass's paths) in the first elements."""
    x = torch.randn((R, C), generator=g, device=cuda) * 3
    bits = torch.tensor(split_tf32.SPECIALS, dtype=torch.int64).to(
        torch.int32)
    n = min(len(bits), x.numel())
    x.view(-1)[:n] = bits[:n].view(torch.float32).to(cuda)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("R,C", [(1, 1), (37, 130), (256, 64), (300, 517)])
def test_split_tf32_kernel_bit_for_bit(cuda, R, C, transpose):
    """The operand pass (csrc/split_tf32.cu) writes split_planes_ref's
    planes bit for bit, as they are or transposed, the padding zeros; on
    random values and on split_tf32.SPECIALS; one launch."""
    g = torch.Generator(device=cuda).manual_seed(R * C)
    x = _split_inputs(g, R, C, cuda)
    before = split_tf32.split_tf32.launches
    out = split_tf32.split_tf32(x, transpose=transpose)
    torch.cuda.synchronize()
    assert split_tf32.split_tf32.launches == before + 1
    ref = split_tf32.split_planes_ref(x, transpose)
    assert out.shape == ref.shape
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
def test_split_tf32_kernel_strided_source(cuda):
    """A source whose rows lie further apart than their length (a view of
    a wider matrix, as W's vocab chunk is) splits as its copy does."""
    g = torch.Generator(device=cuda).manual_seed(5)
    w = torch.randn((70, 300), generator=g, device=cuda)
    view = w[:, 40:137]
    for transpose in (False, True):
        assert torch.equal(split_tf32.split_tf32(view, transpose=transpose),
                           split_tf32.split_planes_ref(view.contiguous(),
                                                       transpose))


def _f64_errors(out, a, b, trans_b):
    """max |out - exact| for the kernel's out and for cuBLAS f32 (TF32
    off), against the f64 product of the same inputs."""
    exact = torch.matmul(a.double(), (b.T if trans_b else b).double())
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lib = torch.matmul(a, b.T if trans_b else b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return ((out.double() - exact).abs().max().item(),
            (lib.double() - exact).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("M,N,K", [(333, 517, 1000), (256, 512, 2048),
                                   (130, 300, 37), (128, 128, 8192),
                                   (64, 64, 16384)])
def test_matmul_f32_split_tf32_accuracy(cuda, M, N, K, trans_b):
    """The f32 tier (split-TF32 products; K split matmul_splits ways where
    the tiles are few: 4, 1, 1, 32, 32 here on an H100) against the f64
    product of the same inputs: at most SPLIT_GATE times cuBLAS f32's
    error (TF32 off), and within the split's bound of its plain model
    (matmul_split_ref: the same planes, f64 sums) plus the f32 sums'
    rounding (K f32 ulps of Σ|a b|, a loose bound); three launches: the
    two operand passes and the GEMM; a second call gives the same bits
    (the splits' partials meet in a fixed order)."""
    g = torch.Generator(device=cuda).manual_seed(M + N + K)
    a = torch.randn((M, K), generator=g, device=cuda) / K ** 0.5
    b = torch.randn((N, K) if trans_b else (K, N), generator=g, device=cuda)
    before = (matmul.matmul.launches, split_tf32.split_tf32.launches)
    out = matmul.matmul(a, b, trans_b=trans_b)
    torch.cuda.synchronize()
    assert (matmul.matmul.launches,
            split_tf32.split_tf32.launches) == (before[0] + 1, before[1] + 2)
    err, cublas = _f64_errors(out, a, b, trans_b)
    assert err <= split_tf32.SPLIT_GATE * cublas, (err, cublas)
    model = split_tf32.matmul_split_ref(a, b, trans_b=trans_b)
    terms = a.abs().double() @ (b.T if trans_b else b).abs().double()
    slack = (split_tf32.SPLIT_REL + K * 2.0 ** -24) * terms
    assert ((out.double() - model.double()).abs() <= 2 * slack).all()
    assert torch.equal(matmul.matmul(a, b, trans_b=trans_b), out)


# the grouped GEMM (#28 gmm, #29 tgmm): the CASES of
# tests/test_grouped_matmul.py:32-41 (T, K, N, sizes) and the five splits
# of tools/gmm_tune.py:136-142 (T 8192, E 8) at K 256 and an N that is no
# tile multiple
GMM_CASES = {
    "aligned": (256, 128, 128, [64, 64, 64, 64]),
    "mid_block": (256, 128, 128, [37, 91, 3, 125]),
    "empty": (256, 128, 128, [0, 200, 0, 56]),
    "E1": (256, 128, 128, [256]),
    "many_blocks": (512, 128, 128, [500, 7, 5]),
    "sum_lt_T": (256, 128, 128, [10, 20, 30, 40]),
    "empty_interleaved": (192, 256, 384, [64, 0, 65, 0, 63]),
    "one_block": (64, 128, 128, [8] * 8),
    **{f"split {name}": (8192, 256, 200, sizes) for name, sizes in {
        "balanced": [1024] * 8,
        "skewed_2x": [2048, 2048, 1024, 1024, 512, 512, 512, 512],
        "hot_expert": [4096, 1536, 1024, 512, 512, 256, 128, 128],
        "two_empty": [2048, 0, 2560, 2048, 0, 1024, 256, 256],
        "one_hot": [8192, 0, 0, 0, 0, 0, 0, 0]}.items()},
}


def _gmm_case(dev, dt, T, K, N, sizes, seed):
    """x (T, K), w (E, K, N) scaled so each product is of unit size, dy
    (T, N) scaled by the largest group's rows, and the int32 sizes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((T, K), generator=g, device=dev).to(DTYPES[dt])
    w = (torch.randn((len(sizes), K, N), generator=g, device=dev)
         / K ** 0.5).to(DTYPES[dt])
    dy = (torch.randn((T, N), generator=g, device=dev)
          / max(max(sizes), 1) ** 0.5).to(DTYPES[dt])
    return x, w, dy, torch.tensor(sizes, dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_gmm_and_tgmm_match_plain(cuda, case, dt):
    """#28 (NN and trans_w) and #29 against gmm_ref/tgmm_ref: the live
    rows at the tolerance of the dtype, zeros past sum(group_sizes) and in
    an empty group's slab, one launch each."""
    from tpukern_torch.ops import grouped_matmul as gm

    T, K, N, sizes = GMM_CASES[case]
    x, w, dy, gs = _gmm_case(cuda, dt, T, K, N, sizes, seed=len(case))
    live = sum(sizes)
    tol = F32 if dt == "f32" else {}
    before = gm.gmm.launches, gm.gmm.trans_w_launches, gm.tgmm.launches
    y = gm.gmm(x, w, gs)
    yt = gm.gmm(x, w.transpose(1, 2).contiguous(), gs, trans_w=True)
    dw = gm.tgmm(x, dy, gs)
    torch.cuda.synchronize()
    assert (gm.gmm.launches, gm.gmm.trans_w_launches,
            gm.tgmm.launches) == (before[0] + 2, before[1] + 1,
                                  before[2] + 1)
    ref = gm.gmm_ref(x, w, gs)
    for name, out in (("gmm", y), ("gmm trans_w", yt)):
        assert out.dtype == DTYPES[dt] and out.shape == (T, N)
        check_all_close(out[:live].float(), ref[:live], dtype=DTYPES[dt],
                        name=f"{name} {case}", **tol)
        assert not out[live:].any()
    check_all_close(dw.float(), gm.tgmm_ref(x, dy, gs), dtype=DTYPES[dt],
                    name=f"tgmm {case}", **tol)
    assert not dw[[e for e, s in enumerate(sizes) if s == 0]].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["mid_block", "empty_interleaved",
                                  "split hot_expert"])
def test_grouped_matmul_grads_match_plain(cuda, case, dt):
    """grouped_matmul's dx (#28 trans_w) and dw (#29) against autograd of
    gmm_ref on the card, with mixed output dtypes (f32 out_dtype on bf16
    inputs)."""
    from tpukern_torch.ops import grouped_matmul as gm

    T, K, N, sizes = GMM_CASES[case]
    x, w, dy, gs = _gmm_case(cuda, dt, T, K, N, sizes, seed=7)
    grads = []
    for fn in (gm.grouped_matmul, gm.gmm_ref):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(xg, wg, gs)
        grads.append(torch.autograd.grad(y, (xg, wg), dy.to(y.dtype)))
    (dx, dw), (rx, rw) = grads
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    tol = F32 if dt == "f32" else {}
    check_all_close(dx.float(), rx.float(), dtype=DTYPES[dt], name="dx",
                    **tol)
    check_all_close(dw.float(), rw.float(), dtype=DTYPES[dt], name="dw",
                    **tol)
    out = gm.gmm(x, w, gs, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    live = sum(sizes)
    check_all_close(out[:live], gm.gmm_ref(x, w, gs)[:live],
                    dtype=DTYPES[dt], **tol)


# tgmm's last slab of a group (fewer than 64 rows) has its other rows
# zeroed by the kernel: groups of 63, 65 and 1 rows starting off a
# 64-row boundary, one of 129 (two whole slabs and one row), then 14 rows
# past sum(group_sizes) holding NaN; x and dy by TMA (K 128, N 136) and
# both copied in every slab (K 130, N 201)
TGMM_TAIL_SIZES = [37, 63, 65, 1, 129, 20]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("K,N", [(128, 136), (130, 201)])
def test_tgmm_last_slabs_and_nan_rows(cuda, K, N, dt):
    """#29 with NaN in the x and dy rows past sum(group_sizes): every dW
    finite and equal to tgmm_ref; the next group's rows and the NaN rows
    never enter a group's last slab."""
    from tpukern_torch.ops import grouped_matmul as gm

    T = sum(TGMM_TAIL_SIZES) + 14
    x, _, dy, gs = _gmm_case(cuda, dt, T, K, N, TGMM_TAIL_SIZES, seed=K + N)
    x[-14:] = float("nan")
    dy[-14:] = float("nan")
    plan = gm.tgmm_slabs(x, dy, TGMM_TAIL_SIZES)
    if dt == "f32":  # 32-column slabs of the split planes from 16-byte
        # aligned columns, all by TMA
        assert {n for slabs in plan for _, n, _ in slabs} == {1, 3, 5, 20,
                                                              30, 31, 32}
        assert {p for slabs in plan for _, _, p in slabs} == {"tma"}
    else:
        assert {n for slabs in plan for _, n, _ in slabs} == {1, 20, 37, 63,
                                                              64}
        assert {p for slabs in plan for _, _, p in slabs} == (
            {"tma"} if K % 8 == 0 else {"copy"})
    dw = gm.tgmm(x, dy, gs)
    torch.cuda.synchronize()
    assert torch.isfinite(dw).all()
    check_all_close(dw.float(), gm.tgmm_ref(x, dy, gs), dtype=DTYPES[dt],
                    name="tgmm", **(F32 if dt == "f32" else {}))


def _grouped_f32_call(kind, x, w, dy, gs):
    """(#28/#29 f32 output, the gate's (a, b, tgmm) operands, its split
    model): kind "gmm", "gmm trans_w" (dy (T, N) times W[e]^T) or
    "tgmm"."""
    from tpukern_torch.ops import grouped_matmul as gm

    if kind == "tgmm":
        return (gm.tgmm(x, dy, gs), (x, dy, True),
                gm.tgmm_split_ref(x, dy, gs))
    if kind == "gmm trans_w":
        return (gm.gmm(dy, w, gs, trans_w=True),
                (dy, w.transpose(1, 2), False),
                gm.gmm_split_ref(dy, w, gs, trans_w=True))
    return gm.gmm(x, w, gs), (x, w, False), gm.gmm_split_ref(x, w, gs)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gmm", "gmm trans_w", "tgmm"])
@pytest.mark.parametrize("case", ["mid_block", "empty_interleaved",
                                  "split hot_expert", "split one_hot"])
def test_grouped_f32_gate(cuda, case, kind):
    """#28 (NN, trans_w) and #29 f32 on split-TF32 products: the largest
    error against the f64 grouped product at most SPLIT_GATE times the
    plain loop's (cuBLAS f32 a group, TF32 off); within the split's bound
    of the plain model (gmm_split_ref, tgmm_split_ref) plus the f32 sums'
    rounding (a slab's ulps of Σ|a b|, a loose bound); two operand passes
    and one kernel launch a call; a second call gives the same bits."""
    from tpukern_torch.harness import ops_bench
    from tpukern_torch.ops import grouped_matmul as gm
    from tpukern_torch.ops import split_tf32

    T, K, N, sizes = GMM_CASES[case]
    x, w, dy, gs = _gmm_case(cuda, "f32", T, K, N, sizes, seed=len(case))
    before = (gm.gmm.launches + gm.tgmm.launches,
              split_tf32.split_tf32.launches)
    out, (a, b, tg), model = _grouped_f32_call(kind, x, w, dy, gs)
    torch.cuda.synchronize()
    assert (gm.gmm.launches + gm.tgmm.launches,
            split_tf32.split_tf32.launches) == (before[0] + 1, before[1] + 2)
    ok, err, rule = ops_bench.split_gate(out, a, b, gs, tgmm=tg)
    assert ok, (err, rule)
    ref = gm.tgmm_ref if tg else gm.gmm_ref
    terms = ref(a.abs(), b.abs(), gs, dtype=torch.float64)
    depth = max(sizes) if tg else a.shape[1]
    slack = (split_tf32.SPLIT_REL + depth * 2.0 ** -24) * terms
    assert ((out.double() - model.double()).abs() <= 2 * slack).all()
    assert torch.equal(_grouped_f32_call(kind, x, w, dy, gs)[0], out)


# #28/#29 f32 at the edges, x and dy NaN past the groups: groups of 1,
# 127, 129 and 255 rows off a 128-row boundary and an empty one (gmm),
# last slabs of 5, 31, 1 and 20 tokens starting off a 32-token boundary
# (tgmm), K and N that leave every plane's rows padded (K 130, N 201) or
# not; W[e + 1] all NaN after a live group e (its own group empty)
@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(128, 136), (130, 201)])
def test_grouped_f32_nan_edges(cuda, K, N):
    """#28 f32 (NN and trans_w): exact zeros past the groups, the live
    rows finite and held to the gate; no element of W[e + 1] enters group
    e's rows. #29 f32: every dW finite (the last slab's columns past the
    group, the next group's tokens or NaN, zeroed in all four planes) and
    held to the gate, an empty group's slab zero."""
    from tpukern_torch.harness import ops_bench
    from tpukern_torch.ops import grouped_matmul as gm

    nan = float("nan")
    sizes, live = GMM_ITEM_SIZES, sum(GMM_ITEM_SIZES)
    x, w, dy, gs = _gmm_case(cuda, "f32", live + 20, K, N, sizes, seed=K)
    x[live:], dy[live:] = nan, nan
    for kind in ("gmm", "gmm trans_w"):
        out, (a, b, _), _ = _grouped_f32_call(kind, x, w, dy, gs)
        torch.cuda.synchronize()
        assert torch.equal(out[live:], torch.zeros_like(out[live:])), kind
        assert torch.isfinite(out).all(), kind
        assert ops_bench.split_gate(out[:live], a[:live], b, gs)[0], kind
    x, w, dy, gs = _gmm_case(cuda, "f32", 300, K, N, [100, 0, 160, 0],
                             seed=K + 1)
    w[1], w[3] = nan, nan
    for kind in ("gmm", "gmm trans_w"):
        out, (a, b, _), _ = _grouped_f32_call(kind, x, w, dy, gs)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all(), kind
    sizes = TGMM_TAIL_SIZES
    T = sum(sizes) + 14
    x, _, dy, gs = _gmm_case(cuda, "f32", T, K, N, sizes + [0], seed=N)
    x[-14:], dy[-14:] = nan, nan
    dw = gm.tgmm(x, dy, gs)
    torch.cuda.synchronize()
    assert torch.isfinite(dw).all() and not dw[-1].any()
    assert ops_bench.split_gate(dw, x, dy, gs, tgmm=True)[0]


# #28 bf16's work items: groups of 1, 127, 129 and 255 rows off a 128-row
# boundary, an empty group, rows past sum(group_sizes); (K, N) that put
# x and W on each load path, NN and trans_w (gm.gmm_items names them)
GMM_ITEM_SIZES = [1, 127, 129, 255, 37, 0, 300]
GMM_PATH_KN = {(128, 136): ("tma", "tma"), (130, 136): ("mixed", "copy"),
               (128, 130): ("mixed", "tma"), (130, 130): ("copy", "copy")}


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", sorted(GMM_PATH_KN))
def test_gmm_bf16_items_on_every_path(cuda, K, N):
    """#28 bf16, NN and trans_w, against gmm_ref at boundary-heavy sizes
    on every load path: the live rows at the bf16 tolerance, exact zeros
    past the groups (x holds NaN there), one launch each."""
    from tpukern_torch.ops import grouped_matmul as gm

    sizes = GMM_ITEM_SIZES
    T = sum(sizes) + 20
    x, w, _, gs = _gmm_case(cuda, "bf16", T, K, N, sizes, seed=K + N)
    x[sum(sizes):] = float("nan")
    wt = w.transpose(1, 2).contiguous()
    want = GMM_PATH_KN[(K, N)]
    for trans, ww, path in ((False, w, want[0]), (True, wt, want[1])):
        items = gm.gmm_items(x, ww, sizes, trans_w=trans)
        assert {p for e, _, _, p in items if e is not None} == {path}
        assert len(items) <= -(-T // 128) + len(sizes)
        before = gm.gmm.launches
        y = gm.gmm(x, ww, gs, trans_w=trans)
        torch.cuda.synchronize()
        assert gm.gmm.launches == before + 1
        live = sum(sizes)
        check_all_close(y[:live].float(), gm.gmm_ref(x, w, gs)[:live],
                        dtype=torch.bfloat16, name=f"{path} trans_w={trans}")
        assert torch.equal(y[live:], torch.zeros_like(y[live:]))


@pytest.mark.cuda
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("K", [130, 136])
def test_gmm_bf16_never_reads_the_next_expert(cuda, K, trans):
    """#28 bf16 with every W[e + 1] after a live group all NaN (its group
    empty): no element of W[e + 1] enters group e's sum, though K % 64 !=
    0 leaves the last slab short (W by TMA from the 3-D map at N 136,
    x by TMA at K 136 and copied at K 130)."""
    from tpukern_torch.ops import grouped_matmul as gm

    sizes = [100, 0, 160, 0]
    N, T = 136, 300
    x, w, _, gs = _gmm_case(cuda, "bf16", T, K, N, sizes, seed=K)
    w[1] = float("nan")
    w[3] = float("nan")
    ww = w.transpose(1, 2).contiguous() if trans else w
    y = gm.gmm(x, ww, gs, trans_w=trans)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    check_all_close(y[:260].float(), gm.gmm_ref(x, w, gs)[:260],
                    dtype=torch.bfloat16, name=f"K {K} trans_w={trans}")
    assert not y[260:].any()


@pytest.mark.cuda
def test_grouped_matmul_raises(cuda):
    from tpukern_torch.ops import grouped_matmul as gm

    x = torch.zeros(16, 8, device=cuda, dtype=torch.float16)
    w = torch.zeros(2, 8, 8, device=cuda, dtype=torch.float16)
    gs = torch.tensor([8, 8], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        gm.gmm(x, w, gs)
    with pytest.raises(ValueError, match="tensors on"):
        gm.gmm(x.float(), w.float(), gs.cpu())


# ---------------------------------------------------------------- the zoo:
# #30 (ew_call), #31 (sum_all / max_all), #32 (dot_prod), #16
# (matmul_naive) against their plain versions, at tail shapes, on
# misaligned views, in every dtype row; the reductions' 0-d results need
# no host sync
EW_SHAPES = [(256, 256), (63, 130), (1,), (7,), (1000, 33)]


def _zoo_close(out, ref, dtype, name):
    rtol, atol = ops_bench.TOLS[dtype]
    assert out.dtype == ref.dtype and out.shape == ref.shape, name
    check_all_close(out.float(), ref.float(), rtol=rtol, atol=atol,
                    name=name)


def _sm_close(out, ref, dtype, name, whole=False):
    """A softmax by ops_bench.softmax_check: TOLS[dtype] with atol scaled
    by each row's largest |ref|, and rows summing to 1."""
    assert out.dtype == ref.dtype and out.shape == ref.shape, name
    ok, err, rule = ops_bench.softmax_check(out, ref, dtype, whole)
    assert ok, f"{name}: max_abs {err:.3e} ({rule})"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EW_SHAPES, ids=str)
@pytest.mark.parametrize("tier", [t[0] for t in _ew.EW_TIERS])
@pytest.mark.parametrize("op", sorted(_ew.OPS))
def test_ew_kernel_matches_plain(cuda, op, tier, shape):
    _, dt, vec = next(t for t in _ew.EW_TIERS if t[0] == tier)
    g = torch.Generator(device=cuda).manual_seed(len(shape))
    xs = [torch.randn(shape, generator=g, device=cuda).to(dt)
          for _ in range(_ew.OPS[op][1])]
    before = _ew.ew_call.launches
    out = _ew.ew_call(op, *xs, vec=vec)
    torch.cuda.synchronize()
    assert _ew.ew_call.launches == before + 1
    _zoo_close(out, _ew.ew_ref(op, *xs), dt, f"{op} {tier}")
    if op in ("add", "mul", "relu"):  # one rounding of the f32 result
        assert torch.equal(out, _ew.ew_ref(op, *xs))


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["aligned", "misaligned"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", sorted(_ew.OPS))
def test_ew_tiers_agree_bit_for_bit(cuda, op, dt, view):
    """Every tier of a dtype computes each element by the same f32 formula,
    whatever its load width and packs a thread: all give the same bits, on
    2^18 + 5 elements (a tail in every tier) and on a view 2 elements off
    a 16-byte boundary; add, mul and relu also equal the plain version bit
    for bit, the others within the zoo's tolerance."""
    g = torch.Generator(device=cuda).manual_seed(11)
    n = 2 ** 18 + 5
    xs = [torch.randn(n + 2, generator=g, device=cuda).to(dt)
          for _ in range(_ew.OPS[op][1])]
    xs = [x[2:] if view == "misaligned" else x[:n] for x in xs]
    scalars = ()
    if op in ("exp_sub", "div"):  # softmax_global's scalar operand
        xs, scalars = xs[:1], (xs[0][:7].float().abs().sum() + 1,)
    ref = _ew.ew_ref(op, *xs, scalars=scalars)
    outs = [_ew.ew_call(op, *xs, scalars=scalars, vec=vec)
            for vec in _ew._VECS[dt]]
    torch.cuda.synchronize()
    for k, out in enumerate(outs):
        assert torch.equal(out, outs[0]), f"{op} {dt} call {k}"
    _zoo_close(outs[0], ref, dt, op)
    if op in ("add", "mul", "relu"):
        assert torch.equal(outs[0], ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_ew_misaligned_views_and_device_scalar(cuda, dt):
    """Views 4 bytes off a 16-byte boundary (copied before the 16-byte
    loads), and a scalar operand read from device memory with no host
    sync."""
    flat = torch.randn(2 * 8191 + 2, device=cuda).to(dt)
    x, y = flat[1:8192], flat[8193:]
    _zoo_close(_ew.ew_call("mul", x, y), _ew.ew_ref("mul", x, y), dt, "mul")
    s = flat[:1].float().sum()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = _ew.ew_call("add", x, scalars=(s,))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _zoo_close(out, _ew.ew_ref("add", x, scalars=(s,)), dt, "add scalar")


RED_SHAPES = [(300, 200), (63, 130), (1,), (17,), (4096, 4097)]


def _exact(shape, dt, g):
    """-1, -0.5, 0, 0.5, 1: sums exact in f32 (int8 truncates the
    halves)."""
    return (torch.randint(-2, 3, shape, generator=g, device=g.device)
            .float() * 0.5).to(dt)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RED_SHAPES, ids=str)
@pytest.mark.parametrize("row", reduce._SUM_VARIANTS + [
    ("max_" + s, i, a) for s, i, a in reduce._MAX_VARIANTS], ids=lambda r: r[0])
def test_reduce_kernel_matches_plain(cuda, row, shape):
    """Every row of the sum and max matrices: a 0-d result in the
    accumulator's dtype, equal to the plain version (exact sums), or for
    the bf16 accumulator to its plain version in the kernel's order
    (reduce.sum_bf16_in_order); the same result twice (bit for bit); no
    host sync."""
    sfx, in_dt, acc = row
    mode = "max" if sfx.startswith("max_") else "sum"
    x = _exact(shape, in_dt, torch.Generator(device=cuda).manual_seed(5))
    fn = reduce.max_all if mode == "max" else reduce.sum_all
    ref = (reduce.max_all_ref if mode == "max" else reduce.sum_all_ref)(
        x, acc)
    before = reduce._reduce_all.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(x, acc_dtype=acc)
        again = fn(x, acc_dtype=acc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert reduce._reduce_all.launches == before + 2
    assert out.shape == () and out.dtype == acc and out.is_cuda
    assert torch.equal(out, again)
    err = abs(out.double().item() - ref.double().item())
    if mode == "sum" and acc == torch.bfloat16:
        assert torch.equal(out, reduce.sum_bf16_in_order(x))
    else:
        assert err == 0, (sfx, out.item(), ref.item())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 5), (300, 200), (4096, 4097)],
                         ids=str)
def test_reduce_bf16_accumulator_in_kernel_order(cuda, shape):
    """Normal values, whose bf16 running sums round at almost every add:
    the kernel equals its plain version in the kernel's order bit for
    bit, also on a view 2 elements off a 16-byte boundary."""
    g = torch.Generator(device=cuda).manual_seed(11)
    n = shape[0] * shape[1]
    flat = (3 * torch.randn(n + 2, generator=g, device=cuda)).to(
        torch.bfloat16)
    for x in (flat[:n].reshape(shape), flat[2:].reshape(shape)):
        assert torch.equal(reduce.sum_all(x, acc_dtype=torch.bfloat16),
                           reduce.sum_bf16_in_order(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16])
def test_reduce_random_values_and_misaligned(cuda, dt):
    """Normal values (sums in another order: f32 within 1e-4 relative to
    the sum of |x|) and a view 2 elements off a 16-byte boundary."""
    flat = torch.randn(300 * 200 + 2, device=cuda).to(dt)
    x = flat[2:]
    scale = x.float().abs().sum().item()
    for fn, ref in ((reduce.sum_all, reduce.sum_all_ref),
                    (reduce.max_all, reduce.max_all_ref)):
        out, want = fn(x), ref(x)
        assert abs(out.item() - want.item()) <= 1e-4 * max(scale, 1.0)
    d = dot_product.dot_prod(x, flat[:-2])
    want = dot_product.dot_prod_ref(x, flat[:-2])
    assert abs(d.item() - want.item()) <= 1e-4 * max(
        (x.float() * flat[:-2].float()).abs().sum().item(), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RED_SHAPES, ids=str)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16])
def test_dot_kernel_matches_plain(cuda, dt, shape):
    g = torch.Generator(device=cuda).manual_seed(9)
    a, b = _exact(shape, dt, g), _exact(shape, dt, g)
    before = dot_product.dot_prod.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = dot_product.dot_prod(a, b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert dot_product.dot_prod.launches == before + 1
    assert out.shape == () and out.dtype == torch.float32
    assert out.item() == dot_product.dot_prod_ref(a, b).item()


@pytest.mark.cuda
def test_reduce_rejects_what_it_does_not_take(cuda):
    x = torch.ones(8, device=cuda)
    with pytest.raises(TypeError):
        reduce.sum_all(x, acc_dtype=torch.int32)
    with pytest.raises(TypeError):
        reduce.sum_all(x.to(torch.int8), acc_dtype=torch.float32)
    with pytest.raises(TypeError):
        dot_product.dot_prod(x.to(torch.float8_e4m3fn),
                             x.to(torch.float8_e4m3fn))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("M,N,K", [(77, 130, 45), (130, 257, 300), (1, 1, 1),
                                   (64, 80, 48), (33, 31, 4099)])
def test_matmul_naive_matches_plain(cuda, M, N, K, dt):
    """Shapes smaller than a tile or with an edge in every dimension: a K
    tail in the last 64-wide slab (K % 64 of 45, 44, 1, 48, 3); in bf16
    all but (64, 80, 48) have rows that TMA cannot take (K or N not a
    multiple of 8) and load both operands by the block's threads."""
    g = torch.Generator(device=cuda).manual_seed(M * N + K)
    a = torch.randn((M, K), generator=g, device=cuda).to(DTYPES[dt])
    b = torch.randn((K, N), generator=g, device=cuda).to(DTYPES[dt])
    before = matmul.matmul_naive.launches
    out = matmul.matmul_naive(a, b)
    torch.cuda.synchronize()
    assert matmul.matmul_naive.launches == before + 1
    _zoo_close(out, matmul.matmul_naive_ref(a, b), DTYPES[dt],
               "matmul_naive")


# (M, N, K) and the bf16 load path they take: both operands by TMA (one
# tile; whole tiles; an M edge, an N edge of a 128-wide tile and a K
# tail), A by TMA and B by the threads (N % 8 != 0), and the reverse
NAIVE_PATHS = [((128, 128, 64), "tma"), ((256, 384, 512), "tma"),
               ((200, 264, 1000), "tma"), ((96, 130, 256), "mixed"),
               ((70, 136, 100), "mixed"), ((130, 257, 300), "copy")]


def _path_launches():
    return dict(matmul.matmul_naive.path_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("mnk,path", NAIVE_PATHS, ids=str)
def test_matmul_naive_load_paths(cuda, mnk, path, dt):
    """Each shape on the path the launcher takes (bf16; f32 has one
    path), counted once in path_launches by tma_operands' mirror of its
    rule, against the plain version."""
    M, N, K = mnk
    g = torch.Generator(device=cuda).manual_seed(M + N + K)
    a = torch.randn((M, K), generator=g, device=cuda).to(DTYPES[dt])
    b = torch.randn((K, N), generator=g, device=cuda).to(DTYPES[dt])
    before = _path_launches()
    out = matmul.matmul_naive(a, b)
    torch.cuda.synchronize()
    want = dict(before)
    if dt == "bf16":
        want[path] += 1
    assert _path_launches() == want
    _zoo_close(out, matmul.matmul_naive_ref(a, b), DTYPES[dt],
               f"matmul_naive {path}")


def _misaligned(t):
    """t's values in a view 2 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    v = buf[1:].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("mnk", [(256, 384, 512), (200, 264, 1000)], ids=str)
def test_matmul_naive_paths_agree_bit_for_bit(cuda, mnk):
    """The threads' copy writes the slab in TMA's swizzled layout and the
    same wgmmas run, so the copy path (operands in misaligned views), the
    mixed paths and the TMA path give the same bits."""
    M, N, K = mnk
    g = torch.Generator(device=cuda).manual_seed(K)
    a = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    b = torch.randn((K, N), generator=g, device=cuda).to(torch.bfloat16)
    am, bm = _misaligned(a), _misaligned(b)
    assert matmul.tma_operands(a, b) == (True, True)
    assert matmul.tma_operands(am, bm) == (False, False)
    before = _path_launches()
    outs = [matmul.matmul_naive(x, y) for x, y in
            ((a, b), (am, bm), (a, bm), (am, b))]
    torch.cuda.synchronize()
    after = _path_launches()
    assert [after[k] - before[k] for k in ("tma", "copy", "mixed")] == [
        1, 1, 2]
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    _zoo_close(outs[0], matmul.matmul_naive_ref(a, b), torch.bfloat16,
               "matmul_naive")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rope_and_kpipe_launch_their_kernels(cuda, dt):
    """rope on rope_batched's kernel (seq_len = S), matmul_kpipe on
    matmul's: each counts its own launch and the kernel's."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((63, 130), generator=g, device=cuda).to(DTYPES[dt])
    r0, b0 = rope.rope.launches, rope.rope_batched.launches
    _zoo_close(rope.rope(x), rope.rope_ref(x), DTYPES[dt], "rope")
    assert (rope.rope.launches, rope.rope_batched.launches) == (r0 + 1,
                                                                b0 + 1)
    a = torch.randn((70, 90), generator=g, device=cuda).to(DTYPES[dt])
    k0, m0 = matmul.matmul_kpipe.launches, matmul.matmul.launches
    out = matmul.matmul_kpipe(a, a, trans_b=True)
    assert (matmul.matmul_kpipe.launches, matmul.matmul.launches) == (
        k0 + 1, m0 + 1)
    _zoo_close(out, matmul.matmul_ref(a, a, trans_b=True).to(a.dtype),
               DTYPES[dt], "matmul_kpipe")


@pytest.mark.cuda
@pytest.mark.parametrize("acc", [torch.float32, torch.bfloat16,
                                 torch.float16])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16])
def test_rms_norm_options_match_plain(cuda, dt, acc):
    """#4's zoo options: f16 rows, the accumulator dtype, scalar g."""
    g = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn((33, 200), generator=g, device=cuda).to(dt)
    for gain in (0.37, 1 + 0.1 * torch.randn(200, generator=g, device=cuda)):
        out = rmsnorm.rms_norm(x, gain, acc_dtype=acc)
        _zoo_close(out, rmsnorm.rms_norm_ref(x, gain, acc_dtype=acc), dt,
                   "rms_norm")


# ------------------------------------------------------------ softmax:
# #33 (softmax_per_token), #34 (online_softmax_per_token), #35/#36
# (grid_stats, grid_norm) against their plain versions in f32, bf16 and
# f16: rows of one warp ((100, 130), (3, 1), (33, 1024)) and of one block
# ((1, 4097), (5, 4096)), and rows wider than #33's shared-memory budget
# ((2, 70000) in f32; (4, 262144) in every dtype); each call twice, bit
# for bit
SM_SHAPES = [(100, 130), (3, 1), (33, 1024), (1, 4097), (5, 4096),
             (2, 70000), (4, 262144)]
SM_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _sm_input(shape, dt, dev):
    g = torch.Generator(device=dev).manual_seed(shape[0] * 7 + shape[1])
    return (3 * torch.randn(shape, generator=g, device=dev)).to(dt)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SM_SHAPES, ids=str)
@pytest.mark.parametrize("dt", SM_DTYPES, ids=str)
@pytest.mark.parametrize("fn", ["softmax_per_token",
                                "online_softmax_per_token"])
def test_softmax_per_token_matches_plain(cuda, fn, dt, shape):
    f = getattr(softmax, fn)
    x = _sm_input(shape, dt, cuda)
    before = f.launches
    out, again = f(x), f(x)
    torch.cuda.synchronize()
    assert f.launches == before + 2
    _sm_close(out, softmax.softmax_ref(x), dt, fn)
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("block_cols", [128, 512, 4096])
@pytest.mark.parametrize("shape", SM_SHAPES, ids=str)
@pytest.mark.parametrize("dt", SM_DTYPES, ids=str)
def test_softmax_grid_matches_plain(cuda, dt, shape, block_cols):
    """#35's partials (m exactly: a max; d within f32's tolerance), #36 on
    the kernel's partials, and online_softmax_grid against softmax_ref:
    one cluster launch (grid_fused, against grid_fused_ref too) where
    grid_plan gives the shape the cluster path, else #35 then #36 (bit
    for bit the two calls above)."""
    x = _sm_input(shape, dt, cuda)
    m, d = softmax.grid_stats(x, 64, block_cols)
    m_ref, d_ref = softmax.grid_stats_ref(x, block_cols)
    assert torch.equal(m, m_ref)
    _zoo_close(d, d_ref, torch.float32, "grid_stats d")
    y = softmax.grid_norm(x, m, d, 64, block_cols)
    _sm_close(y, softmax.grid_norm_ref(x, m, d), dt, "grid_norm")
    plan = softmax.grid_plan(*shape, 64, block_cols)
    n0 = (softmax.grid_fused.launches, softmax.grid_stats.launches,
          softmax.grid_norm.launches)
    out = softmax.online_softmax_grid(x, 64, block_cols)
    torch.cuda.synchronize()
    fused = plan.path == "cluster"
    assert (softmax.grid_fused.launches - n0[0],
            softmax.grid_stats.launches - n0[1],
            softmax.grid_norm.launches - n0[2]) == (
        (1, 0, 0) if fused else (0, 1, 1))
    if fused:
        _sm_close(out, softmax.grid_fused_ref(x, block_cols), dt,
                  "grid_fused")
    else:
        assert torch.equal(out, y)
    _sm_close(out, softmax.softmax_ref(x), dt, "online_softmax_grid")


# the cluster path: (rows, cols, block_cols) at 1, 3, 8, 9 and 16 tiles a
# row (above 8 the non-portable cluster size), odd columns (no whole
# 16-byte packs: 4001 and 4097 in any dtype, 1300 in 2-byte ones), a last
# row block of 1 row, and the bench shape
FUSED_SHAPES = [(300, 500, 512), (1000, 1300, 512), (129, 4001, 512),
                (33, 1536, 512), (129, 4097, 512), (100, 8192, 512),
                (4096, 4096, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FUSED_SHAPES, ids=str)
@pytest.mark.parametrize("dt", SM_DTYPES, ids=str)
def test_softmax_cluster_kernel(cuda, dt, shape):
    """grid_fused (#35 + #36 in one cluster launch) against its plain
    version grid_fused_ref, with a row of -inf (NaN where the plain
    version has NaN) and a row whose last tile (of several) is -inf; one
    launch a call, and a second call equal bit for bit."""
    rows, cols, bc = shape
    x = _sm_input((rows, cols), torch.float32, cuda)
    x[rows // 2] = -torch.inf
    if cols > bc:
        x[rows // 3, (cols - 1) // bc * bc:] = -torch.inf
    x = x.to(dt)
    assert softmax.grid_plan(rows, cols, 64, bc).path == "cluster"
    n0 = softmax.grid_fused.launches
    out, again = (softmax.online_softmax_grid(x, block_cols=bc)
                  for _ in range(2))
    torch.cuda.synchronize()
    assert softmax.grid_fused.launches == n0 + 2
    ref = softmax.grid_fused_ref(x, bc)
    assert torch.equal(out.isnan(), ref.isnan())
    assert int(out.isnan().any(-1).sum()) == 1
    keep = ~ref.isnan().any(-1)
    _sm_close(out[keep], ref[keep], dt, "grid_fused")
    assert torch.equal(out.nan_to_num(), again.nan_to_num())


# the cluster kernel's rows a block by the rule (8 KiB of x a tile, at
# most 32 rows), a warp a row up to 8: (cols, block_cols, dtype, rows a
# block), from 1 row (one warp) to 32 (8 warps of 4 rows), at 8 and 16
# tiles a row
CLUSTER_ROWS = [(16384, 2048, torch.float32, 1),
                (16384, 2048, torch.bfloat16, 2),
                (8192, 512, torch.float32, 4),
                (8192, 512, torch.bfloat16, 8),
                (2048, 128, torch.float32, 16),
                (2048, 128, torch.bfloat16, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CLUSTER_ROWS, ids=str)
def test_softmax_cluster_rows_a_block(cuda, case):
    """At each rows a block of the rule (so blocks of 1 to 8 warps) over
    100 rows (a partial last row block): grid_plan's rows a block is the
    C launcher's own (fused_plan), a block holds two tiles, a launch runs
    as many clusters as fit (at most one a row block), and the one launch
    is within the tolerance of grid_fused_ref and repeats bit for bit."""
    cols, bc, dt, R = case
    plan = softmax.grid_plan(100, cols, block_cols=bc, itemsize=dt.itemsize)
    assert (plan.path, plan.rows_a_block) == ("cluster", R)
    r, smem, active, launched = softmax.fused_plan(100, cols, dt, bc)
    assert r == R and active > 0 and smem >= 2 * R * bc * dt.itemsize
    assert launched == min(active, -(-100 // R))
    x = _sm_input((100, cols), dt, cuda)
    n0 = softmax.grid_fused.launches
    out, again = (softmax.online_softmax_grid(x, block_cols=bc)
                  for _ in range(2))
    torch.cuda.synchronize()
    assert softmax.grid_fused.launches == n0 + 2
    _sm_close(out, softmax.grid_fused_ref(x, bc), dt, f"grid_fused {R}")
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", SM_DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(4096, 4096), (100, 130), (129, 4001),
                                   (3, 1)], ids=str)
def test_softmax_cluster_plan_matches_launcher(cuda, dt, shape):
    """grid_plan's rows a block equals the C launcher's own (fused_plan),
    the cluster fits (cudaOccupancyMaxActiveClusters > 0), and a launch
    runs as many clusters as fit, at most one a row block."""
    plan = softmax.grid_plan(*shape, itemsize=dt.itemsize)
    R, smem, active, launched = softmax.fused_plan(*shape, dt)
    assert plan.path == "cluster" and R == plan.rows_a_block
    assert active > 0 and smem >= 2 * R * plan.block_cols * dt.itemsize
    assert launched == min(active, plan.blocks // plan.ncb)


@pytest.mark.cuda
def test_softmax_two_launch_path_above_the_cluster(cuda):
    """64 x 131072 at block_cols 512 is 256 tiles a row: #35 then #36, one
    launch each; grid_fused refuses the shape; the C launcher plans no
    cluster for it."""
    x = _sm_input((64, 131072), torch.float32, cuda)
    n0 = (softmax.grid_fused.launches, softmax.grid_stats.launches,
          softmax.grid_norm.launches)
    out = softmax.online_softmax_grid(x)
    torch.cuda.synchronize()
    assert (softmax.grid_fused.launches - n0[0],
            softmax.grid_stats.launches - n0[1],
            softmax.grid_norm.launches - n0[2]) == (0, 1, 1)
    _sm_close(out, softmax.softmax_ref(x), torch.float32, "two launches")
    with pytest.raises(ValueError, match="more than a cluster"):
        softmax.grid_fused(x)
    assert softmax.fused_plan(64, 131072, torch.float32)[0] == 0


@pytest.mark.cuda
def test_softmax_views_and_errors(cuda):
    """A view off a 16-byte boundary and a column slice (copied before the
    16-byte loads); the shapes and dtypes the kernels refuse."""
    x = _sm_input((64, 513), torch.float32, cuda)
    for v in (x[:, 1:], x.reshape(-1)[1:1 + 63 * 512].reshape(63, 512)):
        for fn in (softmax.softmax_per_token,
                   softmax.online_softmax_per_token,
                   softmax.online_softmax_grid):
            _sm_close(fn(v), softmax.softmax_ref(v), torch.float32,
                      fn.__name__)
    with pytest.raises(ValueError, match="2-D"):
        softmax.softmax_per_token(x.reshape(-1))
    with pytest.raises(TypeError):
        softmax.online_softmax_per_token(x.to(torch.float8_e4m3fn))
    with pytest.raises(ValueError, match="partials"):
        softmax.grid_norm(x, *softmax.grid_stats(x, 64, 512), 64, 128)


@pytest.mark.cuda
def test_softmax_global_launches_31_and_30_twice_without_sync(cuda):
    x = _sm_input((63, 130), torch.float32, cuda)
    r0, e0 = reduce._reduce_all.launches, _ew.ew_call.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = softmax.softmax_global(x)
        again = softmax.softmax_global(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (reduce._reduce_all.launches, _ew.ew_call.launches) == (r0 + 4,
                                                                   e0 + 4)
    _sm_close(out, softmax.softmax_global_ref(x), torch.float32,
              "softmax_global", whole=True)
    assert torch.equal(out, again)


# --------------------------------------------------------- layer_norm #37
# against layer_norm_plain (the kernel's one-pass function) in f32, bf16
# and f16, with an f32 and a bf16 accumulator: rows of one pack or less,
# tails ((5, 4097), (33, 200) in bf16), rows staged in shared memory and
# rows wider than its budget ((2, 70000) in f32, (4, 131072)); g and b
# as numbers, as vectors (f32, bf16, and one of each), and mixed; each
# call twice, bit for bit
LN_SHAPES = [(33, 200), (3, 1), (17, 48), (64, 4096), (5, 4097), (2, 70000),
             (4, 131072)]


def _ln_input(shape, dt, dev):
    g = torch.Generator(device=dev).manual_seed(shape[0] * 5 + shape[1])
    return torch.randn(shape, generator=g, device=dev).to(dt)


def _ln_affines(K, dev):
    g = torch.Generator(device=dev).manual_seed(K)
    gv = 1 + 0.1 * torch.randn(K, generator=g, device=dev)
    bv = 0.1 * torch.randn(K, generator=g, device=dev)
    return {"one": (1.0, 0.0), "scalars": (1.5, 0.3), "vectors": (gv, bv),
            "bf16_vectors": (gv.bfloat16(), bv.bfloat16()),
            "mixed_dtypes": (gv, bv.bfloat16()), "vector_g": (gv, 0.3),
            "vector_b": (1.5, bv)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LN_SHAPES, ids=str)
@pytest.mark.parametrize("acc", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("dt", SM_DTYPES, ids=str)
def test_layer_norm_matches_plain(cuda, dt, acc, shape):
    x = _ln_input(shape, dt, cuda)
    tol_dt = torch.bfloat16 if torch.bfloat16 in (dt, acc) else dt
    for name, (g, b) in _ln_affines(shape[1], cuda).items():
        before = layernorm.layer_norm.launches
        out = layernorm.layer_norm(x, g, b, acc_dtype=acc)
        again = layernorm.layer_norm(x, g, b, acc_dtype=acc)
        torch.cuda.synchronize()
        assert layernorm.layer_norm.launches == before + 2
        _zoo_close(out, layernorm.layer_norm_plain(x, g, b, acc_dtype=acc),
                   tol_dt, f"layer_norm {name}")
        assert torch.equal(out, again)


@pytest.mark.cuda
def test_layer_norm_views_batch_dims_and_errors(cuda):
    """A column slice and a view off a 16-byte boundary (copied before the
    16-byte loads), a 3-D input, no host sync; the arguments the kernel
    refuses."""
    x = _ln_input((64, 513), torch.float32, cuda)
    for v in (x[:, 1:], x.reshape(-1)[1:1 + 63 * 512].reshape(63, 512),
              x[:, :512].reshape(8, 8, 512)):
        _zoo_close(layernorm.layer_norm(v, 1.5, 0.3),
                   layernorm.layer_norm_plain(v, 1.5, 0.3), torch.float32,
                   "layer_norm view")
    g = torch.ones(513, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        layernorm.layer_norm(x, g, 0.5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    with pytest.raises(ValueError, match="shape"):
        layernorm.layer_norm(x, torch.ones(512, device=cuda))
    with pytest.raises(TypeError):
        layernorm.layer_norm(x.to(torch.float8_e4m3fn))
    with pytest.raises(TypeError):
        layernorm.layer_norm(x, g.half())


@pytest.mark.cuda
def test_layer_norm_one_pass_variance_on_the_card(cuda):
    """Rows of 16 values from 299, 299.5, ..., 301 (mean 300, spread
    about 0.7), whose sums and sums of squares are exact in f32 in any
    order: the kernel equals its plain version, the one-pass function of
    JAX's kernel, which mean^2's rounding moves 1e-2 away from the
    two-pass reference."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x = 300 + 0.5 * torch.randint(-2, 3, (64, 16), generator=g,
                                  device=cuda).float()
    out = layernorm.layer_norm(x)
    _zoo_close(out, layernorm.layer_norm_plain(x), torch.float32,
               "layer_norm at mean 300")
    assert (out - layernorm.layer_norm_ref(x)).abs().max().item() > 1e-3


# ----------------------------------------------- embedding #38, #39, #40
# every gather bit-equal to its plain version (f32, bf16 and f16 tables
# for #38/#39, f32 and bf16 for #40): rows of whole 16-byte chunks and
# rows of none (D 130, 509, 1 in 2-byte types), an odd vocabulary, #39 at
# several block_tokens (and a row wider than its shared buffer, copied a
# chunk at a time), #40 with tails in both tile dims; indices outside
# [0, V) as int32 and int64, with no host sync
EMB_CASES = [(37, 130, 24), (1000, 509, 64), (5, 1, 8), (300, 512, 136),
             (32767, 64, 40)]
EMB_FNS = {"prefetch": embedding.embedding_prefetch,
           "dma": embedding.embedding_dma,
           "onehot": embedding.embedding_onehot}
EMB_PLAIN = {"prefetch": embedding.embedding_prefetch_plain,
             "dma": embedding.embedding_dma_plain,
             "onehot": embedding.embedding_onehot_plain}
# the tables each design takes: #40 f32 and bf16, as the registry's
# variants
EMB_KINDS = [(k, dt) for k in sorted(EMB_FNS) for dt in SM_DTYPES
             if k != "onehot" or dt != torch.float16]


def _emb_input(V, D, S, dt, dev):
    g = torch.Generator(device=dev).manual_seed(V + D + S)
    idx = torch.randint(0, V, (S,), generator=g, device=dev,
                        dtype=torch.int32)
    # indices outside [0, V): past the end, -1, -V, -V - 1, int32's ends
    far = torch.tensor([V, V + 7, -1, -V, -V - 1, 2 ** 31 - 1, -2 ** 31],
                       dtype=torch.int32, device=dev)
    idx[::5][:far.numel()] = far[:idx[::5].numel()]
    return idx, torch.randn((V, D), generator=g, device=dev).to(dt)


@pytest.mark.cuda
@pytest.mark.parametrize("case", EMB_CASES, ids=str)
@pytest.mark.parametrize("kind,dt", EMB_KINDS, ids=str)
def test_embedding_matches_plain(cuda, kind, dt, case):
    fn, plain = EMB_FNS[kind], EMB_PLAIN[kind]
    idx, w = _emb_input(*case, dt, cuda)
    before = fn.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(idx, w)
        out64 = fn(idx.long(), w)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fn.launches == before + 2
    ref = plain(idx, w)
    assert out.dtype == w.dtype and out.shape == (case[2], case[1])
    assert torch.equal(out, ref) and torch.equal(out64, ref)
    inside = (idx >= 0) & (idx < case[0])
    assert torch.equal(out[inside], w[idx[inside].long()])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("V,D,S", [(1024, 512, 1000), (32768, 512, 8195),
                                   (32768, 509, 37)], ids=str)
def test_embedding_onehot_selects_rows(cuda, V, D, S, dt):
    """#40 at the bench's vocabulary and at 32768, S no multiple of the
    block's 16 tokens, indices -1, V, -2^31 and 2^31 - 1 among them: the
    table's row or zeros, bit-equal to the plain version; D 509 takes
    the element path. -0.0 entries come back as -0.0."""
    g = torch.Generator(device=cuda).manual_seed(V + S)
    idx = torch.randint(0, V, (S,), generator=g, device=cuda,
                        dtype=torch.int32)
    far = torch.tensor([-1, V, -2 ** 31, 2 ** 31 - 1], dtype=torch.int32,
                       device=cuda)
    idx[::9][:far.numel()] = far[:idx[::9].numel()]
    w = torch.randn((V, D), generator=g, device=cuda).to(dt)
    w[idx[1].long(), :7] = -0.0
    before = embedding.embedding_onehot.launches
    out = embedding.embedding_onehot(idx, w)
    torch.cuda.synchronize()
    assert embedding.embedding_onehot.launches == before + 1
    bits = torch.int16 if dt == torch.bfloat16 else torch.int32
    ref = embedding.embedding_onehot_plain(idx, w)
    assert torch.equal(out.view(bits), ref.view(bits))
    assert torch.equal(out[1, :7].view(bits), w[idx[1].long(), :7].view(bits))
    outside = (idx < 0) | (idx >= V)
    assert outside.sum().item() == min(4, len(range(0, S, 9)))
    assert not out[outside].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("bt,V,D,S", [(1, 100, 48, 7), (8, 1000, 8192, 16),
                                      (64, 500, 136, 128),
                                      (1024, 300, 512, 2048)])
def test_embedding_dma_block_tokens(cuda, bt, V, D, S, dt):
    """block_tokens 1 to 1024; (8, D 8192 f32): a row of 2048 chunks
    wider than the buffer (320 chunks a row a pass), copied in passes."""
    idx, w = _emb_input(V, D, S, dt, cuda)
    assert torch.equal(embedding.embedding_dma(idx, w, bt),
                       embedding.embedding_dma_plain(idx, w, bt))


@pytest.mark.cuda
def test_embedding_views_and_errors(cuda):
    """A table view 4 bytes off a 16-byte boundary (the element-wise
    paths) and a strided index; the shapes and dtypes the kernels
    refuse."""
    idx, w = _emb_input(300, 65, 64, torch.float32, cuda)
    wv = w.reshape(-1)[1:1 + 300 * 64].reshape(300, 64)
    for kind, fn in EMB_FNS.items():
        assert torch.equal(fn(idx[::2], wv), EMB_PLAIN[kind](idx[::2], wv))
    for kind, fn in EMB_FNS.items():  # no tokens
        assert fn(idx[:0], w).shape == (0, 65)
    assert layernorm.layer_norm(w[:0]).shape == (0, 65)
    with pytest.raises(ValueError, match="block size"):
        embedding.embedding_dma(idx[:63], w)
    with pytest.raises(ValueError, match="at most"):
        embedding.embedding_dma(idx.repeat(32), w, 2048)
    with pytest.raises(TypeError):
        embedding.embedding_onehot(idx, w.half())
    with pytest.raises(TypeError):
        embedding.embedding_prefetch(idx.float(), w)
    with pytest.raises(ValueError, match="idx"):
        embedding.embedding_prefetch(idx[None], w)


# ------------------------------- histogram #41, transpose #42, nms #43,
# gemv #44
# transpose bit-equal to x.T in both dtypes, all three orders and four
# super-tiles: the zoo's tail (a ragged tile edge both ways), rows of
# whole tiles, a 1 x 1 matrix, odd widths (bf16 rows of no whole words)
TR_SHAPES = [(4095, 4097), (384, 256), (1, 1), (63, 130), (129, 65)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TR_SHAPES, ids=str)
@pytest.mark.parametrize("block", [(128, 128), (256, 256), (512, 512),
                                   (64, 192)], ids=str)
@pytest.mark.parametrize("order", ["row", "col", "diag"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=str)
def test_transpose_matches_plain(cuda, dt, order, block, shape):
    g = torch.Generator(device=cuda).manual_seed(shape[0] + shape[1])
    x = torch.randn(shape, generator=g, device=cuda).to(dt)
    before = transpose.transpose.launches
    out = transpose.transpose(x, block, order)
    torch.cuda.synchronize()
    assert transpose.transpose.launches == before + 1
    assert out.shape == shape[::-1] and out.dtype == dt
    assert torch.equal(out, transpose.transpose_plain(x, block, order))
    assert torch.equal(out, x.T)


@pytest.mark.cuda
def test_transpose_views_and_errors(cuda):
    """A bf16 matrix 2 bytes off a 4-byte boundary (the element-wise
    reads), a transposed view (made contiguous), an empty matrix; the
    dtypes and blocks the kernel refuses."""
    g = torch.Generator(device=cuda).manual_seed(0)
    flat = torch.randn(300 * 64 + 1, generator=g, device=cuda)
    for dt in (torch.float32, torch.bfloat16):
        xv = flat.to(dt)[1:].reshape(300, 64)
        assert torch.equal(transpose.transpose(xv), xv.T)
        assert torch.equal(transpose.transpose(xv.T), xv)
    assert transpose.transpose(flat[:0].reshape(0, 5)).shape == (5, 0)
    with pytest.raises(TypeError):
        transpose.transpose(flat[:64].reshape(8, 8).half())
    with pytest.raises(ValueError):
        transpose.transpose(flat[:64].reshape(8, 8), block=(32, 32))


# (values, bins, lo, hi): values uniform in [lo, hi); the zoo's odd case
# (2^20 - 1 values, 1000 bins, -5 to 1005), bench/ops.py's, a tail of
# every load width, one bin, and more bins than shared memory holds (the
# global-atomic path)
HIST_CASES = [(2 ** 20 - 1, 1000, -5, 1005), (2 ** 20, 256, 0, 256),
              (4097, 7, -3, 12), (1, 1, 0, 1), (300001, 60000, -10, 60010)]


@pytest.mark.cuda
@pytest.mark.parametrize("block_rows", [8, 32, 128])
@pytest.mark.parametrize("case", HIST_CASES, ids=str)
def test_histogram_matches_plain(cuda, case, block_rows):
    n, bins, lo, hi = case
    g = torch.Generator(device=cuda).manual_seed(n + bins)
    x = torch.randint(lo, hi, (n,), generator=g, device=cuda,
                      dtype=torch.int32)
    before = histogram.histogram.launches
    out = histogram.histogram(x, bins, block_rows)
    torch.cuda.synchronize()
    assert histogram.histogram.launches == before + 1
    assert out.dtype == torch.int32 and out.shape == (bins,)
    assert torch.equal(out, histogram.histogram_plain(x, bins))
    assert torch.equal(out, histogram.histogram_sorted(x, bins))


@pytest.mark.cuda
@pytest.mark.parametrize("share", [1.0, 0.5])
def test_histogram_hot_bin(cuda, share):
    """Every value (or half of them) in bin 3: the warps' equal values
    aggregated before their atomics, counts exact."""
    g = torch.Generator(device=cuda).manual_seed(1)
    n = 2 ** 20 + 3
    x = torch.randint(0, 256, (n,), generator=g, device=cuda,
                      dtype=torch.int32)
    x[torch.rand(n, generator=g, device=cuda) < share] = 3
    out = histogram.histogram(x, 256)
    assert torch.equal(out, histogram.histogram_plain(x, 256))
    assert out[3].item() >= share * n * 0.99 and out.sum().item() == n


@pytest.mark.cuda
def test_histogram_int64_views_and_no_host_sync(cuda):
    """int64 values narrowed on the card (no host read), a 2-D input, a
    strided view and one 4 bytes off a 16-byte boundary."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randint(-3, 70, (64, 65), generator=g, device=cuda)
    x[0, :4] += 2 ** 32
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = histogram.histogram(x, 64)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(out, histogram.histogram_plain(x, 64))
    for xv in (x.to(torch.int32)[:, ::2], x.to(torch.int32).reshape(-1)[1:]):
        assert torch.equal(histogram.histogram(xv, 64),
                           histogram.histogram_plain(xv, 64))


def _nms_case(n, dev):
    g = torch.Generator(device=dev).manual_seed(n)
    return ops_bench.nms_boxes(n, g, exact_pairs=n // 10 if n >= 100 else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000, 4000])
def test_nms_matches_plain(cuda, n):
    """Kept indices equal; from 1000 boxes on a tenth of them are pairs at
    an IoU of exactly 0.5, whose second box only the strict > keeps."""
    boxes, scores = _nms_case(n, cuda)
    before = nms.nms_keep.launches
    out = nms.nms(boxes, scores)
    torch.cuda.synchronize()
    assert nms.nms_keep.launches == before + 1
    assert out.dtype == torch.int32 and out.shape == (n,)
    assert torch.equal(out, nms.nms_plain(boxes, scores))
    if n >= 100:
        pairs = n // 10
        kept = set(out.tolist())
        assert set(range(n - pairs, n)) <= kept


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [0.0, 0.3, 0.7, 1.0])
def test_nms_keep_thresholds(cuda, thr):
    boxes, scores = _nms_case(1000, cuda)
    order = torch.argsort(-scores, stable=True)
    assert torch.equal(nms.nms_keep(boxes[order], thr),
                       nms.nms_keep_plain(boxes[order], thr))


GEMV_NAMES = sorted(registry.variants("gemv"))
# the zoo's tail (a K tail in every block_k), test_matmul's shape, short
# rows (teams of 4-16 lanes), a 1 x 1 product
GEMV_CASES = [(4095, 4097), (300, 1024), (33, 48), (17, 7), (1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GEMV_CASES, ids=str)
@pytest.mark.parametrize("name", GEMV_NAMES)
def test_gemv_matches_plain(cuda, name, case):
    """Each variant against its plain version by ops_bench.check (TOLS of
    its dtype plus the contraction slack)."""
    g = torch.Generator(device=cuda).manual_seed(case[0] + case[1])
    v = registry.get("gemv", name)
    args = (torch.randn(case, generator=g, device=cuda),
            torch.randn(case[1], generator=g, device=cuda))
    before = gemv.gemv.launches
    ok, err, rule = ops_bench.check(v, args)
    torch.cuda.synchronize()
    assert gemv.gemv.launches == before + 1
    assert ok, f"{name} {case}: {rule} missed ({err:.3e})"


def _tf32(t):
    # round to nearest on TF32's 10 mantissa bits, as a TF32 mma reads
    bits = t.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.cuda
def test_gemv_mxu_f32_holds_the_f32_row(cuda):
    """f32 `mxu` on CUDA-core FMAs: within TOLS's f32 row plus the
    contraction slack at M 768, K 1024, where a product of TF32-rounded
    inputs misses that rule."""
    g = torch.Generator(device=cuda).manual_seed(3)
    v = registry.get("gemv", "gemv_f32_mxu")
    A = torch.randn(768, 1024, generator=g, device=cuda)
    x = torch.randn(1024, generator=g, device=cuda)
    ok, err, rule = ops_bench.check(v, (A, x))
    assert ok, f"{rule} missed ({err:.3e})"
    tf32 = dataclasses.replace(v, fn=lambda A, x: v.ref(_tf32(A), _tf32(x)))
    assert not ops_bench.check(tf32, (A, x))[0]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["vpu", "mxu"])
@pytest.mark.parametrize("dt", SM_DTYPES, ids=str)
@pytest.mark.parametrize("block_k", [None, 7, 96, 512, 5000])
def test_gemv_options_and_views(cuda, block_k, dt, mode):
    """block_k of no whole pack (7) and of no whole mma chunk (96), beyond
    K; A a view 2 elements off a 16-byte boundary (the element-wise
    loads)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    flat = torch.randn(257 * 1000 + 2, generator=g, device=cuda).to(dt)
    A = flat[2:].reshape(257, 1000)
    x = torch.randn(1000, generator=g, device=cuda).to(dt)
    for a in (A, A.contiguous()):
        out = gemv.gemv(a, x, block_k=block_k, mode=mode)
        ref = gemv.gemv_plain(a, x, block_k=block_k, mode=mode)
        lim = (1e-4 + 1e-4 * ref.abs()
               + 2 * 1000 ** 0.5 * 2.0 ** -24 * (a.float().abs()
                                                 @ x.float().abs()))
        assert ((out - ref).abs() <= lim).all(), (block_k, dt, mode)
    with pytest.raises(TypeError):
        gemv.gemv(A, x.float() if dt != torch.float32 else x.half())


RING_FNS = ["ring_all_gather", "ring_reduce_scatter", "ring_all_reduce_grads"]
RING_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _ring_input(fn, n, shape, dt, dev, seed=None):
    """tests/test_parallel.py's shapes ((64, 128) and (n, 64, 128); 66 rows
    where n does not divide 64), a ragged chunk of 37 x 5 elements (no
    16-byte unit), or a large one: more tiles than blocks a rank."""
    rows, cols = {"jax": ((64 if 64 % n == 0 else 66), 128),
                  "ragged": (37 * n, 5),
                  "large": (n * (1 << 20) // 8 * 3, 8)}[shape]
    full = (rows, cols) if fn == "ring_all_gather" else (n, rows, cols)
    g = torch.Generator(device=dev).manual_seed(n if seed is None else seed)
    return torch.randn(full, generator=g, device=dev).to(dt)


def _ring_counts():
    return (ring_kernels.ring_all_gather.launches,
            ring_kernels.ring_reduce_scatter.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["jax", "ragged"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dt", RING_DTYPES, ids=str)
@pytest.mark.parametrize("fn", RING_FNS)
def test_ring_matches_plain(cuda, fn, dt, n, shape):
    """#45, #46 and their composition equal the plain ring walk bit for
    bit in every rank's buffer, on x, another x' and x again: the later
    calls run on the flags and slots the earlier ones left (the epochs),
    and one that read a slot before its data arrived would return an
    earlier call's data."""
    xs = [_ring_input(fn, n, shape, dt, cuda, seed) for seed in (n, n + 99)]
    mesh = Mesh.on_device(n)
    wants = [getattr(ring_kernels, fn + "_plain")(x, mesh, ranks=True)
             for x in xs]
    before = _ring_counts()
    outs = [getattr(ring_kernels, fn)(xs[i], mesh, ranks=True)
            for i in (0, 1, 0)]
    torch.cuda.synchronize()
    ag, rs = (a - b for a, b in zip(_ring_counts(), before))
    assert (ag, rs) == {"ring_all_gather": (3, 0),
                        "ring_reduce_scatter": (0, 3),
                        "ring_all_reduce_grads": (3, 3)}[fn]
    for out, i in zip(outs, (0, 1, 0)):
        assert out.dtype == dt and out.shape == wants[i].shape
        assert torch.equal(out, wants[i])
    x, want = xs[0], wants[0]
    glob = getattr(ring_kernels, fn)(x, mesh)
    assert torch.equal(glob, want[0] if fn != "ring_reduce_scatter"
                       else want.reshape(glob.shape))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=str)
def test_ring_large_chunks(cuda, dt, n):
    """Chunks of more tiles than a rank has blocks: each block sends many
    messages through its two slots, waiting on the receiver's done count
    before it refills one."""
    mesh = Mesh.on_device(n)
    for fn in ("ring_reduce_scatter", "ring_all_gather"):
        for seed in (1, 2, 1):
            x = _ring_input(fn, n, "large", dt, cuda, seed)
            out = getattr(ring_kernels, fn)(x, mesh, ranks=True)
            assert torch.equal(out, getattr(ring_kernels, fn + "_plain")(
                x, mesh, ranks=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.uint8, torch.int16, torch.int32,
                                torch.float64, torch.bool], ids=str)
def test_ring_all_gather_any_dtype(cuda, dt):
    """#45 copies bytes: 16-byte units where the chunk and the buffers
    allow, else 8, 4, 2 or 1; a view off a 16-byte boundary too."""
    g = torch.Generator(device=cuda).manual_seed(5)
    for rows, cols in ((64, 16), (21, 3), (9, 1)):
        flat = torch.randint(0, 2 if dt == torch.bool else 100,
                             (3 * rows * cols + 1,), generator=g,
                             device=cuda).to(dt)
        for x in (flat[:-1].reshape(3 * rows, cols),
                  flat[1:].reshape(3 * rows, cols)):
            mesh = Mesh.on_device(3)
            out = ring_kernels.ring_all_gather(x, mesh, ranks=True)
            assert torch.equal(out, x.expand(3, -1, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", RING_DTYPES, ids=str)
def test_ring_reduce_scatter_views_and_errors(cuda, dt):
    """x a view 2 elements off a 16-byte boundary (the scalar path); an
    int dtype raises; the plain version on the card is the same walk."""
    g = torch.Generator(device=cuda).manual_seed(6)
    flat = torch.randn(4 * 64 * 8 + 2, generator=g, device=cuda).to(dt)
    x = flat[2:].reshape(4, 64, 8)
    mesh = Mesh.on_device(4)
    assert torch.equal(ring_kernels.ring_reduce_scatter(x, mesh),
                       ring_kernels.ring_reduce_scatter_plain(x, mesh))
    with pytest.raises(TypeError):
        ring_kernels.ring_reduce_scatter(x.to(torch.int32), mesh)
    with pytest.raises(ValueError):
        ring_kernels.ring_reduce_scatter(x[:3], mesh)


@pytest.mark.cuda
def test_ring_no_host_sync(cuda):
    x = _ring_input("ring_all_reduce_grads", 8, "jax", torch.bfloat16, cuda)
    mesh = Mesh.on_device(8)
    want = ring_kernels.ring_all_reduce_grads_plain(x, mesh)
    ring_kernels.ring_all_reduce_grads(x, mesh)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ring_kernels.ring_all_reduce_grads(x, mesh)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(out, want)
