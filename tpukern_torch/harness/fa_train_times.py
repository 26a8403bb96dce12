"""Times and accuracy of the training path's flash attention (#6, #8,
and with --featured the two-kernel backward #9/#10).

    python -m tpukern_torch.harness.fa_train_times [label]
    python -m tpukern_torch.harness.fa_train_times [label] --featured
    python -m tpukern_torch.harness.fa_train_times [label] --digests
    python -m tpukern_torch.harness.fa_train_times [label] --featured-bf16

At the 7bish training heads (B 2, Hq 16, Hkv 8, S 1024, D 128, causal)
prints the card's name and power limit, then one line per call: the
device time (the profiler's, 10 calls), the CUDA events time of
back-to-back calls (run_benchmark) and the bounds:

- the forward in f32 as the training step calls it (return_stats=True),
  its plain version (attention_ref) and F.scaled_dot_product_attention
  (is_causal, enable_gqa) on the same inputs; bounds: the visible pairs'
  4 D flops on the f32 FMAs (67 TFLOP/s) and as split-TF32 products (3
  TF32 products a product at 495 TFLOP/s);
- the fused backward in f32 and bf16: flash_attention_bwd on K and V
  repeated to 16 heads (the kernel alone, as chip_smoke.py times it),
  the trainable's backward on the 8 KV heads (what a training step runs,
  the GQA handling included), the plain version, and the autograd
  backward of F.scaled_dot_product_attention(enable_gqa=True); bounds:
  10 D flops a visible pair;
- the accuracy gate of the f32 tier: the largest |error| of o, lse, dq,
  dk and dv against an f64 evaluation of the same inputs, for the kernel
  and for the plain version in f32 (cuBLAS with TF32 off), and their
  ratio (ops/split_tf32.py SPLIT_GATE is the limit), at the training
  shape and at two tail shapes; and the bf16 tier's gate (dq, dk, dv of
  the kernel and of flash_attention_bwd_bf16_ref against f64, where the
  tree has that plain version) at the same shapes.

--featured: at the same heads with the featured training masks (window
512, with and without softcap 50), one line per call as above: #9
(flash_attention_dq) and #10 (flash_attention_dkv) alone on the KV heads
the step uses (on a tree without GQA in them, K and V repeated to 16
heads outside the call, as its step does), the trainable's featured
backward on the 8 KV heads (the GQA handling counted), the plain
versions, and the library call (the autograd backward of compiled
flex_attention with the softcap, of SDPA with a boolean band mask
without); bounds: 3 and 4 D-deep products over the band's visible pairs;
then the f64 gate of the f32 tier (featured_gate_rows) at the training
shape with and without the softcap and at FEATURED_TAILS for every
feature set, with a second call's bits.

--digests: sha256 of the fused backward #8's dk and dv (f32 and bf16) at
DIGEST_SHAPES on seeded inputs, to hold two trees' bits equal.

--featured-bf16: #9 and #10 in bf16 (their CUDA-core FMA kernels, GQA
inside) at the --featured heads and masks, the plain versions and the
library call (the autograd backward of SDPA in bf16 with a boolean band
mask and enable_gqa: dq, dk, dv; the softcap has no SDPA form, so the
same call stands beside both mask sets); bounds: the same products at
the tensor cores' bf16 rate; then each kernel's largest error against
the f64 backward beside its plain version's.

To compare two versions on one card, run it in one command from each
tree's own root (`python -m` puts the working directory first on the
path), the trees in turns. Needs a CUDA device.
"""

import hashlib
import math
import subprocess
import sys
from functools import partial

import torch
import torch.nn.functional as F

from tpukern_torch.harness.bench import run_benchmark
from tpukern_torch.harness.decode_times import _device_ms
from tpukern_torch.harness.ops_bench import PEAK_FLOP_S
from tpukern_torch.ops.split_tf32 import bound_s

B, HQ, HKV, S, D = 2, 16, 8, 1024, 128
# the gate's tail shapes: (B, Hq, Hkv, S, D, causal)
TAILS = ((1, 4, 2, 300, 128, True), (1, 4, 2, 77, 64, False))
# the featured training masks (chip_smoke.py WINDOW, SOFTCAP), and the
# featured gate's odd shapes (B, Hq, Hkv, S, D), GQA 2, 4 and 1
WINDOW, SOFTCAP = 512, 50.0
FEATURED_TAILS = ((2, 4, 2, 333, 128), (1, 4, 1, 200, 64), (1, 4, 4, 77, 32))
# #8's digest shapes, chip_smoke.py's [train kernels] backward cases
# (B, Hq, Hkv, S, D, f32?, causal)
DIGEST_SHAPES = ((2, 16, 8, 1024, 128, True, True),
                 (2, 16, 8, 1024, 128, False, True),
                 (1, 4, 4, 300, 128, True, False),
                 (2, 2, 2, 77, 64, True, True),
                 (1, 8, 2, 300, 128, True, True),
                 (1, 4, 2, 200, 32, True, False),
                 (1, 4, 2, 300, 128, False, True),
                 (2, 8, 2, 77, 64, False, True))


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def _line(label, name, fn, flops, bf16=False):
    dev = _device_ms(fn, 10)
    ev = run_benchmark(fn, iters=10, reps=5)
    dev_s = "not measured" if dev is None else f"{dev:.4f}"
    if bf16:  # the bf16 tier: its bound on the tensor cores' bf16 rate
        bound = flops / PEAK_FLOP_S[torch.bfloat16] * 1e3
        share = ("" if dev is None else
                 f" ({bound / dev:.1%} of it by device time)")
        print(f"[{label}] {name}: device {dev_s} ms, events {ev:.4f} ms; "
              f"bound bf16 {bound:.4f} ms{share}")
        return
    fma = flops / PEAK_FLOP_S[torch.float32] * 1e3
    split = bound_s(flops) * 1e3
    share = ("" if dev is None else
             f" ({split / dev:.1%} of the split bound by device time)")
    print(f"[{label}] {name}: device {dev_s} ms, events {ev:.4f} ms; bounds "
          f"FMA {fma:.4f} ms, split-TF32 {split:.4f} ms{share}")


def f64_attention(q, k, v, causal):
    """(o, lse, P) of q, k, v in f64, GQA by repetition."""
    g = q.shape[1] // k.shape[1]
    qd, kd, vd = (t.double() for t in (q, k, v))
    kd, vd = (t.repeat_interleave(g, dim=1) for t in (kd, vd))
    s = qd @ kd.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if causal:
        n = q.shape[2]
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool,
                                     device=q.device).triu(1), -math.inf)
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    return p @ vd, lse, p


def f64_grads(q, k, v, do, causal):
    """(dq, dk, dv) in f64, dk and dv summed over each GQA group."""
    g = q.shape[1] // k.shape[1]
    o, _, p = f64_attention(q, k, v, causal)
    dod = do.double()
    vd = v.double().repeat_interleave(g, dim=1)
    kd = k.double().repeat_interleave(g, dim=1)
    dp = dod @ vd.transpose(-1, -2)
    ds = p * (dp - (o * dod).sum(-1, keepdim=True)) / math.sqrt(q.shape[-1])
    dq = ds @ kd
    dk = ds.transpose(-1, -2) @ q.double()
    dv = p.transpose(-1, -2) @ dod
    Bq, Hq, n, dd = q.shape
    fold = (Bq, Hq // g, g, k.shape[2], dd)
    return dq, dk.reshape(fold).sum(2), dv.reshape(fold).sum(2)


def plain_grads(q, k, v, do, causal):
    """(dq, dk, dv) of the plain f32 backward from the plain forward's o
    and lse, on K and V repeated over each GQA group, dk and dv summed
    back."""
    from tpukern_torch.ops import attention, attention_bwd

    g = q.shape[1] // k.shape[1]
    kr, vr = (t.repeat_interleave(g, dim=1) for t in (k, v))
    o, lse = attention.attention_ref(q, kr, vr, causal=causal,
                                     return_stats=True)
    dq, dk, dv = attention_bwd.flash_attention_bwd_ref(q, kr, vr, o, lse, do,
                                                       causal=causal)
    fold = (q.shape[0], k.shape[1], g, k.shape[2], q.shape[3])
    return dq, dk.reshape(fold).sum(2), dv.reshape(fold).sum(2)


def _kernel_grads(q, k, v, do, causal):
    from tpukern_torch.ops.trainable import flash_attention_trainable

    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    o = flash_attention_trainable(qs, ks, vs, causal)
    return torch.autograd.grad(o, (qs, ks, vs), do)


def _err(x, exact):
    return (x.double() - exact).abs().max().item()


def gate_rows(gen, shape):
    """The f32 tier's errors against f64 at one (B, Hq, Hkv, S, D,
    causal), on inputs drawn from gen: [(output, kernel's largest |error|,
    the plain f32 version's)] for o and lse (the forward) and dq, dk and
    dv (the backward, from the kernel forward's o and lse)."""
    from tpukern_torch.ops import attention

    b, hq, hkv, n, dd, causal = shape
    q, do = (torch.randn((b, hq, n, dd), generator=gen, device="cuda")
             for _ in range(2))
    k, v = (torch.randn((b, hkv, n, dd), generator=gen, device="cuda")
            for _ in range(2))
    eo, else_, _ = f64_attention(q, k, v, causal)
    o, lse = attention.flash_attention(q, k, v, causal=causal,
                                       return_stats=True)
    ro, rlse = attention.attention_ref(q, k, v, causal=causal,
                                       return_stats=True)
    rows = [("o", _err(o, eo), _err(ro, eo)),
            ("lse", _err(lse, else_), _err(rlse, else_))]
    del eo, else_
    exact = f64_grads(q, k, v, do, causal)
    got = _kernel_grads(q, k, v, do, causal)
    plain = plain_grads(q, k, v, do, causal)
    return rows + [(nm, _err(a, e), _err(p, e)) for nm, a, p, e in
                   zip(("dq", "dk", "dv"), got, plain, exact)]


def gate_rows_bf16(gen, shape):
    """The bf16 tier's errors against f64 at one (B, Hq, Hkv, S, D,
    causal), on bf16 inputs drawn from gen: [(output, the kernel's
    largest |error|, its plain version's)] for dq, dk and dv, the kernel
    flash_attention_bwd on the KV heads as they are, the plain version
    flash_attention_bwd_bf16_ref (P and dS rounded to bf16 alike), both
    from the bf16 forward's o and lse; f64 from the same bf16 values."""
    from tpukern_torch.ops import attention, attention_bwd

    b, hq, hkv, n, dd, causal = shape
    bf = torch.bfloat16
    q, do = (torch.randn((b, hq, n, dd), generator=gen, device="cuda")
             .to(bf) for _ in range(2))
    k, v = (torch.randn((b, hkv, n, dd), generator=gen, device="cuda")
            .to(bf) for _ in range(2))
    o, lse = attention.flash_attention(q, k, v, causal=causal,
                                       return_stats=True)
    exact = f64_grads(q, k, v, do, causal)
    got = attention_bwd.flash_attention_bwd(q, k, v, o, lse, do,
                                            causal=causal)
    plain = attention_bwd.flash_attention_bwd_bf16_ref(q, k, v, o, lse, do,
                                                       causal=causal)
    return [(nm, _err(a, e), _err(p, e)) for nm, a, p, e in
            zip(("dq", "dk", "dv"), got, plain, exact)]


def gate(label, gen, shape):
    """Prints gate_rows at shape with their ratios; returns the largest."""
    worst = 0.0
    for nm, ek, ep in gate_rows(gen, shape):
        r = ek / max(ep, 1e-300)
        worst = max(worst, r)
        print(f"[{label}] gate {shape} {nm}: kernel {ek:.3e} plain f32 "
              f"{ep:.3e} vs f64: x{r:.3f}")
    return worst


def band_pairs(S, window):
    """Visible (q, kv) pairs of one causal head under a window."""
    return sum(min(r + 1, window) for r in range(S))


def featured_f64(q, k, v, do, lse, di, *, window=None, softcap=None,
                 segment_ids=None):
    """(dq, dk, dv) of the causal featured backward in f64 from the same
    inputs (lse and di included), K and V repeated over each GQA group, dk
    and dv summed over it."""
    from tpukern_torch.ops.attention import visible

    g = q.shape[1] // k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    qd, dod = q.double(), do.double()
    kd, vd = (t.double().repeat_interleave(g, dim=1) for t in (k, v))
    s = qd @ kd.transpose(-1, -2) * scale
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    p = torch.exp(s - lse.double()[..., None])
    keep = visible(q.shape[2], k.shape[2], q.device, causal=True,
                   window=window, segment_ids=segment_ids)
    p = torch.where(keep, p, 0.0)
    ds = p * (dod @ vd.transpose(-1, -2) - di.double()[..., None]) * scale
    if softcap is not None:
        ds = ds * (1 - t * t)
    fold = (k.shape[0], k.shape[1], g, k.shape[2], q.shape[3])
    return (ds @ kd, (ds.transpose(-1, -2) @ qd).reshape(fold).sum(2),
            (p.transpose(-1, -2) @ dod).reshape(fold).sum(2))


def _gqa_featured():
    """Whether this tree's featured backward takes K and V at their own
    heads (GQA inside #9/#10; the tree that added the split-TF32 #9 did)."""
    from tpukern_torch.ops import attention_bwd

    return hasattr(attention_bwd, "flash_attention_dq_tf32_ref")


def featured_grads(q, k, v, do, lse, di, kw, plain=False):
    """(dq, dk, dv) of the featured backward (the kernels, or with plain the
    plain versions) on the KV heads as they are; on a tree without GQA in
    them, on K and V repeated, dk and dv summed over each group."""
    from tpukern_torch.ops import attention_bwd as ab

    dq_fn, dkv_fn = ((ab.flash_attention_dq_ref, ab.flash_attention_dkv_ref)
                     if plain else (ab.flash_attention_dq,
                                    ab.flash_attention_dkv))
    g = q.shape[1] // k.shape[1]
    if _gqa_featured() or g == 1:
        return (dq_fn(q, k, v, do, lse, di, causal=True, **kw),
                *dkv_fn(q, k, v, do, lse, di, causal=True, **kw))
    kr, vr = (t.repeat_interleave(g, dim=1) for t in (k, v))
    dk, dv = dkv_fn(q, kr, vr, do, lse, di, causal=True, **kw)
    fold = (k.shape[0], k.shape[1], g, *k.shape[2:])
    return (dq_fn(q, kr, vr, do, lse, di, causal=True, **kw),
            dk.reshape(fold).sum(2), dv.reshape(fold).sum(2))


def featured_gate_rows(gen, shape, kw):
    """The featured f32 tier's errors against f64 at one (B, Hq, Hkv, S,
    D) with the masks kw (feature_sets.feature_kwargs'), on inputs drawn
    from gen, lse and di from the plain forward: [(output, the kernels'
    largest |error|, the plain f32 version's, a second call bit-equal)]
    for dq, dk and dv; f64 from the same lse and di."""
    from tpukern_torch.ops import attention

    b, hq, hkv, n, dd = shape
    q, do = (torch.randn((b, hq, n, dd), generator=gen, device="cuda")
             for _ in range(2))
    k, v = (torch.randn((b, hkv, n, dd), generator=gen, device="cuda")
            for _ in range(2))
    o, lse = attention.attention_ref(q, k, v, causal=True, return_stats=True,
                                     **kw)
    di = (o * do).sum(-1)
    args = (q, k, v, do, lse, di)
    exact = featured_f64(*args, **kw)
    got = featured_grads(*args, kw)
    again = featured_grads(*args, kw)
    plain = featured_grads(*args, kw, plain=True)
    return [(nm, _err(a, e), _err(p, e), torch.equal(a, a2)) for
            nm, a, a2, p, e in zip(("dq", "dk", "dv"), got, again, plain,
                                   exact)]


def flex_band_attention(window, softcap, S):
    """The one PyTorch call of the featured attention, timed as the
    library call only (the port never calls it): torch.compile of
    flex_attention with cap·tanh(s/cap) as its score_mod (applied to the
    scaled score, before the mask) and the causal band of `window` keys
    as its block mask. Returns a function (q, k, v, enable_gqa=False) ->
    (o, natural-log lse)."""
    import torch._inductor.config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def score_mod(score, b, h, qi, ki):
        return softcap * torch.tanh(score / softcap)

    def band(b, h, qi, ki):
        return (ki <= qi) & (ki > qi - window)

    torch._inductor.config.compile_threads = 1  # no worker processes
    return partial(torch.compile(flex_attention), score_mod=score_mod,
                   block_mask=create_block_mask(band, None, None, S, S,
                                                device="cuda"),
                   return_lse=True)


def featured(label, gen):
    """The --featured lines: times at the training heads, then the gate."""
    from tpukern_torch.core.feature_sets import FEATURE_SETS, feature_kwargs
    from tpukern_torch.ops import attention
    from tpukern_torch.ops import attention_bwd as ab
    from tpukern_torch.ops.trainable import flash_attention_trainable

    product = 2 * D * B * HQ * band_pairs(S, WINDOW)
    q, do = (torch.randn((B, HQ, S, D), generator=gen, device="cuda")
             for _ in range(2))
    k, v = (torch.randn((B, HKV, S, D), generator=gen, device="cuda")
            for _ in range(2))
    band = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    band &= ~torch.ones(S, S, dtype=torch.bool, device="cuda").tril(-WINDOW)
    gqa = _gqa_featured()
    heads = f"K, V at {HKV} heads" if gqa else f"K, V repeated to {HQ}"
    for tag, kw in ((f"window {WINDOW} softcap {SOFTCAP:g}",
                     dict(window=WINDOW, softcap=SOFTCAP)),
                    (f"window {WINDOW}", dict(window=WINDOW))):
        o, lse = attention.flash_attention(q, k, v, causal=True,
                                           return_stats=True, **kw)
        di = (o * do).sum(-1)
        kk, vv = ((k, v) if gqa else
                  (t.repeat_interleave(HQ // HKV, dim=1) for t in (k, v)))
        args = (q, kk, vv, do, lse, di)
        _line(label, f"#9 f32 {tag} ({heads})",
              lambda: ab.flash_attention_dq(*args, causal=True, **kw),
              3 * product)
        _line(label, f"#10 f32 {tag} ({heads})",
              lambda: ab.flash_attention_dkv(*args, causal=True, **kw),
              4 * product)
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        ot = flash_attention_trainable(qs, ks, vs, True, None, kw["window"],
                                       kw.get("softcap"))
        _line(label, f"#9 + #10 f32 {tag}: the trainable's backward, GQA "
              f"{HQ}/{HKV}", lambda: torch.autograd.grad(
                  ot, (qs, ks, vs), do, retain_graph=True), 7 * product)
        _line(label, f"#9 plain {tag} (flash_attention_dq_ref)",
              lambda: ab.flash_attention_dq_ref(*args, causal=True, **kw),
              3 * product)
        _line(label, f"#10 plain {tag} (flash_attention_dkv_ref)",
              lambda: ab.flash_attention_dkv_ref(*args, causal=True, **kw),
              4 * product)
        ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
        if "softcap" in kw:
            lib = "autograd backward of compiled flex_attention"
            ol = flex_band_attention(WINDOW, SOFTCAP, S)(
                ql, kl, vl, enable_gqa=True)[0]
        else:
            lib = "autograd backward of SDPA with a band mask"
            ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=band,
                                                enable_gqa=True)
        torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True)
        _line(label, f"#9 + #10 library {tag} ({lib}, dq, dk, dv)",
              lambda: torch.autograd.grad(ol, (ql, kl, vl), do,
                                          retain_graph=True), 7 * product)
        del o, lse, di, args, ot, qs, ks, vs, ol, ql, kl, vl
        torch.cuda.empty_cache()
    worst = 0.0
    cases = [((B, HQ, HKV, S, D), "window+softcap 50",
              dict(window=WINDOW, softcap=SOFTCAP)),
             ((B, HQ, HKV, S, D), "window", dict(window=WINDOW))]
    for shape in FEATURED_TAILS:
        for name in FEATURE_SETS:
            if "sinks" not in name:  # sinks are forward-only
                cases.append((shape, name,
                              feature_kwargs(name, shape[0], shape[3],
                                             "cuda")[0]))
    for shape, name, kw in cases:
        for nm, ek, ep, same in featured_gate_rows(gen, shape, kw):
            r = ek / max(ep, 1e-300)
            worst = max(worst, r)
            print(f"[{label}] featured gate {shape} {name} {nm}: kernel "
                  f"{ek:.3e} plain f32 {ep:.3e} vs f64: x{r:.3f}; second "
                  f"call {'bit-equal' if same else 'DIFFERS'}")
        torch.cuda.empty_cache()
    print(f"[{label}] featured gate: largest kernel / plain f32 error "
          f"ratio x{worst:.3f}")


def featured_bf16(label, gen):
    """The --featured-bf16 lines: #9 and #10 in bf16 at the training
    heads, the plain versions, SDPA's bf16 band-mask backward; the f64
    errors."""
    from tpukern_torch.ops import attention
    from tpukern_torch.ops import attention_bwd as ab

    bf = torch.bfloat16
    product = 2 * D * B * HQ * band_pairs(S, WINDOW)
    q, do = (torch.randn((B, HQ, S, D), generator=gen, device="cuda").to(bf)
             for _ in range(2))
    k, v = (torch.randn((B, HKV, S, D), generator=gen, device="cuda").to(bf)
            for _ in range(2))
    band = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    band &= ~torch.ones(S, S, dtype=torch.bool, device="cuda").tril(-WINDOW)
    for tag, kw in ((f"window {WINDOW} softcap {SOFTCAP:g}",
                     dict(window=WINDOW, softcap=SOFTCAP)),
                    (f"window {WINDOW}", dict(window=WINDOW))):
        o, lse = attention.flash_attention(q, k, v, causal=True,
                                           return_stats=True, **kw)
        di = (o.float() * do.float()).sum(-1)
        args = (q, k, v, do, lse, di)
        _line(label, f"#9 bf16 {tag} (K, V at {HKV} heads)",
              lambda: ab.flash_attention_dq(*args, causal=True, **kw),
              3 * product, bf16=True)
        _line(label, f"#10 bf16 {tag} (K, V at {HKV} heads)",
              lambda: ab.flash_attention_dkv(*args, causal=True, **kw),
              4 * product, bf16=True)
        _line(label, f"#9 bf16 plain {tag} (flash_attention_dq_ref)",
              lambda: ab.flash_attention_dq_ref(*args, causal=True, **kw),
              3 * product, bf16=True)
        _line(label, f"#10 bf16 plain {tag} (flash_attention_dkv_ref)",
              lambda: ab.flash_attention_dkv_ref(*args, causal=True, **kw),
              4 * product, bf16=True)
        exact = featured_f64(*args, **kw)
        got = (ab.flash_attention_dq(*args, causal=True, **kw),
               *ab.flash_attention_dkv(*args, causal=True, **kw))
        plain = (ab.flash_attention_dq_ref(*args, causal=True, **kw),
                 *ab.flash_attention_dkv_ref(*args, causal=True, **kw))
        for nm, g_, p_, e_ in zip(("dq", "dk", "dv"), got, plain, exact):
            print(f"[{label}] bf16 featured {tag} {nm}: kernel "
                  f"{_err(g_, e_):.3e} plain bf16 {_err(p_, e_):.3e} vs "
                  f"f64")
        del o, lse, di, args, exact, got, plain
        torch.cuda.empty_cache()
    ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=band,
                                        enable_gqa=True)
    _line(label, f"#9 + #10 bf16 library (autograd backward of SDPA, band "
          f"mask of {WINDOW}, enable_gqa; dq, dk, dv)",
          lambda: torch.autograd.grad(ol, (ql, kl, vl), do,
                                      retain_graph=True), 7 * product,
          bf16=True)


def digests(label, gen):
    """The --digests lines: #8's dk and dv bits at DIGEST_SHAPES."""
    from tpukern_torch.ops import attention, attention_bwd

    for b, hq, hkv, n, dd, f32, causal in DIGEST_SHAPES:
        dt = torch.float32 if f32 else torch.bfloat16
        q, do = (torch.randn((b, hq, n, dd), generator=gen, device="cuda")
                 .to(dt) for _ in range(2))
        k, v = (torch.randn((b, hkv, n, dd), generator=gen, device="cuda")
                .to(dt) for _ in range(2))
        o, lse = attention.attention_ref(q, k, v, causal=causal,
                                         return_stats=True)
        _, dk, dv = attention_bwd.flash_attention_bwd(q, k, v, o, lse, do,
                                                      causal=causal)
        for nm, t in (("dk", dk), ("dv", dv)):
            h = hashlib.sha256(t.contiguous().view(torch.uint8).cpu()
                               .numpy().tobytes()).hexdigest()[:16]
            print(f"[{label}] digest #8 {nm} B{b} H{hq}/{hkv} S{n} D{dd} "
                  f"{str(dt)[6:]} causal={causal}: {h}")


def main(label="this tree", mode=None):
    if not torch.cuda.is_available():
        raise SystemExit("fa_train_times needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from tpukern_torch.ops import attention, attention_bwd
    from tpukern_torch.ops.trainable import flash_attention_trainable

    print(f"[{label}] {_card()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    modes = {"--featured": featured, "--digests": digests,
             "--featured-bf16": featured_bf16}
    if mode in modes:
        modes[mode](label, gen)
        return
    pairs = S * (S + 1) // 2
    fwd_flops = 4 * D * B * HQ * pairs
    bwd_flops = 10 * D * B * HQ * pairs
    for dt in (torch.float32, torch.bfloat16):
        tag = "f32" if dt == torch.float32 else "bf16"
        q, do = (torch.randn((B, HQ, S, D), generator=gen, device="cuda")
                 .to(dt) for _ in range(2))
        k, v = (torch.randn((B, HKV, S, D), generator=gen, device="cuda")
                .to(dt) for _ in range(2))
        if dt == torch.float32:
            _line(label, f"#6 {tag} return_stats",
                  lambda: attention.flash_attention(q, k, v, causal=True,
                                                    return_stats=True),
                  fwd_flops)
            _line(label, f"#6 {tag} plain (attention_ref)",
                  lambda: attention.attention_ref(q, k, v, causal=True,
                                                  return_stats=True),
                  fwd_flops)
            _line(label, f"#6 {tag} library (SDPA, enable_gqa)",
                  lambda: F.scaled_dot_product_attention(
                      q, k, v, is_causal=True, enable_gqa=True), fwd_flops)
        o, lse = attention.flash_attention(q, k, v, causal=True,
                                           return_stats=True)
        kr, vr = (t.repeat_interleave(HQ // HKV, dim=1) for t in (k, v))
        _line(label, f"#8 {tag} flash_attention_bwd at H {HQ} (K, V "
              "repeated outside the call)",
              lambda: attention_bwd.flash_attention_bwd(q, kr, vr, o, lse, do,
                                                        causal=True),
              bwd_flops)
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        ot = flash_attention_trainable(qs, ks, vs, True)
        bf = dt == torch.bfloat16
        _line(label, f"#8 {tag} the trainable's backward, GQA {HQ}/{HKV}",
              lambda: torch.autograd.grad(ot, (qs, ks, vs), do,
                                          retain_graph=True), bwd_flops, bf)
        if dt == torch.float32:
            _line(label, f"#8 {tag} plain (flash_attention_bwd_ref)",
                  lambda: attention_bwd.flash_attention_bwd_ref(
                      q, kr, vr, o, lse, do, causal=True), bwd_flops)
        ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                            enable_gqa=True)
        _line(label, f"#8 {tag} library (SDPA backward, enable_gqa)",
              lambda: torch.autograd.grad(ol, (ql, kl, vl), do,
                                          retain_graph=True), bwd_flops, bf)
        del q, k, v, do, o, lse, kr, vr, ot, ol, qs, ks, vs, ql, kl, vl
        torch.cuda.empty_cache()
    worst = 0.0
    for shape in ((B, HQ, HKV, S, D, True), *TAILS):
        worst = max(worst, gate(label, gen, shape))
        torch.cuda.empty_cache()
    print(f"[{label}] gate: largest kernel / plain f32 error ratio "
          f"x{worst:.3f}")
    if hasattr(attention_bwd, "flash_attention_bwd_bf16_ref"):
        worst = 0.0
        for shape in ((B, HQ, HKV, S, D, True), *TAILS):
            for nm, ek, ep in gate_rows_bf16(gen, shape):
                r = ek / max(ep, 1e-300)
                worst = max(worst, r)
                print(f"[{label}] bf16 gate {shape} {nm}: kernel {ek:.3e} "
                      f"plain bf16 {ep:.3e} vs f64: x{r:.3f}")
            torch.cuda.empty_cache()
        print(f"[{label}] bf16 gate: largest kernel / plain bf16 error "
              f"ratio x{worst:.3f}")


if __name__ == "__main__":
    words = [a for a in sys.argv[1:] if not a.startswith("--")]
    flags = [a for a in sys.argv[1:] if a.startswith("--")]
    main(*words[:1], mode=flags[0] if flags else None)
