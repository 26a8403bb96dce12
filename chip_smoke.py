#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tpukern_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the device, torch/CUDA/nvcc versions and whether triton imports;
2. builds the kernels from tpukern_torch/csrc (or loads this source
   hash's build) and prints the build seconds;
3. checks every kernel of the serving path against its plain PyTorch
   version on the card, at the 7bish serving shapes in bf16 and at small
   f32 shapes, and times both at the serving shape;
4. serves the 7bish preset (random weights from a seeded generator)
   through ContinuousBatcher: 6 requests on 4 slots, 2 admitted
   mid-stream, 32 new tokens each; the kernels' launch counts are reset
   just before and read just after;
5. profiles one admission and a few decode steps (device time by kernel);
6. checks one prefill's logits against the plain functions in f32.

Exits non-zero, without the result line, if there is no CUDA device or
any phase fails. The last line is {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
# tolerances of the kernel-vs-plain checks (max |kernel - plain| <= atol +
# rtol * |plain|). bf16: the _TOLS bf16 row (the kernels round P, sums and
# outputs to bf16 where the plain versions stay in f32). f32: both sides
# compute in f32; sums run in another order and CUDA's exp/rsqrt differ
# from PyTorch's in the last bits.
TOLS = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-4, 1e-4)}
# end-to-end logits of one 7bish prefill against the plain f32 functions:
# the f32 kernel path within E2E_F32_ATOL max abs; the bf16 kernel path
# (the served one: 16 layers of bf16 rounding) within E2E_BF16_REL
# relative RMS error. Both must pick the plain argmax, or a token whose
# plain logit is within that path's own max error of the plain maximum.
E2E_F32_ATOL = 2e-3
E2E_BF16_REL = 5e-2


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def sh(*cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def phase_device():
    print(sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"))
    print(f"[device] {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()} torch {torch.__version__} "
          f"cuda {torch.version.cuda} python {sys.version.split()[0]}")
    from tpukern_torch import _build
    nvcc = sh(_build._nvcc(), "--version").splitlines()
    print(f"[device] nvcc: {nvcc[-1] if nvcc else 'unavailable'}")
    try:
        import triton
        print(f"[device] triton {triton.__version__} imports")
    except ImportError:
        print("[device] triton does not import")


def phase_build():
    from tpukern_torch import _build
    path, seconds = _build.build()
    _build.library()
    log = (path.parent / "nvcc.log")
    lines = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    for ln in lines:
        print(f"[build] ptxas {ln}")
    print(f"[build] {path} compiled in {seconds:.1f} s "
          f"({'fresh' if seconds else 'already built'})")


def _randn(gen, *shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _compare(name, case, out, ref):
    rtol, atol = TOLS[out.dtype]
    d = (out.float() - ref.float()).abs()
    bound = atol + rtol * ref.float().abs()
    ok = bool(torch.isfinite(out.float()).all() and (d <= bound).all())
    print(f"[check] {name:16s} {case:44s} max_abs {d.max().item():.3e} "
          f"mean_abs {d.mean().item():.3e} tol {rtol:g}/{atol:g} "
          f"{'ok' if ok else 'MISS'}")
    return ok, d.max().item()


def _device_events(fn, n):
    """(start_us, end_us, name) of every device op of n calls of fn, from
    torch.profiler (CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA)


def _device_ms(fn, n=20):
    """Device-only ms per call (the sum of its kernels' durations), or
    None if the profiler saw no device op."""
    ev = _device_events(fn, n)
    return sum(e - s for s, e, _ in ev) / n / 1e3 if ev else None


def phase_kernels(cfg):
    """Every kernel against its plain version; times at the serving shape.
    Returns {kernel: dict(max_abs_err, ms, plain_ms, ...)} and all-ok."""
    from functools import partial

    from tpukern_torch.harness import run_benchmark
    from tpukern_torch.ops import attention, paged_attention, rmsnorm, rope

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf, f32 = torch.bfloat16, torch.float32
    d, D = cfg.d_model, cfg.head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    results, all_ok, timed = {}, True, {}

    def record(name, ok, err):
        nonlocal all_ok
        all_ok &= ok
        r = results.setdefault(name, dict(max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)

    # rms_norm: decode rows (4), the largest prefill bucket (512), f32
    for T, dt in ((4, bf), (512, bf), (8, f32)):
        x = _randn(gen, T, d, dtype=dt)
        g = (1 + 0.1 * _randn(gen, d, dtype=f32)).to(dt)
        record("rms_norm", *_compare("rms_norm", f"({T}, {d}) {dt}",
                                     rmsnorm.rms_norm(x, g),
                                     rmsnorm.rms_norm_ref(x, g)))
    x = _randn(gen, 512, d, dtype=bf)
    g = torch.ones(d, dtype=bf, device="cuda")
    timed["rms_norm"] = ([512, d], partial(rmsnorm.rms_norm, x, g),
                         partial(rmsnorm.rms_norm_ref, x, g))

    # rope_cached: q rows of one decode step and of a 512 prefill, f32
    cos_t, sin_t = rope.make_cos_sin(cfg.max_seq, D, device="cuda")
    for R, dt, dd in ((4 * Hq, bf, D), (Hq * 512, bf, D), (96, f32, 64)):
        c, s = ((cos_t, sin_t) if dd == D
                else rope.make_cos_sin(cfg.max_seq, dd, device="cuda"))
        pos = torch.randint(0, cfg.max_seq, (R,), generator=gen,
                            device="cuda")
        x = _randn(gen, R, dd, dtype=dt)
        record("rope_cached", *_compare(
            "rope_cached", f"({R}, {dd}) {dt}",
            rope.rope_cached(x, c[pos], s[pos]),
            rope.rope_cached_ref(x, c[pos], s[pos])))
    pos = torch.arange(512, device="cuda").repeat(Hq)
    x = _randn(gen, Hq * 512, D, dtype=bf)
    args = (x, cos_t[pos], sin_t[pos])
    timed["rope_cached"] = ([Hq * 512, D], partial(rope.rope_cached, *args),
                            partial(rope.rope_cached_ref, *args))

    # flash_attention: the 7bish prefill heads at S in {128, 300, 512},
    # D = 64, and f32 (causal and not)
    fa_cases = [(1, Hq, Hkv, S, D, bf, True) for S in (128, 300, 512)]
    fa_cases += [(1, 8, 4, 300, 64, bf, True), (2, 4, 2, 100, 64, f32, True),
                 (1, 4, 4, 77, 128, f32, False), (1, 4, 2, 130, 32, bf, False)]
    for B, hq, hkv, S, dd, dt, causal in fa_cases:
        q = _randn(gen, B, hq, S, dd, dtype=dt)
        k = _randn(gen, B, hkv, S, dd, dtype=dt)
        v = _randn(gen, B, hkv, S, dd, dtype=dt)
        record("flash_attention", *_compare(
            "flash_attention",
            f"B{B} H{hq}/{hkv} S{S} D{dd} {dt} causal={causal}",
            attention.flash_attention(q, k, v, causal=causal),
            attention.attention_ref(q, k, v, causal=causal)))
    q = _randn(gen, 1, Hq, 512, D, dtype=bf)
    k = _randn(gen, 1, Hkv, 512, D, dtype=bf)
    v = _randn(gen, 1, Hkv, 512, D, dtype=bf)
    timed["flash_attention"] = (
        [1, Hq, 512, D],
        partial(attention.flash_attention, q, k, v, causal=True),
        partial(attention.attention_ref, q, k, v, causal=True))

    # paged decode: 4 sequences x 8 pages of 128 from a shuffled pool
    def paged_case(B, hq, hkv, dd, page, pps, lengths, dt):
        P = B * pps
        perm = torch.randperm(P, generator=gen, device="cuda")
        table = perm.reshape(B, pps).to(torch.int32)
        kp = _randn(gen, hkv, P, page, dd, dtype=dt)
        vp = _randn(gen, hkv, P, page, dd, dtype=dt)
        qq = _randn(gen, B, hq, dd, dtype=dt)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        return qq, kp, vp, lens, table

    serve_case = paged_case(4, Hq, Hkv, D, 128, 8, [1, 129, 700, 1024], bf)
    for case, args in (
            ("B4 H16/8 D128 page128 x8 bf16", serve_case),
            ("B3 H4/2 D64 page16 x4 f32 len{0,17,64}",
             paged_case(3, 4, 2, 64, 16, 4, [0, 17, 64], f32))):
        record("paged_attention", *_compare(
            "paged_attention", case,
            paged_attention.paged_attention(*args),
            paged_attention.paged_attention_ref(*args)))
    timed["paged_attention"] = (
        [4, Hq, D], partial(paged_attention.paged_attention, *serve_case),
        partial(paged_attention.paged_attention_ref, *serve_case))

    # CUDA events around back-to-back calls (host issue time included
    # where it exceeds the device's), and device-only time (profiler)
    for name, (shape, kernel, plain) in timed.items():
        r = results[name]
        r.update(shape=shape, ms=run_benchmark(kernel),
                 plain_ms=run_benchmark(plain), device_ms=_device_ms(kernel),
                 plain_device_ms=_device_ms(plain))
        dev = ("device-only not measured" if None in (
            r["device_ms"], r["plain_device_ms"]) else
            f"device-only: kernel {r['device_ms']:.4f} ms plain "
            f"{r['plain_device_ms']:.4f} ms")
        print(f"[time] {name:16s} at {shape}: kernel {r['ms']:.4f} ms "
              f"plain {r['plain_ms']:.4f} ms (events); {dev}")
    return results, all_ok


def _timed(fn, *args):
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    out = fn(*args)
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def phase_serve(cfg, params, ops):
    """The main path: ContinuousBatcher over 6 requests."""
    from tpukern_torch.models.batcher import ContinuousBatcher, _bucket

    kw = dict(n_slots=4, pages_per_seq=8, page_size=128, max_new_tokens=32,
              prompt_buckets=(128, 256, 512))
    rng = np.random.default_rng(SEED)
    lens = rng.integers(60, 501, 6)
    requests = [(i, rng.integers(0, cfg.vocab, n).astype(np.int32))
                for i, n in enumerate(lens)]

    # warm-up outside the counted run: one short request per bucket
    warm = ContinuousBatcher(params, cfg, **dict(kw, max_new_tokens=2))
    warm.run([(f"w{b}", np.ones(b - 10, np.int32)) for b in (128, 256, 512)])
    del warm
    torch.cuda.synchronize()

    cb = ContinuousBatcher(params, cfg, **kw)
    for op in ops:
        op.launches = 0
    prefill_ms, decode_ms, emitted = {}, [], 0
    mid_stream, pending, t0 = 0, list(requests), time.perf_counter()
    while pending or cb.active.any():
        while pending and cb.free_slots():
            rid, prompt = pending.pop(0)
            _, ms = _timed(cb.add_request, rid, prompt)
            prefill_ms.setdefault(_bucket(len(prompt), cb.buckets,
                                          cb.max_len), []).append(ms)
            mid_stream += bool(decode_ms)
        if cb.active.any():
            n, ms = _timed(cb.step)
            decode_ms.append(ms)
            emitted += n
    wall = time.perf_counter() - t0
    launches = {op.__name__: op.launches for op in ops}

    print(f"[serve] prompt lengths {lens.tolist()}; {mid_stream} admitted "
          f"mid-stream; {len(decode_ms)} decode steps; {wall:.2f} s wall")
    for b in sorted(prefill_ms):
        v = prefill_ms[b]
        print(f"[serve] prefill bucket {b}: {len(v)} requests, median "
              f"{np.median(v):.3f} ms ({', '.join(f'{x:.3f}' for x in v)})")
    print(f"[serve] decode: median {np.median(decode_ms):.3f} ms/step, "
          f"{emitted} tokens in {sum(decode_ms):.1f} ms = "
          f"{1e3 * emitted / sum(decode_ms):.1f} tok/s")
    print(f"[serve] launches {launches}")
    require(set(cb.finished) == {r for r, _ in requests},
            f"finished {sorted(cb.finished)}")
    for rid, toks in cb.finished.items():
        require(len(toks) == 32 and all(0 <= t < cfg.vocab for t in toks),
                f"request {rid} gave {toks}")
    require(mid_stream == 2, f"{mid_stream} admitted mid-stream, not 2")
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the path never launched: {launches}")
    return launches, requests


_CATEGORIES = (("rms_norm", "rms_norm_kernel"),
               ("rope_cached", "rope_cached_kernel"),
               ("flash_attention", "fa_fwd_"),
               ("paged_attention", "paged_decode_kernel"),
               ("gemm", ("gemm", "nvjet", "cutlass", "xmma")),
               ("memcpy/memset", ("Memcpy", "Memset")))


def _category(name):
    for cat, keys in _CATEGORIES:
        if any(k in name for k in ((keys,) if isinstance(keys, str)
                                   else keys)):
            return cat
    return "other"


def _profile(label, fn, n):
    """Device time of n calls of fn by kernel category (torch.profiler),
    and the device's busy share of the span from first kernel start to
    last kernel end (the profiler's own host cost lowers it)."""
    ev = _device_events(fn, n)
    if not ev:
        print(f"[profile] {label}: no device events; device time not "
              "measured")
        return
    busy, cur_s, cur_e = 0.0, ev[0][0], ev[0][1]
    for s, e, _ in ev[1:]:
        if s > cur_e:
            busy, cur_s = busy + cur_e - cur_s, s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e for _, e, _ in ev) - ev[0][0]
    cats, names = {}, {}
    for s, e, name in ev:
        cats[_category(name)] = cats.get(_category(name), 0.0) + e - s
        names[name] = names.get(name, 0.0) + e - s
    print(f"[profile] {label}: {len(ev) / n:.0f} device ops per call, "
          f"busy {busy / n / 1e3:.3f} ms of a {span / n / 1e3:.3f} ms span "
          f"per call (busy share {busy / span:.3f})")
    print(f"[profile] {label} by category, ms per call: " + ", ".join(
        f"{c} {t / n / 1e3:.3f}" for c, t in
        sorted(cats.items(), key=lambda kv: -kv[1])))
    for name, t in sorted(names.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[profile] {label}   {t / n / 1e3:.4f} ms  {name[:90]}")


def phase_profile(cfg, params, requests):
    """Where the device time goes: one 512-bucket admission and 8 decode
    steps of 4 active slots, each under torch.profiler."""
    from tpukern_torch.models.batcher import ContinuousBatcher

    cb = ContinuousBatcher(params, cfg, n_slots=4, pages_per_seq=8,
                           page_size=128, max_new_tokens=32,
                           prompt_buckets=(128, 256, 512))
    for rid, prompt in requests[1:4]:
        cb.add_request(rid, prompt)
    cb.step()
    rid, prompt = requests[0]
    _profile(f"prefill (T={len(prompt)}, bucket 512)",
             lambda: cb.add_request(rid, prompt), 1)
    _profile("decode step (4 slots)", cb.step, 8)


def _plain_prefill_logits(params, cfg, tokens):
    """Last-token logits of a prompt with the plain functions only."""
    from tpukern_torch.ops.attention import attention_ref
    from tpukern_torch.ops.rmsnorm import rms_norm_ref
    from tpukern_torch.ops.rope import make_cos_sin, rope_cached_ref

    T, D, Hq, Hkv = len(tokens), cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    cos, sin = make_cos_sin(T, D, device="cuda")
    h = params["embed"][tokens]

    def heads(x, n):
        x = x.reshape(T, n, D).transpose(0, 1).reshape(n * T, D)
        x = rope_cached_ref(x, cos.repeat(n, 1), sin.repeat(n, 1))
        return x.reshape(1, n, T, D)

    for lp in params["layers"]:
        hn = rms_norm_ref(h, lp["ln1"])
        q, k = heads(hn @ lp["wq"], Hq), heads(hn @ lp["wk"], Hkv)
        v = (hn @ lp["wv"]).reshape(T, Hkv, D).transpose(0, 1)[None]
        o = attention_ref(q, k, v, causal=True)[0].transpose(0, 1)
        h = h + o.reshape(T, -1) @ lp["wo"]
        hn = rms_norm_ref(h, lp["ln2"])
        h = h + torch.nn.functional.gelu(hn @ lp["w1"],
                                         approximate="tanh") @ lp["w2"]
    return (rms_norm_ref(h[-1], params["lnf"]) @ params["head"]).float()


def phase_logits(cfg, params, prompt):
    """One prefill through the kernels (bf16 as served, and f32) against
    the plain functions in f32 on the same card."""
    import dataclasses
    from tpukern_torch.models import params_to, serving

    f32cfg = dataclasses.replace(cfg, param_dtype=torch.float32)
    p32 = params_to(params, torch.float32)
    tokens = torch.from_numpy(prompt).to("cuda")
    ref = _plain_prefill_logits(p32, f32cfg, tokens.long())
    ok = bool(torch.isfinite(ref).all())
    for name, c, p, dt in (("f32", f32cfg, p32, torch.float32),
                           ("bf16", cfg, params, torch.bfloat16)):
        cache = serving.init_cache(c, 1, 8, 128, dtype=dt, device="cuda")
        logits, _ = serving.prefill(p, c, tokens[None], cache)
        out = logits[0]
        require(out.shape == (cfg.vocab,) and bool(torch.isfinite(out).all()),
                f"{name} logits of shape {tuple(out.shape)} not finite")
        err = (out - ref).abs().max().item()
        rel = ((out - ref).norm() / ref.norm()).item()
        am = int(out.argmax())
        gap = (ref.max() - ref[am]).item()
        if name == "f32":
            passed = err <= E2E_F32_ATOL
            tol = f"max_abs <= {E2E_F32_ATOL:g}"
        else:
            passed = rel <= E2E_BF16_REL
            tol = f"rel_rms <= {E2E_BF16_REL:g}"
        passed &= gap <= err
        print(f"[logits] {name} kernels vs f32 plain, T={len(prompt)}: "
              f"max_abs {err:.3e} rel_rms {rel:.3e} argmax {am} vs "
              f"{int(ref.argmax())} (ref gap {gap:.3e}) {tol} "
              f"{'ok' if passed else 'MISS'}")
        ok &= passed
    return ok


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tpukern_torch.models import Config, init_params
    from tpukern_torch.ops import attention, paged_attention, rmsnorm, rope

    # the 7bish serving preset of bench/serving.py
    cfg = Config(vocab=32768, d_model=2048, n_layers=16, n_heads=16,
                 n_kv_heads=8, d_ff=8192, max_seq=4096,
                 param_dtype=torch.bfloat16)
    ops = [rmsnorm.rms_norm, rope.rope_cached, attention.flash_attention,
           paged_attention.paged_attention]

    phase_device()
    phase_build()
    timing, kernels_ok = phase_kernels(cfg)
    if not kernels_ok:
        print("chip_smoke: a kernel disagrees with its plain version",
              file=sys.stderr)
        return 1
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                         device="cuda")
    n_params = sum(t.numel() for t in [params["embed"], params["head"]]
                   + [w for lp in params["layers"] for w in lp.values()])
    print(f"[serve] 7bish: {n_params / 1e9:.3f} B parameters, bf16")
    launches, requests = phase_serve(cfg, params, ops)
    phase_profile(cfg, params, requests)
    if not phase_logits(cfg, params, requests[0][1]):
        print("chip_smoke: end-to-end logits disagree", file=sys.stderr)
        return 1

    src = {"rms_norm": ("tpukern_torch/csrc/rmsnorm.cu",
                        "tpukern/ops/rmsnorm.py:34"),
           "rope_cached": ("tpukern_torch/csrc/rope.cu",
                           "tpukern/ops/rope.py:118"),
           "flash_attention": ("tpukern_torch/csrc/flash_attention.cu",
                               "tpukern/ops/attention.py:62"),
           "paged_attention": ("tpukern_torch/csrc/paged_attention.cu",
                               "tpukern/ops/paged_attention.py:77")}
    print(json.dumps({"kernels": [
        dict(name=n, route="cuda", source=src[n][0], replaces=src[n][1],
             launches=launches[n], max_abs_err=timing[n]["max_abs_err"],
             ms=timing[n]["ms"], plain_ms=timing[n]["plain_ms"])
        for n in src]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
