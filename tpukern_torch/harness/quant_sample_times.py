"""Times of the quantized K/V write (#20/#22 on the serving path) and of
the top-k / top-p threshold (#27), with digests of their outputs.

    python -m tpukern_torch.harness.quant_sample_times [label]

Prints the card's name and power limit, then:

- the write: #20 alone at a decode step's (32, 128) K rows (a launch
  floor), then models/serving.py `_write_kv` on int8 and fp8 pools of the
  7bish serving cache (Hkv 8, D 128, 4 slots of 8 pages of 128; bf16 K
  and V, V a transposed view as `_layer_qkv` makes it) at each of
  WRITE_CASES: the device time of one layer's write (the profiler's,
  20 calls), its CUDA events time (back-to-back calls: the host's launch
  time where it exceeds the device's), and the device ops and the host's
  top-level aten ops of one call; at decode also per decode step (16
  layers);
- the quantized decode step: a ContinuousBatcher on the 7bish config
  (16 layers, seeded random weights) with 4 slots on int8 and on fp8
  pools, 8 steps under the profiler: device ops a step, busy ms (the
  union of the kernels' intervals) of the span from the first kernel's
  start to the last one's end, and ms a step by CUDA events without the
  profiler;
- #27: count mode (k 50) and mass mode (p 0.9, T 0.8) at (4, 32768) and
  (1, 128256) f32 logits of scale 3, device and events time, beside
  torch.topk(x, 50) for count mode;
- digests (sha256, 16 hex digits) of the thresholds at THRESHOLD_DRAWS and
  of the pools' bytes and scales after each write case: run the script
  from two trees' roots in one call and compare the lines.

Every tree since the quantized tier has `_write_kv`, `_slots` and the
#27 wrappers, so the file runs from an older tree's root as it is (copy
it and harness/decode_times.py in). Needs a CUDA device.
"""

import hashlib
import sys

import numpy as np
import torch

from tpukern_torch.harness.bench import run_benchmark
from tpukern_torch.harness.decode_times import _device_ms, device_events
from tpukern_torch.harness.fa_train_times import _card

HKV, D, PAGE, PPS, LAYERS = 8, 128, 128, 8, 16
# name -> (B, T, starts, ring pages (0: flat), sinks); ring: the 5-page
# rings of chip_smoke.py [ring-serve], a write of 700 > 636 slots wraps
WRITE_CASES = {"decode": (4, 1, (1, 129, 700, 1023), 0, 0),
               "verify": (4, 5, (3, 200, 640, 1000), 0, 0),
               "prefill": (4, 512, (0, 0, 0, 0), 0, 0),
               "clamped tail": (2, 5, (3, 1021), 0, 0),
               "ring wrap": (2, 700, (100, 2000), 5, 4)}
POOLS = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
# (B, V, seed) of the digests' draws; each row of scale 3, the second row
# with a 21-way tie at its top
THRESHOLD_DRAWS = ((4, 32768, 1), (1, 128256, 2), (4, 1000, 3),
                   (64, 32768, 4), (200, 4096, 5), (1, 1 << 20, 6))
COUNT_K = (1, 50, 1000)
MASS_PT = ((0.5, 1.0), (0.9, 0.8), (0.99, 1.0))


def write_case(name, pool_dtype, dtype=torch.bfloat16, device="cuda",
               seed=0, layers=2):
    """(k, v, pools, layer, slots) of a write case: k (B, Hkv, T, D)
    contiguous and v the transposed view of a (B, T, Hkv, D) tensor, of
    scale 3; pools (k_pages, k_scales, v_pages, v_scales) of `layers`
    layers behind a shuffled page table, written at the last layer; the
    slots of serving._slots."""
    from tpukern_torch.models import serving

    B, T, starts, ring_pps, sinks = WRITE_CASES[name]
    pps = ring_pps or PPS
    gen = torch.Generator(device=device).manual_seed(seed)
    k = 3 * torch.randn((B, HKV, T, D), generator=gen, device=device)
    v = 3 * torch.randn((B, T, HKV, D), generator=gen, device=device)
    k, v = k.to(dtype), v.to(dtype).transpose(1, 2)
    k[0, 0, 0] = 0  # a row of zeros: scale 1
    P = B * pps
    table = torch.randperm(P, generator=gen, device=device).reshape(
        B, pps).to(torch.int32)
    shape = (layers, HKV, P, PAGE, D)
    pools = (torch.zeros(shape, dtype=pool_dtype, device=device),
             torch.zeros(shape[:4], device=device),
             torch.zeros(shape, dtype=pool_dtype, device=device),
             torch.zeros(shape[:4], device=device))
    start = torch.tensor(starts, dtype=torch.int32, device=device)
    slots = serving._slots(table, start, T, PAGE, ring=ring_pps > 0,
                           sinks=sinks)
    return k, v, pools, layers - 1, slots


def _cache(pools):
    """A KVCache over the write case's pools (what _write_kv reads)."""
    from tpukern_torch.models import serving

    kp, ks, vp, vs = pools
    z = torch.zeros(1, device=kp.device)
    return serving.KVCache(k_pages=kp, v_pages=vp, page_table=z, lengths=z,
                           cos=z, sin=z, k_scales=ks, v_scales=vs)


def _dev_us(fn, n=20):
    """Device µs a call as text: the profiler's, retried twice where it saw
    no device op (it drops whole sessions of short kernels at times)."""
    for _ in range(3):
        ms = _device_ms(fn, n)
        if ms is not None:
            return f"{ms * 1e3:.2f}"
    return "not measured"


def _counts(fn, n=4):
    """Device ops and host top-level aten ops (names) of one call."""
    for _ in range(3):
        dev, host = device_events(fn, n)
        if dev:
            break
    return len(dev) / n, len(host) / n, sorted(set(host))


def _digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def writes(label):
    from tpukern_torch.models import serving
    from tpukern_torch.ops import quant

    # a launch floor beside them: #20 alone on a decode step's 32 K rows
    x = 3 * torch.randn((32, D), device="cuda").to(torch.bfloat16)
    print(f"[{label}] quantize_int8 alone (32, {D}) bf16: device "
          f"{_dev_us(lambda: quant.quantize_int8(x))} us")
    for tier, pdt in POOLS.items():
        for name in WRITE_CASES:
            k, v, pools, layer, slots = write_case(name, pdt)
            cache = _cache(pools)

            def call():
                serving._write_kv(cache, layer, k, v, slots)

            call()
            torch.cuda.synchronize()
            digest = _digest(*pools)
            n_dev, n_host, kinds = _counts(call)
            dev = _dev_us(call)
            ev = run_benchmark(call, iters=20, reps=5)
            per = "" if name != "decode" else (
                f"; a decode step ({LAYERS} layers): {n_dev * LAYERS:g} "
                f"device ops, {n_host * LAYERS:g} host ops")
            print(f"[{label}] write {tier} {name} (B {k.shape[0]}, T "
                  f"{k.shape[2]}): device {dev} us, events "
                  f"{ev * 1e3:.2f} us a layer; {n_dev:g} device ops, "
                  f"{n_host:g} host ops {kinds}{per}")
            print(f"[{label}] digest write {tier} {name}: {digest}")


def _busy_span(dev, n):
    busy, cur_s, cur_e = 0.0, dev[0][0], dev[0][1]
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy, cur_s = busy + cur_e - cur_s, s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e for _, e, _ in dev) - dev[0][0]
    return busy / n / 1e3, span / n / 1e3


def decode_steps(label):
    from tpukern_torch.models import Config, ContinuousBatcher, init_params

    cfg = Config(vocab=32768, d_model=2048, n_layers=LAYERS, n_heads=16,
                 n_kv_heads=HKV, d_ff=8192, max_seq=4096,
                 param_dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (435, 340, 285, 178)]
    for tier, pdt in POOLS.items():
        cb = ContinuousBatcher(params, cfg, cache_dtype=pdt, n_slots=4,
                               pages_per_seq=PPS, page_size=PAGE,
                               max_new_tokens=200,
                               prompt_buckets=(128, 256, 512))
        for i, p in enumerate(prompts):
            cb.add_request(i, p)
        for _ in range(3):
            cb.step()
        n = 8
        for _ in range(3):
            dev, host = device_events(cb.step, n)
            if dev:
                break
        busy, span = _busy_span(dev, n)
        step = run_benchmark(cb.step, warmup=1, iters=8, reps=3)
        kinds = {}
        for _, _, name in dev:
            key = ("write_kv_quant_kernel" if "write_kv_quant" in name else
                   "quantize_kernel" if "quantize_kernel" in name else
                   "index_put" if "index" in name and "put" in name
                   else None)
            if key:
                kinds[key] = kinds.get(key, 0) + 1
        print(f"[{label}] {tier} decode step (4 slots, 7bish, 16 layers): "
              f"{len(dev) / n:.1f} device ops, {len(host) / n:.1f} host "
              f"ops, busy {busy:.4f} ms of a {span:.4f} ms span (busy "
              f"share {busy / span:.3f}); {step:.4f} ms a step by events; "
              f"write kernels a step "
              f"{ {k: c / n for k, c in kinds.items()} }")
        del cb
        torch.cuda.empty_cache()


def _draws(B, V, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = 3 * torch.randn((B, V), generator=gen, device="cuda")
    if B > 1:
        x[1, :20] = x[1].max()
    return x


def thresholds(label):
    from tpukern_torch.ops import sampling as sp

    for B, V in ((4, 32768), (1, 128256)):
        x = _draws(B, V, 0)
        for mode, fn in (("count k 50", lambda: sp.topk_threshold(x, 50)),
                         ("mass p 0.9 T 0.8",
                          lambda: sp.topp_threshold(x, 0.9, 0.8))):
            fn()
            ev = run_benchmark(fn, iters=20, reps=5)
            print(f"[{label}] #27 {mode} ({B}, {V}): device {_dev_us(fn)} "
                  f"us, events {ev * 1e3:.2f} us")
        lev = run_benchmark(lambda: torch.topk(x, 50), iters=20, reps=5)
        print(f"[{label}] torch.topk(x, 50) ({B}, {V}): device "
              f"{_dev_us(lambda: torch.topk(x, 50))} us, events "
              f"{lev * 1e3:.2f} us")
    for B, V, seed in THRESHOLD_DRAWS:
        x = _draws(B, V, seed)
        outs = [sp.topk_threshold(x, k) for k in COUNT_K]
        outs += [sp.topp_threshold(x, p, T) for p, T in MASS_PT]
        again = [sp.topk_threshold(x, k) for k in COUNT_K]
        again += [sp.topp_threshold(x, p, T) for p, T in MASS_PT]
        same = all(torch.equal(a, b) for a, b in zip(outs, again))
        print(f"[{label}] digest #27 ({B}, {V}) count k {COUNT_K}, mass "
              f"(p, T) {MASS_PT}: {_digest(*outs)}; second calls "
              f"{'bit-equal' if same else 'DIFFER'}")


def main(label="this tree"):
    if not torch.cuda.is_available():
        raise SystemExit("quant_sample_times needs a CUDA device")
    print(f"[{label}] {_card()}")
    writes(label)
    thresholds(label)
    decode_steps(label)


if __name__ == "__main__":
    main(*sys.argv[1:2])
