"""Times of the w8a16 GEMM #25 (csrc/matmul_w8a16.cu) at the 7bish
serving shapes, and its share of a w8a16 decode step.

    python -m tpukern_torch.harness.w8a16_times [label] [--sweep]

Prints the card's name and power limit, then one line per (weight, M):
the 7bish projections (head 2048 x 32768, w1 2048 x 8192, w2 8192 x 2048,
wq/wo 2048 x 2048, wk/wv 2048 x 1024) at M = 1, 4, 8, 20, 64 and 128 rows
of bf16 activations (M = 4: a decode step of 4 slots; 20: a gamma = 4
verification of 4 slots; 128: a bucket-128 prefill): the kernel's device
time (the profiler's, 20 calls) and CUDA events time of back-to-back
calls (run_benchmark: host issue included where it exceeds the
device's), the bound (the int8 weights, the f32 scales, x and y moved
once over 3.35 TB/s, or 2 M K N operations over 989 TFLOP/s, whichever
is larger) and the share of it reached by device time, the largest error
against matmul_w8a16_ref and whether a second call gives the same bits;
beside torch.matmul of the same x by the weights dequantized to bf16 (the
bf16 tier's GEMM, twice the weight bytes; the library call). Back-to-back
calls of one weight find it in the 50 MB L2 when it is smaller (all but
the head); the decode step below reads each layer's weights once.

Then one w8a16 decode step of the 7bish model (16 layers, random weights
from seed 0, quantize_model_weights, 4 slots with prompts of 435, 340,
285 and 178 tokens): #25's launches and device time a step and the
step's busy device time, from torch.profiler over 8 steps. To compare
two versions on one card, run it from each tree's own root in one
command, the trees in turns. With --sweep it prints instead, for each
weight at M = 4, 20 and 128, the kernel's device time at each forced
count of K splits (matmul_w8a16.SPLITS: 1 to 32) beside the rule's.
Needs a CUDA device.
"""

import subprocess
import sys

import numpy as np
import torch

from tpukern_torch.harness.bench import run_benchmark
from tpukern_torch.harness.decode_times import _device_ms

D_MODEL, D_FF, VOCAB, HQ, HKV, HEAD_DIM = 2048, 8192, 32768, 16, 8, 128
WEIGHTS = {"head": (D_MODEL, VOCAB), "w1": (D_MODEL, D_FF),
           "w2": (D_FF, D_MODEL), "wq/wo": (D_MODEL, HQ * HEAD_DIM),
           "wk/wv": (D_MODEL, HKV * HEAD_DIM)}
MS = (1, 4, 8, 20, 64, 128)
PROMPTS = (435, 340, 285, 178)


def bound_ms(M, K, N):
    """The least ms for one bf16 w8a16 product: bytes (int8 weights, f32
    scales, bf16 x and y) over 3.35 TB/s, or operations over 989
    TFLOP/s."""
    nbytes = K * N + 4 * N + 2 * M * K + 2 * M * N
    return max(nbytes / 3.35e12, 2 * M * K * N / 989e12) * 1e3


def _line(label, name, fn, bound, extra=""):
    dev = _device_ms(fn, 20)
    ev = run_benchmark(fn)
    dev_s = "not measured" if dev is None else f"{dev * 1e3:.1f}"
    share = "" if dev is None else f" ({bound / dev:.1%} of the bound)"
    print(f"[{label}] {name}: device {dev_s} us{share}, events "
          f"{ev * 1e3:.1f} us, bound {bound * 1e3:.1f} us{extra}",
          flush=True)


def _shapes(label, gen):
    from tpukern_torch.ops import matmul_w8a16 as w8
    for name, (K, N) in WEIGHTS.items():
        q, s = w8.quantize_weights(
            0.02 * torch.randn((K, N), generator=gen, device="cuda"))
        wd = (q.float() * s).to(torch.bfloat16)
        for M in MS:
            x = torch.randn((M, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            out = w8.matmul_w8a16(x, q, s)
            again = w8.matmul_w8a16(x, q, s)
            err = (out.float() - w8.matmul_w8a16_ref(x, q, s).float()).abs()
            bound = bound_ms(M, K, N)
            _line(label, f"{name} M {M}", lambda: w8.matmul_w8a16(x, q, s),
                  bound, f", max abs err {err.max().item():.3e}, repeat "
                  f"{'bit-equal' if torch.equal(out, again) else 'DIFFERS'}")
            _line(label, f"{name} M {M} library (torch.matmul, bf16 weights)",
                  lambda: torch.matmul(x, wd), bound)
        del q, s, wd


def _sweep(label, gen):
    from tpukern_torch.ops import matmul_w8a16 as w8
    for name, (K, N) in WEIGHTS.items():
        q, s = w8.quantize_weights(
            0.02 * torch.randn((K, N), generator=gen, device="cuda"))
        for M in (4, 20, 128):
            x = torch.randn((M, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            rule = w8._splits(M, N, K, w8._sm_count(0))[0]
            times = []
            for n in (1, 2, 4, 8, 16, 32):
                w8.SPLITS = n
                try:
                    dev = _device_ms(lambda: w8.matmul_w8a16(x, q, s), 20)
                finally:
                    w8.SPLITS = None
                times.append(f"{n}: {dev * 1e3:.1f}" if dev else f"{n}: -")
            print(f"[{label}] sweep {name} M {M} (rule {rule} splits), "
                  f"device us by splits: {', '.join(times)}", flush=True)
        del q, s


def _decode_step(label):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpukern_torch.models import Config, init_params, serving
    from tpukern_torch.models.batcher import ContinuousBatcher
    from tpukern_torch.ops import matmul_w8a16 as w8

    cfg = Config(vocab=VOCAB, d_model=D_MODEL, n_layers=16, n_heads=HQ,
                 n_kv_heads=HKV, d_ff=D_FF, max_seq=4096,
                 param_dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    qparams = serving.quantize_model_weights(params)
    del params
    cb = ContinuousBatcher(qparams, cfg, n_slots=4, pages_per_seq=8,
                           page_size=128, max_new_tokens=64,
                           prompt_buckets=(128, 256, 512))
    rng = np.random.default_rng(0)
    for i, n in enumerate(PROMPTS):
        cb.add_request(i, rng.integers(0, cfg.vocab, n).astype(np.int32))
    for _ in range(2):
        cb.step()
    n, before = 8, w8.matmul_w8a16.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            cb.step()
        torch.cuda.synchronize()
    launches = (w8.matmul_w8a16.launches - before) / n
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
          and not getattr(e, "is_user_annotation", False)]
    total = sum(e.time_range.end - e.time_range.start for e in ev) / n
    mine = sum(e.time_range.end - e.time_range.start for e in ev
               if "w8a16_" in e.name) / n
    print(f"[{label}] w8a16 decode step (4 slots, 16 layers): #25 "
          f"{launches:.0f} launches, device {mine / 1e3:.4f} ms of "
          f"{total / 1e3:.4f} ms busy a step", flush=True)


def main(label="this tree", *flags):
    if not torch.cuda.is_available():
        raise SystemExit("w8a16_times needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[{label}] {card}")
    if "--sweep" in flags:
        _sweep(label, torch.Generator(device="cuda").manual_seed(0))
        return
    _shapes(label, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.empty_cache()
    _decode_step(label)


if __name__ == "__main__":
    main(*sys.argv[1:])
