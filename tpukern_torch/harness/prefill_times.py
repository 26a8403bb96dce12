"""Times of the float paged prefix prefill kernel (#24,
csrc/paged_prefill.cu).

    python -m tpukern_torch.harness.prefill_times [label] [--quant]

Prints the card's name and power limit, then one line per (shape, dtype,
split length): chip_smoke.py's verify shape (B 4, H 16/8, T 5, D 128, 8
pages of 128 tokens, lengths 6, 133, 705 and 1029) and its chunk shape
(B 1, T 256, length 900), in bf16 and f32, each with
paged_attention.PREFILL_CHUNK set to 64, 128, 256 and 1024 (one split)
and left to the rule (`prefill_splits`): the kernel's device time (the
profiler's, 20 calls), the CUDA events time of back-to-back calls
(run_benchmark: host issue included where it exceeds the device's), the
bound (the K/V rows some token sees, q and o, once over 3.35 TB/s) and
the largest difference from paged_prefill_ref. A tree whose module has
no PREFILL_CHUNK (one block a row tile, no split) gets one line a shape.
With --quant, the quantized kernel (csrc/paged_quant.cu) at the verify
and chunk shapes instead, in the served tiers of decode_times.py
(decode_times.quant_lines: the rule and the split lengths, the library
call, the bound).
To compare two versions of the kernel on one card, run it in one command
from each tree's own root (`cd <other checkout> && python -m
tpukern_torch.harness.prefill_times old`), the trees in turns. Needs a
CUDA device.
"""

import subprocess
import sys

import torch

from tpukern_torch.harness.bench import run_benchmark
from tpukern_torch.harness.decode_times import _device_ms, quant_lines

# name -> (B, T, pages_per_seq, lengths); H 16/8, D 128, pages of 128
SHAPES = {"verify": (4, 5, 8, [6, 133, 705, 1029]),
          "chunk": (1, 256, 8, [900])}
CHUNKS = (64, 128, 256, 1024, None)  # None: the module's own rule


def _case(gen, B, T, pps, lengths, dt):
    Hq, Hkv, D, page = 16, 8, 128, 128
    table = torch.randperm(B * pps, generator=gen, device="cuda").reshape(
        B, pps).to(torch.int32)
    kp, vp = (torch.randn((Hkv, B * pps, page, D), generator=gen,
                          device="cuda").to(dt) for _ in range(2))
    q = torch.randn((B, Hq, T, D), generator=gen, device="cuda").to(dt)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    # the K and V rows some token sees (positions below the last token's,
    # within the pool), q and o
    live = sum(min(n, pps * page) for n in lengths)
    size = torch.finfo(dt).bits // 8
    return (q, kp, vp, lens, table), (2 * live * Hkv * D
                                      + 2 * q.numel()) * size


def main(label="this tree", *flags):
    if not torch.cuda.is_available():
        raise SystemExit("prefill_times needs a CUDA device")
    from tpukern_torch.ops import paged_attention as pa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[{label}] {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "--quant" in flags:
        for name, (B, T, pps, lengths) in SHAPES.items():
            args, _ = _case(gen, B, T, pps, lengths, torch.bfloat16)
            quant_lines(label, args, f"{name} #24 quantized",
                        pa.paged_prefill_attention_quantized,
                        pa.paged_prefill_quantized_ref)
        return
    split = hasattr(pa, "PREFILL_CHUNK")
    keep = pa.PREFILL_CHUNK if split else None
    try:
        for name, (B, T, pps, lengths) in SHAPES.items():
            for dt in (torch.bfloat16, torch.float32):
                args, nbytes = _case(gen, B, T, pps, lengths, dt)
                ref = pa.paged_prefill_ref(*args)
                for chunk in CHUNKS if split else ("none",):
                    if split:
                        pa.PREFILL_CHUNK = chunk

                    def fn():
                        return pa.paged_prefill_attention(*args)
                    err = (fn().float() - ref.float()).abs().max().item()
                    dev = _device_ms(fn)
                    n = (pa.prefill_splits(*args[0].shape[:2], 8, T,
                                           pps * 128, dt)
                         if split else (1, 1))
                    print(f"[{label}] {name} {str(dt)[6:]} chunk {chunk} "
                          f"(slots a split {n[0]}, n_split {n[1]}): device "
                          f"{'not measured' if dev is None else f'{dev:.4f}'}"
                          f" ms, events {run_benchmark(fn):.4f} ms, bound "
                          f"{1e3 * nbytes / 3.35e12:.4f} ms, max_abs "
                          f"{err:.3e}")
    finally:
        if split:
            pa.PREFILL_CHUNK = keep


if __name__ == "__main__":
    main(*sys.argv[1:])
