"""Times of the float paged decode kernel (#23, csrc/paged_attention.cu).

    python -m tpukern_torch.harness.decode_times [label]

Prints the card's name and power limit, then one line per (shape, split
length): the serving shape of chip_smoke.py (B 4, H 16/8, D 128, 8 pages
of 128 tokens, lengths 1, 129, 700 and 1024, bf16) and 4 sequences of
8192 tokens (64 pages), each with paged_attention.DECODE_CHUNK set to
64, 128 and 256 (and n_split with it): the kernel's device time (the
profiler's, 20 calls), the CUDA events time of back-to-back calls
(run_benchmark: host issue included where it exceeds the device's), and
the bound (the K/V rows read once over 3.35 TB/s). To compare two
versions of the kernel on one card, run it in one command from each
tree's own root, e.g. `(cd <other checkout> && python -m
tpukern_torch.harness.decode_times old)`, the trees in turns (`python
-m` puts the working directory first on the path, before PYTHONPATH).
Needs a CUDA device.
"""

import subprocess
import sys

import torch

from tpukern_torch.harness.bench import run_benchmark

SHAPES = {"serving": (8, [1, 129, 700, 1024]),
          "4 x 8192": (64, [8192] * 4)}
CHUNKS = (64, 128, 256)


def _device_ms(fn, n=20):
    """Device ms per call: the sum of the profiled kernels' durations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / n / 1e3 if us else None


def _case(gen, pps, lengths):
    B, Hq, Hkv, D, page = len(lengths), 16, 8, 128, 128
    table = torch.randperm(B * pps, generator=gen, device="cuda").reshape(
        B, pps).to(torch.int32)
    kp, vp = (torch.randn((Hkv, B * pps, page, D), generator=gen,
                          device="cuda").to(torch.bfloat16) for _ in range(2))
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    live = sum(min(n, pps * page) for n in lengths)
    return (q, kp, vp, lens, table), 2 * live * Hkv * D * 2


def main(label="this tree"):
    if not torch.cuda.is_available():
        raise SystemExit("decode_times needs a CUDA device")
    from tpukern_torch.ops import paged_attention as pa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[{label}] {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    keep = pa.DECODE_CHUNK
    try:
        for name, (pps, lengths) in SHAPES.items():
            args, nbytes = _case(gen, pps, lengths)
            for chunk in CHUNKS:
                pa.DECODE_CHUNK = chunk

                def fn():
                    return pa.paged_attention(*args)
                ref = pa.paged_attention_split_ref(*args, chunk=chunk)
                err = (fn().float() - ref.float()).abs().max().item()
                dev = _device_ms(fn)
                print(f"[{label}] {name} chunk {chunk} (n_split "
                      f"{pa.decode_splits(pps, 128)}): device "
                      f"{'not measured' if dev is None else f'{dev:.4f}'} "
                      f"ms, events {run_benchmark(fn):.4f} ms, bound "
                      f"{1e3 * nbytes / 3.35e12:.4f} ms, max_abs {err:.3e}")
    finally:
        pa.DECODE_CHUNK = keep


if __name__ == "__main__":
    main(*sys.argv[1:2])
