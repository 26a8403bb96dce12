"""Times of the paged decode kernels (#23): the float one
(csrc/paged_attention.cu) and the quantized one (csrc/paged_quant.cu).

    python -m tpukern_torch.harness.decode_times [label] [--quant]

Prints the card's name and power limit, then one line per (shape, split
length): the serving shape of chip_smoke.py (B 4, H 16/8, D 128, 8 pages
of 128 tokens, lengths 1, 129, 700 and 1024, bf16) and 4 sequences of
8192 tokens (64 pages), each with paged_attention.DECODE_CHUNK set to
64, 128 and 256 (and n_split with it): the kernel's device time (the
profiler's, 20 calls), the CUDA events time of back-to-back calls
(run_benchmark: host issue included where it exceeds the device's), and
the bound (the K/V rows read once over 3.35 TB/s). With --quant, the
quantized tiers as served (QUANT_TIERS: int8 pools with q_int8, with and
without pv_int8 at 8 pages a block, fp8) at the serving shape instead,
each at the module's split rule and, where the module has QUANT_CHUNK,
at split lengths of 64, 256 and 1024 slots (a pv_int8 split holds whole
page blocks), beside the library call (SDPA with the mask of the visible
slots on a dequantized gathered copy made outside the timed call) and
the bound (the 1-byte K/V rows and their f32 scales, q and o, once). To compare two
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
# the quantized tiers as served: pool dtype, q_int8, pv_int8,
# pages_per_block (chip_smoke.py QUANT_SERVED)
QUANT_TIERS = {"int8 q_int8": ("int8", True, False, 8),
               "int8 q_int8 pv_int8 ppb8": ("int8", True, True, 8),
               "fp8": ("fp8", False, False, 8)}
QUANT_CHUNKS = (None, 64, 256, 1024)  # None: the module's rule


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


def quant_case(args, tier):
    """(args, kw, library call, bound ms) of the quantized tier on a float
    case's q and pools (q, k_pages, v_pages, lengths, table; q (B, Hq, D)
    or (B, Hq, T, D)): the pools quantized by quantize_pages."""
    from functools import partial

    import torch.nn.functional as F

    from tpukern_torch.ops import paged_attention as pa

    q, kp, vp, lens, table = args
    dtype, q_int8, pv_int8, ppb = QUANT_TIERS[tier]
    kq, ks = pa.quantize_pages(kp.float(), dtype)
    vq, vs = pa.quantize_pages(vp.float(), dtype)
    kw = dict(pages_per_block=ppb, q_int8=q_int8, pv_int8=pv_int8)
    q4 = q[:, :, None] if q.dim() == 3 else q
    B, _, T, D = q4.shape
    Hkv, _, page, _ = kq.shape
    S = table.shape[1] * page
    keep, _ = pa._visible(lens, T, S, None, None, False, q.device)
    kd, vd = ((p.float() * sc[..., None]).to(q.dtype)
              for p, sc in ((kq, ks), (vq, vs)))
    k, v = (p[:, table.long()].permute(1, 0, 2, 3, 4).reshape(B, Hkv, S, D)
            .contiguous() for p in (kd, vd))
    lib = partial(F.scaled_dot_product_attention, q4, k, v,
                  attn_mask=keep[:, None], enable_gqa=True)
    live = int(keep.any(dim=1).sum())
    nbytes = 2 * q.numel() * q.element_size() + 2 * live * Hkv * (D + 4)
    return (q, kq, ks, vq, vs, lens, table), kw, lib, 1e3 * nbytes / 3.35e12


def quant_lines(label, args, name, fn, ref):
    """One line per quantized tier and split length of fn (the decode or
    the prefix entry point) on the case args, beside ref (its plain
    version) and the library call."""
    from tpukern_torch.ops import paged_attention as pa

    levers = hasattr(pa, "QUANT_CHUNK")
    keep = pa.QUANT_CHUNK if levers else None
    try:
        for tier in QUANT_TIERS:
            qargs, kw, lib, bound = quant_case(args, tier)
            want = ref(*qargs, **kw).float()
            for chunk in QUANT_CHUNKS if levers else (None,):
                if levers:
                    pa.QUANT_CHUNK = chunk

                def call():
                    return fn(*qargs, **kw)
                err = (call().float() - want).abs().max().item()
                dev = _device_ms(call)
                split = ""
                if levers:
                    q = qargs[0]
                    T = 1 if q.dim() == 3 else q.shape[2]
                    page = qargs[1].shape[2]
                    split = " (slots a split %d, n_split %d)" % pa.quant_splits(
                        q.shape[0], q.shape[1], qargs[1].shape[0], T,
                        qargs[6].shape[1] * page, page * kw["pages_per_block"],
                        kw["pv_int8"])
                print(f"[{label}] {name} {tier} chunk {chunk}{split}: device "
                      f"{'not measured' if dev is None else f'{dev:.4f}'} "
                      f"ms, events {run_benchmark(call):.4f} ms, bound "
                      f"{bound:.4f} ms, max_abs {err:.3e}")
            dev = _device_ms(lib)
            print(f"[{label}] {name} {tier} library (SDPA on a dequantized "
                  f"copy): device "
                  f"{'not measured' if dev is None else f'{dev:.4f}'} ms, "
                  f"events {run_benchmark(lib):.4f} ms")
    finally:
        if levers:
            pa.QUANT_CHUNK = keep


def main(label="this tree", *flags):
    if not torch.cuda.is_available():
        raise SystemExit("decode_times needs a CUDA device")
    from tpukern_torch.ops import paged_attention as pa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[{label}] {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "--quant" in flags:
        args, _ = _case(gen, *SHAPES["serving"])
        quant_lines(label, args, "serving #23 quantized",
                    pa.paged_attention_quantized,
                    pa.paged_attention_quantized_ref)
        return
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
    main(*sys.argv[1:])
