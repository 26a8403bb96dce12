"""Times of the bf16 flash-attention forward (#6, csrc/flash_attention.cu).

    python -m tpukern_torch.harness.fa_times [label]

Prints the card's name and power limit, then one line per (shape, tile
shape): the 7bish prefill heads (B 1, H 16/8, D 128, causal) at the
serving length S 512 and at S 4096, each at the kernel's default tiles
and at every shape of attention.FWD_CONFIGS (64 or 128 query rows a
block, 64- or 128-key tiles, the two heads of a GQA pair on one K/V
stream), and the Gemma-2 serving masks (window 512, 4 sinks, softcap
50) at S 512 and 1024 at the default tiles: the kernel's device time (the
profiler's, 20 calls), the CUDA events time of back-to-back calls
(run_benchmark: host issue included where it exceeds the device's), the
bound (the larger of q, k, v and o moved once over 3.35 TB/s and the
visible pairs' 4 D flops over 989 TFLOP/s), the share of it reached, and
the largest error against attention_ref; then
F.scaled_dot_product_attention on the same inputs (the library call). SDPA
cannot express a softcap: the Gemma-2 masks' library call is
torch.compile of flex_attention in bf16, the softcap as its score_mod and
the window plus the sinks as its block mask, timed the same way (its
compile caches under tpukern_torch/build/, as chip_smoke.py keeps
them). A tree without
the tile option (the redesign's parent) times its one kernel. To compare
two versions on one card, run it in one command from each tree's own
root (`python -m` puts the working directory first on the path), the
trees in turns. Needs a CUDA device.
"""

import os
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from tpukern_torch.harness.bench import run_benchmark
from tpukern_torch.harness.decode_times import _device_ms

HQ, HKV, D = 16, 8, 128
LENGTHS = (512, 4096)
GEMMA2 = dict(window=512, sinks=4, softcap=50.0)


def _bound_ms(S, nbytes, **masks):
    pairs = int(_visible(S, **masks).sum())
    return max(4 * D * HQ * pairs / 989e12, nbytes / 3.35e12) * 1e3


def _visible(S, **masks):
    from tpukern_torch.ops import attention
    return attention.visible(S, S, "cuda", causal=True, **{
        k: v for k, v in masks.items() if k != "softcap"})


def _line(label, name, fn, ref, bound):
    out = fn()
    err = (out.float() - ref.float()).abs().max().item()
    dev = _device_ms(fn, 20)
    ev = run_benchmark(fn)
    dev_s = "not measured" if dev is None else f"{dev:.4f}"
    share = "" if dev is None else f" ({bound / dev:.1%} of the bound)"
    print(f"[{label}] {name}: device {dev_s} ms{share}, events {ev:.4f} ms, "
          f"bound {bound:.4f} ms, max abs err {err:.3e}")


def main(label="this tree"):
    if not torch.cuda.is_available():
        raise SystemExit("fa_times needs a CUDA device")
    build = Path(__file__).resolve().parents[1] / "build"
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(build / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    from tpukern_torch.ops import attention

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[{label}] {card}")
    configs = [None, *getattr(attention, "FWD_CONFIGS", {})]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for S in LENGTHS:
        q = torch.randn((1, HQ, S, D), generator=gen, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn((1, HKV, S, D), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        bound = _bound_ms(S, nbytes)
        ref = attention.attention_ref(q, k, v, causal=True)
        for tiles in configs:
            if tiles is not None:
                attention.FWD_TILES = tiles
            try:
                _line(label, f"S {S} tiles {tiles or 'default'}",
                      lambda: attention.flash_attention(q, k, v, causal=True),
                      ref, bound)
            finally:
                if tiles is not None:
                    attention.FWD_TILES = None
        _line(label, f"S {S} library (SDPA)",
              lambda: F.scaled_dot_product_attention(
                  q, k, v, is_causal=True, enable_gqa=True), ref, bound)
        del ref
    for S in (512, 1024):
        q = torch.randn((1, HQ, S, D), generator=gen, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn((1, HKV, S, D), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        ref = attention.attention_ref(q, k, v, causal=True, **GEMMA2)
        bound = _bound_ms(S, nbytes, **GEMMA2)
        _line(label, f"S {S} gemma2 masks, default tiles",
              lambda: attention.flash_attention(q, k, v, causal=True,
                                                **GEMMA2),
              ref, bound)
        flex = _flex_gemma2(S)
        _line(label, f"S {S} gemma2 masks library (compiled flex_attention)",
              lambda: flex(q, k, v), ref, bound)
        del ref


def _flex_gemma2(S):
    """torch.compile of flex_attention with the Gemma-2 masks: softcap
    as cap·tanh(s/cap) of the scaled score, the causal band of `window`
    keys plus the first `sinks` as the block mask, GQA inside."""
    from functools import partial

    import torch._inductor.config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    cap, window, sinks = (GEMMA2[k] for k in ("softcap", "window", "sinks"))

    def score_mod(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    def mask(b, h, qi, ki):
        return (ki <= qi) & ((ki > qi - window) | (ki < sinks))

    torch._inductor.config.compile_threads = 1  # no worker processes
    return partial(torch.compile(flex_attention), score_mod=score_mod,
                   block_mask=create_block_mask(mask, None, None, S, S,
                                                device="cuda"),
                   enable_gqa=True)


if __name__ == "__main__":
    main(*sys.argv[1:2])
