"""Times of the GEMM kernels on the pipelines of csrc/hopper.cuh.

    python -m tpukern_torch.harness.gemm_times [label] [--f32]

Prints the card's name and power limit, then one line per call: #2
`matmul` (NN, TN, both epilogues; K 4100 puts A, and a TN B, on the
producer's copy), `tgmm` #29 at 4096^3 in 1, 4 and 16 groups (the same
work in tiles of 64, 16 and 4 slabs), at Mixtral's dW1 and at the bench
shape's three splits; each the median of run_benchmark's 5 runs of 10
back-to-back calls (L2 warm), with its TFLOP/s. Then the f32 tier (#2
with f32 inputs and output, as matmul_t calls it) at 2048 x 8192 x 2048
and 4096^3, NN and TN: events and device time (the profiler's, 5 calls);
the split passes alone
(split_tf32.split_tf32 on A and B, the share of the call they take);
cuBLAS f32 (TF32 off) on the same inputs; the bounds (as split-TF32
products, ops/split_tf32.py bound_s, where the tree has that tier, and
at the 67 TFLOP/s of f32 FMAs); and the
largest error of the kernel and of cuBLAS against the f64 product; then
that error alone (no timing) at ACCURACY_SHAPES, short and long
contractions and ragged edges, NN and TN. With --f32 only the f32
lines. To compare two versions
of the kernels on one card, run it in one command from each tree's own
root, e.g. `(cd <other checkout> && python -m
tpukern_torch.harness.gemm_times old)`, the trees in turns (`python -m`
puts the working directory first on the path, before PYTHONPATH). Needs
a CUDA device.
"""

import subprocess
import sys

import torch

from tpukern_torch.harness.bench import run_benchmark


def _shapes():
    """(label, kernel name, (M, N, K) or (T, K, N, sizes), trans_b, f32
    out)."""
    mm = [("matmul 2048x8192x2048 NN bf16 out", (2048, 8192, 2048), False,
           False),
          ("matmul 2048x8192x2048 NN f32 out", (2048, 8192, 2048), False,
           True),
          ("matmul 2048x8192x2048 TN f32 out", (2048, 8192, 2048), True,
           True),
          ("matmul 4096^3 NN", (4096, 4096, 4096), False, False),
          ("matmul 4096^3 TN", (4096, 4096, 4096), True, False),
          ("matmul 4096x4096x4100 NN (A copied)", (4096, 4096, 4100), False,
           False),
          ("matmul 4096x4096x4100 TN (both copied)", (4096, 4096, 4100),
           True, False)]
    tg = [(f"tgmm 4096^3 in {n} groups", (4096, 4096, 4096, [4096 // n] * n))
          for n in (1, 4, 16)]
    tg += [("tgmm Mixtral dW1", (8192, 4096, 14336, [1024] * 8))]
    tg += [(f"tgmm bench {name}", (8192, 2048, 1408, sizes)) for name, sizes
           in (("balanced", [1024] * 8),
               ("skewed_2x", [2048, 2048, 1024, 1024, 512, 512, 512, 512]),
               ("one_hot", [8192] + [0] * 7))]
    return mm, tg


F32_SHAPES = [(2048, 8192, 2048), (4096, 4096, 4096)]
# (M, N, K) of the f32 tier's accuracy lines: one slab and a tail, the
# odd shape of chip_smoke.py's gate, long contractions on one tile and on
# many, tiny and ragged
ACCURACY_SHAPES = [(130, 300, 37), (333, 517, 1000), (128, 128, 8192),
                   (1024, 1024, 8192), (64, 64, 16384), (7, 9, 5)]


def _f32_lines(label, gen):
    """The f32 tier: the kernel, the split passes, cuBLAS f32, the bounds
    and the errors against f64."""
    from tpukern_torch.harness.decode_times import _device_ms
    from tpukern_torch.ops import matmul
    try:
        from tpukern_torch.ops import split_tf32
    except ImportError:  # a tree before the split-TF32 tier
        split_tf32 = None
    torch.backends.cuda.matmul.allow_tf32 = False
    for M, N, K in F32_SHAPES:
        flops = 2 * M * N * K
        bounds = f"{flops / 67e12 * 1e6:.1f} us f32 FMA"
        if split_tf32 is not None:
            bounds = (f"{split_tf32.bound_s(flops) * 1e6:.1f} us split-TF32, "
                      + bounds)
        for trans_b in (False, True):
            a = torch.randn((M, K), generator=gen, device="cuda") / K ** 0.5
            b = torch.randn((N, K) if trans_b else (K, N), generator=gen,
                            device="cuda")
            bt = b.T if trans_b else b
            tag = f"f32 {M}x{N}x{K} {'TN' if trans_b else 'NN'}"
            exact = torch.matmul(a.double(), bt.double())

            def fn():
                return matmul.matmul(a, b, trans_b=trans_b, acc_in_out=True)
            err = (fn().double() - exact).abs().max().item()
            ms, dev = run_benchmark(fn, warmup=3, iters=10, reps=5), \
                _device_ms(fn, 5)
            print(f"[{label}] matmul {tag}: events {ms * 1e3:.1f} us, device "
                  f"{'not measured' if dev is None else f'{dev * 1e3:.1f}'}"
                  f" us, {flops / ms / 1e9:.1f} TFLOP/s, bound {bounds}, max abs "
                  f"err vs f64 {err:.3e}", flush=True)
            if split_tf32 is not None:
                def split():
                    split_tf32.split_tf32(a)
                    split_tf32.split_tf32(b, transpose=not trans_b)
                ms = run_benchmark(split, warmup=3, iters=10, reps=5)
                print(f"[{label}] split passes {tag} (A, B"
                      f"{'' if trans_b else ' transposed'}): events "
                      f"{ms * 1e3:.1f} us", flush=True)

            def lib():
                return torch.matmul(a, bt)
            err = (lib().double() - exact).abs().max().item()
            ms, dev = run_benchmark(lib, warmup=3, iters=10, reps=5), \
                _device_ms(lib, 5)
            print(f"[{label}] cuBLAS {tag}: events {ms * 1e3:.1f} us, device "
                  f"{'not measured' if dev is None else f'{dev * 1e3:.1f}'}"
                  f" us, max abs err vs f64 {err:.3e}", flush=True)
            del a, b, bt, exact
    for M, N, K in ACCURACY_SHAPES:
        for trans_b in (False, True):
            a = torch.randn((M, K), generator=gen, device="cuda") / K ** 0.5
            b = torch.randn((N, K) if trans_b else (K, N), generator=gen,
                            device="cuda")
            bt = b.T if trans_b else b
            exact = torch.matmul(a.double(), bt.double())
            err = (matmul.matmul(a, b, trans_b=trans_b).double()
                   - exact).abs().max().item()
            lib = (torch.matmul(a, bt).double() - exact).abs().max().item()
            print(f"[{label}] accuracy f32 {M}x{N}x{K} "
                  f"{'TN' if trans_b else 'NN'}: max abs err vs f64 kernel "
                  f"{err:.3e}, cuBLAS {lib:.3e}, ratio "
                  f"{err / max(lib, 1e-300):.3f}", flush=True)


def main(label="this tree", *flags):
    if not torch.cuda.is_available():
        raise SystemExit("gemm_times needs a CUDA device")
    from tpukern_torch.ops import grouped_matmul as gm
    from tpukern_torch.ops import matmul

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[{label}] {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "--f32" in flags:
        _f32_lines(label, gen)
        return

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def line(name, fn, flops):
        ms = run_benchmark(fn, warmup=3, iters=10, reps=5)
        print(f"[{label}] {name}: {ms * 1e3:.1f} us, "
              f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)

    mm, tg = _shapes()
    for name, (M, N, K), trans_b, f32 in mm:
        a, b = randn(M, K), randn(*((N, K) if trans_b else (K, N)))
        line(name, lambda: matmul.matmul(a, b, trans_b=trans_b,
                                         acc_in_out=f32), 2 * M * N * K)
    for name, (T, K, N, sizes) in tg:
        x, dy = randn(T, K), randn(T, N)
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        line(name, lambda: gm.tgmm(x, dy, gs), 2 * sum(sizes) * K * N)
        del x, dy
    _f32_lines(label, gen)


if __name__ == "__main__":
    main(*sys.argv[1:])
