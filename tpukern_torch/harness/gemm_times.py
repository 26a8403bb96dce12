"""Times of the bf16 GEMM kernels on the pipeline of csrc/hopper.cuh.

    python -m tpukern_torch.harness.gemm_times [label]

Prints the card's name and power limit, then one line per call: #2
`matmul` (NN, TN, both epilogues; K 4100 puts A, and a TN B, on the
producer's copy), `tgmm` #29 at 4096^3 in 1, 4 and 16 groups (the same
work in tiles of 64, 16 and 4 slabs), at Mixtral's dW1 and at the bench
shape's three splits; each the median of run_benchmark's 5 runs of 10
back-to-back calls (L2 warm), with its TFLOP/s. To compare two versions
of the kernels on one card, run it in one command on each tree, e.g.
`PYTHONPATH=<other checkout> python -m tpukern_torch.harness.gemm_times
old`, the trees in turns. Needs a CUDA device.
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


def main(label="this tree"):
    if not torch.cuda.is_available():
        raise SystemExit("gemm_times needs a CUDA device")
    from tpukern_torch.ops import grouped_matmul as gm
    from tpukern_torch.ops import matmul

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[{label}] {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)

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


if __name__ == "__main__":
    main(*sys.argv[1:2])
