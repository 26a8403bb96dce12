"""Times of the bf16 fused cross-entropy: the forward (#13,
csrc/cross_entropy.cu: one gemm_pipeline launch and the combine) and the
backward (#14/#15: three gemm_pipeline launches a vocab chunk).

    python -m tpukern_torch.harness.ce_times [label]

Prints the card's name and power limit, then, at chip_smoke.py's
training head, x (2048, 2048) by w (2048, 32768) in bf16 with about 5% of
the targets ignored: the forward's CUDA events time of back-to-back
calls, device time (the profiler's, 5 calls), bound (2 N D V operations
over 989 TFLOP/s) and largest loss and lse error against _ce_ref, then
torch.matmul and F.cross_entropy on the same inputs (the library call);
then one line per backward vocab chunk length: the whole vocab
(bwd_vocab_chunk's choice there), 12288 (three chunks) and 4096 (eight):
the CUDA events time of back-to-back calls (run_benchmark), the device
time (the profiler's, 5 calls), the bound (three products of 2 N D V
operations over 989 TFLOP/s) and the largest error of dx and dW against
ce_bwd_ref relative to their largest value; then autograd's backward of
torch.matmul and F.cross_entropy on the same inputs (the library call).
Needs a CUDA device.
"""

import subprocess
import sys

import torch
import torch.nn.functional as F

from tpukern_torch.harness.bench import run_benchmark
from tpukern_torch.harness.decode_times import _device_ms

N, D, V = 2048, 2048, 32768
CHUNKS = (None, 12288, 4096)  # None: bwd_vocab_chunk's


def main(label="this tree"):
    if not torch.cuda.is_available():
        raise SystemExit("ce_times needs a CUDA device")
    from tpukern_torch.ops import cross_entropy as ce

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[{label}] {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((N, D), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((D, V), generator=gen, device="cuda") / D ** 0.5).to(
        torch.bfloat16)
    t = torch.randint(0, V, (N,), generator=gen, device="cuda",
                      dtype=torch.int32)
    t[torch.rand(N, generator=gen, device="cuda") < 0.05] = -1
    g = torch.full((N,), 1.0 / N, device="cuda")

    def fwd():
        return ce.ce_fwd(x, w, t, True)

    def lib_fwd():
        return F.cross_entropy(torch.matmul(x, w).float(), t.long(),
                               ignore_index=-1, reduction="none")
    loss, lse = fwd()
    rloss, rlse = ce._ce_ref(x, w, t)
    err = max((a - b).abs().max().item() for a, b in ((loss, rloss),
                                                       (lse, rlse)))
    for name, fn in (("ce_fwd bf16", fwd),
                     ("library (matmul + cross_entropy)", lib_fwd)):
        dev = _device_ms(fn, 5)
        print(f"[{label}] {name}: events {run_benchmark(fn):.4f} ms, device "
              f"{'not measured' if dev is None else f'{dev:.4f}'} ms, bound "
              f"{2 * N * D * V / 989e12 * 1e3:.4f} ms"
              + (f", max abs err {err:.3e}" if fn is fwd else ""))
    rdx, rdw = ce.ce_bwd_ref(x, w, t, lse, g)
    bound = 3 * 2 * N * D * V / 989e12 * 1e3
    for chunk in CHUNKS:
        kw = {} if chunk is None else dict(vocab_chunk=chunk)

        def fn():
            return ce.ce_bwd(x, w, t, lse, g, True, **kw)
        dx, dw = fn()
        err = max(((a - b).abs().max() / b.abs().max()).item()
                  for a, b in ((dx, rdx), (dw, rdw)))
        dev = _device_ms(fn, 5)
        print(f"[{label}] ce_bwd bf16 chunk {chunk or 'default'}: events "
              f"{run_benchmark(fn):.4f} ms, device "
              f"{'not measured' if dev is None else f'{dev:.4f}'} ms, bound "
              f"{bound:.4f} ms, max rel err {err:.3e}")
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    loss = F.cross_entropy(torch.matmul(xl, wl).float(), t.long(),
                           ignore_index=-1, reduction="none")

    def lib():
        return torch.autograd.grad(loss, (xl, wl), g, retain_graph=True)
    dev = _device_ms(lib, 5)
    print(f"[{label}] library (autograd of matmul + cross_entropy): events "
          f"{run_benchmark(lib):.4f} ms, device "
          f"{'not measured' if dev is None else f'{dev:.4f}'} ms")


if __name__ == "__main__":
    main(*sys.argv[1:2])
