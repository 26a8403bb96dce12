"""Times of the fused cross-entropy: the bf16 forward (#13,
csrc/cross_entropy.cu: one gemm_pipeline launch and the combine) and
backward (#14/#15: three gemm_pipeline launches a vocab chunk), and the
f32 backward (three gemm_pipeline_tf32 launches a vocab chunk after the
split-TF32 operand passes).

    python -m tpukern_torch.harness.ce_times [label] [--f32]

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
Then the f32 backward at the same shape in f32 (natural-log tier, the f32
default): one line per chunk length, bwd_vocab_chunk_f32's (8192), the
whole vocab and 4096, with its launches (and the operand passes'), the
events and device times, the bounds (3 products of 2 N D V as split-TF32
products, ops/split_tf32.py bound_s, where the tree has that tier, and
at the 67 TFLOP/s of f32 FMAs), and the
largest error of dx and dW against the f64 gradients of the same inputs
(ce_bwd_f64), beside ce_bwd_ref's in f32 on cuBLAS (TF32 off); then
autograd's backward of torch.matmul and F.cross_entropy in f32. With
--f32 only the f32 lines. Needs a CUDA device.
"""

import subprocess
import sys

import torch
import torch.nn.functional as F

from tpukern_torch.harness.bench import run_benchmark
from tpukern_torch.harness.decode_times import _device_ms

N, D, V = 2048, 2048, 32768
CHUNKS = (None, 12288, 4096)  # None: bwd_vocab_chunk's
F32_CHUNKS = (None, 32768, 4096)  # None: bwd_vocab_chunk_f32's


def ce_bwd_f64(x, w, targets, lse, g):
    """(dx, dW) of sum(g * loss) in f64 from the same inputs and saved lse:
    the exact function the f32 kernels and ce_bwd_ref round."""
    xd, wd = x.double(), w.double()
    dlog = torch.exp(xd @ wd - lse.double()[:, None])
    rows = torch.arange(x.shape[0], device=x.device)
    dlog[rows, targets.long().clamp(min=0)] -= 1.0
    dlog *= torch.where(targets < 0, 0.0, g.double())[:, None]
    return dlog @ wd.T, xd.T @ dlog


def _f32_lines(label, gen):
    from tpukern_torch.ops import cross_entropy as ce
    try:
        from tpukern_torch.ops import split_tf32 as st
    except ImportError:  # a tree before the split-TF32 tier
        st = None
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.randn((N, D), generator=gen, device="cuda")
    w = torch.randn((D, V), generator=gen, device="cuda") / D ** 0.5
    t = torch.randint(0, V, (N,), generator=gen, device="cuda",
                      dtype=torch.int32)
    t[torch.rand(N, generator=gen, device="cuda") < 0.05] = -1
    g = torch.full((N,), 1.0 / N, device="cuda")
    _, lse = ce.ce_fwd(x, w, t, False)
    exact = ce_bwd_f64(x, w, t, lse, g)

    def errs(out):
        return ", ".join(f"{n} {(o.double() - e).abs().max().item():.3e}"
                         for n, o, e in zip(("dx", "dW"), out, exact))
    flops = 3 * 2 * N * D * V
    bounds = f"{flops / 67e12 * 1e3:.4f} ms f32 FMA"
    if st is not None:
        bounds = f"{st.bound_s(flops) * 1e3:.4f} ms split-TF32, " + bounds
    for chunk in F32_CHUNKS:
        kw = {} if chunk is None else dict(vocab_chunk=chunk)

        def fn():
            return ce.ce_bwd(x, w, t, lse, g, False, **kw)
        before = (ce.ce_bwd.launches,
                  st.split_tf32.launches if st else 0)
        out = fn()
        counts = (ce.ce_bwd.launches - before[0],
                  (st.split_tf32.launches if st else 0) - before[1])
        err = errs(out)
        del out
        dev = _device_ms(fn, 3)
        print(f"[{label}] ce_bwd f32 chunk {chunk or 'default'}: launches "
              f"{counts[0]} (+{counts[1]} operand passes), events "
              f"{run_benchmark(fn, warmup=1, iters=3, reps=3):.4f} ms, "
              f"device {'not measured' if dev is None else f'{dev:.4f}'} ms,"
              f" bound {bounds}, max abs err vs f64: {err}", flush=True)
    print(f"[{label}] ce_bwd_ref f32 (cuBLAS, TF32 off): max abs err vs "
          f"f64: {errs(ce.ce_bwd_ref(x, w, t, lse, g))}", flush=True)
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    loss = F.cross_entropy(torch.matmul(xl, wl), t.long(), ignore_index=-1,
                           reduction="none")

    def lib():
        return torch.autograd.grad(loss, (xl, wl), g, retain_graph=True)
    dev = _device_ms(lib, 3)
    print(f"[{label}] library f32 (autograd of matmul + cross_entropy): "
          f"events {run_benchmark(lib, warmup=1, iters=3, reps=3):.4f} ms, "
          f"device {'not measured' if dev is None else f'{dev:.4f}'} ms",
          flush=True)


def main(label="this tree", *flags):
    if not torch.cuda.is_available():
        raise SystemExit("ce_times needs a CUDA device")
    from tpukern_torch.ops import cross_entropy as ce

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[{label}] {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "--f32" in flags:
        _f32_lines(label, gen)
        return
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
    del x, w, xl, wl, loss, rdx, rdw
    _f32_lines(label, gen)


if __name__ == "__main__":
    main(*sys.argv[1:])
