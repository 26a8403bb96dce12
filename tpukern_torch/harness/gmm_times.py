"""Times of the f32 grouped GEMMs #28 (NN, trans_w) and #29 on the card.

    python -m tpukern_torch.harness.gmm_times [label] [--digests]

Prints the card's name and power limit, then one line per call of #28 NN
(the forward), #28 trans_w (dx) and #29 (dW) with f32 inputs and output,
at the Mixtral expert products (8192 routed rows balanced over 8 experts:
w1 4096 x 14336, w2 14336 x 4096) and at the bench shape (8192 x 2048 x
1408, E 8) under the five splits of tools/gmm_tune.py:136-142: events µs
(run_benchmark: the median of 5 runs of 10 back-to-back calls, L2 warm;
3 runs of 2 at Mixtral), the profiler's device µs and the operand passes'
share of it (kernels named split_tf32_kernel: none on a tree before the
split-TF32 tier), the per-group plain loop's events µs (gmm_ref/tgmm_ref:
cuBLAS f32 a group, TF32 off), the bounds (as split-TF32 products,
ops/split_tf32.py bound_s, and on the 67 TFLOP/s of f32 FMAs) with the
kernel's share of the split one by events, and the largest error of the
kernel and of the plain loop against the f64 grouped product. Then
moe_block_dropless(use_kernel=True) at Mixtral's widths in f32 (T 4096,
k 2, init_moe_params weights from seed 0): ms forward and forward plus
backward (the grads of x, router, w1, w2), and its peak device memory.

With --digests, instead: a sha256 digest of each output of the f32 #2
(acc_in_out, NN and TN, at chip_smoke.py [train kernels]' shapes), of the
f32 CE forward and backward (loss, lse, dx, dW at the 7bish head and a
tail), and of the bf16 #28 (NN, trans_w) and #29 at the Mixtral w1
product, the bench shape's five splits and a case of ragged groups:
diff two trees' lines to hold their outputs bit-equal.

To compare two versions of the kernels on one card, run it in one
command from each tree's own root, in turns: `(cd <other checkout> &&
python -m tpukern_torch.harness.gmm_times old)` (`python -m` puts the
working directory first on the path). The file has no import that a
tree of the port before the f32 grouped tier lacks, so it can be copied
into such a tree's checkout. Needs a CUDA device.
"""

import hashlib
import subprocess
import sys

import torch

from tpukern_torch.harness.bench import run_benchmark

E = 8
MIXTRAL = {"w1": (8192, 4096, 14336), "w2": (8192, 14336, 4096)}
BENCH = (8192, 2048, 1408)
SPLITS = {"balanced": [1024] * 8,
          "skewed_2x": [2048, 2048, 1024, 1024, 512, 512, 512, 512],
          "hot_expert": [4096, 1536, 1024, 512, 512, 256, 128, 128],
          "two_empty": [2048, 0, 2560, 2048, 0, 1024, 256, 256],
          "one_hot": [8192, 0, 0, 0, 0, 0, 0, 0]}
FMA_FLOP_S = 67e12  # f32 on the CUDA cores, H100 SXM at 700 W


def _inputs(gen, T, K, N, sizes, dt=torch.float32):
    """x (T, K), w (E, K, N) scaled so each product is of unit size, dy
    (T, N) scaled by the largest group's rows (chip_smoke.py _gmm_inputs),
    the int32 sizes."""
    x = torch.randn((T, K), generator=gen, device="cuda").to(dt)
    w = (torch.randn((len(sizes), K, N), generator=gen, device="cuda")
         / K ** 0.5).to(dt)
    dy = (torch.randn((T, N), generator=gen, device="cuda")
          / max(max(sizes), 1) ** 0.5).to(dt)
    return x, w, dy, torch.tensor(sizes, dtype=torch.int32, device="cuda")


def _calls(x, w, dy, gs):
    """{kind: (kernel call, plain call, (a, b) of the product a · b a
    group (tgmm: a^T · b))}."""
    from tpukern_torch.ops import grouped_matmul as gm

    return {"gmm": (lambda: gm.gmm(x, w, gs), lambda: gm.gmm_ref(x, w, gs),
                    (x, w)),
            "gmm trans_w": (lambda: gm.gmm(dy, w, gs, trans_w=True),
                            lambda: gm.gmm_ref(dy, w, gs, trans_w=True),
                            (dy, w.transpose(1, 2))),
            "tgmm": (lambda: gm.tgmm(x, dy, gs),
                     lambda: gm.tgmm_ref(x, dy, gs), (x, dy))}


def _f64_error(kind, out, a, b, sizes):
    """max |out - the f64 grouped product| over the groups' rows (gmm) or
    every group's slab (tgmm)."""
    err, off = 0.0, 0
    for e, n in enumerate(sizes):
        if kind == "tgmm":
            want = (a[off:off + n].double().T @ b[off:off + n].double()
                    if n else torch.zeros_like(out[e], dtype=torch.float64))
            got = out[e]
        else:
            want = a[off:off + n].double() @ b[e].double()
            got = out[off:off + n]
        if got.numel():
            err = max(err, (got.double() - want).abs().max().item())
        off += n
    return err


def _device(fn, n):
    """(device µs a call, the split_tf32 kernels' µs a call) from the
    profiler's kernel events over n calls, or (None, None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [(e.time_range.end - e.time_range.start, e.name)
          for e in prof.events() if e.device_type == DeviceType.CUDA
          and not getattr(e, "is_user_annotation", False)]
    if not ev:
        return None, None
    return (sum(d for d, _ in ev) / n,
            sum(d for d, name in ev if "split_tf32" in name) / n)


def _lines(label, gen, name, T, K, N, sizes, heavy):
    from tpukern_torch.ops import split_tf32

    x, w, dy, gs = _inputs(gen, T, K, N, sizes)
    sched = (dict(warmup=1, iters=2, reps=3) if heavy
             else dict(warmup=3, iters=10, reps=5))
    for kind, (kernel, plain, (a, b)) in _calls(x, w, dy, gs).items():
        flops = 2 * sum(sizes) * K * N
        ms = run_benchmark(kernel, **sched)
        dev, passes = _device(kernel, 2)
        plain_ms = run_benchmark(plain, **sched)
        out = kernel()
        err = _f64_error(kind, out, a, b, sizes)
        ref_err = _f64_error(kind, plain(), a, b, sizes)
        split = split_tf32.bound_s(flops) * 1e6
        dev_s = ("not measured" if dev is None else
                 f"{dev:.1f} us (operand passes {passes:.1f}, "
                 f"{passes / dev:.3f})")
        print(f"[{label}] {kind} {name} f32: events {ms * 1e3:.1f} us, "
              f"device {dev_s}; plain loop {plain_ms * 1e3:.1f} us; bound "
              f"{split:.1f} us split-TF32 ({split / (ms * 1e3):.3f} of it "
              f"by events), {flops / FMA_FLOP_S * 1e6:.1f} us f32 FMA; max "
              f"abs err vs f64 kernel {err:.3e}, plain {ref_err:.3e}, ratio "
              f"{err / max(ref_err, 1e-300):.3f}", flush=True)
        del out
    del x, w, dy
    torch.cuda.empty_cache()


def _dropless(label):
    """moe_block_dropless(use_kernel=True) at Mixtral's widths, f32."""
    from tpukern_torch.models.moe import init_moe_params, moe_block_dropless

    gen = torch.Generator(device="cuda").manual_seed(0)
    d, ff, T, k = 4096, 14336, 4096, 2
    mp = init_moe_params(gen, d, ff, E, device="cuda")
    mp = {n: v.requires_grad_() for n, v in mp.items()}
    x = torch.randn((T, d), generator=gen, device="cuda").requires_grad_()
    xd = x.detach()

    def both():
        out = moe_block_dropless(x, mp, k=k, use_kernel=True)
        return torch.autograd.grad((out ** 2).mean(),
                                   [x, mp["router"], mp["w1"], mp["w2"]])

    with torch.no_grad():
        fwd = run_benchmark(lambda: moe_block_dropless(
            xd, mp, k=k, use_kernel=True), warmup=2, iters=3, reps=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    back = run_benchmark(both, warmup=2, iters=3, reps=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{label}] moe_block_dropless Mixtral widths f32 T {T} k {k}: "
          f"forward {fwd:.3f} ms, forward plus backward {back:.3f} ms, peak "
          f"device memory {peak:.2f} GiB", flush=True)


def _digest(t):
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def _digests(label, gen):
    """sha256 digests of the outputs that must not move with the f32
    grouped tier: the f32 #2, the f32 CE, the bf16 #28/#29."""
    from tpukern_torch.ops import cross_entropy as ce
    from tpukern_torch.ops import matmul

    for M, N, K in ((333, 517, 1000), (2048, 8192, 2048), (128, 128, 8192),
                    (4096, 4096, 4096)):
        a = torch.randn((M, K), generator=gen, device="cuda") / K ** 0.5
        for trans_b in (False, True):
            b = torch.randn((N, K) if trans_b else (K, N), generator=gen,
                            device="cuda")
            out = matmul.matmul(a, b, trans_b=trans_b, acc_in_out=True)
            print(f"[{label}] digest matmul f32 {M}x{N}x{K} "
                  f"{'TN' if trans_b else 'NN'} {_digest(out)}", flush=True)
    for N, D, V in ((2048, 2048, 32768), (300, 100, 1001)):
        x = torch.randn((N, D), generator=gen, device="cuda")
        w = torch.randn((D, V), generator=gen, device="cuda") * 0.02
        t = torch.randint(0, V, (N,), generator=gen, device="cuda",
                          dtype=torch.int32)
        g = torch.rand((N,), generator=gen, device="cuda")
        loss, lse = ce.ce_fwd(x, w, t)
        dx, dw = ce.ce_bwd(x, w, t, lse, g)
        print(f"[{label}] digest cross_entropy f32 {N}x{D}x{V} loss "
              f"{_digest(loss)} lse {_digest(lse)} dx {_digest(dx)} dW "
              f"{_digest(dw)}", flush=True)
    shapes = [("Mixtral w1", *MIXTRAL["w1"], [1024] * E)]
    shapes += [(f"bench {s}", *BENCH, sizes) for s, sizes in SPLITS.items()]
    shapes += [("case ragged", 330, 136, 200, [37, 63, 65, 1, 129, 20])]
    for name, T, K, N, sizes in shapes:
        x, w, dy, gs = _inputs(gen, T, K, N, sizes, torch.bfloat16)
        for kind, (kernel, _, _) in _calls(x, w, dy, gs).items():
            print(f"[{label}] digest {kind} bf16 {name} {_digest(kernel())}",
                  flush=True)
        del x, w, dy


def main(label="this tree", *flags):
    if not torch.cuda.is_available():
        raise SystemExit("gmm_times needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[{label}] {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "--digests" in flags:
        _digests(label, gen)
        return
    for name, (T, K, N) in MIXTRAL.items():
        _lines(label, gen, f"Mixtral {name} {T}x{K}x{N}", T, K, N,
               [T // E] * E, heavy=True)
    for split, sizes in SPLITS.items():
        _lines(label, gen, f"bench {split} {'x'.join(map(str, BENCH))}",
               *BENCH, sizes, heavy=False)
    _dropless(label)


if __name__ == "__main__":
    main(*sys.argv[1:])
