"""Small-op benchmark of the port: bench/ops.py's role.

Walks the port's variant registry (tpukern_torch.core.registry) on the
card at bench/ops.py's shapes (S = K = 4096; the matmul ladder at
S x K x S) and prints, for each variant, the time of one call with the L2
flushed before it (harness.bench.run_benchmark(flush_l2=True)), its
rate (GB/s, and TFLOP/s where the variant counts operations) and its
share of the bound: the larger of the bytes it must move (its
`bytes_moved` where it has one, else each input read once and each
output written once) over 3.35 TB/s and its operations over the H100's
peak for their type. With --check each variant is first
held against its plain version (`ref`) by `check`. A PENDING variant is
listed with its reason and never run. Nothing is swallowed: a variant
that raises stops the run with its traceback, and one that misses its
check makes the exit code 1.

    python -m tpukern_torch.harness.ops_bench [--family F] [--S 4096]
        [--K 4096] [--check] [--iters N]

chip_smoke.py's [zoo] phase and tests/test_torch_registry.py build their
inputs and checks from `inputs` and `check` here.
"""

import argparse
import dataclasses
import math
import sys

import torch

import tpukern_torch.ops  # noqa: F401  (fills the registry)
from tpukern_torch.core import registry
from tpukern_torch.harness.bench import run_benchmark
from tpukern_torch.ops import reduce, split_tf32

EW_FAMILIES = ["elementwise", "relu", "elu", "gelu", "swish", "sigmoid",
               "hardswish", "hardshrink"]
# bench/ops.py's order, then the families it leaves to other scripts
FAMILIES = EW_FAMILIES + [
    "softmax", "layer_norm", "rms_norm", "rope", "reduce", "dot_product",
    "transpose", "embedding", "histogram", "gemv", "nms", "cross_entropy",
    "sampling", "grouped_matmul", "matmul_w8a16", "matmul", "attention",
    "paged_attention", "quant"]

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense):
# HBM bytes/s and the FLOP/s of the unit a dtype runs on. SPLIT_TF32: an
# f32 product of the split-TF32 tier (#1-#3, #17, #14/#15), PRODUCTS TF32
# products on the tensor cores (ops/split_tf32.py)
PEAK_BYTES_S = 3.35e12
SPLIT_TF32 = "split-tf32"
PEAK_FLOP_S = {torch.float32: 67e12, torch.bfloat16: 989e12,
               torch.float16: 989e12, torch.int8: 1979e12,
               SPLIT_TF32: split_tf32.TF32_PEAK_FLOP_S / split_tf32.PRODUCTS}
# kernel-vs-plain tolerances (max |out - ref| <= atol + rtol |ref|) by the
# lowest precision among a variant's inputs and output: the _TOLS rows of
# core.tolerances, and f32 1e-4 (CUDA's exp/rsqrt and the kernels'
# summation order differ from PyTorch's in the last bits)
TOLS = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2),
        torch.float16: (2e-3, 2e-3), torch.float8_e4m3fn: (1.5e-1, 1.5e-1),
        torch.float8_e5m2: (3e-1, 3e-1)}
# softmax outputs are probabilities, most of them far below TOLS's atol
# (a 4096-wide row's are about 2e-4, the global softmax's of 4096^2 about
# 6e-8): their atol is scaled by each row's largest |ref| (the whole
# array's for the global softmax), and each row must sum to 1 within the
# rounding of its outputs to their dtype (at most UNIT_ROUNDOFF |y| an
# element, or HALF_SUBNORMAL, half the subnormal step, where y is below
# the normal range: most of an f16 row of 262144 outputs is) plus
# SOFTMAX_SUM_F32 for the f32 statistics: the kernels' longest chain of
# roundings in a row's denominator (about 350 at 262144 columns: 64
# packs a thread, then the trees) is about 2e-5 at worst and about 1e-6
# as a random walk
UNIT_ROUNDOFF = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8,
                 torch.float16: 2.0 ** -11}
HALF_SUBNORMAL = {torch.float32: 2.0 ** -150, torch.bfloat16: 2.0 ** -134,
                  torch.float16: 2.0 ** -25}
SOFTMAX_SUM_F32 = 2e-5
# a grouped product's outputs are f32 sums of n terms (a group's rows in
# tgmm, K in gmm and gemv), summed in another order by the kernel than by ref:
# each order's rounding error is a random walk of about sqrt(n)
# UNIT_ROUNDOFF times the sum of the terms' magnitudes, so the two are
# held within CONTRACTION_F32 times that on top of TOLS. An output near 0
# whose terms are large (tgmm's at 1024 rows) is thus not held to TOLS's
# f32 atol, and a product that rounds its inputs to TF32 (10 mantissa
# bits) still misses (tests/test_torch_registry.py)
CONTRACTION_F32 = 2.0


@dataclasses.dataclass(frozen=True)
class Size:
    S: int = 4096                       # rows; M = N of the matmul ladder
    K: int = 4096                       # columns; the ladder's K
    ce: tuple = (8192, 2048, 32768)     # N, D, V (bench/ops.py)
    sampling: tuple = (64, 131072)      # B, V (bench/ops.py)
    gmm: tuple = (8192, 2048, 1408, 8)  # T, K, N, E (bench/ops.py)
    w8a16: tuple = (16, 4096, 4096)     # M, K, N (bench/ops.py's decode)
    attention: tuple = (1, 16, 8, 2048, 128)    # B, Hq, Hkv, S, D
    # B, Hq, Hkv, D, page, pages a sequence, new tokens (prefill): the
    # 7bish serving shape of chip_smoke.py
    paged: tuple = (4, 16, 8, 128, 128, 8, 5)
    quant: tuple = (4096, 128)          # rows, K (a K/V write)
    embedding: tuple = (32768, 512, 8192)  # V, D, S (bench/ops.py)
    # the vocabulary of the one-hot gather (#40): bench/ops.py skips it at
    # V 32768 (its TPU kernel holds the whole table in VMEM); 1024 is the
    # vocabulary of __graft_entry__.entry()'s config
    onehot_vocab: int = 1024
    hist: tuple = (1 << 20, 256)        # values, bins (bench/ops.py)
    # boxes: bench/ops.py has no nms shape; JAX's docstring's size
    nms: int = 1024


# the tiny size of the CPU tests
TINY = Size(S=40, K=48, ce=(16, 32, 80), sampling=(4, 300),
            gmm=(48, 32, 24, 4), w8a16=(4, 64, 40),
            attention=(1, 4, 2, 33, 32), paged=(2, 4, 2, 32, 16, 4, 3),
            quant=(24, 32), embedding=(64, 48, 40), onehot_vocab=37,
            hist=(1000, 37), nms=64)

_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16,
           "f32": torch.float32, "i8": torch.int8,
           "fp8e4m3": torch.float8_e4m3fn, "fp8e5m2": torch.float8_e5m2}


def _in_dtype(family, name):
    """The input dtype a variant's name declares."""
    if family == "matmul":
        return torch.bfloat16 if name.startswith("hgemm") else torch.float32
    head = {"reduce": 1, "dot_product": 1, "rms_norm": 2, "rope": 1,
            "layer_norm": 2}
    tokens = name.split("_")
    if family in head:
        return _DTYPES[tokens[head[family]]]
    # bench/ops.py:48-49: bf16, else f16 (softmax_safe_f16_f32_per_token),
    # else f32
    return (torch.bfloat16 if "bf16" in tokens else
            torch.float16 if "f16" in tokens else torch.float32)


def nms_boxes(n, gen, exact_pairs=0):
    """(boxes (n, 4), scores (n,)), f32 on gen's device: boxes drawn as
    tests/test_memory_ops.py:70-74 draws its 64 (centres U(0, 100), sizes
    U(5, 30), scores U(0, 1)) with the field scaled by sqrt(n / 64), so
    the overlap stays that test's; then `exact_pairs` pairs apart from the
    field, [x, y, x + 2, y + 1] above [x, y, x + 1, y + 1] in score at
    integer x and y: an IoU of exactly 0.5, so the second box is kept
    under the strict `>` and suppressed under `>=`."""
    dev, f64 = gen.device, torch.float64
    m = n - 2 * exact_pairs
    field = 100 * math.sqrt(n / 64)

    def unif(*shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=f64)

    centres, sizes = field * unif(m, 2), 5 + 25 * unif(m, 2)
    boxes = [torch.cat([centres - sizes / 2, centres + sizes / 2], 1)]
    scores = [unif(m)]
    if exact_pairs:
        k = torch.arange(exact_pairs, device=dev, dtype=f64)
        x = math.ceil(field) + 20 + 4 * (k % 64)
        y = 4 * torch.div(k, 64, rounding_mode="floor")
        boxes += [torch.stack([x, y, x + 2, y + 1], 1),
                  torch.stack([x, y, x + 1, y + 1], 1)]
        s = unif(exact_pairs) / 2
        scores += [0.5 + s, s]
    return torch.cat(boxes).float(), torch.cat(scores).float()


def inputs(family, name, size, gen):
    """The positional arguments of variant (family, name) at `size`, made
    on gen's device from the torch.Generator gen."""
    dev = gen.device

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            dtype)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    S, K = size.S, size.K
    dt = _in_dtype(family, name)
    if family in EW_FAMILIES:
        n = 2 if family == "elementwise" else 1
        return tuple(randn(S, K, dtype=dt) for _ in range(n))
    if family in ("softmax", "rms_norm", "rope", "layer_norm"):
        # softmax and layer_norm: bench/ops.py:46's standard normal
        return (randn(S, K, dtype=dt),)
    if family in ("reduce", "dot_product"):
        # bench/ops.py's values, exact in every dtype: -1, -0.5, 0, 0.5, 1
        # (int8 truncates the halves to 0); the dot product's two inputs
        # are two arrays (one array twice would be read from HBM once)
        def exact():
            return (ints(-2, 3, S, K).float() * 0.5).to(dt)
        return (exact(),) if family == "reduce" else (exact(), exact())
    if family == "transpose":
        return (randn(S, K, dtype=dt),)
    if family == "gemv":
        return randn(S, K, dtype=dt), randn(K, dtype=dt)
    if family == "histogram":
        n, bins = size.hist
        return ints(0, bins, n), bins
    if family == "nms":
        return nms_boxes(size.nms, gen)
    if family == "embedding":
        V, D, St = size.embedding
        if "_onehot_" in name:
            V = size.onehot_vocab
        return ints(0, V, St), randn(V, D, dtype=dt)
    if family == "matmul":
        b = (S, K) if "_tn_" in name else (K, S)
        return randn(S, K, dtype=dt), randn(*b, dtype=dt)
    if family == "matmul_w8a16":
        from tpukern_torch.ops.matmul_w8a16 import quantize_weights
        M, Kw, N = size.w8a16
        return (randn(M, Kw, dtype=torch.bfloat16),
                *quantize_weights(randn(Kw, N, scale=0.05)))
    if family == "grouped_matmul":
        T, Kg, N, E = size.gmm
        gs = torch.full((E,), T // E, dtype=torch.int32, device=dev)
        if name.startswith("tgmm"):
            return randn(T, Kg), randn(T, N), gs
        return randn(T, Kg), randn(E, Kg, N, scale=0.05), gs
    if family == "cross_entropy":
        N, D, V = size.ce
        return randn(N, D), randn(D, V, scale=0.02), ints(0, V, N)
    if family == "sampling":
        return (randn(*size.sampling, scale=2.0),)
    if family == "attention":
        B, Hq, Hkv, Sa, D = size.attention
        return randn(B, Hq, Sa, D), randn(B, Hkv, Sa, D), randn(B, Hkv, Sa, D)
    if family == "paged_attention":
        B, Hq, Hkv, D, page, pps, T = size.paged
        P = B * pps
        q = randn(B, Hq, T, D) if "prefill" in name else randn(B, Hq, D)
        table = torch.randperm(P, generator=gen, device=dev).reshape(B, pps)
        return (q, randn(Hkv, P, page, D), randn(Hkv, P, page, D),
                ints(T, pps * page + 1, B), table.to(torch.int32))
    if family == "quant":
        x = randn(*size.quant)
        if name == "dequantize_int8":
            from tpukern_torch.ops.quant import quantize_ref
            return quantize_ref(x)
        return (x,)
    raise ValueError(f"ops_bench: no inputs for family {family!r}")


def _tol_dtype(v, args, out):
    """The lowest precision among the variant's float inputs, output and
    declared dtype: the row of TOLS it is held to."""
    cands = [t.dtype for t in (*args, out) if t.is_floating_point()]
    if "bf16" in v.name.split("_"):
        cands.append(torch.bfloat16)
    return max(cands, key=lambda d: TOLS[d][0])


def softmax_check(out, ref, dtype, whole=False):
    """A softmax's out against ref: (ok, largest |difference|, the rule).
    Elementwise within TOLS[dtype] with atol scaled by each row's largest
    |ref| (whole: the array is one row), and every row's sum within
    UNIT_ROUNDOFF + columns x HALF_SUBNORMAL of out's dtype, plus
    SOFTMAX_SUM_F32, of 1."""
    rtol, atol = TOLS[dtype]
    o, r = out.double(), ref.double()
    if whole:
        o, r = o.reshape(1, -1), r.reshape(1, -1)
    d = (o - r).abs()
    scale = r.abs().amax(-1, keepdim=True)
    miss = (o.sum(-1) - 1).abs()
    lim = (UNIT_ROUNDOFF[out.dtype] + o.shape[-1] * HALF_SUBNORMAL[out.dtype]
           + SOFTMAX_SUM_F32)
    ok = bool(torch.isfinite(o).all()
              and (d <= atol * scale + rtol * r.abs()).all()
              and (miss <= lim).all())
    return (ok, d.max().item() if d.numel() else 0.0,
            f"rtol {rtol:g} atol {atol:g} x row max; rows sum to 1 within "
            f"{lim:.3g}, worst {miss.max().item():.2e}")


def contraction_slack(v, args, out):
    """CONTRACTION_F32 sqrt(n) UNIT_ROUNDOFF[f32] times each output's sum
    of its terms' magnitudes (ref on the inputs' magnitudes), n the terms
    an output sums on average (the operations over twice the outputs)."""
    mags = v.ref(*(a.abs() if a.is_floating_point() else a for a in args))
    n = v.flops(*args) / (2 * out.numel())
    return (CONTRACTION_F32 * math.sqrt(n) * UNIT_ROUNDOFF[torch.float32]
            * mags.double())


def check(v, args):
    """v.fn(*args) against v.ref(*args): (ok, largest |difference|, the
    rule). Integers equal (a stochastic rounding: within one step); the
    bf16-accumulator sum on the card equal to its plain version in the
    kernel's order (reduce.sum_bf16_in_order); softmax by
    softmax_check; a gather (embedding) and a transpose bit-equal; the
    split-TF32 f32 tier of matmul and of the grouped products by
    split_gate; floats within TOLS, a bf16 grouped product's and a gemv's
    with their contraction_slack on top (a gemv output sums K
    products)."""
    out, ref = v.fn(*args), v.ref(*args)
    pairs = list(zip(out, ref)) if isinstance(out, tuple) else [(out, ref)]
    ok, worst, rules = True, 0.0, []
    for o, r in pairs:
        if o.shape != r.shape or o.dtype != r.dtype:
            return (False, math.inf, f"{tuple(o.shape)} {o.dtype} against "
                    f"{tuple(r.shape)} {r.dtype}")
        d = (o.double() - r.double()).abs()
        err = d.max().item() if d.numel() else 0.0
        if not o.is_floating_point():
            lim = 1 if "stochastic" in v.tags else 0
            rules.append(f"integers within {lim}")
            ok &= err <= lim
        elif v.family == "reduce" and o.dtype == torch.bfloat16 \
                and v.name.startswith("sum"):
            # each add rounds to bf16, so the result is the kernel's order's;
            # a CPU tensor takes the plain version, ref itself
            want = (reduce.sum_bf16_in_order(args[0].to(
                _in_dtype(v.family, v.name))) if o.is_cuda else r)
            err = (o.double() - want.double()).abs().item()
            rules.append("bf16 sum equal to the kernel's order")
            ok &= bool(torch.equal(o, want))
        elif v.family in ("embedding", "transpose"):
            rules.append("bit-equal")
            ok &= torch.equal(o, r)
        elif runs_split_tf32(v, args):
            good, err, rule = split_gate(o, *args,
                                         tgmm=v.name.startswith("tgmm"))
            rules.append(rule)
            ok &= good
        elif v.family == "softmax":
            good, err, rule = softmax_check(
                o, r, _tol_dtype(v, args, o), whole=v.name.endswith("global"))
            rules.append(rule)
            ok &= good
        else:
            rtol, atol = TOLS[_tol_dtype(v, args, o)]
            lim = atol + rtol * r.double().abs()
            if v.family in ("grouped_matmul", "gemv"):
                lim = lim + contraction_slack(v, args, o)
                rules.append(f"rtol {rtol:g} atol {atol:g} + "
                             f"{CONTRACTION_F32:g} sqrt(n) u_f32 sum|terms|")
            else:
                rules.append(f"rtol {rtol:g} atol {atol:g}")
            ok &= bool(torch.isfinite(o.double()).all() and (d <= lim).all())
        worst = max(worst, err)
    return ok, worst, "; ".join(dict.fromkeys(rules))


def split_gate(out, a, b, group_sizes=None, *, tgmm=False):
    """The accuracy gate of the split-TF32 f32 tier (ops/split_tf32.py):
    (ok, out's largest |error| against the f64 product, the rule): of a
    (M, K) and b (K, N), or with group_sizes the grouped product, gmm(a,
    b, group_sizes) or with tgmm tgmm(a, b, group_sizes). ok: out is
    finite and that error is at most SPLIT_GATE times that of torch.matmul
    in f32 on the same inputs (gmm_ref/tgmm_ref: torch.matmul a group),
    TF32 off. The sums run in another order than cuBLAS's, so the two f32
    results are held to the exact product, not to each other."""
    if group_sizes is None:
        def product(a, b):
            return torch.matmul(a, b)
        what = "torch.matmul"
    else:
        from tpukern_torch.ops import grouped_matmul as gm
        ref = gm.tgmm_ref if tgmm else gm.gmm_ref

        def product(a, b):
            return ref(a, b, group_sizes, dtype=a.dtype)
        what = f"{ref.__name__} (torch.matmul a group)"
    exact = product(a.double(), b.double())
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lib = product(a.float(), b.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    err = (out.double() - exact).abs().max().item()
    lib_err = (lib.double() - exact).abs().max().item()
    ok = bool(torch.isfinite(out).all()) and err <= (
        split_tf32.SPLIT_GATE * lib_err)
    return ok, err, (f"f64 product: at most {split_tf32.SPLIT_GATE:g}x "
                     f"{what} f32's {lib_err:.3e}")


def work(v, args, out):
    """(operations, their dtype, bytes): the work the bound counts. The
    bytes are the variant's `bytes_moved` where it has one (a gather reads
    the distinct rows its indices name, not the table), else every
    argument read once
    and every output written once."""
    if v.bytes_moved:
        nbytes = v.bytes_moved(*args)
    else:
        tensors = [*args, *(out if isinstance(out, tuple) else (out,))]
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
    flops = v.flops(*args) if v.flops else 0
    # histogram's num_bins is an int
    floats = [t.dtype for t in args
              if isinstance(t, torch.Tensor) and t.dtype in PEAK_FLOP_S]
    dtype = (torch.bfloat16 if torch.bfloat16 in floats
             or "bf16" in v.name.split("_") else torch.float32)
    return flops, SPLIT_TF32 if runs_split_tf32(v, args) else dtype, nbytes


def runs_split_tf32(v, args):
    """Whether variant v takes the f32 tier of `matmul` or of the grouped
    products on these arguments: split-TF32 products (#1-#3, #17, #28,
    #29; ops/split_tf32.py), not #16's (`naive`), cuBLAS's or the ragged
    dot's (the baselines), nor a bf16 variant on f32 arguments."""
    return (v.family in ("matmul", "grouped_matmul")
            and "naive" not in v.name and "baseline" not in v.tags
            and _in_dtype(v.family, v.name) == torch.float32
            and args[0].dtype == torch.float32)


def bound_ms(flops, dtype, nbytes):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_ops, t_bytes = flops / PEAK_FLOP_S[dtype], nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--family", default="", help="one family (default all)")
    p.add_argument("--S", type=int, default=4096)
    p.add_argument("--K", type=int, default=4096)
    p.add_argument("--check", action="store_true")
    p.add_argument("--iters", type=int, default=20)
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    if not torch.cuda.is_available():
        print("ops_bench: times kernels on a CUDA device, and there is none",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    families = [args.family] if args.family else FAMILIES
    size = Size(S=args.S, K=args.K)
    gen = torch.Generator("cuda").manual_seed(0)
    missed = []
    for fam in families:
        print(f"== {fam}")
        for name, v in sorted(registry.variants(fam).items()):
            a = inputs(fam, name, size, gen)
            line = f"{name:34s}"
            if args.check:
                ok, err, rule = check(v, a)
                line += f" max_abs {err:.3e} ({rule}) {'ok' if ok else 'MISS'}"
                if not ok:
                    missed.append(f"{fam}.{name}")
            ms = run_benchmark(v.fn, *a, warmup=2, iters=args.iters, reps=1,
                               flush_l2=True)
            flops, dt, nbytes = work(v, a, v.fn(*a))
            b_ms, by = bound_ms(flops, dt, nbytes)
            rate = f"{nbytes / ms / 1e6:9.1f} GB/s"
            if flops:
                rate += f" {flops / ms / 1e9:8.2f} TFLOP/s"
            print(f"{line} {ms:10.4f} ms {rate}; bound {b_ms:.4f} ms by {by} "
                  f"({b_ms / ms:.1%} of it)"
                  + (f" [{', '.join(v.tags)}]" if v.tags else ""))
            del a
        for (f, n), why in sorted(registry.PENDING.items()):
            if f == fam:
                print(f"{n:34s} PENDING ({why})")
    print(f"[ops_bench] {torch.cuda.get_device_name(0)}; "
          f"{len(missed)} missed: {missed}")
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
