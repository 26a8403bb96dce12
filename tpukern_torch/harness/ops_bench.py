"""Small-op benchmark of the port: bench/ops.py's role.

Walks the port's variant registry (tpukern_torch.core.registry) on the
card at bench/ops.py's shapes (S = K = 4096; the matmul ladder at
S x K x S) and prints, for each variant, the time of one call with the L2
flushed before it (harness.bench.run_benchmark(flush_l2=True)), its
rate (GB/s, and TFLOP/s where the variant counts operations) and its
share of the bound: the larger of the bytes it must move (each input
read once, each output written once) over 3.35 TB/s and its operations
over the H100's peak for their type. With --check each variant is first
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

EW_FAMILIES = ["elementwise", "relu", "elu", "gelu", "swish", "sigmoid",
               "hardswish", "hardshrink"]
# bench/ops.py's order, then the families it leaves to other scripts;
# softmax ... nms have no port variant yet (core.registry.PENDING)
FAMILIES = EW_FAMILIES + [
    "softmax", "layer_norm", "rms_norm", "rope", "reduce", "dot_product",
    "transpose", "embedding", "histogram", "gemv", "nms", "cross_entropy",
    "sampling", "grouped_matmul", "matmul_w8a16", "matmul", "attention",
    "paged_attention", "quant"]

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense):
# HBM bytes/s and the FLOP/s of the unit a dtype runs on
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {torch.float32: 67e12, torch.bfloat16: 989e12,
               torch.float16: 989e12, torch.int8: 1979e12}
# kernel-vs-plain tolerances (max |out - ref| <= atol + rtol |ref|) by the
# lowest precision among a variant's inputs and output: the _TOLS rows of
# core.tolerances, and f32 1e-4 (CUDA's exp/rsqrt and the kernels'
# summation order differ from PyTorch's in the last bits)
TOLS = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2),
        torch.float16: (2e-3, 2e-3), torch.float8_e4m3fn: (1.5e-1, 1.5e-1),
        torch.float8_e5m2: (3e-1, 3e-1)}
# the bf16-accumulator sum: every add rounds to bf16, in another order on
# the card than in the plain version (one f32 sum rounded once), so it is
# held as tests/test_reduce.py holds JAX's: |out - ref| <= max(rel |ref|,
# 100 rel)
BF16_SUM_REL = 3e-2


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


# the tiny size of the CPU tests
TINY = Size(S=40, K=48, ce=(16, 32, 80), sampling=(4, 300),
            gmm=(48, 32, 24, 4), w8a16=(4, 64, 40),
            attention=(1, 4, 2, 33, 32), paged=(2, 4, 2, 32, 16, 4, 3),
            quant=(24, 32))

_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16,
           "f32": torch.float32, "i8": torch.int8,
           "fp8e4m3": torch.float8_e4m3fn, "fp8e5m2": torch.float8_e5m2}


def _in_dtype(family, name):
    """The input dtype a variant's name declares."""
    if family == "matmul":
        return torch.bfloat16 if name.startswith("hgemm") else torch.float32
    head = {"reduce": 1, "dot_product": 1, "rms_norm": 2, "rope": 1}
    tokens = name.split("_")
    if family in head:
        return _DTYPES[tokens[head[family]]]
    return torch.bfloat16 if "bf16" in tokens else torch.float32


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
    if family in ("rms_norm", "rope"):
        return (randn(S, K, dtype=dt),)
    if family in ("reduce", "dot_product"):
        # bench/ops.py's values, exact in every dtype: -1, -0.5, 0, 0.5, 1
        # (int8 truncates the halves to 0); the dot product's two inputs
        # are two arrays (one array twice would be read from HBM once)
        def exact():
            return (ints(-2, 3, S, K).float() * 0.5).to(dt)
        return (exact(),) if family == "reduce" else (exact(), exact())
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


def check(v, args):
    """v.fn(*args) against v.ref(*args): (ok, largest |difference|, the
    rule). Integers equal (a stochastic rounding: within one step);
    the bf16-accumulator sum by BF16_SUM_REL; floats within TOLS."""
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
            lim = BF16_SUM_REL * max(abs(r.double().item()), 100.0)
            rules.append(f"bf16 sum within {lim:.3g}")
            ok &= err <= lim
        else:
            rtol, atol = TOLS[_tol_dtype(v, args, o)]
            rules.append(f"rtol {rtol:g} atol {atol:g}")
            ok &= bool(torch.isfinite(o.double()).all()
                       and (d <= atol + rtol * r.double().abs()).all())
        worst = max(worst, err)
    return ok, worst, "; ".join(dict.fromkeys(rules))


def work(v, args, out):
    """(operations, their dtype, bytes): the work the bound counts."""
    tensors = [*args, *(out if isinstance(out, tuple) else (out,))]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    flops = v.flops(*args) if v.flops else 0
    floats = [t.dtype for t in args if t.dtype in PEAK_FLOP_S]
    dtype = (torch.bfloat16 if torch.bfloat16 in floats
             or "bf16" in v.name.split("_") else torch.float32)
    return flops, dtype, nbytes


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
