"""The split-TF32 products of the f32 GEMM tier (#1-#3, #17, #13-#15,
#28, #29).

The tensor cores run f32 products only as TF32 (10 mantissa bits). To
keep f32's accuracy the f32 tier splits each operand x into hi, x rounded
to TF32 half away from zero (cvt.rna.tf32.f32's rounding), and lo = x -
hi, exact in f32, and computes A·B ≈ A_lo·B_hi + A_hi·B_lo + A_hi·B_hi,
three TF32 products in f32 accumulators (CUTLASS calls it 3xTF32; the JAX
f32 tier's Precision.HIGHEST is the TPU's bf16 passes of the same idea,
tpukern/ops/cross_entropy.py:65-68). Kernels: csrc/split_tf32.cu (the
operand pass) and csrc/hopper.cuh `gemm_pipeline_tf32` (the products),
launched by csrc/matmul.cu, csrc/cross_entropy.cu and
csrc/grouped_matmul.cu (whose layouts, scratch and plain models are in
ops/grouped_matmul.py). `wgmma .tf32` reads both operands K-major only,
so an operand whose contraction is not along its rows is split
transposed.

This module holds the operand pass's wrapper (`split_tf32`), the count
of its launches by every launcher (`launch_counting_passes`) and its
plain version (`split_tf32_ref`, the kernel's split bit for bit, and
SPECIALS, the values on its every path), the plain model of the product
(`split_product_ref`, `matmul_split_ref`; `split_bmm_ref` and
`key_order` for the f32 flash attention #6/#8), the bound of its error
(SPLIT_REL), the tier's cost (PRODUCTS, TF32_PEAK_FLOP_S) and accuracy
gate (SPLIT_GATE), and the mirrors of the layouts, the splits of K and
the scratch that the launchers use (`matmul_transposed`, CE_TRANSPOSED,
`matmul_splits`, `matmul_scratch`, `ce_scratch`).
"""

import ctypes

import torch

from tpukern_torch import _build
from tpukern_torch.core import cdiv, round_up

# One split product's error relative to |a b|: the tensor core reads lo
# as its truncation to TF32 (off by less than 2^-10 |lo| <= 2^-21 |x|), hi
# is at most (1 + 2^-11) |x|, and lo·lo (at most 2^-22 |a b|) is dropped:
# 2^-22 + 2 (1 + 2^-11) 2^-21 (csrc/hopper.cuh).
SPLIT_REL = 2.0 ** -20 * (1.25 + 2.0 ** -11)
# TF32 products an f32 product costs, and their dense rate on an H100 SXM
# at 700 W (NVIDIA's data sheet): a split-TF32 kernel's bound is PRODUCTS
# times its f32 operations over TF32_PEAK_FLOP_S
PRODUCTS = 3
TF32_PEAK_FLOP_S = 495e12


def bound_s(flops):
    """The least seconds for `flops` f32 operations as split-TF32
    products on the tensor cores."""
    return PRODUCTS * flops / TF32_PEAK_FLOP_S

# the tier's accuracy gate: its largest error against an f64 product of
# the same inputs at most SPLIT_GATE times torch.matmul's in f32 (cuBLAS
# with TF32 off on the card)
SPLIT_GATE = 2.0
# f32 bit patterns on every path of the split: ±0, subnormals, ±inf, NaN
# (payloads in the kept and the cleared bits), values within half a TF32
# ulp of FLT_MAX, ties of the rounding
SPECIALS = [0x00000000, 0x80000000, 0x00000001, 0x80001000, 0x007FFFFF,
            0x7F800000, 0xFF800000, 0x7FC00000, 0x7F800001, 0xFFA00000,
            0x7F7FFFFF, 0x7F7FF000, 0x7F7FEFFF, 0xFF7FF000, 0x3F801000,
            0x3F803000, 0xBF801000, 0x3F800FFF]

_LOW13 = -0x2000  # 0xFFFFE000 as an int32: the bits TF32 keeps
_SIGN = -0x80000000


def _f32(bits):
    return bits.view(torch.float32)


def tf32_truncate(x):
    """f32 x as the tensor core reads it: its low 13 bits cleared."""
    return _f32(x.float().contiguous().view(torch.int32) & _LOW13)


def split_tf32_ref(x):
    """(hi, lo) of f32 x, as csrc/common.cuh split_tf32 computes them: hi
    is x rounded to TF32 half away from zero (its low 13 bits zero), lo =
    x - hi (exact), with x's sign where it is zero, so hi + lo == x bit for
    bit; a finite x that would round past FLT_MAX takes its truncation;
    ±inf keep hi = x, lo = 0; a NaN gets hi = its truncation with the
    quiet bit set, lo = 0."""
    x = x.float().contiguous()
    u = x.view(torch.int32)
    mag, sign = u & 0x7FFFFFFF, u & _SIGN
    r = (mag + 0x1000) & _LOW13
    r = torch.where(r >= 0x7F800000, mag & _LOW13, r)
    hi = _f32(r | sign)
    lo = x - hi
    lo = torch.where(lo == 0, _f32(sign), lo)
    special, nan = mag >= 0x7F800000, mag > 0x7F800000
    hi = torch.where(nan, _f32((u & _LOW13) | 0x00400000),
                     torch.where(special, x, hi))
    lo = torch.where(special, torch.zeros_like(lo), lo)
    return hi, lo


def split_planes_ref(x, transpose=False):
    """The planes (2, rows, ld) that the operand pass writes for x (R, C):
    hi then lo of x (rows R) or of x^T (rows C), each row padded with
    zeros to ld, its length rounded up to 4 (whole 16-byte chunks)."""
    src = x.float().T if transpose else x.float()
    rows, n = src.shape
    out = torch.zeros(2, rows, round_up(n, 4), device=x.device)
    out[0, :, :n], out[1, :, :n] = split_tf32_ref(src)
    return out


def split_tf32(x, *, transpose=False):
    """The split-TF32 planes of f32 x (R, C), as split_planes_ref lays
    them out. A CPU tensor takes split_planes_ref; a CUDA tensor launches
    the operand pass (csrc/split_tf32.cu), counted. The GEMM launchers run
    the same pass themselves; launch_counting_passes adds their launches
    to this count."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"split_tf32 takes a 2-D float32 matrix, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return split_planes_ref(x, transpose)
    _build.check_cuda(x)
    if x.stride(1) != 1:
        x = x.contiguous()
    R, C = x.shape
    rows, n = (C, R) if transpose else (R, C)
    out = torch.empty(2, rows, round_up(n, 4), device=x.device)
    if R and C:
        ld = out.shape[2]
        launch_counting_passes(
            "tk_split_tf32", x.data_ptr(), R, C, max(x.stride(0), C),
            None if transpose else out.data_ptr(), ld,
            out.data_ptr() if transpose else None, ld, _build.stream(x))
    return out


split_tf32.launches = 0


def launch_counting_passes(name, *args):
    """_build.launch of C entry point `name` with args, a host counter
    put before the last (the stream): the C launcher raises it once for
    each operand pass it launches (csrc/split_tf32.cu split_tf32_launch),
    and that count is added to split_tf32.launches."""
    passes = ctypes.c_int(0)
    _build.launch(name, *args[:-1], ctypes.addressof(passes), args[-1])
    split_tf32.launches += passes.value


def split_product_ref(a_planes, b_planes):
    """The split product of K-major planes: A (2, M, ld) and B (2, N, ld)
    (split_planes_ref's layout, zeros past K) into C (M, N) = A_lo·B_hi^T
    + A_hi·B_lo^T + A_hi·B_hi^T, lo read as the tensor core reads it
    (tf32_truncate), the sums in f64, rounded once to f32."""
    ah, al = a_planes[0].double(), tf32_truncate(a_planes[1]).double()
    bh, bl = b_planes[0].double(), tf32_truncate(b_planes[1]).double()
    return (al @ bh.T + ah @ bl.T + ah @ bh.T).float()


def split_bmm_ref(a, b, slab=32):
    """A (..., M, K) times B (..., N, K)^T as the split-TF32 attention
    kernels (csrc/flash_attention_tf32.cu, csrc/flash_attention_bwd.cu)
    sum it: both operands split (split_tf32_ref), lo read as the tensor core
    reads it (tf32_truncate), each slab of `slab` contraction values' three
    products summed in f64 and rounded once to f32 (a fresh accumulator a
    slab), the slabs' sums added in f32 in order."""
    out = torch.zeros(*a.shape[:-1], b.shape[-2], device=a.device)
    for k0 in range(0, a.shape[-1], slab):
        ah, al = split_tf32_ref(a[..., k0:k0 + slab])
        bh, bl = split_tf32_ref(b[..., k0:k0 + slab])
        ah, bh = ah.double(), bh.double()
        al, bl = tf32_truncate(al).double(), tf32_truncate(bl).double()
        out = out + (al @ bh.mT + ah @ bl.mT + ah @ bh.mT).float()
    return out


def key_order(n):
    """Which key each column of a K-major B operand holds where A comes
    from an accumulator (csrc/hopper.cuh tf_frag, tf_perm), for n keys:
    within each 8, columns 0-3 hold keys 0, 2, 4, 6 and columns 4-7 keys
    1, 3, 5, 7, the order in which A's k8 fragment takes the
    accumulator's columns."""
    c = torch.arange(n)
    return (c & ~7) | ((c & 3) << 1) | ((c >> 2) & 1)


def matmul_transposed(trans_b):
    """Which operands of csrc/matmul.cu's f32 tier the operand pass
    transposes, so that both are K-major: A (M, K) never; B (K, N) in NN,
    not B (N, K) in TN."""
    return {"a": False, "b": not trans_b}


# the f32 CE backward's planes (csrc/cross_entropy.cu ce_bwd_launch):
# operand -> (transposed?) of each layout it is split into: x as it is
# (launch 1's A) and transposed (launch 3's A), W's vocab chunk
# transposed (launch 1's B) and as it is (launch 2's B), dlog as it is
# (launch 2's A) and transposed (launch 3's B)
CE_TRANSPOSED = {"x": (False, True), "w": (True, False),
                 "dlog": (False, True)}


def matmul_split_ref(a, b, *, trans_b=False):
    """csrc/matmul.cu's f32 tier, modelled in plain torch: both operands
    split into K-major planes by matmul_transposed's rule, then
    split_product_ref."""
    t = matmul_transposed(trans_b)
    return split_product_ref(split_planes_ref(a, t["a"]),
                             split_planes_ref(b, t["b"]))


TILE = 128  # the f32 tier's tile: 128 x 128 (csrc/hopper.cuh TF_BN)
SLAB = 32  # values of K a slab (TF_BK)


def matmul_splits(M, N, K, n_sms):
    """Splits of K of csrc/matmul.cu's f32 tier, from the shapes and the
    card's SM count: 1 where the 128 x 128 tiles fill half the SMs or K is
    under 16 slabs of 32; else as many as bring the blocks to the SM
    count, each at least 8 slabs, at most 32 splits, every split
    non-empty."""
    tiles = cdiv(M, TILE) * cdiv(N, TILE)
    slabs = cdiv(K, SLAB)
    if 2 * tiles >= n_sms or slabs < 16:
        return 1
    want = min(cdiv(n_sms, tiles), slabs // 8, 32)
    return cdiv(slabs, cdiv(slabs, want))


def matmul_scratch(M, N, K, splits=1):
    """f32 values of scratch csrc/matmul.cu's f32 tier takes: A's planes
    (2, M, K4) and B's (2, N, K4), K4 = K rounded up to 4, none at K 0;
    then, with more than one split of K, each split's partial tiles of
    128 x 128."""
    if not K:
        return 0
    tiles = cdiv(M, TILE) * cdiv(N, TILE)
    return (2 * (M + N) * round_up(K, 4)
            + (splits * tiles * TILE * TILE if splits > 1 else 0))


def ce_fwd_scratch(N, D, vc):
    """(x's, W's chunk's) f32 values of scratch of the f32 CE forward at a
    chunk of vc columns: x's planes (2, N, D4) and the chunk's transposed
    planes (2, vc, D4), D4 = D rounded up to 4."""
    return 2 * N * round_up(D, 4), 2 * vc * round_up(D, 4)


def ce_scratch(N, D, vc):
    """(x's, W's chunk's, dlog's) f32 values of scratch of the f32 CE
    backward at a chunk of vc columns: each split into two layouts
    (CE_TRANSPOSED), two planes each, every row rounded up to 4."""
    def r4(n):
        return round_up(n, 4)
    return (2 * N * r4(D) + 2 * D * r4(N), 2 * vc * r4(D) + 2 * D * r4(vc),
            2 * N * r4(vc) + 2 * vc * r4(N))
