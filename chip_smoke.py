#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tpukern_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the device, torch/CUDA/nvcc versions and whether triton imports;
2. builds the kernels from tpukern_torch/csrc (one nvcc per source, in
   parallel, or loads this source hash's build) and prints the seconds,
   and counts in the library's SASS (cuobjdump) the wgmma (HGMMA), TMA
   loads (UTMALDG) and mma.sync products (HMMA, none) of #16's bf16
   kernel, of the bf16 #2 (NN and TN), #28, #29, CE forward (#13) and
   CE backward (#14/#15: dlog, dx, dW) kernels on csrc/hopper.cuh's
   pipeline, of the f32 #2 and f32 CE forward and backward on its
   split-TF32 form, of the f32 #28 (NN and trans_w, one instance) and
   #29 on it, of every instance of the bf16 flash-attention
   forward (#6) and of the split-TF32 f32 flash-attention forward (#6)
   and fused backward (#8), the matrix products of #40's, which must have
   none, and of the bf16 w8a16 GEMM (#25: mma.sync, and no int-to-float
   conversion); ptxas may serialise the wgmmas (C7520) of no split-TF32
   kernel;
3. checks every kernel of the serving path against its plain PyTorch
   version on the card, at the 7bish serving shapes in bf16 and at small
   f32 shapes, and times both at the serving shape (flash_attention also
   at S 4096, and at the Gemma-2 serving masks, every bf16 call twice,
   bit-equal): paged_prefill_attention
   (#24) at a 256-token chunk over a 900-token prefix and at a gamma = 4
   verification whose last length passes the pool, small f32/bf16 cases of
   every head dim, and the window, sinks and softcap of #24 and #23;
   #24's split-KV at lengths on the split edges (bf16 and f32; window and
   sinks, softcap, ring, ALiBi) against its split order's plain version
   and the final-max one, twice (bit-equal), and [prefill split]: its
   split lengths 64, 128, 256, one split and the rule's at the verify and
   chunk shapes, device and event times with n_split; #23's
   bf16 P against the plain version that rounds it and the one that
   keeps it in f32; the quantize kernels #20 (round to nearest and
   stochastic), #21 and #22 at the K/V write and q shapes, and every
   quantized instance of #23 and #24 (int8 with and without q_int8 and
   pv_int8, pv_int8 at two pages_per_block, fp8) at the serving shapes in
   bf16 and f32, with the window, sinks and softcap; ring pools (5 pages
   of 128 slots, lengths wrapped more than once, sinks 4, the window at
   its ring limit, T = 5 verification rows) and ALiBi on every instance
   of #23 and #24 (float bf16 and f32, int8 with q_int8 and pv_int8,
   fp8); the w8a16 GEMM #25 at the 7bish weight shapes (M = 4, 20, 128,
   and in bf16 1, 8, 9, 16, 33, 64: each token-tile instance and its
   edges; forced at 256 and 2048; a K tail and an N of 1000) in bf16 and
   f32, each call twice (bit-equal), timed at M = 4 on every weight, at
   M = 1, 8, 20, 64 and 128 on w1 and at M = 20 on the head beside
   torch.matmul on bf16 weights; the sampling kernels #26 and #27 at the
   serving shape (4, 32768) f32 and at a 128256-token vocabulary;
4. checks the training slices' kernels (matmul in its three epilogues,
   with its bf16 launches counted by load path, each path met required,
   its f32 tier (split-TF32 products) held to the accuracy gate: its
   largest error against the f64 product at most SPLIT_GATE times cuBLAS
   f32's (TF32 off), NN and TN at 333 x 517 x 1000, 2048 x 8192 x 2048
   and 4096^3, and timed at both; the split-TF32 operand pass bit for bit
   against its plain version, specials included;
   rope_batched, the flash_attention lse (the f32 tier twice, bit-equal,
   and timed at the training shape beside SDPA's f32 forward),
   flash_attention_bwd (GQA groups 1, 2 and 4 in one launch, the f32
   tier's dk and dv twice, bit-equal; timed at the training shape, GQA
   16/8, f32 and bf16, beside SDPA's backward with enable_gqa), the
   accuracy gate of both f32 tiers (o, lse, dq, dk, dv against f64 at
   most SPLIT_GATE times the plain f32 version's error, at the training
   shape and two tails), the fused
   cross-entropy's forward and backward (the backward also at forced
   vocab chunks, bf16 three of them on TMA and on the copy paths, f32 at
   its own chunk rule, launches counted with the operand passes, and
   twice, bit-equal; the f32 forward's loss and lse and the f32
   backward's dx and dW held to the accuracy gate, the forward also at a
   tail in D and V), and the featured attention:
   flash_attention with window, sinks, softcap and segments, and the
   two-kernel backward flash_attention_dq / flash_attention_dkv (GQA
   inside both; each call twice, bit-equal; the f32 tier on split-TF32
   products held to the accuracy gate against f64) against their plain
   versions, and times them at the 7bish training shapes;
   every timed kernel also gets its bound (bytes or operations over the
   H100's peak) and, where one PyTorch call computes the same function,
   that call's time (for the paged kernels, SDPA on a gathered copy);
   [gmm]/[tgmm]: the grouped GEMMs #28 (NN and trans_w) and #29 against
   gmm_ref/tgmm_ref in f32 and bf16 at the Mixtral expert products (8192
   routed rows: w1 4096 x 14336, w2 14336 x 4096, their dx and dW), at the
   bench shape (8192 x 2048 x 1408, E 8) under five splits and at the test
   cases, and #29 with NaN in the rows past the groups and last slabs of
   1-63 rows (finite, equal to tgmm_ref), timed at the first two (bf16
   beside torch._grouped_mm, f32 against its split-TF32 bound); the f32
   tier (split-TF32 products) also held to the accuracy gate: its largest
   error against the f64 grouped product at most SPLIT_GATE times the
   plain loop's (cuBLAS f32 a group), at the Mixtral products, the bench
   shape's balanced and one_hot splits and two test cases, each call
   twice (bit-equal);
   [zoo]: walks the port's variant registry at bench/ops.py's shapes
   (tpukern_torch/harness/ops_bench.py: 4096 x 4096, 16.8 M elements for
   reduce and dot, 4096^3 for the matmul ladder; the gathers at V 32768,
   D 512, S 8192, the one-hot #40 at V 1024; histogram 2^20 values in
   256 bins, nms 1024 boxes), matmul_kpipe, #16 on each of its bf16
   load paths and the grid softmax at 64 x 131072, with the nineteen zoo
   kernels' launch counts (and #16's and matmul's by load path) reset
   just before and read just after, each grid softmax call held to one
   launch of the cluster kernel (at 4096 x 4096) or of #35 and of #36
   (at 64 x 131072) and no other;
   the bf16 matmul ladder also at 4095 x 4097 (the copy path); holds
   every variant against its plain version (#30-#37, the transpose #42
   and gemv #44 also at 4095 x 4097, a tail in every tier; softmax and
   layer_norm also at the sampling logits' 64 x 131072; the gathers
   #38-#40 and the transpose bit for bit, the gathers also at an odd
   shape, on indices outside [0, V) and with no host sync; #40 at V 1024
   and 32768 with S 8192; #16 at 4095 x 4097 and with one operand by
   TMA; histogram #41 also at 2^20 - 1 values in 1000
   bins from -5 to 1005, at 2^26 values and with every value in one bin;
   nms #43 also at 1000 and 4000 boxes with pairs at an IoU of exactly
   0.5; #30's tiers bit for bit against each other at 4095 x 4097,
   aligned and 2 elements off, add, mul and relu also against the plain
   version; the cluster softmax kernel at 1-16 tiles a row, odd columns
   and rows of -inf, twice bit for bit, its
   cudaOccupancyMaxActiveClusters printed), runs softmax_global under
   sync debug mode "error", and times the zoo's variants (all six tiers
   of add and of gelu beside torch.add and F.gelu), the grid variant at
   64 x 131072, #35, #36 and #43 alone, #41 at 2^26 values and in
   one bin, #16 at 4095 x 4097 and #40 at V 32768, with the L2 flushed
   before each call, beside the plain version, the library call and the
   bound;
5. serves the 7bish preset (random bf16 weights from a seeded generator)
   through ContinuousBatcher: 6 requests on 4 slots, 2 admitted
   mid-stream, 32 new tokens each; then [chunked] the same requests with
   chunked_prefill=256, [prefix] 4 requests sharing a 512-token system
   prompt with prefix_cache=True and without, [spec] SpeculativeBatcher
   (gamma 4) on 4 of them with the target as its own draft, with a
   2-layer draft, and with an agreeing 2-layer draft (the target with wo
   and w2 of layers 2-15 zeroed computes the draft's function at full
   depth's cost), [sample] sampled decoding (temperature 0.8 with top_k
   50, top_p 0.9, min_p 0.05; top_k 1 must give the greedy streams; one
   sampled generate), [spec-sample] the sampled SpeculativeBatcher and
   speculative_sample_generate with the agreeing draft, and
   [gemma2-serve] window 512, sinks 4 and softcap 50 over prompts longer
   than the window; [int8-serve] and [fp8-serve] the serve requests on
   the quantized KV tier (int8, int8 with Config.pv_int8, fp8; each twice
   in turns with two bf16 runs), chunked, with the prefix cache, and
   SpeculativeBatcher on int8 caches; [w8a16-serve] the serve requests
   with quantize_model_weights's tree (#25's launches per step checked
   against the dispatch rule; twice in turns with two bf16 runs, on int8
   pools, chunked, and SpeculativeBatcher with a w8a16 agreeing draft);
   [ring-serve] the [gemma2-serve] config on ring pools of 640 slots in
   turns with flat pools, 560-620-token prompts and 256 new tokens (every
   stream wraps), int8 rings, SpeculativeBatcher on rings and
   generate(ring=True). Each run resets the kernels' launch counts just
   before and reads them just after;
6. profiles one admission, a few decode steps (greedy on bf16, int8 and
   fp8 pools, with w8a16 weights, and sampled), a chunked admission and
   two speculative rounds (device time by kernel; the w8a16 decode
   step's #25 device time on a line of its own);
7. checks one prefill's logits against the plain functions in f32, one
   verify_step's (plain and Gemma-2-style, bf16, full depth) and one
   decode step's on each quantized tier against the plain quantized
   functions, and one w8a16 decode step's against the plain w8a16
   functions; then, in f32 at the 7bish widths cut to 2 layers, requires
   equal greedy streams: chunked against unchunked, the prefix cache on
   against off, SpeculativeBatcher and speculative_generate against
   ContinuousBatcher, windowed serving against greedy decoding with the
   plain functions, on int8 pools chunk sizes, the prefix cache and
   speculation each against a path of the same function, w8a16 through
   the kernels against the plain functions, ring pools against flat pools
   (wrapping) and SpeculativeBatcher on a ring against ContinuousBatcher
   on a ring;
8. trains the 7bish preset in f32 at full depth: 5 Adam steps (lr
   TRAIN_LR) on one seeded batch (B=2, S=1024), launch counts reset just
   before and read just after, then profiles one more step by kernel
   category; once with the unfused log-softmax loss, once with
   Config.fused_loss (the fused cross-entropy kernels) and once with
   Config.window=512 and Config.softcap=50.0 (the featured forward and
   the two-kernel backward, and no launch of the fused backward); prints
   the fused against the unfused step's ms and peak memory;
9. checks one loss-and-grad at the 7bish widths with 2 layers (B=1,
   S=1024, f32) against a loss built from the plain functions only,
   differentiated by torch.autograd: unfused, fused, and with the window
   and softcap;
10. [moe-train]: trains Mixtral-8x7B's widths cut to 2 layers (8
   experts, top 2, capacity factor 2.0; f32) for 5 Adam steps on B=2,
   S=2048 through the capacity-dispatch path (matmul launches, none of
   #28/#29), with the share of routed assignments dropped and one
   profiled step; [moe-dropless]: moe_block_dropless(use_kernel=True) on
   that model's first moe layer, T 4096, k 2: 2 gmm, 2 trans_w and 2 tgmm
   launches a forward plus backward, out and grads against the plain
   ragged products, ms, 3 Adam steps, and a router that sends half the
   tokens to one expert; then the train parity at the Mixtral widths
   (S=1024), counting the routings that part between the two runs;
11. [ring]: the ring collectives of tpukern_torch.parallel (#45 the
   all-gather, #46 the reduce-scatter, and their composition) against
   their plain ring walks bit for bit at 1-8 ranks on the card, in f32,
   bf16 and f16, on x, another x' and x again; [ring-grads]: the
   data-parallel all-reduce of 8 ranks' gradients of the 7bish training
   config cut to 2 layers (each rank its own B=1, S=1024 batch), every
   rank's copy against the plain walk and 8x the union batch's
   gradient, with the two kernels' launch counts reset just before and
   read just after; then #46, #45 and the all-reduce timed at the
   16-layer parameter count (8 x 872.5 M f32) beside the plain walks,
   one card's library calls and the bounds.

Exits non-zero, without the result line, if there is no CUDA device or
any phase fails. The last line is {"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
# tolerances of the kernel-vs-plain checks (max |kernel - plain| <= atol +
# rtol * |plain|). bf16: the _TOLS bf16 row (the kernels round P, sums and
# outputs to bf16 where the plain versions stay in f32). f32: both sides
# compute in f32; sums run in another order and CUDA's exp/rsqrt differ
# from PyTorch's in the last bits.
TOLS = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-4, 1e-4)}
# end-to-end logits of one 7bish prefill against the plain f32 functions:
# the f32 kernel path within E2E_F32_ATOL max abs; the bf16 kernel path
# (the served one: 16 layers of bf16 rounding) within E2E_BF16_REL
# relative RMS error. Both must pick the plain argmax, or a token whose
# plain logit is within that path's own max error of the plain maximum.
E2E_F32_ATOL = 2e-3
E2E_BF16_REL = 5e-2
# train-parity bounds: the kernel path's loss against the plain path's
# (relative error), and each parameter's gradient (relative RMS error).
# Both paths are f32 and differ in summation order only: measured on an
# H100, loss error 0 (1e-6 is about 11 f32 ulps at a loss of 10.8) and
# gradient errors 2.8e-6 to 5.6e-6 (1e-4 is 18x the largest).
TRAIN_LOSS_REL = 1e-6
TRAIN_GRAD_REL = 1e-4
# Adam's step size in the train phase. At 1e-3 the loss of this batch
# jumps at step 5 (10.80, 9.62, 7.60, 7.29, 11.96) on the kernel path and
# on the plain path alike, equal to 4 decimals; at 3e-4 it falls at every
# step of the first 7 on both.
TRAIN_LR = 3e-4
# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet,
# dense): HBM bytes/s, and FLOP/s of the unit a kernel's dtype runs on
# (f32 on CUDA cores, bf16 on tensor cores). A kernel's bound is the
# larger of its bytes and its operations over these. The split-TF32 f32
# kernels (#1-#3, #17, #14/#15) count their f32 operations at
# ops_bench.PEAK_FLOP_S[SPLIT_TF32] (ops/split_tf32.py: PRODUCTS TF32
# products a product); their bound on the CUDA cores' f32 FMAs is printed
# beside it.
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {torch.float32: 67e12, torch.bfloat16: 989e12,
               torch.int8: 1979e12, torch.float8_e4m3fn: 1979e12}
# the quantized paged kernels in f32: the kernels take a running max where
# the plain versions take the final one, so with pv_int8 a p * v_scale
# within an f32 rounding of a rounding boundary quantizes one step apart,
# which moves an output by at most amax / (127 l): those tiers are held to
# this (rtol, atol); the others to TOLS
QUANT_PV_F32_TOL = (2e-3, 2e-3)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def sh(*cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def phase_device():
    print(sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"))
    print(f"[device] {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()} torch {torch.__version__} "
          f"cuda {torch.version.cuda} python {sys.version.split()[0]}")
    from tpukern_torch import _build
    nvcc = sh(_build._nvcc(), "--version").splitlines()
    print(f"[device] nvcc: {nvcc[-1] if nvcc else 'unavailable'}")
    try:
        import triton
        print(f"[device] triton {triton.__version__} imports")
    except ImportError:
        print("[device] triton does not import")


def phase_build():
    from tpukern_torch import _build
    path, seconds = _build.build()
    _build.library()
    log = (path.parent / "nvcc.log")
    text = log.read_text() if log.exists() else ""
    # one line per kernel: ptxas -v's entry name (demangled), registers,
    # shared memory and spills
    entries = []  # [mangled name, spills, "N registers, ..."]
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entries.append([m.group(1), "", ""])
        elif entries and "spill" in ln:
            entries[-1][1] = ln.strip()
        elif entries and "Used" in ln:
            entries[-1][2] = ln.split("Used", 1)[1].strip()
    names = sh("c++filt", *[e[0] for e in entries]).splitlines()
    if len(names) != len(entries):
        names = [e[0] for e in entries]
    for name, (_, spills, used) in zip(names, entries):
        name = name.replace("(anonymous namespace)::", "").split("(")[0]
        print(f"[build] ptxas {name}: {used}; {spills}")
    print(f"[build] {path} compiled in {seconds:.1f} s "
          f"({'fresh' if seconds else 'already built'})")
    serialized = [ln.strip() for ln in text.splitlines() if "C7520" in ln]
    for ln in serialized:
        print(f"[build] ptxas {ln}")
    bad = [ln for ln in serialized if any(k in ln for k in NO_SERIALIZED)]
    require(not bad, f"ptxas serialised the wgmmas of {bad}")
    counts = sass_counts(path)
    for kernel, want in SASS_WANT.items():
        funcs = counts[kernel]
        got = {op: sum(c[op] for c in funcs.values()) for op in want}
        print(f"[build] sass {kernel} ({len(funcs)} instance"
              f"{'s' if len(funcs) > 1 else ''}): "
              + ", ".join(f"{op} {n}" for op, n in got.items()))
        for func, c in funcs.items():  # each instance on its own
            for op, present in want.items():
                require((c[op] > 0) == present,
                        f"{func}'s SASS has {c[op]} {op}, wanted "
                        f"{'some' if present else 'none'}")


# instructions the SASS of the redesigned kernels must (True) or must not
# (False) hold, in every function whose mangled name holds the fragment:
# #16's bf16 kernel, the bf16 CE forward (#13) and backward's three
# launches (#14/#15) and the bf16 #2 (NN and TN), #28 (NN and trans_w)
# and #29 kernels with both operands by TMA, every instance of the
# bf16 flash-attention forward (#6), and the split-TF32 f32 #2, f32 CE
# forward and f32 CE backward's three launches and the split-TF32 f32
# #28 (one kernel, NN and trans_w) and #29, run wgmma (HGMMA) fed by
# TMA (UTMALDG), no mma.sync (HMMA), as do every instance of the f32
# flash-attention forward (#6) and the f32 fused backward (#8) on
# split-TF32 products, and of the bf16 fused backward (#8 on bf16
# wgmma), and the f32 featured backward (#9 fa_dq_tf32_kernel, #10
# fa_dkv_tf32_kernel); #40 runs no matrix product (HMMA, HGMMA); the
# bf16 w8a16 GEMM (#25) runs mma.sync (HMMA) at 1, 2 and 4 token tiles
# and register-A wgmma (HGMMA, no HMMA) at 8 and 16, and widens its int8
# weights with no conversion instruction (I2F, I2FP) in every instance;
# every instance of #30's ew_kernel loads its tier's width (16-bit LDG16
# at bf16 x1, 32-bit LDG32 at f32 x1 and bf16 x2, LDG64 at f32 x2, LDG128
# at the 16-byte tiers) and nothing wider; the cluster softmax kernel (#35 + #36) passes
# the cluster barrier (UCGABAR_ARV, UCGABAR_WAIT)
_WGMMA_TMA = {"HGMMA": True, "UTMALDG": True, "HMMA": False}
SASS_WANT = {"matmul_naive_bf16_kernelILb1ELb1E": _WGMMA_TMA,
             "ce_fwd_wgmma_kernelILb1ELb1E": _WGMMA_TMA,
             "fa_fwd_wgmma_kernel": _WGMMA_TMA,
             "ce_dlog_kernelILb1ELb1E": _WGMMA_TMA,
             "ce_dx_kernelILb1E": _WGMMA_TMA,
             "ce_dw_kernelILb1E": _WGMMA_TMA,
             "hgemm_wgmma_kernelILb0ELb1ELb1E": _WGMMA_TMA,
             "hgemm_wgmma_kernelILb1ELb1ELb1E": _WGMMA_TMA,
             "gmm_wgmma_kernelILb0ELb1ELb1E": _WGMMA_TMA,
             "gmm_wgmma_kernelILb1ELb1ELb1E": _WGMMA_TMA,
             "tgmm_bf16_kernelILb1ELb1E": _WGMMA_TMA,
             "gemm_tf32_kernel": _WGMMA_TMA,
             "ce_fwd_tf32_kernel": _WGMMA_TMA,
             "ce_dlog_tf32_kernel": _WGMMA_TMA,
             "ce_dx_tf32_kernel": _WGMMA_TMA,
             "ce_dw_tf32_kernel": _WGMMA_TMA,
             # the mangled names' lengths keep the two apart
             "15gmm_tf32_kernel": _WGMMA_TMA,
             "16tgmm_tf32_kernel": _WGMMA_TMA,
             "fa_fwd_tf32_kernel": _WGMMA_TMA,
             "fa_bwd_tf32_kernel": _WGMMA_TMA,
             "fa_dq_tf32_kernel": _WGMMA_TMA,
             "fa_dkv_tf32_kernel": _WGMMA_TMA,
             "fa_bwd_bf16_kernel": _WGMMA_TMA,
             "embedding_select_kernel": {"HMMA": False, "HGMMA": False},
             **{f"w8a16_mma_kernelILi{nt}E": {"HMMA": True, "I2F": False,
                                               "I2FP": False}
                for nt in (1, 2, 4)},
             **{f"w8a16_mma_kernelILi{nt}E": {"HGMMA": True, "HMMA": False,
                                               "I2F": False, "I2FP": False}
                for nt in (8, 16)},
             **{f"ew_kernelI{t}Li{vec}E": {
                 f"LDG{bits}": True,
                 **{f"LDG{w}": False for w in (64, 128) if w > bits}}
                for t, vec, bits in (
                    ("f", 1, 32), ("f", 2, 64), ("f", 4, 128),
                    ("13__nv_bfloat16", 1, 16), ("13__nv_bfloat16", 2, 32),
                    ("13__nv_bfloat16", 8, 128))},
             "softmax_grid_fused_kernel": {"UCGABAR_ARV": True,
                                           "UCGABAR_WAIT": True}}
# SASS_WANT's names for instructions that a plain word does not pick out:
# the global loads by width (LDG.E is 32 bits, with or without the
# read-only .CONSTANT; the others name their width)
SASS_PATTERNS = {"LDG16": r"\bLDG\.E\.(U|S)16\b",
                 "LDG32": r"\bLDG\.E(\.CONSTANT)?\s",
                 "LDG64": r"\bLDG\.E\.64\b", "LDG128": r"\bLDG\.E\.128\b"}
# kernels whose wgmmas ptxas must leave asynchronous: no C7520 info line
# ("wgmma.mma_async instructions are serialized") may name them
NO_SERIALIZED = ("w8a16_mma_kernel", "gemm_tf32_kernel",
                 "ce_fwd_tf32_kernel", "ce_dlog_tf32_kernel",
                 "ce_dx_tf32_kernel", "ce_dw_tf32_kernel",
                 "gmm_tf32_kernel", "tgmm_tf32_kernel",
                 "fa_fwd_tf32_kernel", "fa_bwd_tf32_kernel",
                 "fa_dq_tf32_kernel", "fa_dkv_tf32_kernel",
                 "fa_bwd_bf16_kernel")


def sass_counts(lib):
    """{SASS_WANT fragment: {function: {instruction: count}}} in cuobjdump
    -sass of the built library, for each function whose name holds the
    fragment."""
    from tpukern_torch import _build
    ops = sorted({op for want in SASS_WANT.values() for op in want})
    counts = {k: {} for k in SASS_WANT}
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    proc = subprocess.Popen([str(tool), "-sass", str(lib)],
                            stdout=subprocess.PIPE, text=True)
    current, seen = [], set()
    for line in proc.stdout:
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = [counts[k].setdefault(m.group(1), dict.fromkeys(ops, 0))
                       for k in SASS_WANT if k in m.group(1)]
            seen.update(k for k in SASS_WANT if k in m.group(1))
            continue
        for c in current:
            for op in ops:
                if re.search(SASS_PATTERNS.get(op, rf"\b{op}\b"), line):
                    c[op] += 1
    require(proc.wait() == 0, f"{tool} -sass failed")
    require(seen == set(SASS_WANT), f"no SASS of {set(SASS_WANT) - seen}")
    return counts


def _randn(gen, *shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _compare(name, case, out, ref, scale=1.0, dtype=None, tol=None):
    """max |out - ref| <= atol * scale + rtol * |ref| elementwise, at the
    tolerance `tol` (rtol, atol), default that of `dtype` (default: out's);
    scale (the largest |ref|) holds gradients of small magnitude to the
    tolerance relative to their own size."""
    rtol, atol = tol or TOLS[dtype or out.dtype]
    d = (out.float() - ref.float()).abs()
    bound = atol * scale + rtol * ref.float().abs()
    ok = bool(torch.isfinite(out.float()).all() and (d <= bound).all())
    tol = f"{rtol:g}/{atol:g}" + (f"x{scale:.3g}" if scale != 1.0 else "")
    print(f"[check] {name:16s} {case:44s} max_abs {d.max().item():.3e} "
          f"mean_abs {d.mean().item():.3e} tol {tol} "
          f"{'ok' if ok else 'MISS'}")
    return ok, d.max().item()


def _same_bits(name, case, out, again):
    """(ok, 0.0): a second call gave the same bits as the first."""
    ok = torch.equal(out, again)
    if not ok:
        print(f"[check] {name:16s} {case:44s} a second call differs MISS")
    return ok, 0.0


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# the timing schedule of a call that takes tens of ms (the Mixtral expert
# products): run_benchmark's arguments, and no profiled calls. A call that
# long is one kernel or a few that keep the queue full, so its events time
# is its device time; the profiler dropped whole calls of such kernels on
# an H100 (device times of 0.5x the events' or none at all in a session
# of 2 calls)
LIGHT = dict(bench=dict(warmup=1, iters=2, reps=3), device_n=0)


def _timed_entry(name, shape, kernel, plain, library, flops, nbytes, dtype,
                 light=False, fma=None):
    """One kernel to time: its call, its plain version's, the one
    PyTorch call of the same function (or None), and the work the
    function needs on these inputs (operations, and bytes with each input
    read once and each output written once); `light` times it on the
    LIGHT schedule; `fma`, the f32 operations of a split-TF32 kernel,
    whose bound on the CUDA cores' FMAs is printed and kept beside its
    own (fma_bound_ms)."""
    return dict(name=name, shape=shape, kernel=kernel, plain=plain,
                library=library, flops=flops, nbytes=nbytes, dtype=dtype,
                fma=fma, **(LIGHT if light else dict(bench={}, device_n=20)))


def _device_events(fn, n):
    """(start_us, end_us, name) of every device op of n calls of fn, from
    torch.profiler (CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    # user annotations (the optimizer's "Optimizer.step#Adam.step") span
    # the kernels they enclose: kernels only
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))


def _device_ms(fn, n=20):
    """Device-only ms per call (the sum of its kernels' durations), or
    None if the profiler saw no device op in three sessions (one session
    saw none for SDPA at the verification shape on an H100) or n is 0."""
    for _ in range(3 if n else 0):
        ev = _device_events(fn, n)
        if ev:
            return sum(e - s for s, e, _ in ev) / n / 1e3
    return None


class _Checks:
    """Kernel-vs-plain outcomes: {kernel: dict(max_abs_err, ...)}, all ok."""

    def __init__(self):
        self.results, self.ok = {}, True

    def record(self, name, ok, err):
        self.ok &= ok
        r = self.results.setdefault(name, dict(max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)


def _bound(flops, nbytes, dtype):
    """(ms, "bytes" or "operations"): the least time the card could take.
    flops is a count at dtype's rate (ops_bench.SPLIT_TF32: the f32
    operations of a split-TF32 kernel), or {dtype: count} for work of
    several types."""
    from tpukern_torch.harness import ops_bench

    split = ops_bench.SPLIT_TF32
    peaks = {**PEAK_FLOP_S, split: ops_bench.PEAK_FLOP_S[split]}
    if not isinstance(flops, dict):
        flops = {dtype: flops}
    t_ops = sum(n / peaks[dt] for dt, n in flops.items())
    t_bytes = nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _time_kernels(timed, results):
    """CUDA events around back-to-back calls (host issue time included
    where it exceeds the device's), and device-only time (profiler), of
    each {key: _timed_entry} (kernel, plain and library calls), with the
    kernel's bound; the first entry of a kernel name is the one its
    result row keeps."""
    from tpukern_torch.harness import run_benchmark

    def dev(ms):
        return "not measured" if ms is None else f"{ms:.4f}"

    for key, t in timed.items():
        lib, kw, n = t["library"], t["bench"], t["device_n"]
        bound_ms, bound_by = _bound(t["flops"], t["nbytes"], t["dtype"])
        r = dict(shape=t["shape"], ms=run_benchmark(t["kernel"], **kw),
                 plain_ms=run_benchmark(t["plain"], **kw),
                 library_ms=None if lib is None else run_benchmark(lib, **kw),
                 bound_ms=bound_ms, bound_by=bound_by,
                 device_ms=_device_ms(t["kernel"], n),
                 plain_device_ms=_device_ms(t["plain"], n),
                 library_device_ms=(None if lib is None
                                    else _device_ms(lib, n)))
        fma = ""
        if t["fma"] is not None:
            r["fma_bound_ms"] = _bound(t["fma"], t["nbytes"],
                                       torch.float32)[0]
            fma = f" (split-TF32; f32 FMA bound {r['fma_bound_ms']:.4f} ms)"
        for k, v in r.items():
            results[t["name"]].setdefault(k, v)
        libs = ("none" if lib is None else
                f"{r['library_ms']:.4f} ms events, "
                f"{dev(r['library_device_ms'])} ms device")
        print(f"[time] {key:24s} at {t['shape']}: kernel {r['ms']:.4f} ms "
              f"plain {r['plain_ms']:.4f} ms (events); device-only: kernel "
              f"{dev(r['device_ms'])} ms plain {dev(r['plain_device_ms'])} "
              f"ms; library {libs}; bound {bound_ms:.4f} ms by {bound_by}"
              f"{fma}")


def phase_kernels(cfg):
    """Every serving kernel against its plain version; times at the
    serving shape. Returns {kernel: dict(max_abs_err, ms, plain_ms, ...)}
    and all-ok."""
    from functools import partial

    from tpukern_torch.ops import attention, paged_attention, rmsnorm, rope

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf, f32 = torch.bfloat16, torch.float32
    d, D = cfg.d_model, cfg.head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    checks, timed = _Checks(), {}
    record = checks.record

    # rms_norm: decode rows (4), the largest prefill bucket (512), f32
    for T, dt in ((4, bf), (512, bf), (8, f32)):
        x = _randn(gen, T, d, dtype=dt)
        g = (1 + 0.1 * _randn(gen, d, dtype=f32)).to(dt)
        record("rms_norm", *_compare("rms_norm", f"({T}, {d}) {dt}",
                                     rmsnorm.rms_norm(x, g),
                                     rmsnorm.rms_norm_ref(x, g)))
    x = _randn(gen, 512, d, dtype=bf)
    g = torch.ones(d, dtype=bf, device="cuda")
    timed["rms_norm"] = _timed_entry(
        "rms_norm", [512, d], partial(rmsnorm.rms_norm, x, g),
        partial(rmsnorm.rms_norm_ref, x, g),
        partial(F.rms_norm, x, (d,), g, 1e-5), 4 * x.numel(),
        _nbytes(x, g, x), bf)

    # rope_cached: q rows of one decode step and of a 512 prefill, f32
    cos_t, sin_t = rope.make_cos_sin(cfg.max_seq, D, device="cuda")
    for R, dt, dd in ((4 * Hq, bf, D), (Hq * 512, bf, D), (96, f32, 64)):
        c, s = ((cos_t, sin_t) if dd == D
                else rope.make_cos_sin(cfg.max_seq, dd, device="cuda"))
        pos = torch.randint(0, cfg.max_seq, (R,), generator=gen,
                            device="cuda")
        x = _randn(gen, R, dd, dtype=dt)
        record("rope_cached", *_compare(
            "rope_cached", f"({R}, {dd}) {dt}",
            rope.rope_cached(x, c[pos], s[pos]),
            rope.rope_cached_ref(x, c[pos], s[pos])))
    pos = torch.arange(512, device="cuda").repeat(Hq)
    x = _randn(gen, Hq * 512, D, dtype=bf)
    args = (x, cos_t[pos], sin_t[pos])
    timed["rope_cached"] = _timed_entry(
        "rope_cached", [Hq * 512, D], partial(rope.rope_cached, *args),
        partial(rope.rope_cached_ref, *args), None, 3 * x.numel(),
        _nbytes(*args, x), bf)

    # flash_attention: the 7bish prefill heads at S in {128, 300, 512},
    # D = 64, and f32 (causal and not); the bf16 kernel (TMA + wgmma)
    # gives the same bits on a second call
    fa_cases = [(1, Hq, Hkv, S, D, bf, True) for S in (128, 300, 512)]
    fa_cases += [(1, 8, 4, 300, 64, bf, True), (2, 4, 2, 100, 64, f32, True),
                 (1, 4, 4, 77, 128, f32, False), (1, 4, 2, 130, 32, bf, False)]
    for B, hq, hkv, S, dd, dt, causal in fa_cases:
        q = _randn(gen, B, hq, S, dd, dtype=dt)
        k = _randn(gen, B, hkv, S, dd, dtype=dt)
        v = _randn(gen, B, hkv, S, dd, dtype=dt)
        case = f"B{B} H{hq}/{hkv} S{S} D{dd} {dt} causal={causal}"
        o = attention.flash_attention(q, k, v, causal=causal)
        record("flash_attention", *_compare(
            "flash_attention", case, o,
            attention.attention_ref(q, k, v, causal=causal)))
        if dt == bf:
            record("flash_attention", *_same_bits(
                "flash_attention", case, o,
                attention.flash_attention(q, k, v, causal=causal)))
    # the Gemma-2-style serving instance (FEAT): window 512, 4 sinks,
    # softcap 50, at the 7bish heads and S 512 and 1024 (the band then
    # starts past the sinks)
    for S in (512, 1024):
        q = _randn(gen, 1, Hq, S, D, dtype=bf)
        k, v = (_randn(gen, 1, Hkv, S, D, dtype=bf) for _ in range(2))
        case = f"gemma2 B1 H{Hq}/{Hkv} S{S} D{D} bf16"
        o, lse = attention.flash_attention(q, k, v, causal=True,
                                           return_stats=True, **GEMMA2)
        ro, rlse = attention.attention_ref(q, k, v, causal=True,
                                           return_stats=True, **GEMMA2)
        record("flash_attention", *_compare("flash_attention", f"o {case}",
                                            o, ro))
        record("flash_attention", *_compare("flash_attention",
                                            f"lse {case}", lse, rlse,
                                            dtype=f32))
        record("flash_attention", *_same_bits(
            "flash_attention", case, o,
            attention.flash_attention(q, k, v, causal=True, **GEMMA2)))
    q = _randn(gen, 1, Hq, 512, D, dtype=bf)
    k = _randn(gen, 1, Hkv, 512, D, dtype=bf)
    v = _randn(gen, 1, Hkv, 512, D, dtype=bf)
    timed["flash_attention"] = _timed_entry(
        "flash_attention", [1, Hq, 512, D],
        partial(attention.flash_attention, q, k, v, causal=True),
        partial(attention.attention_ref, q, k, v, causal=True),
        partial(F.scaled_dot_product_attention, q, k, v, is_causal=True,
                enable_gqa=True),
        4 * D * Hq * 512 * 513 // 2, _nbytes(q, k, v, q), bf)
    # the same heads at S 4096, where the flops bound it
    q = _randn(gen, 1, Hq, 4096, D, dtype=bf)
    k, v = (_randn(gen, 1, Hkv, 4096, D, dtype=bf) for _ in range(2))
    record("flash_attention", *_compare(
        "flash_attention", f"B1 H{Hq}/{Hkv} S4096 D{D} bf16 causal=True",
        attention.flash_attention(q, k, v, causal=True),
        attention.attention_ref(q, k, v, causal=True)))
    timed["flash_attention S4096"] = _timed_entry(
        "flash_attention", [1, Hq, 4096, D],
        partial(attention.flash_attention, q, k, v, causal=True),
        partial(attention.attention_ref, q, k, v, causal=True),
        partial(F.scaled_dot_product_attention, q, k, v, is_causal=True,
                enable_gqa=True),
        4 * D * Hq * 4096 * 4097 // 2, _nbytes(q, k, v, q), bf)

    # paged decode: 4 sequences x 8 pages of 128 from a shuffled pool
    def paged_case(B, hq, hkv, dd, page, pps, lengths, dt, T=None):
        return _paged_case(gen, B, hq, hkv, dd, page, pps, lengths, dt, T)

    serve_case = paged_case(4, Hq, Hkv, D, 128, 8, [1, 129, 700, 1024], bf)
    for case, args in (
            ("B4 H16/8 D128 page128 x8 bf16", serve_case),
            ("B3 H4/2 D64 page16 x4 f32 len{0,17,64}",
             paged_case(3, 4, 2, 64, 16, 4, [0, 17, 64], f32))):
        record("paged_attention", *_compare(
            "paged_attention", case,
            paged_attention.paged_attention(*args),
            paged_attention.paged_attention_ref(*args)))
    timed["paged_attention"] = _timed_entry(
        "paged_attention", [4, Hq, D],
        partial(paged_attention.paged_attention, *serve_case),
        partial(paged_attention.paged_attention_ref, *serve_case),
        _paged_library(*serve_case), *_paged_work(*serve_case), bf)
    long_case = paged_case(4, Hq, Hkv, D, 128, LONG_PAGES, [LONG_TOKENS] * 4,
                           bf)
    _paged_split_checks(record, paged_case, cfg, serve_case, long_case)
    timed["paged_attention long"] = _timed_entry(
        "paged_attention_long", [4, Hq, D, LONG_TOKENS],
        partial(paged_attention.paged_attention, *long_case),
        partial(paged_attention.paged_attention_ref, *long_case),
        _paged_library(*long_case), *_paged_work(*long_case), bf)

    # paged prefix prefill (#24): a 256-token chunk over a 900-token
    # prefix and a gamma = 4 verification whose last length passes the
    # pool (the clamp), both timed; small f32 and bf16 cases of every head
    # dim, T in {1, 7, 70}, page 16; then the window, sinks and softcap of
    # #24 and #23
    pp = paged_attention.paged_prefill_attention
    pp_ref = paged_attention.paged_prefill_ref
    chunk_case = paged_case(1, Hq, Hkv, D, 128, 8, [900], bf, T=256)
    verify_case = paged_case(4, Hq, Hkv, D, 128, 8, [6, 133, 705, 1029], bf,
                             T=5)
    cases = [("chunk B1 H16/8 T256 D128 len900 bf16", chunk_case),
             ("verify B4 H16/8 T5 D128 len{6,133,705,1029}", verify_case)]
    for dd in (32, 64, 128):
        for T in (1, 7, 70):
            for dt in (f32, bf):
                cases.append((f"B2 H4/2 T{T} D{dd} page16 x8 {dt}",
                              paged_case(2, 4, 2, dd, 16, 8, [T + 13, 128],
                                         dt, T=T)))
    small = paged_case(2, 8, 2, 64, 16, 8, [70, 128], f32, T=7)
    for case, args in cases:
        record("paged_prefill_attention", *_compare(
            "paged_prefill", case, pp(*args), pp_ref(*args)))
    for feat in (dict(window=512, sinks=4, softcap=50.0),
                 dict(window=40, sinks=5), dict(softcap=2.0)):
        tag = " ".join(f"{k} {v:g}" for k, v in feat.items())
        for case, args in (("chunk", chunk_case), ("verify", verify_case),
                           ("B2 H8/2 T7 D64 f32", small)):
            record("paged_prefill_attention", *_compare(
                "paged_prefill", f"{tag} {case}", pp(*args, **feat),
                pp_ref(*args, **feat)))
        for case, args in (("serve", serve_case),
                           ("B2 H8/2 D64 f32", (small[0][:, :, 0],
                                                *small[1:]))):
            record("paged_attention", *_compare(
                "paged_attention", f"{tag} {case}",
                paged_attention.paged_attention(*args, **feat),
                paged_attention.paged_attention_ref(*args, **feat)))
    _prefill_split_checks(record, paged_case, cfg, verify_case, chunk_case)
    for tag, args in (("chunk", chunk_case), ("verify", verify_case)):
        B, _, T, _ = args[0].shape
        timed[f"paged_prefill_attention {tag}"] = _timed_entry(
            "paged_prefill_attention", [B, Hq, T, D], partial(pp, *args),
            partial(pp_ref, *args), _paged_library(*args),
            *_paged_work(*args), bf)
    for name, args in (("paged_attention", serve_case),
                       ("paged_prefill_attention", chunk_case)):
        lib = _paged_library(*args)().reshape(args[0].shape)
        ref = (paged_attention.paged_attention_ref if args[0].dim() == 3
               else pp_ref)(*args)
        print(f"[library] SDPA for {name}: max_abs "
              f"{(lib.float() - ref.float()).abs().max().item():.3e} "
              f"against the plain version")
    _paged_bf16_p(serve_case)
    _quant_kernels(checks, timed, gen, serve_case, verify_case, chunk_case)
    _ring_kernels(checks, timed, gen, cfg, serve_case, verify_case)
    _w8a16_kernels(checks, timed, gen, cfg)
    _sampling_kernels(checks, timed, gen)

    _time_kernels(timed, checks.results)
    return checks.results, checks.ok


# #23's long timed shape: 4 sequences of 8192 tokens (64 pages of 128)
LONG_TOKENS, LONG_PAGES = 8192, 64
# the split lengths timed against each other (multiples of the tile)
SPLIT_CHUNKS = (64, 128, 256)


def _with_chunk(chunk, fn):
    """fn with paged_attention.DECODE_CHUNK set to chunk for the call."""
    from tpukern_torch.ops import paged_attention

    def run():
        keep = paged_attention.DECODE_CHUNK
        paged_attention.DECODE_CHUNK = chunk
        try:
            return fn()
        finally:
            paged_attention.DECODE_CHUNK = keep
    return run


def _paged_split_checks(record, paged_case, cfg, serve_case, long_case):
    """#23 split-KV: bf16 and f32 pools, FEAT off and on (window + sinks,
    softcap, ring, ALiBi), lengths at the split edges (0, 1, chunk - 1,
    chunk, chunk + 1, the pool's end and past it) over three splits,
    against the split order's plain version and the final-max one; a
    second call bit-equal to the first; the long shape against the plain
    version. Then each split length of SPLIT_CHUNKS at the serving and
    the long shape: checked, and timed by device time (the profiler)
    and CUDA events, with its n_split."""
    from functools import partial

    from tpukern_torch.ops import paged_attention as pa
    from tpukern_torch.harness import run_benchmark

    c = pa.DECODE_CHUNK
    edge = [0, 1, c - 1, c, c + 1, 3 * c, 3 * c + 9]
    feats = {"": {}, "window 40 sinks 5": dict(window=40, sinks=5),
             "softcap 2": dict(softcap=2.0),
             "ring w300 sinks 4": dict(ring=True, window=300, sinks=4),
             "alibi": dict(alibi_slopes=pa.default_alibi_slopes(
                 cfg.n_heads))}
    for dt, dn in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        args = paged_case(len(edge), cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, 16, 3 * c // 16, edge, dt)
        for tag, feat in feats.items():
            out = pa.paged_attention(*args, **feat)
            for name, ref in (("split", pa.paged_attention_split_ref),
                              ("final max", pa.paged_attention_ref)):
                record("paged_attention", *_compare(
                    "paged_attention", f"edges {tag} {dn} vs {name}", out,
                    ref(*args, **feat)))
            same = torch.equal(out, pa.paged_attention(*args, **feat))
            if not same:
                print(f"[check] paged_attention  edges {tag} {dn}: a second "
                      "call differs MISS")
            record("paged_attention", same, 0.0)
    record("paged_attention_long", *_compare(
        "paged_attention", f"B4 H16/8 D128 {LONG_TOKENS} tokens bf16",
        pa.paged_attention(*long_case), pa.paged_attention_ref(*long_case)))
    S = {"serving": 8 * 128, f"4 x {LONG_TOKENS}": LONG_PAGES * 128}
    for chunk in SPLIT_CHUNKS:
        times = []
        for (label, slots), args in zip(S.items(), (serve_case, long_case)):
            fn = _with_chunk(chunk, partial(pa.paged_attention, *args))
            record("paged_attention", *_compare(
                "paged_attention", f"chunk {chunk} {label} vs split",
                fn(), pa.paged_attention_split_ref(*args, chunk=chunk)))
            dev = _device_ms(fn)
            times.append(
                f"{label} {'not measured' if dev is None else f'{dev:.4f}'}"
                f" ms device, {run_benchmark(fn):.4f} ms events (n_split "
                f"{-(-slots // chunk)})")
        print(f"[paged split] chunk {chunk}: " + "; ".join(times))
    print(f"[paged split] DECODE_CHUNK {c}: n_split "
          f"{pa.decode_splits(8, 128)} at the serving shape, "
          f"{pa.decode_splits(LONG_PAGES, 128)} at 4 x {LONG_TOKENS}")


def _with_prefill_chunk(chunk, fn):
    """fn with paged_attention.PREFILL_CHUNK set to chunk for the call
    (None: prefill_splits' rule)."""
    from tpukern_torch.ops import paged_attention

    def run():
        keep = paged_attention.PREFILL_CHUNK
        paged_attention.PREFILL_CHUNK = chunk
        try:
            return fn()
        finally:
            paged_attention.PREFILL_CHUNK = keep
    return run


# #24's split edges: a split length forced for the check, over three
# splits a sequence
PREFILL_EDGE_CHUNK = 128


def _prefill_split_checks(record, paged_case, cfg, verify_case, chunk_case):
    """#24 split-KV: bf16 and f32 pools, T = 5, FEAT off and on (window +
    sinks, softcap, ring, ALiBi), lengths at the split edges (0, 1, chunk
    - 1, chunk, chunk + 1, the pool's end and past it) over three splits
    of PREFILL_EDGE_CHUNK, against the split order's plain version and
    the final-max one; a second call bit-equal to the first. Then [prefill
    split]: each split length of SPLIT_CHUNKS, one split (the pool) and
    the rule's at the verify and the chunk shapes: checked against the
    split order, and timed by device time (the profiler) and CUDA events,
    with its n_split."""
    from functools import partial

    from tpukern_torch.ops import paged_attention as pa
    from tpukern_torch.harness import run_benchmark

    c = PREFILL_EDGE_CHUNK
    edge = [0, 1, c - 1, c, c + 1, 3 * c, 3 * c + 9]
    feats = {"": {}, "window 40 sinks 5": dict(window=40, sinks=5),
             "softcap 2": dict(softcap=2.0),
             "ring w300 sinks 4": dict(ring=True, window=300, sinks=4),
             "alibi": dict(alibi_slopes=pa.default_alibi_slopes(
                 cfg.n_heads))}
    for dt, dn in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        args = paged_case(len(edge), cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, 16, 3 * c // 16, edge, dt, T=5)
        for tag, feat in feats.items():
            fn = _with_prefill_chunk(
                c, partial(pa.paged_prefill_attention, *args, **feat))
            out = fn()
            for name, ref in (("split", partial(pa.paged_prefill_split_ref,
                                                chunk=c)),
                              ("final max", pa.paged_prefill_ref)):
                record("paged_prefill_attention", *_compare(
                    "paged_prefill", f"edges {tag} {dn} vs {name}", out,
                    ref(*args, **feat)))
            same = torch.equal(out, fn())
            if not same:
                print(f"[check] paged_prefill    edges {tag} {dn}: a second "
                      "call differs MISS")
            record("paged_prefill_attention", same, 0.0)
    slots = verify_case[4].shape[1] * verify_case[1].shape[2]
    for chunk in (*SPLIT_CHUNKS, slots, None):
        times = []
        for label, args in (("verify", verify_case), ("chunk", chunk_case)):
            fn = _with_prefill_chunk(
                chunk, partial(pa.paged_prefill_attention, *args))
            B, Hq, T, _ = args[0].shape
            n = _with_prefill_chunk(chunk, partial(
                pa.prefill_splits, B, Hq, args[1].shape[0], T, slots,
                args[0].dtype))()
            record("paged_prefill_attention", *_compare(
                "paged_prefill", f"chunk {chunk} {label} vs split", fn(),
                pa.paged_prefill_split_ref(*args, chunk=n[0])))
            dev = _device_ms(fn)
            times.append(
                f"{label} {'not measured' if dev is None else f'{dev:.4f}'}"
                f" ms device, {run_benchmark(fn):.4f} ms events (slots a "
                f"split {n[0]}, n_split {n[1]})")
        print(f"[prefill split] chunk {chunk or 'rule'}: " + "; ".join(times))


def _paged_bf16_p(args):
    """#23 on bf16 pools rounds P to bf16 for the P V sum, as JAX's
    _decode_kernel does: its error against the plain version that rounds
    P alike (the check above) beside its error against P kept in f32 (the
    plain version on the same values as f32 pools)."""
    from tpukern_torch.ops import paged_attention

    q, kp, vp, lengths, table = args
    out = paged_attention.paged_attention(*args).float()
    errs = []
    for ref in (paged_attention.paged_attention_ref(*args),
                paged_attention.paged_attention_ref(
                    q.float(), kp.float(), vp.float(), lengths, table)):
        ref = ref.to(torch.bfloat16).float()
        errs.append(((out - ref).abs().max().item(),
                     int((out != ref).sum())))
    print(f"[check] paged_attention  bf16 P at the serving shape: max_abs "
          f"{errs[0][0]:.3e} against the plain version that rounds P "
          f"({errs[0][1]} of {out.numel()} outputs differ), {errs[1][0]:.3e} "
          f"against P in f32 ({errs[1][1]} differ)")


# the quantized instances of #23/#24: tier -> (pool dtype, q_int8, pv_int8,
# pages_per_block); pv_int8 quantizes p per block of page * pages_per_block
# tokens, so it runs at two
QUANT_KERNEL_TIERS = {
    "int8": ("int8", False, False, 8),
    "int8 q_int8": ("int8", True, False, 8),
    "int8 pv_int8 ppb1": ("int8", False, True, 1),
    "int8 q_int8 pv_int8 ppb1": ("int8", True, True, 1),
    "int8 q_int8 pv_int8 ppb8": ("int8", True, True, 8),
    "fp8": ("fp8", False, False, 8)}
# the tiers as served (int8 pools always take q_int8): timed
QUANT_SERVED = ("int8 q_int8", "int8 q_int8 pv_int8 ppb8", "fp8")
_QUANT_LABEL = {True: "#23 quantized", False: "#24 quantized"}


def _quant_case(args, tier):
    """(q, pools, scales, lengths, table) of a float paged case with its
    pools quantized to the tier's dtype (quantize_pages), and the tier's
    keyword arguments."""
    from tpukern_torch.ops import paged_attention

    q, kp, vp, lengths, table = args
    dtype, q_int8, pv_int8, ppb = QUANT_KERNEL_TIERS[tier]
    kq, ks = paged_attention.quantize_pages(kp.float(), dtype)
    vq, vs = paged_attention.quantize_pages(vp.float(), dtype)
    return ((q, kq, ks, vq, vs, lengths, table),
            dict(pages_per_block=ppb, q_int8=q_int8, pv_int8=pv_int8))


def _quant_work(args, kw, **feat):
    """(flops by dtype, bytes) of a quantized paged call: the score and the
    P V products, 2 D each a visible (query head, position) pair, at int8's
    rate under q_int8 / pv_int8, else at q's type's; q, o, the 1-byte K and
    V rows and their f32 scales at the positions some token sees, the
    lengths and the table, each once."""
    q, kq, ks, vq, vs, lengths, table = args
    T = 1 if q.dim() == 3 else q.shape[2]
    Hkv, _, page, D = kq.shape
    keep = _visible(lengths, T, table.shape[1] * page, **feat)
    half = 2 * D * q.shape[1] * int(keep.sum())
    flops = {}
    for on in (kw["q_int8"], kw["pv_int8"]):
        dt = torch.int8 if on else q.dtype
        flops[dt] = flops.get(dt, 0) + half
    live = int(keep.any(dim=1).sum())
    return flops, (2 * _nbytes(q) + 2 * live * Hkv * (D + 4)
                   + _nbytes(lengths, table))


def _quant_library(args, **feat):
    """_paged_library on pools dequantized to q's type outside the timed
    call."""
    q, kq, ks, vq, vs, lengths, table = args
    kd, vd = ((p.float() * s[..., None]).to(q.dtype)
              for p, s in ((kq, ks), (vq, vs)))
    return _paged_library(q, kd, vd, lengths, table, **feat)


def _quant_kernels(checks, timed, gen, serve_case, verify_case, chunk_case):
    """#20 (round to nearest), #21 and #22 against their plain versions at
    the K/V write shapes (32 rows a decode step, 4096 a 512-token
    prefill), q's shape (64 rows) and an odd width: values equal (int8
    exactly, fp8 bit for bit), scales within 1 f32 ulp; #20's stochastic
    mode by tests/test_quant.py's midpoint test. Then every quantized
    instance of #23 and #24 against its plain version at the serving
    shapes (decode, gamma = 4 verification, a 256-token chunk) with q in
    bf16 and in f32, and with the window, sinks and softcap; the served
    tiers timed beside SDPA on dequantized gathered copies. Each
    quantized call twice: the second gives the same bits (the splits
    merge in a fixed order)."""
    from functools import partial

    from tpukern_torch.ops import paged_attention as pa
    from tpukern_torch.ops import quant

    bf, f32 = torch.bfloat16, torch.float32
    for rows, K in ((32, 128), (64, 128), (4096, 128), (33, 100)):
        for dt in (bf, f32):
            x = 3 * _randn(gen, rows, K, dtype=f32)
            x[0] = 0
            x = x.to(dt)
            for name, fn, ref in (
                    ("quantize_int8", quant.quantize_int8, quant.quantize_ref),
                    ("quantize_fp8", quant.quantize_fp8,
                     quant.quantize_fp8_ref)):
                (v, s), (rv, rs) = fn(x), ref(x)
                n = int((v.view(torch.uint8) != rv.view(torch.uint8)).sum())
                ulps = int((s.view(torch.int32) - rs.view(torch.int32))
                           .abs().max())
                err = max((v.float() - rv.float()).abs().max().item(),
                          (s - rs).abs().max().item())
                ok = n == 0 and ulps <= 1
                print(f"[check] {name:16s} {f'({rows}, {K}) {dt}':44s} "
                      f"{n} values differ, scales within {ulps} ulp "
                      f"{'ok' if ok else 'MISS'}")
                checks.record(name, ok, err)
            v, s = quant.quantize_int8(x)
            for out in (bf, f32):
                checks.record("dequantize_int8", *_compare(
                    "dequantize_int8", f"({rows}, {K}) -> {out}",
                    quant.dequantize_int8(v, s, out),
                    quant.dequantize_ref(v, s, out), tol=(0.0, 0.0)))
    # stochastic rounding: 0.505 at scale 0.01 is 50.5, drawn to 50 or 51
    x = torch.full((64, 128), 0.505, device=serve_case[0].device)
    x[:, 0] = 1.27
    draws = torch.stack([quant.quantize_int8(x, seed=s, stochastic=True)[0]
                         for s in range(16)])[:, :, 1:].float()
    again = quant.quantize_int8(x, seed=3, stochastic=True)[0][:, 1:]
    ok = (set(draws.unique().tolist()) <= {50.0, 51.0}
          and abs(draws.mean().item() - 50.5) < 0.02
          and torch.equal(again.float(), draws[3])
          and not torch.equal(draws[3], draws[4]))
    print(f"[check] quantize_int8    {'stochastic, 0.505 at scale 0.01':44s} "
          f"values {sorted(set(draws.unique().tolist()))}, mean "
          f"{draws.mean().item():.4f} (50.5), a seed repeats, seeds differ "
          f"{'ok' if ok else 'MISS'}")
    checks.record("quantize_int8", ok, 0.0)
    for name, rows, fn, ref, nout in (
            ("quantize_int8", 32, quant.quantize_int8, quant.quantize_ref, 1),
            ("quantize_int8", 4096, quant.quantize_int8, quant.quantize_ref,
             1),
            ("quantize_fp8", 32, quant.quantize_fp8, quant.quantize_fp8_ref,
             1),
            ("quantize_fp8", 4096, quant.quantize_fp8, quant.quantize_fp8_ref,
             1),
            ("dequantize_int8", 4096, None, None, 2)):
        x = _randn(gen, rows, 128, dtype=bf)
        if fn is None:
            v, s = quant.quantize_int8(x)
            fn, ref = (partial(quant.dequantize_int8, v, s, bf),
                       partial(quant.dequantize_ref, v, s, bf))
            nbytes = _nbytes(v, s) + rows * 128 * nout
        else:
            fn, ref = partial(fn, x), partial(ref, x)
            nbytes = _nbytes(x) + rows * 128 * nout + 4 * rows
        # operations: |x|, the max, the division and the rounding a value
        timed[f"{name} ({rows}, 128)"] = _timed_entry(
            name, [rows, 128], fn, ref, None, 4 * rows * 128, nbytes, f32)

    cases = {"decode": serve_case, "verify": verify_case, "chunk": chunk_case}
    for tier in QUANT_KERNEL_TIERS:
        for case, base in cases.items():
            args, kw = _quant_case(base, tier)
            fn, ref = ((pa.paged_attention_quantized,
                        pa.paged_attention_quantized_ref) if case == "decode"
                       else (pa.paged_prefill_attention_quantized,
                             pa.paged_prefill_quantized_ref))
            name = fn.__name__
            for dt in (bf, f32) if case != "chunk" else (bf,):
                a = (args[0].to(dt), *args[1:])
                tol = QUANT_PV_F32_TOL if dt == f32 and kw["pv_int8"] else None
                out = fn(*a, **kw)
                checks.record(name, *_compare(
                    _QUANT_LABEL[case == "decode"], f"{tier} {case} {dt}",
                    out, ref(*a, **kw), tol=tol))
                checks.record(name, *_same_bits(
                    _QUANT_LABEL[case == "decode"], f"{tier} {case} {dt}",
                    out, fn(*a, **kw)))
            if tier in QUANT_SERVED:
                timed[f"{_QUANT_LABEL[case == 'decode']} {tier} {case}"] = (
                    _timed_entry(
                    name, list(args[0].shape), partial(fn, *args, **kw),
                        partial(ref, *args, **kw), _quant_library(args),
                        *_quant_work(args, kw), bf))
    for tier, feat, dt in (
            ("int8 q_int8 pv_int8 ppb8", GEMMA2, bf),
            ("fp8", GEMMA2, bf),
            ("int8 q_int8 pv_int8 ppb1", dict(window=40, sinks=5,
                                              softcap=2.0), f32),
            ("int8 q_int8", dict(window=40, sinks=5), f32)):
        tag = " ".join(f"{k} {v:g}" for k, v in feat.items())
        for case in ("decode", "verify"):
            args, kw = _quant_case(cases[case], tier)
            a = (args[0].to(dt), *args[1:])
            fn, ref = ((pa.paged_attention_quantized,
                        pa.paged_attention_quantized_ref) if case == "decode"
                       else (pa.paged_prefill_attention_quantized,
                             pa.paged_prefill_quantized_ref))
            tol = QUANT_PV_F32_TOL if dt == f32 and kw["pv_int8"] else None
            out = fn(*a, **kw, **feat)
            checks.record(fn.__name__, *_compare(
                _QUANT_LABEL[case == "decode"], f"{tier} {tag} {case} {dt}",
                out, ref(*a, **kw, **feat), tol=tol))
            checks.record(fn.__name__, *_same_bits(
                _QUANT_LABEL[case == "decode"], f"{tier} {tag} {case} {dt}",
                out, fn(*a, **kw, **feat)))


# [ring] kernel cases: 4 sequences on rings of 5 pages of 128 slots (640,
# the [ring-serve] pool), lengths wrapped more than once and one exactly
# full, sinks 4 and windows at the ring's limit (decode: ring - sinks;
# T = 5 new tokens: ring - sinks - 4)
RING_PPS, RING_LENGTHS, RING_SINKS = 5, [600, 1500, 2900, 640], 4
RING_WINDOW = {1: 128 * RING_PPS - RING_SINKS, 5: 128 * RING_PPS - RING_SINKS - 4}
# the quantized tiers on rings (page blocks divide the 5 pages)
RING_QUANT_TIERS = {"int8 q_int8": ("int8", True, False, RING_PPS),
                    "int8 q_int8 pv_int8 ppb1": ("int8", True, True, 1),
                    "fp8": ("fp8", False, False, RING_PPS)}


def _ring_kernels(checks, timed, gen, cfg, serve_case, verify_case):
    """Ring pools and ALiBi on every instance of #23 and #24 against the
    plain versions at the serving widths: float in bf16 and f32, int8
    (q_int8, with and without pv_int8) and fp8; decode and a T = 5
    verification on rings wrapped more than once with sinks 4 and the
    window at its ring limit, a 512 window with ALiBi on a ring, and ALiBi
    on the flat pools of the serving decode and verification cases. Times the ring decode and verification
    (float bf16 and int8) beside SDPA on a gathered copy with the mask of
    the visible slots."""
    from functools import partial

    from tpukern_torch.ops import paged_attention as pa

    bf, f32 = torch.bfloat16, torch.float32
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # the ALiBi paper's slopes 2^(-8 h / Hq), h = 1 .. Hq
    slopes = 2.0 ** (-8.0 * torch.arange(1, Hq + 1, device="cuda") / Hq)
    ring = {T: dict(ring=True, sinks=RING_SINKS, window=RING_WINDOW[T])
            for T in (1, 5)}
    feats = {"ring sinks 4 window at the limit": (ring[1], ring[5]),
             "ring window 512 alibi": (dict(ring=True, window=512,
                                            alibi_slopes=slopes),) * 2}
    cases = {}
    for dt in (bf, f32):
        cases[dt] = (_paged_case(gen, 4, Hq, Hkv, D, 128, RING_PPS,
                                 RING_LENGTHS, dt),
                     _paged_case(gen, 4, Hq, Hkv, D, 128, RING_PPS,
                                 RING_LENGTHS, dt, T=5))
        flat = tuple(tuple(a.to(dt) if a.is_floating_point() else a
                           for a in case) for case in (serve_case,
                                                       verify_case))
        for tag, (fd, fv) in {**feats, "flat alibi": (
                dict(alibi_slopes=slopes),) * 2}.items():
            dec, ver = flat if tag == "flat alibi" else cases[dt]
            checks.record("paged_attention", *_compare(
                "paged_attention", f"{tag} {dt}",
                pa.paged_attention(*dec, **fd),
                pa.paged_attention_ref(*dec, **fd)))
            checks.record("paged_prefill_attention", *_compare(
                "paged_prefill", f"{tag} T5 {dt}",
                pa.paged_prefill_attention(*ver, **fv),
                pa.paged_prefill_ref(*ver, **fv)))
            for tier, (qdt, q_int8, pv_int8, ppb) in RING_QUANT_TIERS.items():
                if dt == f32 and tier == "int8 q_int8":
                    continue
                kw = dict(pages_per_block=1 if ppb == 1 else dec[4].shape[1],
                          q_int8=q_int8, pv_int8=pv_int8)
                tol = QUANT_PV_F32_TOL if dt == f32 and pv_int8 else None
                for fn, ref, base, feat in (
                        (pa.paged_attention_quantized,
                         pa.paged_attention_quantized_ref, dec, fd),
                        (pa.paged_prefill_attention_quantized,
                         pa.paged_prefill_quantized_ref, ver, fv)):
                    kq, ks = pa.quantize_pages(base[1].float(), qdt)
                    vq, vs = pa.quantize_pages(base[2].float(), qdt)
                    a = (base[0], kq, ks, vq, vs, base[3], base[4])
                    label = _QUANT_LABEL[fn is pa.paged_attention_quantized]
                    out = fn(*a, **kw, **feat)
                    checks.record(fn.__name__, *_compare(
                        label, f"{tier} {tag} {dt}", out,
                        ref(*a, **kw, **feat), tol=tol))
                    checks.record(fn.__name__, *_same_bits(
                        label, f"{tier} {tag} {dt}", out,
                        fn(*a, **kw, **feat)))
    dec, ver = cases[bf]
    for label, name, fn, ref, args, feat in (
            ("#23 ring", "paged_attention", pa.paged_attention,
             pa.paged_attention_ref, dec, ring[1]),
            ("#24 ring verify", "paged_prefill_attention",
             pa.paged_prefill_attention, pa.paged_prefill_ref, ver, ring[5])):
        timed[label] = _timed_entry(
            name, list(args[0].shape), partial(fn, *args, **feat),
            partial(ref, *args, **feat), _paged_library(*args, **feat),
            *_paged_work(*args, **feat), bf)
    for label, fn, ref, base, T in (
            ("#23 quantized ring int8", pa.paged_attention_quantized,
             pa.paged_attention_quantized_ref, dec, 1),
            ("#24 quantized ring int8 verify",
             pa.paged_prefill_attention_quantized,
             pa.paged_prefill_quantized_ref, ver, 5)):
        kq, ks = pa.quantize_pages(base[1].float(), "int8")
        vq, vs = pa.quantize_pages(base[2].float(), "int8")
        a = (base[0], kq, ks, vq, vs, base[3], base[4])
        kw = dict(pages_per_block=RING_PPS, q_int8=True, pv_int8=False)
        timed[label] = _timed_entry(
            fn.__name__, list(a[0].shape), partial(fn, *a, **kw, **ring[T]),
            partial(ref, *a, **kw, **ring[T]), _quant_library(a, **ring[T]),
            *_quant_work(a, kw, **ring[T]), bf)
    for label, args, feat in (("#23", dec, ring[1]), ("#24", ver, ring[5])):
        lib = _paged_library(*args, **feat)().reshape(args[0].shape)
        ref = (pa.paged_attention_ref if args[0].dim() == 3
               else pa.paged_prefill_ref)(*args, **feat)
        print(f"[library] SDPA with the ring mask for {label}: max_abs "
              f"{(lib.float() - ref.float()).abs().max().item():.3e} against "
              f"the plain version")


def _w8a16_shapes(cfg):
    """The 7bish projections (K, N) by weight, one of each shape."""
    d, Dh = cfg.d_model, cfg.head_dim
    return {"head": (d, cfg.vocab), "w1": (d, cfg.d_ff), "w2": (cfg.d_ff, d),
            "wq/wo": (d, cfg.n_heads * Dh), "wk/wv": (d, cfg.n_kv_heads * Dh)}


def _w8a16_work(M, K, N, dt):
    """(flops, bytes) of one w8a16 product: 2 M N K operations at x's
    type's rate; the int8 weights, the f32 scales, x and y once."""
    es = torch.empty(0, dtype=dt).element_size()
    return 2 * M * N * K, K * N + 4 * N + es * M * K + es * M * N


def _w8a16_kernels(checks, timed, gen, cfg):
    """#25 against matmul_w8a16_ref at the 7bish weight shapes: M = 4
    (decode), 20 (a gamma = 4 verification of 4 slots) and 128 (a
    bucket-128 prefill), and forced at M = 256 and 2048, in bf16 and f32;
    in bf16 also M = 1, 8, 9, 16, 33 and 64 (the bf16 kernel's token-tile
    instances and their edges); a K tail (K = 200) and an N that is no
    tile multiple (1000). Each call twice: the split-K sum must repeat bit
    for bit. Times M = 4 on every shape, 1, 8, 20, 64 and 128 on w1, 20 on
    the head, and the forced kernel at 256 and 2048 on w1 beside the
    dispatch path (JAX's dequant-then-dot at M > 128); library:
    torch.matmul over pre-dequantized bf16 weights (the bf16 tier's
    GEMM)."""
    from functools import partial

    from tpukern_torch.harness import run_benchmark
    from tpukern_torch.ops import matmul_w8a16 as w8

    bf, f32 = torch.bfloat16, torch.float32
    shapes = {**_w8a16_shapes(cfg), "K tail": (200, 2048),
              "N 1000": (cfg.d_model, 1000)}
    weights = {name: w8.quantize_weights(0.02 * _randn(gen, K, N, dtype=f32))
               for name, (K, N) in shapes.items()}

    def check(tag, x, q, s, force=False):
        out = w8.matmul_w8a16(x, q, s, force_kernel=force)
        again = w8.matmul_w8a16(x, q, s, force_kernel=force)
        ok, err = _compare("matmul_w8a16", tag, out,
                           w8.matmul_w8a16_ref(x, q, s))
        if not torch.equal(out, again):
            print(f"[check] matmul_w8a16     {tag}: a second call differs "
                  f"MISS")
            ok = False
        checks.record("matmul_w8a16", ok, err)

    for name, (q, s) in weights.items():
        K, N = q.shape
        for M in (4, 20, 128) if name not in ("K tail", "N 1000") else (4, 20):
            for dt in (bf, f32):
                check(f"{name} {M}x{K}x{N} {dt}", _randn(gen, M, K, dtype=dt),
                      q, s)
        for M in (1, 8, 9, 16, 33, 64):
            check(f"{name} {M}x{K}x{N} {bf}", _randn(gen, M, K, dtype=bf),
                  q, s)
    for name in ("wq/wo", "w1"):
        q, s = weights[name]
        for M in (256, 2048):
            for dt in (bf, f32):
                check(f"{name} {M}x{q.shape[0]}x{q.shape[1]} {dt} forced",
                      _randn(gen, M, q.shape[0], dtype=dt), q, s, force=True)

    def entry(name, M, force=False):
        q, s = weights[name]
        K, N = q.shape
        x = _randn(gen, M, K, dtype=bf)
        wd = (q.float() * s).to(bf)  # the bf16 tier's weights
        timed[f"matmul_w8a16 {name} M{M}"] = _timed_entry(
            "matmul_w8a16", [M, K, N],
            partial(w8.matmul_w8a16, x, q, s, force_kernel=force),
            partial(w8.matmul_w8a16_ref, x, q, s),
            partial(torch.matmul, x, wd), *_w8a16_work(M, K, N, bf), bf)
        return x, q, s

    for name in ("head", "w1", "w2", "wq/wo", "wk/wv"):
        entry(name, 4)
    for M in (1, 8, 20, 64, 128):
        entry("w1", M)
    entry("head", 20)
    for M in (256, 2048):
        x, q, s = entry("w1", M, force=True)
        path = partial(w8._dequant_matmul, x, q, s, bf)
        dev = _device_ms(path)
        print(f"[time] matmul_w8a16 dispatch path (dequant in bf16, then "
              f"torch.matmul) w1 M{M}: {run_benchmark(path):.4f} ms "
              f"events, {'not measured' if dev is None else f'{dev:.4f}'} ms "
              f"device")


# the sampling kernels' shapes: the 7bish serving batch and vocabulary,
# and Llama-3's vocabulary
SAMPLE_VOCABS = (32768, 128256)
SAMPLE_T = 0.8  # the temperature of the sampled checks and runs


def _index_check(case, out, ref, score, near=None):
    """#26's indices `out` against its twin's `ref`: equal, or (with the
    bool rows `near`) different only in those rows. The error is the
    largest gap between the twin's scores at the two indices. Prints one
    line; returns (ok, error)."""
    same = out == ref
    err = (score.gather(1, out.long()[:, None])
           - score.gather(1, ref.long()[:, None])).abs().max().item()
    ok = bool(same.all() if near is None else (same | near).all())
    extra = "" if near is None else f", {int(near.sum())} near-tie rows"
    print(f"[check] sample           {case:44s} {int((~same).sum())} of "
          f"{out.numel()} indices differ{extra}; score gap {err:.3e} "
          f"{'ok' if ok else 'MISS'}")
    return ok, err


def _kept_sets(x, a, b, T):
    """Top-p rule: per row the kept sets (x >= threshold) of thresholds a
    and b differ by at most one token, of softmax(x / T) mass < 1e-4.
    Returns (ok, tokens that differ, their largest mass)."""
    probs = torch.softmax(x.double() / T, -1)
    differ = (x >= a[:, None]) ^ (x >= b[:, None])
    n = differ.sum(-1)
    mass = (probs * differ).sum(-1)
    return (bool((n <= 1).all() and (mass < 1e-4).all()), int(n.sum()),
            mass.max().item())


def _sampling_kernels(checks, timed, gen):
    """#26 (`sample`) and #27 (`sample_threshold`) against their plain
    twins at (4, V) f32 logits of scale 3, V in SAMPLE_VOCABS. #26:
    greedy, and input noise under top-k 50 thresholds, indices equal; its
    in-kernel Philox noise against the twin, which computes the same
    bits: equal except where the two best perturbed scores lie within
    1e-5; the same seed repeats; every draw inside the top-50 set over 8
    seeds; 8192 draws of one 16-wide row within 3 sigma of softmax(x/T).
    #27: count mode bit-equal (k 1, 50, 1000); mass mode (p 0.5, 0.9,
    0.99 at T 1 and 0.8) within one boundary token of mass < 1e-4. Times
    at both vocabularies; the library call of #26 is torch.argmax (greedy
    mode) and of #27's count mode torch.topk; mass mode has none (sort,
    softmax and cumsum are three calls)."""
    from functools import partial

    from tpukern_torch.ops import sampling as sp

    f32 = torch.float32
    for V in SAMPLE_VOCABS:
        x = 3 * _randn(gen, 4, V, dtype=f32)
        tag = f"(4, {V}) f32"
        ref = sp._stream_sample_ref(x, 0, inv_temp=1.0, gumbel=False)
        checks.record("sample", *_index_check(f"greedy {tag}",
                                              sp.greedy_sample(x), ref, x))
        thr = sp._bisect_threshold_ref(x, mode="count", kk=50)
        live = x >= thr[:, None]
        noise = -torch.log(-torch.log(torch.rand(
            x.shape, generator=gen, device="cuda")))
        kw = dict(inv_temp=1 / SAMPLE_T, gumbel=True, thresholds=thr)
        score = torch.where(live, x * (1 / SAMPLE_T) + noise, sp.NEG_BIG)
        checks.record("sample", *_index_check(
            f"input noise, top-k 50 {tag}",
            sp._stream_sample(x, 0, noise=noise, **kw),
            sp._stream_sample_ref(x, 0, noise=noise, **kw), score))
        out = sp._stream_sample(x, 1234, **kw)
        score = torch.where(live, x * (1 / SAMPLE_T)
                            + sp._gumbel(1234, *x.shape, "cuda"), sp.NEG_BIG)
        top2 = torch.topk(score, 2, dim=-1).values
        checks.record("sample", *_index_check(
            f"Philox, top-k 50 {tag}", out,
            sp._stream_sample_ref(x, 1234, **kw), score,
            near=top2[:, 0] - top2[:, 1] < 1e-5))
        again = bool((sp._stream_sample(x, 1234, **kw) == out).all())
        topk = torch.topk(x, 50, dim=-1).indices
        inside = all(bool((topk == sp.sample(x, seed, SAMPLE_T, top_k=50)
                           [:, None]).any(-1).all()) for seed in range(8))
        print(f"[check] sample           {'Philox ' + tag:44s} same seed "
              f"same draw {again}; 8 seeds inside the top-50 set {inside} "
              f"{'ok' if again and inside else 'MISS'}")
        checks.record("sample", again and inside, 0.0)
        for k in (1, 50, 1000):
            out = sp.topk_threshold(x, k)
            err = (out - sp._bisect_threshold_ref(x, mode="count", kk=k)
                   ).abs().max().item()
            ok = err == 0 and bool((out == torch.topk(x, k).values[:, -1])
                                   .all())
            print(f"[check] sample_threshold {f'count k={k} ' + tag:44s} "
                  f"max_abs {err:.3e} (bit-equal) {'ok' if ok else 'MISS'}")
            checks.record("sample_threshold", ok, err)
        for p in (0.5, 0.9, 0.99):
            for T in (1.0, SAMPLE_T):
                out = sp.topp_threshold(x, p, T)
                ref = sp._bisect_threshold_ref(x, mode="mass", pp=p,
                                               inv_temp=1 / T)
                ok, n, mass = _kept_sets(x, out, ref, T)
                ok &= bool((out == sp.topp_threshold(x, p, T)).all()
                           and (x == out[:, None]).any(-1).all())
                err = (out - ref).abs().max().item()
                print(f"[check] sample_threshold "
                      f"{f'mass p={p} T={T} ' + tag:44s} max_abs {err:.3e}; "
                      f"{n} kept tokens differ, mass <= {mass:.3e}; repeats, "
                      f"data values {'ok' if ok else 'MISS'}")
                checks.record("sample_threshold", ok, err)
        # one bf16 greedy case: the kernel reads bf16 logits
        xb = x.to(torch.bfloat16)
        checks.record("sample", *_index_check(
            f"greedy (4, {V}) bf16", sp.greedy_sample(xb),
            sp._stream_sample_ref(xb, 0, inv_temp=1.0, gumbel=False),
            xb.float()))

        # times: each mode beside its twin, its library call and its bound
        # (bytes: the logits and thresholds read once, the (4,) output
        # written once; operations: float ops a column, a log counted as
        # one, the Philox integer work uncounted: the peaks table has no
        # integer rate)
        io = _nbytes(x) + 16
        timed[f"sample greedy V{V}"] = _timed_entry(
            "sample", [4, V], partial(sp.greedy_sample, x),
            partial(sp._stream_sample_ref, x, 0, inv_temp=1.0, gumbel=False),
            partial(torch.argmax, x, -1), x.numel(), io, f32)
        timed[f"sample Philox top-k V{V}"] = _timed_entry(
            "sample", [4, V], partial(sp._stream_sample, x, 7, **kw),
            partial(sp._stream_sample_ref, x, 7, **kw), None,
            8 * x.numel(), io + 16, f32)
        timed[f"sample_threshold count V{V}"] = _timed_entry(
            "sample_threshold", [4, V], partial(sp.topk_threshold, x, 50),
            partial(sp._bisect_threshold_ref, x, mode="count", kk=50),
            partial(torch.topk, x, 50), 0, io, f32)
        timed[f"sample_threshold mass V{V}"] = _timed_entry(
            "sample_threshold", [4, V],
            partial(sp.topp_threshold, x, 0.9, SAMPLE_T),
            partial(sp._bisect_threshold_ref, x, mode="mass", pp=0.9,
                    inv_temp=1 / SAMPLE_T), None, 3 * x.numel(), io, f32)

    # frequencies of the in-kernel noise: 8192 draws of one 16-wide row
    V, N = 16, 8192
    base = 1.5 * _randn(gen, 1, V, dtype=f32)
    got = sp.sample(base.expand(N, V).contiguous(), 7, SAMPLE_T)
    freq = torch.bincount(got.long(), minlength=V).double() / N
    probs = torch.softmax(base[0].double() / SAMPLE_T, -1)
    dev = (freq - probs).abs() / (3 * torch.sqrt(probs * (1 - probs) / N)
                                  + 2e-3)
    ok = bool((dev < 1).all())
    print(f"[check] sample           {f'Philox frequencies ({N}, {V})':44s} "
          f"largest |freq - p| {dev.max().item():.3f} of its 3-sigma band "
          f"{'ok' if ok else 'MISS'}")
    checks.record("sample", ok, 0.0)


def _paged_case(gen, B, hq, hkv, dd, page, pps, lengths, dt, T=None):
    """q (B, hq, dd), or (B, hq, T, dd) with T, pools of B * pps pages
    behind a shuffled table, and the lengths, on the card."""
    P = B * pps
    perm = torch.randperm(P, generator=gen, device="cuda")
    table = perm.reshape(B, pps).to(torch.int32)
    kp = _randn(gen, hkv, P, page, dd, dtype=dt)
    vp = _randn(gen, hkv, P, page, dd, dtype=dt)
    qq = _randn(gen, B, hq, *(() if T is None else (T,)), dd, dtype=dt)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return qq, kp, vp, lens, table


def _visible(lengths, T, S, window=None, sinks=None, ring=False):
    """Bool (B, T, S): whether token t of sequence b sees slot j of its
    S-slot pool: flat, positions [0, lengths[b] - T + t]; on a ring, the
    position the slot holds; with a window, only the band and the sinks
    (paged_attention._visible, the plain versions' mask)."""
    from tpukern_torch.ops.paged_attention import _visible

    return _visible(lengths, T, S, window, sinks, ring, lengths.device)[0]


def _paged_work(q, k_pages, v_pages, lengths, page_table, **feat):
    """(flops, bytes) of paged attention on these inputs: 4 D flops per
    visible (query head, position) pair; q, o, the K and V rows of the
    positions some token sees, the lengths and the table, each once."""
    T = 1 if q.dim() == 3 else q.shape[2]
    Hkv, _, page, D = k_pages.shape
    S = page_table.shape[1] * page
    keep = _visible(lengths, T, S, **feat)
    pairs = int(keep.sum())
    live = int(keep.any(dim=1).sum())
    return (4 * D * q.shape[1] * pairs,
            2 * _nbytes(q) + 2 * live * Hkv * D * k_pages.element_size()
            + _nbytes(lengths, page_table))


def _paged_library(q, k_pages, v_pages, lengths, page_table, **feat):
    """The library yardstick of #23 and #24 (no PyTorch call reads a page
    table): F.scaled_dot_product_attention(enable_gqa=True) on a
    contiguous copy of each sequence's K/V with the boolean mask of the
    visible slots (feat: window, sinks, ring; in slot order, which
    attention does not see). The gather and the mask are made here,
    outside the timed call, which this returns; decode q (B, Hq, D) goes
    in as T = 1."""
    from functools import partial

    q4 = q[:, :, None] if q.dim() == 3 else q
    B, _, T, D = q4.shape
    Hkv, _, page, _ = k_pages.shape
    S = page_table.shape[1] * page
    table = page_table.long()
    k, v = (p[:, table].permute(1, 0, 2, 3, 4).reshape(B, Hkv, S, D)
            .contiguous() for p in (k_pages, v_pages))
    mask = _visible(lengths, T, S, **feat)[:, None]
    return partial(F.scaled_dot_product_attention, q4, k, v, attn_mask=mask,
                   enable_gqa=True)


def phase_train_kernels(cfg, B, S):
    """The training slice's kernels against their plain versions (odd
    shapes and the training shapes); times at the 7bish training shapes.
    Returns {kernel: dict(max_abs_err, ms, plain_ms, ...)} and all-ok."""
    from functools import partial

    from tpukern_torch.harness import ops_bench
    from tpukern_torch.ops import (attention, attention_bwd, matmul, rmsnorm,
                                   rope, split_tf32)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    bf, f32 = torch.bfloat16, torch.float32
    d, D, ff = cfg.d_model, cfg.head_dim, cfg.d_ff
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    checks, timed = _Checks(), {}

    # matmul: NN and TN, f32 and bf16, the three epilogues, odd M, N, K
    # and the (B*S, d) x (d, d_ff) projection; A scaled by 1/sqrt(K) so
    # every output is of unit scale
    modes = dict(out=dict(), accio=dict(acc_in_out=True),
                 dual=dict(acc_in_out=True, out_dtype=bf))
    paths = matmul.matmul.path_launches
    paths.update(dict.fromkeys(paths, 0))
    met = dict.fromkeys(paths, 0)  # the mirror's count of the calls below
    for (M, N, K), dt in (((333, 517, 1000), f32), ((333, 517, 1000), bf),
                          ((B * S, ff, d), f32), ((B * S, ff, d), bf)):
        a = _randn(gen, M, K, dtype=f32).div(K ** 0.5).to(dt)
        for trans_b in (False, True):
            b = _randn(gen, *((N, K) if trans_b else (K, N)), dtype=dt)
            ref = matmul.matmul_ref(a, b, trans_b=trans_b)
            for mode, kw in modes.items():
                out = matmul.matmul(a, b, trans_b=trans_b, **kw)
                if dt == bf:
                    met[matmul.load_path(matmul.tma_operands(a, b))] += 1
                checks.record("matmul", *_compare(
                    "matmul", f"({M},{K})x({K},{N}) {'TN' if trans_b else 'NN'}"
                    f" {dt} {mode}->{out.dtype}", out, ref.to(out.dtype)))
    print(f"[train kernels] matmul's bf16 launches by load path: {paths} "
          f"(the rule's: {met})")
    require(dict(paths) == met and all(paths[p] > 0 for p in met if met[p]),
            f"[train kernels] matmul's load paths {paths}, wanted {met}")
    checks.results["matmul"]["path_launches"] = dict(paths)
    _split_tf32_checks(checks, timed, gen, d, ff)
    # the odd shape splits K 4 ways, 128 x 128 x 8192 32 ways (one tile)
    _matmul_gate(checks, gen, [(333, 517, 1000), (128, 128, 8192),
                               (B * S, ff, d), (4096, 4096, 4096)])
    # the library call is cuBLAS in the input dtype (bf16 cuBLAS writes
    # bf16, the kernel the f32 accumulator, as matmul_t asks); the plain
    # version is cuBLAS in f32
    def cublas(a, b, trans_b):
        return torch.matmul(a, b.T if trans_b else b)

    for dt, tag, (M, K, N) in ((f32, "f32", (d, d, ff)), (bf, "bf16", (d, d, ff)),
                               (f32, "f32", (4096, 4096, 4096))):
        a = _randn(gen, M, K, dtype=dt)
        for trans_b in (False, True):
            b = _randn(gen, *((N, K) if trans_b else (K, N)), dtype=dt)
            flops = 2 * M * K * N
            big = "" if N == ff else f" {M}x{N}x{K}"
            timed[f"matmul {tag} {'TN' if trans_b else 'NN'}{big}"] = (
                _timed_entry(
                    "matmul", [M, K, N],
                    partial(matmul.matmul, a, b, trans_b=trans_b,
                            acc_in_out=True),
                    partial(matmul.matmul_ref, a, b, trans_b=trans_b),
                    partial(cublas, a, b, trans_b),
                    {ops_bench.SPLIT_TF32: flops} if dt == f32 else flops,
                    _nbytes(a, b) + 4 * M * N, dt,
                    fma=flops if dt == f32 else None))

    # rope_batched: q rows of the training batch, sign +-1, f32 and bf16
    R = B * Hq * S
    for dt in (f32, bf):
        x = _randn(gen, R, D, dtype=dt)
        for sign in (1.0, -1.0):
            checks.record("rope_batched", *_compare(
                "rope_batched", f"({R}, {D}) S{S} {dt} sign {sign:+g}",
                rope.rope_batched(x, S, sign),
                rope.rope_batched_ref(x, S, sign)))
    x = _randn(gen, R, D, dtype=f32)
    timed["rope_batched"] = _timed_entry(
        "rope_batched", [R, D], partial(rope.rope_batched, x, S),
        partial(rope.rope_batched_ref, x, S), None, 3 * x.numel(),
        _nbytes(x, x), f32)

    # rms_norm at the training shape: f32 (B*S, d), non-unit gain
    x = _randn(gen, B * S, d, dtype=f32)
    g = 1 + 0.1 * _randn(gen, d, dtype=f32)
    checks.record("rms_norm", *_compare(
        "rms_norm", f"({B * S}, {d}) {f32}", rmsnorm.rms_norm(x, g),
        rmsnorm.rms_norm_ref(x, g)))

    # flash_attention o and lse (return_stats) at the training shape, GQA
    # 2; the f32 tier (split-TF32) twice, bit-equal
    for dt in (f32, bf):
        q = _randn(gen, B, Hq, S, D, dtype=dt)
        k, v = (_randn(gen, B, Hkv, S, D, dtype=dt) for _ in range(2))
        outs = attention.flash_attention(q, k, v, causal=True,
                                         return_stats=True)
        refs = attention.attention_ref(q, k, v, causal=True,
                                       return_stats=True)
        case = f"B{B} H{Hq}/{Hkv} S{S} D{D} {dt}"
        for what, out, ref in zip(("o", "lse"), outs, refs):
            checks.record("flash_attention", *_compare(
                "flash_attention", f"{what} {case}", out, ref))
        if dt == f32:
            again = attention.flash_attention(q, k, v, causal=True,
                                              return_stats=True)
            checks.record("flash_attention_train_f32", *_same_bits(
                "flash_attention", case, torch.cat([outs[0].flatten(),
                                                    outs[1].flatten()]),
                torch.cat([again[0].flatten(), again[1].flatten()])))
            del again
    # the f32 tier as the training step calls it, beside SDPA's forward in
    # f32 (GQA, causal): 4 D flops a visible pair as split-TF32 products
    pairs = B * Hq * S * (S + 1) // 2
    q = _randn(gen, B, Hq, S, D, dtype=f32)
    k, v = (_randn(gen, B, Hkv, S, D, dtype=f32) for _ in range(2))
    o, lse = attention.flash_attention(q, k, v, causal=True,
                                       return_stats=True)
    timed["flash_attention f32 train"] = _timed_entry(
        "flash_attention_train_f32", [B, Hq, Hkv, S, D],
        partial(attention.flash_attention, q, k, v, causal=True,
                return_stats=True),
        partial(attention.attention_ref, q, k, v, causal=True,
                return_stats=True),
        partial(F.scaled_dot_product_attention, q, k, v, is_causal=True,
                enable_gqa=True),
        {ops_bench.SPLIT_TF32: 4 * D * pairs}, _nbytes(q, k, v, o, lse),
        f32, fma=4 * D * pairs)

    # flash_attention_bwd: dq/dk/dv, f32 (the split-TF32 kernel) and bf16
    # (the bf16 wgmma kernel, held to its plain order of work, which
    # rounds P and dS to bf16 as the kernel does), causal and not, D 32,
    # 64 and 128, tail lengths, GQA groups 1, 2 and 4 (Hq/Hkv); the
    # training shape first; dk and dv (no atomics) twice, bit-equal
    for Bb, H, Hk, Sb, dd, dt, causal in (
            (B, Hq, Hkv, S, D, f32, True), (B, Hq, Hkv, S, D, bf, True),
            (1, 4, 2, 300, 128, bf, True), (1, 4, 2, 77, 64, bf, False),
            (1, 4, 4, 300, 64, bf, True), (1, 4, 1, 130, 32, bf, True),
            (1, 4, 4, 300, 128, f32, False), (2, 2, 2, 77, 64, f32, True),
            (1, 4, 4, 200, 128, bf, False), (1, 2, 2, 130, 64, f32, False),
            (1, 8, 2, 300, 128, f32, True), (1, 4, 2, 200, 32, f32, False),
            (1, 8, 2, 200, 32, bf, False), (2, 8, 2, 77, 64, bf, True)):
        q, do = (_randn(gen, Bb, H, Sb, dd, dtype=dt) for _ in range(2))
        k, v = (_randn(gen, Bb, Hk, Sb, dd, dtype=dt) for _ in range(2))
        o, lse = attention.attention_ref(q, k, v, causal=causal,
                                         return_stats=True)
        outs = attention_bwd.flash_attention_bwd(q, k, v, o, lse, do,
                                                 causal=causal)
        name, plain = (
            ("flash_attention_bwd", attention_bwd.flash_attention_bwd_ref)
            if dt == f32 else ("flash_attention_bwd_bf16",
                               attention_bwd.flash_attention_bwd_bf16_ref))
        refs = plain(q, k, v, o, lse, do, causal=causal)
        case = f"B{Bb} H{H}/{Hk} S{Sb} D{dd} {dt} causal={causal}"
        for grad, out, ref in zip(("dq", "dk", "dv"), outs, refs):
            checks.record(name, *_compare(name, f"{grad} {case}", out, ref))
        again = attention_bwd.flash_attention_bwd(q, k, v, o, lse, do,
                                                  causal=causal)
        checks.record(name, *_same_bits(
            name, f"dk, dv {case}",
            torch.cat([outs[1].flatten(), outs[2].flatten()]),
            torch.cat([again[1].flatten(), again[2].flatten()])))
        del q, k, v, do, o, lse, outs, refs, again
    # the training step's call: GQA 16/8 inside the kernel, beside
    # autograd's backward of SDPA (enable_gqa) on the same q, k, v; the
    # bf16 tier at the same shape beside SDPA's bf16 backward
    for dt in (f32, bf):
        q, do = (_randn(gen, B, Hq, S, D, dtype=dt) for _ in range(2))
        k, v = (_randn(gen, B, Hkv, S, D, dtype=dt) for _ in range(2))
        o, lse = attention.flash_attention(q, k, v, causal=True,
                                           return_stats=True)
        args = (q, k, v, o, lse, do)
        ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                            enable_gqa=True)
        flops = 10 * D * pairs
        timed[f"flash_attention_bwd {'f32' if dt == f32 else 'bf16'}"] = (
            _timed_entry(
                "flash_attention_bwd" if dt == f32
                else "flash_attention_bwd_bf16", [B, Hq, Hkv, S, D],
                partial(attention_bwd.flash_attention_bwd, *args,
                        causal=True),
                partial(attention_bwd.flash_attention_bwd_ref if dt == f32
                        else attention_bwd.flash_attention_bwd_bf16_ref,
                        *args, causal=True),
                partial(torch.autograd.grad, ol, (ql, kl, vl), do,
                        retain_graph=True),
                {ops_bench.SPLIT_TF32: flops} if dt == f32 else flops,
                _nbytes(*args, q, k, v), dt,
                fma=flops if dt == f32 else None))
    _attention_gate(checks, gen, ((B, Hq, Hkv, S, D, True),
                                  (1, 4, 2, 300, 128, True),
                                  (1, 4, 2, 77, 64, False)))

    _ce_kernels(checks, timed, gen, cfg, B * S)
    _featured_kernels(checks, timed, gen, cfg, B, S)
    _time_kernels(timed, checks.results)
    return checks.results, checks.ok


def _split_tf32_checks(checks, timed, gen, d, ff):
    """The split-TF32 operand pass bit for bit against split_planes_ref,
    as it is and transposed, at an odd shape with st.SPECIALS in it and
    the NN B of the training GEMM (d, ff); timed there, transposed (as
    matmul splits an NN B). A strided source (W's vocab chunk) is the f32
    CE backward's, checked in _ce_kernels."""
    from functools import partial

    from tpukern_torch.ops import split_tf32 as st

    odd = _randn(gen, 301, 517, dtype=torch.float32) * 3
    bits = torch.tensor(st.SPECIALS, dtype=torch.int64).to(torch.int32)
    odd.view(-1)[:len(bits)] = bits.view(torch.float32).cuda()
    b = _randn(gen, d, ff, dtype=torch.float32)
    for case, x in (("301x517 with specials", odd), (f"{d}x{ff}", b)):
        for transpose in (False, True):
            out = st.split_tf32(x, transpose=transpose)
            ref = st.split_planes_ref(x.contiguous(), transpose)
            ok = out.shape == ref.shape and torch.equal(
                out.view(torch.int32), ref.view(torch.int32))
            print(f"[check] split_tf32       {case:28s} "
                  f"{'transposed' if transpose else 'as it is':10s} "
                  f"{'bit-equal' if ok else 'MISS'}")
            checks.record("split_tf32", ok, 0.0)
    timed["split_tf32"] = _timed_entry(
        "split_tf32", [d, ff], partial(st.split_tf32, b, transpose=True),
        partial(st.split_planes_ref, b, True), None, 0,
        _nbytes(b) * 3, torch.float32)


def _gate(name, case, err, ref_err, ref="cuBLAS f32"):
    """(ok, err): the split-TF32 kernel's error against f64 at most
    split_tf32.SPLIT_GATE times that of `ref` (cuBLAS f32, or the plain
    version on it) on the same inputs."""
    from tpukern_torch.ops.split_tf32 import SPLIT_GATE

    ok = err <= SPLIT_GATE * ref_err
    print(f"[gate] {name:16s} {case:44s} kernel {err:.3e} {ref} "
          f"{ref_err:.3e} vs f64: x{err / max(ref_err, 1e-300):.3f} "
          f"(<= {SPLIT_GATE:g}) {'ok' if ok else 'MISS'}")
    return ok


# the f32 attention tiers' gate: the 7bish training heads and two tails
# (B, Hq, Hkv, S, D, causal), from tpukern_torch/harness/fa_train_times.py
def _attention_gate(checks, gen, shapes):
    """The accuracy gate of the f32 flash attention (#6's forward, #8's
    fused backward, split-TF32 products): at each shape the largest error
    of o and lse (the forward, as the training step calls it) and of dq,
    dk and dv (the backward, GQA inside) against an f64 evaluation of the
    same inputs, at most SPLIT_GATE times the plain version's in f32
    (attention_ref and flash_attention_bwd_ref on cuBLAS, TF32 off); and
    the bf16 #8's dq, dk and dv on bf16 inputs, at most SPLIT_GATE times
    its plain order of work's (flash_attention_bwd_bf16_ref, P and dS
    rounded to bf16 alike) against f64."""
    from tpukern_torch.harness import fa_train_times

    require(not torch.backends.cuda.matmul.allow_tf32,
            "the gate needs cuBLAS f32 with TF32 off")
    for shape in shapes:
        rows = [(out, err, ref_err, "plain f32") for out, err, ref_err in
                fa_train_times.gate_rows(gen, shape)]
        rows += [(out, err, ref_err, "plain bf16") for out, err, ref_err in
                 fa_train_times.gate_rows_bf16(gen, shape)]
        for out, err, ref_err, ref in rows:
            name = ("flash_attention_train_f32" if out in ("o", "lse")
                    else "flash_attention_bwd" if ref == "plain f32"
                    else "flash_attention_bwd_bf16")
            case = f"{out} B{shape[0]} H{shape[1]}/{shape[2]} S{shape[3]} " \
                   f"D{shape[4]} causal={shape[5]}"
            checks.record(name, _gate(name, case, err, ref_err, ref=ref),
                          0.0)
            gate = checks.results[name].setdefault("f64_gate", {})
            gate[case] = dict(kernel=err, plain=ref_err)
        torch.cuda.empty_cache()


def _matmul_gate(checks, gen, shapes):
    """The accuracy gate of #2's f32 tier, NN and TN: at each (M, N, K),
    the largest error of the kernel (acc_in_out, as matmul_t calls it)
    and of cuBLAS f32 (TF32 off) against the f64 product of the same
    inputs (A scaled by 1/sqrt(K), every output of unit size); a second
    call gives the same bits (the splits of K meet in a fixed order)."""
    from tpukern_torch.ops import matmul

    require(not torch.backends.cuda.matmul.allow_tf32,
            "the gate needs cuBLAS f32 with TF32 off")
    gate = checks.results.setdefault("matmul", dict(max_abs_err=0.0))
    gate = gate.setdefault("f64_gate", {})
    for M, N, K in shapes:
        a = _randn(gen, M, K, dtype=torch.float32) / K ** 0.5
        for trans_b in (False, True):
            b = _randn(gen, *((N, K) if trans_b else (K, N)),
                       dtype=torch.float32)
            bt = b.T if trans_b else b
            exact = torch.matmul(a.double(), bt.double())
            out = matmul.matmul(a, b, trans_b=trans_b, acc_in_out=True)
            err = (out.double() - exact).abs().max().item()
            ref = (torch.matmul(a, bt).double() - exact).abs().max().item()
            case = f"({M},{K})x({K},{N}) {'TN' if trans_b else 'NN'} f32"
            checks.record("matmul", _gate("matmul", case, err, ref), 0.0)
            checks.record("matmul", *_same_bits(
                "matmul", case, out,
                matmul.matmul(a, b, trans_b=trans_b, acc_in_out=True)))
            gate[case] = dict(kernel=err, cublas=ref)
            del b, bt, exact, out


# the featured training configuration: a sliding window of half the
# context and a logit softcap (Gemma-2's attention softcap)
WINDOW, SOFTCAP = 512, 50.0


def _featured_kernels(checks, timed, gen, cfg, B, S):
    """The featured forward (#6 with window, sinks, softcap, segments) and
    the two-kernel backward (#9 flash_attention_dq, #10
    flash_attention_dkv) against their plain versions: each feature set
    at small odd shapes (S off the tiles) in f32 and bf16, the backward on
    K and V at 2 KV heads (GQA inside the kernels) and repeated to the 4
    query heads (group 1), fused=False with no feature, and the slice
    shape with window and softcap on its KV heads. Each backward call
    twice, bit-equal (one owner an output, no atomics), and the f32 tier
    (split-TF32 products) held to the accuracy gate: dq's, dk's and dv's
    largest error against an f64 evaluation of the same function on the
    same lse and di (fa_train_times.featured_f64) at most SPLIT_GATE times
    the plain version's in f32, at the D 128 odd shape for every feature
    set and at the slice shape with window + softcap and window only; at
    D 32 the ratio is printed ([gate-info]) and the TOLS check holds the
    kernels. There the plain version sums 32 terms over D and at most 37
    over the window, 1-4 ulps off f64, and three TF32 products with
    wgmma's rounding of its accumulator each k8 step come within 2x of
    that only on some draws (PERF.md §6). Times at the slice shape (B,
    Hq, S, D) with WINDOW and SOFTCAP, f32, K and V at the KV heads the
    step uses, where the library call is compiled flex_attention
    (fa_train_times.flex_band_attention) and its autograd backward (for
    #9 and #10 together), first checked against the plain versions; and
    at the window-only shape, where it is SDPA with a boolean band mask
    and its autograd backward."""
    from functools import partial

    from tpukern_torch.core.feature_sets import FEATURE_SETS, feature_kwargs
    from tpukern_torch.harness import ops_bench
    from tpukern_torch.harness.fa_train_times import (band_pairs,
                                                      featured_f64,
                                                      flex_band_attention)
    from tpukern_torch.ops import attention, attention_bwd

    bf, f32 = torch.bfloat16, torch.float32
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    fa, ref = attention.flash_attention, attention.attention_ref
    dq, dkv = attention_bwd.flash_attention_dq, attention_bwd.flash_attention_dkv
    dq_ref = attention_bwd.flash_attention_dq_ref
    dkv_ref = attention_bwd.flash_attention_dkv_ref
    names = ("flash_attention_dq",) + ("flash_attention_dkv",) * 2

    def bwd_checks(case, q, k, v, do, kw):
        o, lse = ref(q, k, v, causal=True, return_stats=True, **kw)
        di = (o.float() * do.float()).sum(-1)
        args = (q, k, v, do, lse, di)
        out = (dq(*args, causal=True, **kw), *dkv(*args, causal=True, **kw))
        again = (dq(*args, causal=True, **kw),
                 *dkv(*args, causal=True, **kw))
        refs = (dq_ref(*args, causal=True, **kw),
                *dkv_ref(*args, causal=True, **kw))
        exact = featured_f64(*args, **kw) if q.dtype == f32 else refs
        for name, grad, a, a2, b, e in zip(names, ("dq", "dk", "dv"), out,
                                           again, refs, exact):
            checks.record(name, *_compare(name, f"{grad} {case}", a, b))
            checks.record(name, *_same_bits(name, f"{grad} {case}", a, a2))
            if q.dtype == f32:
                err, ref_err = ((x.double() - e).abs().max().item()
                                for x in (a, b))
                if q.shape[-1] >= 64:
                    checks.record(name, _gate(name, f"{grad} {case}", err,
                                              ref_err, ref="plain f32"), 0.0)
                    gate = checks.results[name].setdefault("f64_gate", {})
                else:
                    print(f"[gate-info] {name:16s} {grad} {case:40s} kernel "
                          f"{err:.3e} plain f32 {ref_err:.3e} vs f64: "
                          f"x{err / max(ref_err, 1e-300):.3f}")
                    gate = checks.results[name].setdefault("f64_ratio_d32",
                                                           {})
                gate[f"{grad} {case}"] = dict(kernel=err, plain=ref_err)

    for (Bb, S_, dd), dt in (((2, 333, 128), f32), ((1, 200, 64), bf),
                             ((2, 333, 128), bf), ((1, 77, 32), f32)):
        q = _randn(gen, Bb, 4, S_, dd, dtype=dt)
        k, v = (_randn(gen, Bb, 2, S_, dd, dtype=dt) for _ in range(2))
        do = _randn(gen, Bb, 4, S_, dd, dtype=dt)
        k4, v4 = (t.repeat_interleave(2, dim=1) for t in (k, v))
        for name in FEATURE_SETS:
            kw, seen = feature_kwargs(name, Bb, S_, "cuda")
            case = f"{name} B{Bb} H4/2 S{S_} D{dd} {dt}"
            o, lse = fa(q, k, v, causal=True, return_stats=True, **kw)
            ro, rlse = ref(q, k, v, causal=True, return_stats=True, **kw)
            checks.record("flash_attention", *_compare(
                "flash_attention", f"o {case}", o, ro))
            checks.record("flash_attention", *_compare(
                "flash_attention", f"lse {case}", lse[..., seen],
                rlse[..., seen], dtype=f32))
            checks.record("flash_attention", bool(
                (o[..., ~seen, :] == 0).all()), 0.0)
            if "sinks" not in name:  # sinks are forward-only
                bwd_checks(case, q, k, v, do, kw)
                bwd_checks(f"{name} B{Bb} H4/4 S{S_} D{dd} {dt}", q, k4, v4,
                           do, kw)
                if "segments" in name:  # rows that see no key: zero dq
                    o, lse = ref(q, k, v, causal=True, return_stats=True,
                                 **kw)
                    di = (o.float() * do.float()).sum(-1)
                    g = dq(q, k, v, do, lse, di, causal=True, **kw)
                    checks.record("flash_attention_dq", bool(
                        (g[..., ~seen, :] == 0).all()), 0.0)
        bwd_checks(f"fused=False B{Bb} H4/2 S{S_} D{dd} {dt}", q, k, v, do,
                   {})
        bwd_checks(f"fused=False B{Bb} H4/4 S{S_} D{dd} {dt}", q, k4, v4, do,
                   {})

    # the slice shape: window and softcap, f32, as the training step runs
    # them (GQA 16/8 in the forward and in both backward kernels)
    feat = dict(window=WINDOW, softcap=SOFTCAP)
    q = _randn(gen, B, Hq, S, D, dtype=f32)
    k, v = (_randn(gen, B, Hkv, S, D, dtype=f32) for _ in range(2))
    do = _randn(gen, B, Hq, S, D, dtype=f32)
    case = f"window {WINDOW} softcap {SOFTCAP:g} B{B} H{Hq}/{Hkv} S{S} D{D}"
    for what, a, b in zip(("o", "lse"),
                          fa(q, k, v, causal=True, return_stats=True, **feat),
                          ref(q, k, v, causal=True, return_stats=True,
                              **feat)):
        checks.record("flash_attention", *_compare(
            "flash_attention", f"{what} {case}", a, b))
    bwd_checks(case, q, k, v, do, feat)
    bwd_checks(f"window {WINDOW} B{B} H{Hq}/{Hkv} S{S} D{D}", q, k, v, do,
               dict(window=WINDOW))
    torch.cuda.empty_cache()

    pairs = B * Hq * band_pairs(S, WINDOW)
    product = 2 * D * pairs  # flops of one D-deep product over the band
    band = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    band &= ~torch.ones(S, S, dtype=torch.bool, device="cuda").tril(
        -WINDOW)
    flex = flex_band_attention(WINDOW, SOFTCAP, S)
    for tag, kw in ((f"window {WINDOW} softcap {SOFTCAP:g}", feat),
                    (f"window-only {WINDOW}", dict(window=WINDOW))):
        o, lse = fa(q, k, v, causal=True, return_stats=True, **kw)
        di = (o * do).sum(-1)
        args = (q, k, v, do, lse, di)
        # the library call and autograd's backward of it (dq, dk and dv
        # together) on the backward kernels' inputs
        ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
        if "softcap" in kw:
            t0 = time.perf_counter()  # the first calls compile
            lib_fwd = partial(flex, q, k, v, enable_gqa=True)
            ol = flex(ql, kl, vl, enable_gqa=True)[0]
        else:
            lib_fwd = partial(F.scaled_dot_product_attention, q, k, v,
                              attn_mask=band, enable_gqa=True)
            ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=band,
                                                enable_gqa=True)
        lib_bwd = partial(torch.autograd.grad, ol, (ql, kl, vl), do,
                          retain_graph=True)
        if "softcap" in kw:  # flex computes this function: o, lse, grads
            err = max((a - b).abs().max().item() for a, b in zip(
                (*lib_fwd(), *lib_bwd()),
                (*ref(q, k, v, causal=True, return_stats=True, **kw),
                 dq_ref(*args, causal=True, **kw),
                 *dkv_ref(*args, causal=True, **kw))))
            print(f"[library] flex_attention {tag}: compiled and checked in "
                  f"{time.perf_counter() - t0:.1f} s; o, lse, dq, dk, dv "
                  f"max_abs {err:.3e} against the plain versions")
            require(err <= 1e-2, f"flex_attention is not the featured "
                    f"attention: max_abs {err:.3e}")
        timed[f"flash_attention {tag}"] = _timed_entry(
            "flash_attention", [B, Hq, S, D],
            partial(fa, q, k, v, causal=True, return_stats=True, **kw),
            partial(ref, q, k, v, causal=True, return_stats=True, **kw),
            lib_fwd, 2 * product, _nbytes(q, k, v, o, lse), f32)
        io = _nbytes(*args)
        timed[f"flash_attention_dq {tag}"] = _timed_entry(
            "flash_attention_dq", [B, Hq, Hkv, S, D],
            partial(dq, *args, causal=True, **kw),
            partial(dq_ref, *args, causal=True, **kw), lib_bwd,
            {ops_bench.SPLIT_TF32: 3 * product}, io + _nbytes(q), f32,
            fma=3 * product)
        timed[f"flash_attention_dkv {tag}"] = _timed_entry(
            "flash_attention_dkv", [B, Hq, Hkv, S, D],
            partial(dkv, *args, causal=True, **kw),
            partial(dkv_ref, *args, causal=True, **kw), lib_bwd,
            {ops_bench.SPLIT_TF32: 4 * product}, io + _nbytes(k, v), f32,
            fma=4 * product)


def _ce_kernels(checks, timed, gen, cfg, N):
    """The fused cross-entropy's forward (loss, lse) and backward (dx, dW)
    against their plain versions: odd shapes first, then the head of the
    7bish training step, x (N, d) by w (d, vocab), in f32 and bf16, about
    5% of the targets ignored. x ~ N(0, 1) and w ~ N(0, 1/d) give logits
    of unit scale. The gradients are held relative to their largest value
    (scale), since their size depends on the cotangent, at the tolerance
    of the inputs' dtype: with bf16 inputs both sides round dlog to bf16,
    and a dlog near a rounding boundary may round the other way on one
    side. The f32 forward and backward (split-TF32 products) are also
    held to the accuracy gate: the loss's and lse's largest error against
    an f64 product and log-sum-exp of the same inputs (ce_times.ce_fwd_f64;
    also at a tail, D % 8 and V % 128 not 0), and dx's and dW's against
    the f64 gradients (ce_times.ce_bwd_f64), at most SPLIT_GATE times the
    plain version's in f32 on cuBLAS. Times at the
    training shape; the library call is torch.matmul then F.cross_entropy
    (two calls, JAX's dense_xla baseline), and autograd's backward of the
    two for the backward kernel."""
    from functools import partial

    from tpukern_torch.harness import ops_bench
    from tpukern_torch.harness.ce_times import ce_bwd_f64, ce_fwd_f64
    from tpukern_torch.ops import cross_entropy as ce
    from tpukern_torch.ops import split_tf32 as st

    bf, f32 = torch.bfloat16, torch.float32
    d, V = cfg.d_model, cfg.vocab

    def inputs(n, dd, v, dt):
        x = _randn(gen, n, dd, dtype=f32).to(dt)
        w = _randn(gen, dd, v, dtype=f32).div(dd ** 0.5).to(dt)
        t = torch.randint(0, v, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
        t[torch.rand(n, generator=gen, device="cuda") < 0.05] = -1
        return x, w, t

    for n, dd, v, dt, exp2 in ((200, 128, 1000, f32, False),
                               (200, 128, 1000, f32, True),
                               (300, 203, 1000, f32, True),
                               (129, 100, 257, bf, True),
                               (N, d, V, f32, False), (N, d, V, bf, True)):
        x, w, t = inputs(n, dd, v, dt)
        cot = torch.rand(n, generator=gen, device="cuda")
        case = f"({n},{dd})x({dd},{v}) {dt} exp2={exp2}"
        loss, lse = ce.ce_fwd(x, w, t, exp2)
        # a partial a vocab tile, merged in order: the same bits again
        checks.record("ce_fwd", *_same_bits(
            "ce_fwd", case, torch.stack([loss, lse]),
            torch.stack(ce.ce_fwd(x, w, t, exp2))))
        dx, dw = ce.ce_bwd(x, w, t, lse, cot, exp2)
        rloss, rlse = ce._ce_ref(x, w, t)
        if dt == f32:
            gate = checks.results["ce_fwd"].setdefault("f64_gate", {})
            for what, out, ref, exact in zip(("loss", "lse"), (loss, lse),
                                             (rloss, rlse),
                                             ce_fwd_f64(x, w, t)):
                err = (out.double() - exact).abs().max().item()
                rerr = (ref.double() - exact).abs().max().item()
                checks.record("ce_fwd", _gate("ce_fwd", f"{what} {case}",
                                              err, rerr), 0.0)
                gate[f"{what} {case}"] = dict(kernel=err, cublas=rerr)
        rdx, rdw = ce.ce_bwd_ref(x, w, t, rlse, cot)
        for what, out, ref in (("loss", loss, rloss), ("lse", lse, rlse)):
            checks.record("ce_fwd", *_compare("ce_fwd", f"{what} {case}",
                                              out, ref))
        for what, out, ref in (("dx", dx, rdx), ("dW", dw, rdw)):
            checks.record("ce_bwd", *_compare(
                "ce_bwd", f"{what} {case}", out, ref,
                scale=ref.abs().max().item(), dtype=dt))
        ignored = t < 0
        checks.record("ce_bwd", bool((loss[ignored] == 0).all()
                                     and (dx[ignored] == 0).all()), 0.0)
        if dt == f32:
            # both against the f64 gradients from the kernel's own lse
            gate = checks.results["ce_bwd"].setdefault("f64_gate", {})
            for what, out, ref, exact in zip(
                    ("dx", "dW"), (dx, dw), ce.ce_bwd_ref(x, w, t, lse, cot),
                    ce_bwd_f64(x, w, t, lse, cot)):
                err = (out.double() - exact).abs().max().item()
                rerr = (ref.double() - exact).abs().max().item()
                checks.record("ce_bwd", _gate("ce_bwd", f"{what} {case}",
                                              err, rerr), 0.0)
                gate[f"{what} {case}"] = dict(kernel=err, cublas=rerr)
                del exact
        del rdx, rdw

    # the backward at forced vocab chunks (three launches a chunk): bf16
    # at three chunks of the training head (12288, 12288, 8192 columns,
    # TMA) and of the odd shape (96, 96, 65: the copy paths), and the
    # training head at its own chunk (the whole vocab); f32 at the odd
    # shape's 96 columns and at the training head's own chunk
    # (bwd_vocab_chunk_f32: 4 of 8192), with the split-TF32 operand pass
    # once on x and once a chunk on W; against ce_bwd_ref; a second call
    # gives the same bits (no atomics)
    for n, dd, v, chunk, dt in ((N, d, V, 12288, bf), (129, 100, 257, 96, bf),
                                (N, d, V, None, bf), (129, 100, 257, 96, f32),
                                (N, d, V, None, f32)):
        x, w, t = inputs(n, dd, v, dt)
        cot = torch.rand(n, generator=gen, device="cuda")
        exp2 = dt == bf
        _, lse = ce.ce_fwd(x, w, t, exp2)
        rdx, rdw = ce.ce_bwd_ref(x, w, t, lse, cot)
        before = (ce.ce_bwd.launches, st.split_tf32.launches)
        out = ce.ce_bwd(x, w, t, lse, cot, exp2, vocab_chunk=chunk)
        rule = ce.bwd_vocab_chunk if dt == bf else ce.bwd_vocab_chunk_f32
        n_chunks = -(-v // (chunk or rule(n, dd, v)))
        made = (ce.ce_bwd.launches - before[0],
                st.split_tf32.launches - before[1])
        want = (3 * n_chunks, 0 if dt == bf else 1 + n_chunks)
        require(made == want, f"ce_bwd {dt} made {made} launches (kernels, "
                f"operand passes), not {want} for {n_chunks} chunks")
        tag = "bf16" if dt == bf else "f32"
        case = (f"({n},{dd})x({dd},{v}) {tag} {n_chunks} chunk"
                f"{'s' if n_chunks > 1 else ''}")
        for what, o, ref in (("dx", out[0], rdx), ("dW", out[1], rdw)):
            checks.record("ce_bwd", *_compare(
                "ce_bwd", f"{what} {case}", o, ref,
                scale=ref.abs().max().item(), dtype=dt))
        again = ce.ce_bwd(x, w, t, lse, cot, exp2, vocab_chunk=chunk)
        same = all(torch.equal(a, b) for a, b in zip(out, again))
        if not same:
            print(f"[check] ce_bwd           {case}: a second call differs "
                  "MISS")
        checks.record("ce_bwd", same, 0.0)
        del rdx, rdw, out, again

    for dt, exp2 in ((f32, False), (bf, True)):
        tag = "f32" if dt == f32 else "bf16"
        x, w, t = inputs(N, d, V, dt)
        g = torch.full((N,), 1.0 / N, device="cuda")
        t64 = t.long()
        _, lse = ce.ce_fwd(x, w, t, exp2)

        def lib_fwd(x=x, w=w, t64=t64):
            return F.cross_entropy(torch.matmul(x, w).float(), t64,
                                   ignore_index=-1, reduction="none")

        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        ll = F.cross_entropy(torch.matmul(xl, wl).float(), t64,
                             ignore_index=-1, reduction="none")
        flops, io = 2 * N * d * V, _nbytes(x, w, t) + 8 * N
        # f32 on split-TF32 products
        timed[f"ce_fwd {tag}"] = _timed_entry(
            "ce_fwd", [N, d, V], partial(ce.ce_fwd, x, w, t, exp2),
            partial(ce._ce_ref, x, w, t), lib_fwd,
            {ops_bench.SPLIT_TF32: flops} if dt == f32 else flops, io, dt,
            fma=flops if dt == f32 else None)
        # the scores recomputed, then the dx and dW products; f32 on
        # split-TF32 products
        timed[f"ce_bwd {tag}"] = _timed_entry(
            "ce_bwd", [N, d, V], partial(ce.ce_bwd, x, w, t, lse, g, exp2),
            partial(ce.ce_bwd_ref, x, w, t, lse, g),
            partial(torch.autograd.grad, ll, (xl, wl), g, retain_graph=True),
            {ops_bench.SPLIT_TF32: 3 * flops} if dt == f32 else 3 * flops,
            _nbytes(x, w, t, lse, g) + 4 * (N * d + d * V), dt,
            fma=3 * flops if dt == f32 else None)


def _timed(fn, *args):
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    out = fn(*args)
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


# the serving batchers' shape: 4 slots of 8 pages of 128 tokens
SERVE_KW = dict(n_slots=4, pages_per_seq=8, page_size=128, max_new_tokens=32,
                prompt_buckets=(128, 256, 512))
GAMMA = 4  # draft tokens per speculative round
# the Gemma-2-style serving configuration: a band of 512 keys, 4 sinks
# and logits capped at 50
GEMMA2 = dict(window=512, sinks=4, softcap=50.0)


def _drive(cb, requests, ops=()):
    """Run requests through the batcher cb, admitting whenever a slot
    frees, with CUDA events around each admission and each step; the
    launch counts of ops are set to 0 just before and read just after.
    Returns dict(admit_ms {rid: ms}, step_ms, step_tokens, mid_stream
    (admissions after the first step), wall s, launches)."""
    for op in ops:
        op.launches = 0
    admit, step_ms, step_tokens, mid = {}, [], [], 0
    pending, t0 = list(requests), time.perf_counter()
    while pending or cb.active.any():
        while pending and cb.free_slots():
            rid, prompt = pending.pop(0)
            _, admit[rid] = _timed(cb.add_request, rid, prompt)
            mid += bool(step_ms)
        if cb.active.any():
            n, ms = _timed(cb.step)
            step_ms.append(ms)
            step_tokens.append(n)
    return dict(admit_ms=admit, step_ms=step_ms, step_tokens=step_tokens,
                mid_stream=mid, wall=time.perf_counter() - t0,
                launches={op.__name__: op.launches for op in ops},
                finished=dict(cb.finished))


def _ms_per_token(run):
    return sum(run["step_ms"]) / sum(run["step_tokens"])


def _require_finished(cb, requests, n_new, cfg, tag):
    require(set(cb.finished) == {r for r, _ in requests},
            f"{tag}: finished {sorted(cb.finished)}")
    for rid, toks in cb.finished.items():
        require(len(toks) == n_new and all(0 <= t < cfg.vocab for t in toks),
                f"{tag}: request {rid} gave {toks}")


def phase_serve(cfg, params, ops):
    """The main path: ContinuousBatcher over 6 requests."""
    from tpukern_torch.models.batcher import ContinuousBatcher, _bucket

    rng = np.random.default_rng(SEED)
    lens = rng.integers(60, 501, 6)
    requests = [(i, rng.integers(0, cfg.vocab, n).astype(np.int32))
                for i, n in enumerate(lens)]

    # warm-up outside the counted run: one short request per bucket
    warm = ContinuousBatcher(params, cfg, **dict(SERVE_KW, max_new_tokens=2))
    warm.run([(f"w{b}", np.ones(b - 10, np.int32)) for b in (128, 256, 512)])
    del warm
    torch.cuda.synchronize()

    cb = ContinuousBatcher(params, cfg, **SERVE_KW)
    run = _drive(cb, requests, ops)
    prefill_ms = {}
    for rid, prompt in requests:
        prefill_ms.setdefault(_bucket(len(prompt), cb.buckets, cb.max_len),
                              []).append(run["admit_ms"][rid])
    decode_ms, launches = run["step_ms"], run["launches"]
    print(f"[serve] prompt lengths {lens.tolist()}; {run['mid_stream']} "
          f"admitted mid-stream; {len(decode_ms)} decode steps; "
          f"{run['wall']:.2f} s wall")
    for b in sorted(prefill_ms):
        v = prefill_ms[b]
        print(f"[serve] prefill bucket {b}: {len(v)} requests, median "
              f"{np.median(v):.3f} ms ({', '.join(f'{x:.3f}' for x in v)})")
    emitted = sum(run["step_tokens"])
    print(f"[serve] decode: median {np.median(decode_ms):.3f} ms/step, "
          f"{emitted} tokens in {sum(decode_ms):.1f} ms = "
          f"{1e3 * emitted / sum(decode_ms):.1f} tok/s")
    print(f"[serve] launches {launches}")
    _require_finished(cb, requests, 32, cfg, "serve")
    require(run["mid_stream"] == 2,
            f"{run['mid_stream']} admitted mid-stream, not 2")
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the path never launched: {launches}")
    return launches, requests, run


def _prefix_requests(cfg, n=4):
    """n requests that share a 512-token system prompt, each with its own
    tail of 40 to 200 tokens."""
    rng = np.random.default_rng(SEED + 3)
    system = rng.integers(0, cfg.vocab, 512)
    return [(i, np.concatenate([system, rng.integers(0, cfg.vocab, t)])
             .astype(np.int32)) for i, t in enumerate(rng.integers(40, 201, n))]


def phase_chunked(cfg, params, requests, serve_run, ops):
    """[chunked]: phase_serve's requests through
    ContinuousBatcher(chunked_prefill=256): prompts over 256 tokens admit
    in 256-token chunks through verify_step and the prefix kernel."""
    from tpukern_torch.models.batcher import ContinuousBatcher

    C = 256
    warm = ContinuousBatcher(params, cfg, chunked_prefill=C,
                             **dict(SERVE_KW, max_new_tokens=2))
    warm.run([("w", np.ones(300, np.int32))])
    del warm
    cb = ContinuousBatcher(params, cfg, chunked_prefill=C, **SERVE_KW)
    run = _drive(cb, requests, ops)
    for rid, prompt in requests:
        n = len(prompt)
        ms, plain = run["admit_ms"][rid], serve_run["admit_ms"][rid]
        how = (f"{-(-n // C)} chunks, {ms / -(-n // C):.3f} ms per chunk"
               if n > C else "one prefill (not over the chunk)")
        print(f"[chunked] request {rid} ({n} tokens): admission {ms:.3f} ms, "
              f"{how}; unchunked admission {plain:.3f} ms")
    print(f"[chunked] decode {_ms_per_token(run):.3f} ms per token "
          f"(unchunked run {_ms_per_token(serve_run):.3f}); {run['wall']:.2f}"
          f" s wall; launches {run['launches']}")
    _require_finished(cb, requests, 32, cfg, "chunked")
    require(run["launches"]["paged_prefill_attention"] > 0,
            f"chunked admission never launched #24: {run['launches']}")
    return run["launches"]["paged_prefill_attention"]


def phase_prefix(cfg, params, ops):
    """[prefix]: 4 requests sharing a 512-token system prompt, admitted
    with prefix_cache=True and without, in turns (off, on, on, off); a hit
    aliases the first request's 4 full pages and scores only its tail
    through the prefix kernel. Admission ms are medians over the two runs
    of each."""
    from tpukern_torch.models.batcher import ContinuousBatcher

    requests = _prefix_requests(cfg)
    warm = ContinuousBatcher(params, cfg, prefix_cache=True,
                             **dict(SERVE_KW, max_new_tokens=2))
    warm.run(_prefix_requests(cfg, 2))
    del warm
    admit, launches = {False: [], True: []}, 0
    for on in (False, True, True, False):
        cb = ContinuousBatcher(params, cfg, prefix_cache=on, **SERVE_KW)
        for op in ops:
            op.launches = 0
        ms = {}
        for rid, prompt in requests:
            _, ms[rid] = _timed(cb.add_request, rid, prompt)
        admit[on].append(ms)
        if on:
            t = cb.cache.page_table.cpu()
            require(all(bool((t[j, :4] == t[0, :4]).all())
                        for j in range(1, 4)),
                    f"the hits did not alias the system prompt's pages: {t}")
        while cb.active.any():
            cb.step()
        _require_finished(cb, requests, 32, cfg, f"prefix cache={on}")
        if on:
            counts = {op.__name__: op.launches for op in ops}
            require(counts["paged_prefill_attention"] > 0,
                    f"prefix-cache admission never launched #24: {counts}")
            launches = counts["paged_prefill_attention"]
    med = {on: {rid: float(np.median([r[rid] for r in runs]))
                for rid, _ in requests} for on, runs in admit.items()}
    for rid, prompt in requests:
        what = ("a miss" if rid == 0 else
                f"a hit, {len(prompt) - 512} tokens past the shared 512")
        print(f"[prefix] request {rid} ({len(prompt)} tokens, {what}): "
              f"admission {med[True][rid]:.3f} ms with the cache, "
              f"{med[False][rid]:.3f} ms without (medians of 2)")
    print(f"[prefix] launches of the last cached run {counts}")
    return launches


def _agreeing(params, cfg):
    """(target, draft, draft cfg): the target with wo and w2 of layers
    2-15 zeroed (those layers then add nothing to the residual stream, at
    full cost) and its first two layers as the draft, which so computes
    the target's function."""
    zero = {k: torch.zeros_like(params["layers"][0][k]) for k in ("wo", "w2")}
    target = dict(params, layers=[lp if i < 2 else dict(lp, **zero)
                                  for i, lp in enumerate(params["layers"])])
    return (target, dict(params, layers=params["layers"][:2]),
            dataclasses.replace(cfg, n_layers=2))


def _rounding_split(cfg, params, prompt):
    """Where a bf16 draft's decode and the target's verification part:
    the logits of one position after the prompt from decode_step (#23),
    from verify_step with T = 1 (#24 at the decode's GEMM shapes) and as
    position 0 of a T = 5 verify_step (#24, five times the GEMM rows),
    each from the same prefilled cache."""
    from tpukern_torch.models import serving

    tokens = torch.from_numpy(prompt[None]).to("cuda")
    cand = torch.tensor([[7, 1, 2, 3, 4]], dtype=torch.int32, device="cuda")

    def cache():
        c = serving.init_cache(cfg, 1, 8, 128, device="cuda")
        return serving.prefill(params, cfg, tokens, c)[1]

    dec = serving.decode_step(params, cfg, cand[:, 0], cache())[0][0]
    ver1 = serving.verify_step(params, cfg, cand[:, :1], cache())[0][0, 0]
    ver5 = serving.verify_step(params, cfg, cand, cache())[0][0, 0]
    for label, a, b in (("#23 decode vs #24 verify, T=1", dec, ver1),
                        ("#24 verify T=1 vs T=5 (GEMM rows)", ver1, ver5)):
        print(f"[spec] rounding: {label}: logits max_abs "
              f"{(a - b).abs().max().item():.3e}, {int((a != b).sum())} of "
              f"{a.numel()} differ, argmax {int(a.argmax())} vs "
              f"{int(b.argmax())}")


def phase_spec(cfg, params, requests, ops):
    """[spec]: SpeculativeBatcher(gamma=4) on 4 slots, 32 new tokens each,
    with the target as its own draft (every proposal accepted, so gamma + 1
    tokens per slot per round), with a 2-layer draft made of the target's
    first two layers, embed, lnf and head, and with that draft for the
    agreeing target of _agreeing; ContinuousBatcher's decode over the same
    requests (on the target, and on the agreeing target) in the same
    call."""
    from tpukern_torch.models.batcher import (ContinuousBatcher,
                                              SpeculativeBatcher)

    requests = requests[:4]
    agree, draft, dcfg = _agreeing(params, cfg)
    warm = SpeculativeBatcher(params, cfg, draft, dcfg, gamma=GAMMA,
                              **dict(SERVE_KW, max_new_tokens=6))
    warm.run(requests[:1])
    del warm
    for tag, target in (("", params), (" (agreeing target)", agree)):
        base = _drive(ContinuousBatcher(target, cfg, **SERVE_KW), requests)
        print(f"[spec] ContinuousBatcher{tag}: {len(base['step_ms'])} decode "
              f"steps, {_ms_per_token(base):.3f} ms per emitted token")
    _rounding_split(cfg, params, requests[0][1])
    total = 0
    for name, tp, dp, dc in (("self-draft", params, params, cfg),
                             ("2-layer draft", params, draft, dcfg),
                             ("agreeing 2-layer draft", agree, draft, dcfg)):
        sb = SpeculativeBatcher(tp, cfg, dp, dc, gamma=GAMMA, **SERVE_KW)
        run = _drive(sb, requests, ops)
        st = sb.stats
        print(f"[spec] {name}: acceptance {st.acceptance_rate:.4f} "
              f"({st.accepted}/{st.drafted}), {st.rounds} target passes for "
              f"{sum(run['step_tokens'])} tokens, {_ms_per_token(run):.3f} "
              f"ms per emitted token (median round "
              f"{np.median(run['step_ms']):.3f} ms); launches "
              f"{run['launches']}")
        _require_finished(sb, requests, 32, cfg, f"spec {name}")
        require(run["launches"]["paged_prefill_attention"] > 0,
                f"speculative verification never launched #24: {run}")
        total += run["launches"]["paged_prefill_attention"]
        if name != "2-layer draft":
            # in bf16 the draft's decode (#23) and the target's verify
            # (#24) still round differently (the score products in
            # another order, other GEMM shapes), and at an argmax near-tie
            # the target rejects a proposal it would make itself. Every
            # proposal is accepted in f32 ([exact], _short_rounds)
            require(st.acceptance_rate >= 0.8,
                    f"{name} accepted only {st}")
    return total


# [sample]: the supports of the sampled runs, at temperature SAMPLE_T
SAMPLE_RUNS = {"top_k=50": dict(top_k=50), "top_p=0.9": dict(top_p=0.9),
               "min_p=0.05": dict(min_p=0.05)}


def _sampling_counts(reset=False):
    """The launches of #26 and of #27 by mode; with reset, set to 0."""
    from tpukern_torch.ops import sampling as sp

    names = ((sp._stream_sample, "launches", "sample"),
             (sp._bisect_threshold, "count_launches", "count"),
             (sp._bisect_threshold, "mass_launches", "mass"),
             (sp._bisect_threshold, "launches", None))
    if reset:
        for fn, attr, _ in names:
            setattr(fn, attr, 0)
    return {key: getattr(fn, attr) for fn, attr, key in names if key}


def _top1_draws(cb):
    """Wrap cb._sample to hold each top_k=1 draw to the row's maximum
    logit: returns counts of the draws, of those off the maximum (must
    stay 0) and of those that differ from the first maximum's index (a
    tie at the maximum: the bf16 head's logits tie often, and top-k keeps
    every tied token, as JAX's threshold does)."""
    counts = dict(draws=0, off_max=0, tie_picks=0)
    sample = cb._sample

    def checked(logits):
        tok = sample(logits)
        x = logits.float()
        t = torch.from_numpy(tok).to(x.device).long()
        picked = x.gather(1, t[:, None])[:, 0]
        counts["draws"] += len(tok)
        counts["off_max"] += int((picked != x.amax(-1)).sum())
        counts["tie_picks"] += int((t != x.argmax(-1)).sum())
        return tok

    cb._sample = checked
    return counts


def phase_sample(cfg, params, requests):
    """[sample]: phase_serve's requests through ContinuousBatcher(greedy=
    False, temperature=SAMPLE_T) with each support of SAMPLE_RUNS, each
    twice, in turns with two greedy runs (greedy, the supports, the
    supports reversed, greedy); then with top_k=1, whose every draw must
    be a maximum of its logits and whose streams must be the greedy ones
    where no tie at the maximum parted them; then one generate(greedy=
    False, temperature=0.7, top_p=0.9) of 32 tokens. The launch counts of
    #26 and #27 are set to 0 just before each run and read just after.
    Prints ms per emitted token, median step and admission ms of each
    support beside the greedy runs'. Returns the launches over all these
    runs."""
    from tpukern_torch.models import ContinuousBatcher, generate

    warm = ContinuousBatcher(params, cfg, greedy=False, temperature=SAMPLE_T,
                             top_k=50, top_p=0.9,
                             **dict(SERVE_KW, max_new_tokens=2))
    warm.run(requests[:1])
    del warm
    total = dict(sample=0, count=0, mass=0)
    runs = {name: dict(greedy=False, temperature=SAMPLE_T, seed=SEED, **kw)
            for name, kw in SAMPLE_RUNS.items()}
    runs["greedy"] = {}
    runs["top_k=1"] = dict(greedy=False, top_k=1, seed=SEED)
    # the timed runs in turns (greedy, each support, each support, greedy),
    # then the top_k=1 check
    names = list(SAMPLE_RUNS)
    order = ["greedy", *names, *names[::-1], "greedy", "top_k=1"]
    per_token, steps, admits, streams = {}, {}, {}, {}
    for name in order:
        kw = runs[name]
        cb = ContinuousBatcher(params, cfg, **kw, **SERVE_KW)
        top1 = _top1_draws(cb) if name == "top_k=1" else None
        _sampling_counts(reset=True)
        run = _drive(cb, requests)
        counts = _sampling_counts()
        per_token.setdefault(name, []).append(_ms_per_token(run))
        steps.setdefault(name, []).extend(run["step_ms"])
        admits.setdefault(name, []).extend(run["admit_ms"].values())
        streams.setdefault(name, run["finished"])
        print(f"[sample] {name} run {len(per_token[name])}: "
              f"{per_token[name][-1]:.3f} ms per emitted token (median step "
              f"{np.median(run['step_ms']):.3f} ms); launches #26 "
              f"{counts['sample']}, #27 count {counts['count']}, #27 mass "
              f"{counts['mass']}")
        _require_finished(cb, requests, 32, cfg, f"sample {name}")
        require((counts["sample"] > 0) == (name != "greedy")
                and (counts["count"] > 0) == ("top_k" in kw)
                and (counts["mass"] > 0) == ("top_p" in kw),
                f"sample {name}: launches {counts}")
        if top1 is not None:
            same = run["finished"] == streams["greedy"]
            print(f"[sample] top_k=1 (each draw checked against its logits, "
                  f"so its time includes the checks): {top1['draws']} "
                  f"draws, {top1['off_max']} off the maximum, "
                  f"{top1['tie_picks']} tied maxima drawn past the first; "
                  f"streams equal the greedy ones: {same}")
            require(top1["off_max"] == 0 and (same or top1["tie_picks"] > 0),
                    f"top_k=1 sampling is not greedy decoding: {top1}")
        for k in total:
            total[k] += counts[k]
    for name in ["greedy", *names]:
        print(f"[sample] {name}: {np.mean(per_token[name]):.3f} ms per "
              f"emitted token (mean of {len(per_token[name])} runs), median "
              f"step {np.median(steps[name]):.3f} ms, median admission "
              f"{np.median(admits[name]):.3f} ms")
    rid, prompt = requests[0]
    _sampling_counts(reset=True)
    t0 = time.perf_counter()
    out = generate(params, cfg, torch.from_numpy(prompt[None]).to("cuda"), 32,
                   greedy=False, temperature=0.7, top_p=0.9, seed=SEED)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    counts = _sampling_counts()
    print(f"[sample] generate(greedy=False, temperature=0.7, top_p=0.9), "
          f"prompt {len(prompt)}: 32 tokens in {ms:.1f} ms (prefill "
          f"included); launches #26 {counts['sample']}, #27 mass "
          f"{counts['mass']}")
    require(out.shape == (1, 32) and bool(((out >= 0) & (out < cfg.vocab))
                                          .all())
            and counts["sample"] == 32 and counts["mass"] == 32,
            f"generate: {tuple(out.shape)}, launches {counts}")
    for k in total:
        total[k] += counts[k]
    return total


def phase_spec_sample(cfg, params, requests, ops):
    """[spec-sample]: the sampled SpeculativeBatcher (temperature
    SAMPLE_T, gamma 4) with the agreeing draft of _agreeing on 4 of the
    requests, beside the sampled ContinuousBatcher on the agreeing target;
    then speculative_sample_generate once, 32 tokens."""
    from tpukern_torch.models import (ContinuousBatcher, SpeculativeBatcher,
                                      speculative_sample_generate)

    requests = requests[:4]
    agree, draft, dcfg = _agreeing(params, cfg)
    kw = dict(greedy=False, temperature=SAMPLE_T, seed=SEED, **SERVE_KW)
    warm = SpeculativeBatcher(agree, cfg, draft, dcfg, gamma=GAMMA,
                              **dict(kw, max_new_tokens=6))
    warm.run(requests[:1])
    del warm
    base = _drive(ContinuousBatcher(agree, cfg, **kw), requests)
    sb = SpeculativeBatcher(agree, cfg, draft, dcfg, gamma=GAMMA,
                            accept_seed=SEED, **kw)
    run = _drive(sb, requests, ops)
    st = sb.stats
    print(f"[spec-sample] T={SAMPLE_T}, agreeing 2-layer draft: acceptance "
          f"{st.acceptance_rate:.4f} ({st.accepted}/{st.drafted}), "
          f"{st.rounds} target passes for {sum(run['step_tokens'])} tokens, "
          f"{_ms_per_token(run):.3f} ms per emitted token (median round "
          f"{np.median(run['step_ms']):.3f} ms); sampled ContinuousBatcher "
          f"{_ms_per_token(base):.3f}; launches {run['launches']}")
    _require_finished(sb, requests, 32, cfg, "spec-sample")
    require(run["launches"]["paged_prefill_attention"] > 0
            and st.acceptance_rate >= 0.5,
            f"spec-sample: {st}, launches {run['launches']}")
    rid, prompt = requests[0]
    t0 = time.perf_counter()
    out, st = speculative_sample_generate(
        agree, cfg, draft, dcfg, torch.from_numpy(prompt[None]).to("cuda"),
        32, gamma=GAMMA, temperature=SAMPLE_T, seed=SEED, return_stats=True)
    ms = 1e3 * (time.perf_counter() - t0)
    print(f"[spec-sample] speculative_sample_generate: 32 tokens in "
          f"{ms:.1f} ms (prefills included), acceptance "
          f"{st.acceptance_rate:.4f} ({st.accepted}/{st.drafted}), "
          f"{st.rounds} rounds")
    require(out.shape == (1, 32) and bool(((out >= 0) & (out < cfg.vocab))
                                          .all()) and st.accepted > 0,
            f"speculative_sample_generate: {tuple(out.shape)}, {st}")
    return run["launches"]["paged_prefill_attention"]


def _short_rounds(sb, requests):
    """Drive the SpeculativeBatcher sb over requests; returns the number
    of rounds in which some slot emitted fewer than gamma + 1 tokens while
    its budget allowed more (a rejected proposal)."""
    pending, short = list(requests), 0
    while pending or sb.active.any():
        while pending and sb.free_slots():
            sb.add_request(*pending.pop(0))
        if sb.active.any():
            want = sum(min(sb.gamma + 1, sb.max_new - int(sb.n_generated[s]))
                       for s in np.flatnonzero(sb.active))
            short += sb.step() < want
    return short


def phase_gemma2(cfg, params, ops):
    """[gemma2-serve]: the preset with window 512, sinks 4 and softcap 50
    through ContinuousBatcher over prompts longer than the window, so the
    decode band moves: the featured #6 prefill and the featured #23."""
    from tpukern_torch.models.batcher import ContinuousBatcher
    from tpukern_torch.ops import paged_attention

    gcfg = dataclasses.replace(cfg, **GEMMA2)
    rng = np.random.default_rng(SEED + 5)
    requests = [(i, rng.integers(0, cfg.vocab, n).astype(np.int32))
                for i, n in enumerate(rng.integers(600, 901, 4))]
    warm = ContinuousBatcher(params, gcfg, **dict(SERVE_KW, max_new_tokens=2))
    warm.run(requests[:1])
    del warm
    paged_attention.paged_attention.featured_launches = 0
    cb = ContinuousBatcher(params, gcfg, **SERVE_KW)
    run = _drive(cb, requests, ops)
    featured = paged_attention.paged_attention.featured_launches
    admit = [f"{run['admit_ms'][r]:.3f}" for r, _ in requests]
    print(f"[gemma2-serve] {GEMMA2}, prompt lengths "
          f"{[len(p) for _, p in requests]}: admission ms {admit}; decode "
          f"median {np.median(run['step_ms']):.3f} ms/step, "
          f"{_ms_per_token(run):.3f} ms per token; launches "
          f"{run['launches']}, featured #23 {featured}")
    _require_finished(cb, requests, 32, cfg, "gemma2-serve")
    require(featured > 0 and featured == run["launches"]["paged_attention"],
            f"the featured #23 did not take every decode: {featured}, "
            f"{run['launches']}")
    return featured


# [int8-serve] / [fp8-serve]: the quantized tiers (cache dtype,
# Config.pv_int8); the whole-prompt runs go in turns with two bf16 runs
QUANT_SERVE = {"int8": (torch.int8, False),
               "int8 pv_int8": (torch.int8, True),
               "fp8": (torch.float8_e4m3fn, False)}


def _quant_ops():
    from tpukern_torch.ops import attention, paged_attention, quant, rmsnorm
    from tpukern_torch.ops import rope

    return [rmsnorm.rms_norm, rope.rope_cached, attention.flash_attention,
            paged_attention.paged_attention,
            paged_attention.paged_prefill_attention,
            paged_attention.paged_attention_quantized,
            paged_attention.paged_prefill_attention_quantized,
            quant.quantize_int8, quant.quantize_fp8, quant.dequantize_int8]


def _tier_counts(reset=False):
    """The quantized #23's and #24's launches by tier ("#23 int8", "#23
    pv_int8", "#23 fp8", "#24 ..."); with reset, set to 0."""
    from tpukern_torch.ops import paged_attention as pa

    fns = {"#23": pa.paged_attention_quantized,
           "#24": pa.paged_prefill_attention_quantized}
    tiers = ("int8", "pv_int8", "fp8")
    if reset:
        for fn in fns.values():
            for t in tiers:
                setattr(fn, f"{t}_launches", 0)
    return {f"{k} {t}": getattr(fn, f"{t}_launches")
            for k, fn in fns.items() for t in tiers}


def _agreement(streams, ref):
    """Per request, how many leading tokens of streams equal ref's."""
    out = []
    for rid in sorted(ref):
        a, b = streams[rid], ref[rid]
        n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        out.append(n)
    return out


def _pool_bytes(cache):
    return sum(t.numel() * t.element_size() for t in (
        cache.k_pages, cache.v_pages, cache.k_scales, cache.v_scales)
        if t is not None)


def _drive_quant(cb, requests, tag, need):
    """_drive with the quantized tier's counts: the float paged kernels
    must not launch, every count named in `need` must. Returns the run
    with its tier counts under run["tiers"]."""
    _tier_counts(reset=True)
    run = _drive(cb, requests, _quant_ops())
    run["tiers"] = _tier_counts()
    counts = {**run["launches"], **run["tiers"]}
    require(counts["paged_attention"] == 0
            and counts["paged_prefill_attention"] == 0
            and all(counts[n] > 0 for n in need),
            f"{tag}: the float paged kernels launched, or one of {need} did "
            f"not: {counts}")
    return run


def _add_counts(total, run):
    for k, v in {**run["launches"], **run["tiers"]}.items():
        total[k] = total.get(k, 0) + v


def phase_quant_serve(cfg, params, requests):
    """[int8-serve] and [fp8-serve]: phase_serve's requests through
    ContinuousBatcher on each quantized tier (int8, int8 with
    Config.pv_int8, fp8), whole-prompt admission, each tier twice in turns
    with two bf16 runs (equal streams, first tokens equal the bf16
    tier's: the prefill attends over unquantized K/V); then int8 and fp8
    with chunked_prefill=256, int8 with the prefix cache, and
    SpeculativeBatcher (the agreeing draft) on int8 caches. Each run
    resets the launch counts just before and reads them just after: the
    quantized instances and #20/#22 launch, the float paged kernels
    never. Returns the launches summed over these runs."""
    from tpukern_torch.models.batcher import (ContinuousBatcher,
                                              SpeculativeBatcher)

    total = {}

    def batcher(tier, **kw):
        if tier == "bf16":
            return ContinuousBatcher(params, cfg, **kw, **SERVE_KW)
        dt, pv = QUANT_SERVE[tier]
        return ContinuousBatcher(params, dataclasses.replace(cfg, pv_int8=pv),
                                 cache_dtype=dt, **kw, **SERVE_KW)

    def need(tier, prefix=False):
        dt, pv = QUANT_SERVE[tier]
        t = "fp8" if dt != torch.int8 else "pv_int8" if pv else "int8"
        q = "quantize_int8" if dt == torch.int8 else "quantize_fp8"
        return [q, f"#23 {t}"] + ([f"#24 {t}"] if prefix else [])

    for tier in QUANT_SERVE:  # warm-up outside the counted runs
        warm = ContinuousBatcher(
            params, dataclasses.replace(cfg, pv_int8=QUANT_SERVE[tier][1]),
            cache_dtype=QUANT_SERVE[tier][0], chunked_prefill=256,
            **dict(SERVE_KW, max_new_tokens=2))
        warm.run([(f"w{b}", np.ones(b - 10, np.int32)) for b in (128, 512)])
    del warm
    torch.cuda.synchronize()
    runs, pools = {}, {}
    order = ["bf16", *QUANT_SERVE, *list(QUANT_SERVE)[::-1], "bf16"]
    for tier in order:
        cb = batcher(tier)
        pools[tier] = _pool_bytes(cb.cache)
        if tier == "bf16":
            run = _drive(cb, requests)
        else:
            run = _drive_quant(cb, requests, f"{tier}-serve", need(tier))
            _add_counts(total, run)
        _require_finished(cb, requests, 32, cfg, f"{tier}-serve")
        runs.setdefault(tier, []).append(run)
    bf16 = runs["bf16"][0]["finished"]
    require(runs["bf16"][1]["finished"] == bf16, "two bf16 runs differ")
    for tier in QUANT_SERVE:
        tag = f"[{tier.split()[0]}-serve]"
        a, b = (r["finished"] for r in runs[tier])
        firsts = [a[rid][0] == bf16[rid][0] for rid in sorted(bf16)]
        step = [float(np.median(r["step_ms"])) for r in runs[tier]]
        per_tok = [_ms_per_token(r) for r in runs[tier]]
        print(f"{tag} {tier}: decode median {step[0]:.3f} / {step[1]:.3f} "
              f"ms/step, {per_tok[0]:.3f} / {per_tok[1]:.3f} ms per emitted "
              f"token (runs 1 / 2); bf16 in the same turns "
              f"{_ms_per_token(runs['bf16'][0]):.3f} / "
              f"{_ms_per_token(runs['bf16'][1]):.3f}; KV pool "
              f"{pools[tier]} bytes against bf16's {pools['bf16']} "
              f"({pools[tier] / pools['bf16']:.4f}x)")
        print(f"{tag} {tier}: leading tokens equal to the bf16 stream "
              f"{_agreement(a, bf16)} of 32; first tokens equal "
              f"{sum(firsts)}/{len(firsts)}; two runs equal {a == b}; "
              f"launches {runs[tier][0]['launches']}, by tier "
              f"{runs[tier][0]['tiers']}")
        require(a == b and all(firsts),
                f"{tier}-serve: runs differ or a first token is not the "
                f"bf16 tier's: {a} {b}")

    # chunked admission (#24 quantized), the prefix cache, speculation
    for tier in ("int8", "fp8"):
        cb = batcher(tier, chunked_prefill=256)
        run = _drive_quant(cb, requests, f"{tier} chunked",
                           need(tier, prefix=True))
        _add_counts(total, run)
        _require_finished(cb, requests, 32, cfg, f"{tier} chunked")
        print(f"[{tier}-serve] chunked_prefill=256: admission ms "
              f"{[round(run['admit_ms'][r], 3) for r, _ in requests]}; "
              f"decode {_ms_per_token(run):.3f} ms per emitted token; "
              f"leading tokens equal to the bf16 stream "
              f"{_agreement(run['finished'], bf16)}; by tier {run['tiers']}")
    shared = _prefix_requests(cfg)
    cb = batcher("int8", prefix_cache=True)
    run = _drive_quant(cb, shared, "int8 prefix cache",
                       need("int8", prefix=True))
    _add_counts(total, run)
    _require_finished(cb, shared, 32, cfg, "int8 prefix cache")
    t = cb.cache.page_table.cpu()
    require(all(bool((t[j, :4] == t[0, :4]).all()) for j in range(1, 4)),
            f"int8 prefix cache: the hits did not alias the shared pages {t}")
    print(f"[int8-serve] prefix_cache: admission ms "
          f"{[round(run['admit_ms'][r], 3) for r, _ in shared]} (request 0 "
          f"a miss, 1-3 hits on 512 shared tokens); by tier {run['tiers']}")

    agree, draft, dcfg = _agreeing(params, cfg)
    spec_req = requests[:4]
    base = _drive(ContinuousBatcher(agree, cfg, cache_dtype=torch.int8,
                                    **SERVE_KW), spec_req)
    sb = SpeculativeBatcher(agree, cfg, draft, dcfg, gamma=GAMMA,
                            cache_dtype=torch.int8, **SERVE_KW)
    require(sb.dcache.quantized and sb.dcache.k_pages.dtype == torch.int8,
            "the draft cache is not in the target's tier")
    run = _drive_quant(sb, spec_req, "int8 spec", need("int8", prefix=True))
    _add_counts(total, run)
    _require_finished(sb, spec_req, 32, cfg, "int8 spec")
    st = sb.stats
    print(f"[int8-serve] SpeculativeBatcher (gamma {GAMMA}, agreeing 2-layer "
          f"draft): acceptance {st.acceptance_rate:.4f} "
          f"({st.accepted}/{st.drafted}), {st.rounds} target passes, "
          f"{_ms_per_token(run):.3f} ms per emitted token against "
          f"ContinuousBatcher's {_ms_per_token(base):.3f} (int8, agreeing "
          f"target); by tier {run['tiers']}")
    require(st.acceptance_rate >= 0.5, f"int8 spec accepted only {st}")
    print(f"[quant-serve] launches over these runs {total}")
    return total


def _weight_bytes(params):
    """Bytes of the projections and the head (what w8a16 quantizes), and
    of the whole tree."""
    from tpukern_torch.models import param_leaves
    from tpukern_torch.models.serving import W8A16_WEIGHTS

    proj = [params["head"]] + [lp[k] for lp in params["layers"]
                               for k in W8A16_WEIGHTS]
    flat = [t for w in proj for t in (w.values() if isinstance(w, dict)
                                      else [w])]
    return _nbytes(*flat), _nbytes(*param_leaves(params))


def _w8a16_ops():
    from tpukern_torch.ops import matmul_w8a16

    return _quant_ops() + [matmul_w8a16.matmul_w8a16]


def _w8a16_step_counts(cfg, qparams, requests):
    """#25's launches in one call of each serving step on the w8a16 tree,
    against the dispatch rule (the kernel at M <= 128 rows): a decode step
    of 4 slots and a gamma = 4 verification of 4 slots (M = 4, 20: every
    projection and the head, 6 L + 1), whole prefills in buckets 128 (M =
    128: 6 L + 1), 256 and 512 (the layers take the dequant-then-dot path,
    the head at M = 1 the kernel: 1), a 256-token chunk (M = 256
    everywhere: 0)."""
    from tpukern_torch.models import serving
    from tpukern_torch.models.batcher import ContinuousBatcher
    from tpukern_torch.ops.matmul_w8a16 import matmul_w8a16

    full = 6 * cfg.n_layers + 1
    cb = ContinuousBatcher(qparams, cfg, **SERVE_KW)
    counts, want = {}, {}
    by_bucket = {}
    for rid, prompt in requests:
        b = 128 if len(prompt) <= 128 else 256 if len(prompt) <= 256 else 512
        by_bucket.setdefault(b, (rid, prompt))
    for b, (rid, prompt) in sorted(by_bucket.items()):
        if not cb.free_slots():
            break
        matmul_w8a16.launches = 0
        cb.add_request(rid, prompt)
        counts[f"prefill bucket {b}"] = matmul_w8a16.launches
        want[f"prefill bucket {b}"] = full if b == 128 else 1
    for rid, prompt in requests:
        if cb.free_slots() and rid not in cb.outputs:
            cb.add_request(rid, prompt)
    cb.step()
    matmul_w8a16.launches = 0
    cb.step()
    counts["decode step"], want["decode step"] = matmul_w8a16.launches, full
    dev = qparams["embed"].device
    for tag, T, B, n in (("verify gamma 4", 5, 4, full),
                         ("chunk of 256", 256, 1, 0)):
        cache = serving.init_cache(cfg, B, 8, 128, device=dev)
        toks = torch.zeros(B, T, dtype=torch.int32, device=dev)
        matmul_w8a16.launches = 0
        serving.verify_step(qparams, cfg, toks, cache)
        counts[tag], want[tag] = matmul_w8a16.launches, n
    print(f"[w8a16-serve] #25 launches per call {counts}")
    require(counts == want, f"#25 launches {counts}, want {want}")
    return counts["decode step"]


def phase_w8a16_serve(cfg, params, requests):
    """[w8a16-serve]: quantize_model_weights on the 7bish bf16 params on
    the card, then phase_serve's requests through ContinuousBatcher with
    the w8a16 tree twice in turns with two bf16 runs, once on int8 KV
    pools, once with chunked_prefill=256, and SpeculativeBatcher with a
    w8a16 agreeing target and draft. Each run resets the launch counts
    just before and reads them just after; #25 must launch in every w8a16
    run. Weight quantization moves the logits, so leading tokens equal to
    the bf16 streams are printed, not required. Returns #25's launches
    summed over these runs."""
    from tpukern_torch.models import serving
    from tpukern_torch.models.batcher import (ContinuousBatcher,
                                              SpeculativeBatcher)

    qparams = serving.quantize_model_weights(params)
    require(qparams["head"]["q"].is_cuda and qparams["head"]["q"].dtype ==
            torch.int8, "quantize_model_weights did not stay on the card")
    (pq, tq), (pb, tb) = _weight_bytes(qparams), _weight_bytes(params)
    print(f"[w8a16-serve] weight bytes: projections and head {pq} (w8a16) "
          f"against {pb} (bf16), {pq / pb:.4f}x; whole tree {tq} against "
          f"{tb}")
    per_step = _w8a16_step_counts(cfg, qparams, requests)
    warm = ContinuousBatcher(qparams, cfg, chunked_prefill=256,
                             **dict(SERVE_KW, max_new_tokens=2))
    warm.run([(f"w{b}", np.ones(b - 10, np.int32)) for b in (128, 256, 512)])
    del warm
    torch.cuda.synchronize()
    ops = _w8a16_ops()
    total, runs = 0, {}
    for tag in ("bf16", "w8a16", "w8a16", "bf16"):
        cb = ContinuousBatcher(qparams if tag == "w8a16" else params, cfg,
                               **SERVE_KW)
        run = _drive(cb, requests, ops)
        _require_finished(cb, requests, 32, cfg, f"{tag}-serve")
        n = run["launches"]["matmul_w8a16"]
        require((n > 0) == (tag == "w8a16"),
                f"{tag}: #25 launched {n} times")
        total += n
        runs.setdefault(tag, []).append(run)
    bf16 = runs["bf16"][0]["finished"]
    a, b = (r["finished"] for r in runs["w8a16"])
    firsts = [a[r][0] == bf16[r][0] for r in sorted(bf16)]
    print(f"[w8a16-serve] decode median "
          f"{' / '.join(f'{np.median(r['step_ms']):.3f}' for r in runs['w8a16'])}"
          f" ms/step, "
          f"{' / '.join(f'{_ms_per_token(r):.3f}' for r in runs['w8a16'])} "
          f"ms per emitted token (runs 1 / 2); bf16 in the same turns "
          f"{' / '.join(f'{_ms_per_token(r):.3f}' for r in runs['bf16'])}; "
          f"#25 launches {[r['launches']['matmul_w8a16'] for r in runs['w8a16']]}"
          f" ({per_step} per decode step)")
    print(f"[w8a16-serve] leading tokens equal to the bf16 stream "
          f"{_agreement(a, bf16)} of 32; first tokens equal "
          f"{sum(firsts)}/{len(firsts)}; two runs equal {a == b}")
    require(a == b, "two w8a16 runs differ")

    cb = ContinuousBatcher(qparams, cfg, cache_dtype=torch.int8, **SERVE_KW)
    _tier_counts(reset=True)
    run = _drive(cb, requests, ops)
    _require_finished(cb, requests, 32, cfg, "w8a16 int8 KV")
    tiers = _tier_counts()
    require(run["launches"]["matmul_w8a16"] > 0 and tiers["#23 int8"] > 0,
            f"w8a16 on int8 pools: {run['launches']} {tiers}")
    total += run["launches"]["matmul_w8a16"]
    print(f"[w8a16-serve] int8 KV pools: {_ms_per_token(run):.3f} ms per "
          f"emitted token; leading tokens equal to the bf16 stream "
          f"{_agreement(run['finished'], bf16)}; #25 "
          f"{run['launches']['matmul_w8a16']}, quantized #23 "
          f"{tiers['#23 int8']}")

    cb = ContinuousBatcher(qparams, cfg, chunked_prefill=256, **SERVE_KW)
    run = _drive(cb, requests, ops)
    _require_finished(cb, requests, 32, cfg, "w8a16 chunked")
    n = run["launches"]
    require(n["matmul_w8a16"] > 0 and n["paged_prefill_attention"] > 0,
            f"w8a16 chunked: {n}")
    total += n["matmul_w8a16"]
    print(f"[w8a16-serve] chunked_prefill=256: admission ms "
          f"{[round(run['admit_ms'][r], 3) for r, _ in requests]}; "
          f"{_ms_per_token(run):.3f} ms per emitted token; #25 "
          f"{n['matmul_w8a16']} (decode steps and the short prompts' "
          f"whole prefills; a 256-token chunk launches none)")

    agree, draft, dcfg = _agreeing(params, cfg)
    qa, qd = (serving.quantize_model_weights(p) for p in (agree, draft))
    spec_req = requests[:4]
    base = _drive(ContinuousBatcher(qa, cfg, **SERVE_KW), spec_req)
    sb = SpeculativeBatcher(qa, cfg, qd, dcfg, gamma=GAMMA, **SERVE_KW)
    run = _drive(sb, spec_req, ops)
    _require_finished(sb, spec_req, 32, cfg, "w8a16 spec")
    st = sb.stats
    total += run["launches"]["matmul_w8a16"]
    print(f"[w8a16-serve] SpeculativeBatcher (gamma {GAMMA}, w8a16 agreeing "
          f"target and 2-layer draft): acceptance {st.acceptance_rate:.4f} "
          f"({st.accepted}/{st.drafted}), {st.rounds} target passes, "
          f"{_ms_per_token(run):.3f} ms per emitted token against "
          f"ContinuousBatcher's {_ms_per_token(base):.3f}; #25 "
          f"{run['launches']['matmul_w8a16']}")
    require(run["launches"]["matmul_w8a16"] > 0 and st.rounds > 0,
            f"w8a16 spec: {run['launches']} {st}")
    print(f"[w8a16-serve] #25 launches over these runs {total}")
    return total, qparams


# [ring-serve]: Gemma-2-style serving (GEMMA2) on ring pools of 5 pages
# of 128 slots (640 >= window + sinks + gamma + 1) against flat pools of 8
RING_SERVE_KW = dict(n_slots=4, page_size=128, max_new_tokens=256,
                     prompt_buckets=(640,))


def _ring_requests(cfg):
    """4 prompts of 560-620 tokens (bucket 640): with 256 new tokens each
    stream passes the 640-slot ring."""
    rng = np.random.default_rng(SEED + 7)
    return [(i, rng.integers(0, cfg.vocab, n).astype(np.int32))
            for i, n in enumerate(rng.integers(560, 621, 4))]


def _ring_counts(reset=False):
    """ring_launches of #23, #24 and their quantized instances; with
    reset, set to 0."""
    from tpukern_torch.ops import paged_attention as pa

    fns = (pa.paged_attention, pa.paged_prefill_attention,
           pa.paged_attention_quantized, pa.paged_prefill_attention_quantized)
    if reset:
        for fn in fns:
            fn.ring_launches = 0
    return {fn.__name__: fn.ring_launches for fn in fns}


def phase_ring_serve(cfg, params):
    """[ring-serve]: the [gemma2-serve] config (window 512, sinks 4,
    softcap 50) through ContinuousBatcher on ring pools (5 pages of 128)
    in turns with flat pools of 8 pages, 4 prompts of 560-620 tokens and
    256 new tokens (every stream wraps the ring); then int8 ring pools,
    SpeculativeBatcher on a ring (the agreeing draft, float and int8
    pools) and generate(ring=True). The ring instances must launch, and
    the first tokens equal the flat pools' (the prefill is one function).
    Returns the ring launches of each paged kernel summed over the ring
    runs."""
    from tpukern_torch.models import serving
    from tpukern_torch.models.batcher import (ContinuousBatcher,
                                              SpeculativeBatcher)

    gcfg = dataclasses.replace(cfg, **GEMMA2)
    requests = _ring_requests(cfg)
    n_new = RING_SERVE_KW["max_new_tokens"]
    total = {}

    def counted(make, tag, need):
        _ring_counts(reset=True)
        _tier_counts(reset=True)
        cb = make()
        run = _drive(cb, requests, _quant_ops())
        _require_finished(cb, requests, n_new, cfg, tag)
        rc = _ring_counts()
        require(all(rc[n] > 0 for n in need),
                f"{tag}: a ring instance of {need} did not launch: {rc}")
        for k, v in rc.items():
            total[k] = total.get(k, 0) + v
        return cb, run, rc

    def ring_cb(**kw):
        return ContinuousBatcher(params, gcfg, pages_per_seq=5, ring=True,
                                 **kw, **RING_SERVE_KW)

    warm = ContinuousBatcher(params, gcfg, pages_per_seq=5, ring=True,
                             **dict(RING_SERVE_KW, max_new_tokens=2))
    warm.run(requests[:1])
    del warm
    runs, pools = {}, {}
    for tag in ("flat", "ring", "ring", "flat"):
        if tag == "flat":
            cb = ContinuousBatcher(params, gcfg, pages_per_seq=8,
                                   **RING_SERVE_KW)
            run = _drive(cb, requests)
            _require_finished(cb, requests, n_new, cfg, "flat")
        else:
            cb, run, rc = counted(ring_cb, "ring", ["paged_attention"])
            require(rc["paged_attention"] == run["launches"]["paged_attention"],
                    f"a decode on the ring pool took the flat instance: {rc} "
                    f"{run['launches']}")
        pools[tag] = _pool_bytes(cb.cache)
        runs.setdefault(tag, []).append(run)
    flat = runs["flat"][0]["finished"]
    a, b = (r["finished"] for r in runs["ring"])
    firsts = [a[r][0] == flat[r][0] for r in sorted(flat)]
    print(f"[ring-serve] {GEMMA2}, prompt lengths "
          f"{[len(p) for _, p in requests]}, {n_new} new tokens: ring pools "
          f"{pools['ring']} bytes against flat {pools['flat']} "
          f"({pools['ring'] / pools['flat']:.4f}x); ms per emitted token "
          f"ring {' / '.join(f'{_ms_per_token(r):.3f}' for r in runs['ring'])}"
          f", flat in the same turns "
          f"{' / '.join(f'{_ms_per_token(r):.3f}' for r in runs['flat'])}")
    print(f"[ring-serve] leading tokens equal to the flat stream "
          f"{_agreement(a, flat)} of {n_new}; first tokens equal "
          f"{sum(firsts)}/{len(firsts)}; two ring runs equal {a == b}; "
          f"ring #23 launches {total['paged_attention']}")
    require(all(firsts) and a == b,
            f"ring-serve: a first token is not the flat pool's, or two runs "
            f"differ: {a} {b}")

    _, run, rc = counted(lambda: ring_cb(cache_dtype=torch.int8), "int8 ring",
                         ["paged_attention_quantized"])
    print(f"[ring-serve] int8 ring pools: {_ms_per_token(run):.3f} ms per "
          f"emitted token; leading tokens equal to the flat bf16 stream "
          f"{_agreement(run['finished'], flat)}; ring launches {rc}")
    agree, draft, dcfg = _agreeing(params, gcfg)
    for dt, need in ((torch.bfloat16, "paged_prefill_attention"),
                     (torch.int8, "paged_prefill_attention_quantized")):
        sb, run, rc = counted(lambda: SpeculativeBatcher(
            agree, gcfg, draft, dcfg, gamma=GAMMA, pages_per_seq=5,
            ring=True, cache_dtype=dt, **RING_SERVE_KW), f"{dt} ring spec",
            [need])
        require(not sb.dcache.ring, "the draft cache is a ring")
        st = sb.stats
        print(f"[ring-serve] SpeculativeBatcher on a {dt} ring (gamma "
              f"{GAMMA}, agreeing 2-layer draft on a flat pool that clamps "
              f"past 640): acceptance {st.acceptance_rate:.4f} "
              f"({st.accepted}/{st.drafted}), {st.rounds} target passes, "
              f"{_ms_per_token(run):.3f} ms per emitted token; ring "
              f"launches {rc}")
    _ring_counts(reset=True)
    prompt = torch.from_numpy(requests[0][1][None]).to("cuda")
    out = serving.generate(params, gcfg, prompt, n_steps=96, pages_per_seq=5,
                           ring=True)
    ref = serving.generate(params, gcfg, prompt, n_steps=96, pages_per_seq=8)
    rc = _ring_counts()
    for k, v in rc.items():
        total[k] += v
    require(out.shape == (1, 96) and rc["paged_attention"] == 96 * cfg.n_layers
            and int(out.min()) >= 0 and int(out.max()) < cfg.vocab,
            f"generate(ring=True): {tuple(out.shape)} {rc}")
    print(f"[ring-serve] generate(ring=True), {prompt.shape[1]} + 96 tokens:"
          f" leading tokens equal to generate on flat pools "
          f"{_agreement({0: out[0].tolist()}, {0: ref[0].tolist()})}; ring "
          f"#23 launches {rc['paged_attention']}")
    print(f"[ring-serve] ring launches over these runs {total}")
    return total


@contextlib.contextmanager
def _plain_serving():
    """models/serving.py with every kernel it calls swapped for its plain
    version (norms, RoPE, attention, the float and quantized paged
    kernels, the quantizers, #25: at M <= 128 its plain version, above it
    the dequant-then-dot path, which runs no kernel of the port)."""
    from tpukern_torch.models import serving
    from tpukern_torch.ops import attention
    from tpukern_torch.ops import matmul_w8a16 as w8
    from tpukern_torch.ops import paged_attention as pa
    from tpukern_torch.ops import quant, rmsnorm, rope

    def plain_w8a16(x, q, s):
        return (w8.matmul_w8a16_ref(x, q, s) if x.shape[0] <= w8.KERNEL_MAX_M
                else w8._dequant_matmul(x, q, s, x.dtype))

    swap = dict(rms_norm=rmsnorm.rms_norm_ref,
                rope_cached=rope.rope_cached_ref,
                flash_attention=attention.attention_ref,
                paged_attention=pa.paged_attention_ref,
                paged_prefill_attention=pa.paged_prefill_ref,
                matmul_w8a16=plain_w8a16,
                paged_attention_quantized=pa.paged_attention_quantized_ref,
                paged_prefill_attention_quantized=(
                    pa.paged_prefill_quantized_ref),
                quantize_int8=quant.quantize_ref,
                quantize_fp8=quant.quantize_fp8_ref)
    saved = {k: getattr(serving, k) for k in swap}
    for k, v in swap.items():
        setattr(serving, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(serving, k, v)


def phase_quant_logits(cfg, params, prompt):
    """One decode step on each quantized tier after a prefill of prompt,
    through the kernels and through the plain functions (_plain_serving)
    on copies of the same cache, at full depth: bf16 as served (rel RMS
    <= E2E_BF16_REL) and f32 (max abs <= E2E_F32_ATOL), each with
    _logits_verdict's argmax rule."""
    from tpukern_torch.models import params_to, serving

    dev = params["embed"].device
    tokens = torch.from_numpy(prompt[None]).to(dev)
    p32 = params_to(params, torch.float32)
    ok = True
    for name, p, f32 in (("bf16", params, False), ("f32", p32, True)):
        for tier, (dt, pv) in QUANT_SERVE.items():
            c = dataclasses.replace(cfg, pv_int8=pv, param_dtype=(
                torch.float32 if f32 else cfg.param_dtype))
            cache = serving.init_cache(c, 1, 8, 128, dtype=dt, device=dev)
            logits, cache = serving.prefill(p, c, tokens, cache)
            tok = logits.argmax(-1).to(torch.int32)
            copy = dataclasses.replace(cache, **{
                k: getattr(cache, k).clone() for k in (
                    "k_pages", "v_pages", "k_scales", "v_scales", "lengths")})
            out, _ = serving.decode_step(p, c, tok, cache)
            with _plain_serving():
                ref, _ = serving.decode_step(p, c, tok, copy)
            ok &= _logits_verdict(out[0], ref[0], f32,
                                  f"{tier} decode step, {name} weights, "
                                  f"kernels vs plain quantized functions")
    del p32
    return ok


def phase_w8a16_logits(cfg, qparams, prompt):
    """One decode step of the w8a16 tree after a prefill of prompt, at
    full depth, through the kernels and through the plain functions
    (_plain_serving: #25's plain version, the plain attention, paged
    attention, norms and RoPE) on copies of the same cache: bf16 as served
    (rel RMS <= E2E_BF16_REL) and f32 (max abs <= E2E_F32_ATOL), each with
    _logits_verdict's argmax rule."""
    from tpukern_torch.models import params_to, serving

    dev = qparams["embed"].device
    tokens = torch.from_numpy(prompt[None]).to(dev)
    ok = True
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        p = qparams if dt == torch.bfloat16 else params_to(qparams, dt)
        c = dataclasses.replace(cfg, param_dtype=dt)
        cache = serving.init_cache(c, 1, 8, 128, dtype=dt, device=dev)
        logits, cache = serving.prefill(p, c, tokens, cache)
        tok = logits.argmax(-1).to(torch.int32)
        copy = dataclasses.replace(cache, **{
            k: getattr(cache, k).clone() for k in ("k_pages", "v_pages",
                                                   "lengths")})
        out, _ = serving.decode_step(p, c, tok, cache)
        with _plain_serving():
            ref, _ = serving.decode_step(p, c, tok, copy)
        ok &= _logits_verdict(out[0], ref[0], dt == torch.float32,
                              f"w8a16 decode step, {name}, kernels vs "
                              f"plain w8a16 functions")
    return ok


_CATEGORIES = (("cross_entropy", ("ce_fwd_", "ce_combine_kernel",
                                  "ce_bwd_", "ce_dlog_", "ce_dx_", "ce_dw_")),
               ("split-TF32 pass", "split_tf32_kernel"),
               ("rms_norm", "rms_norm_kernel"),
               ("rope", ("rope_cached_kernel", "rope_batched_kernel")),
               ("fa_fwd", "fa_fwd_"),
               ("fa_bwd", ("fa_bwd_tf32_kernel", "fa_dq_tf32_kernel",
                           "fa_dkv_tf32_kernel", "fa_dq_kernel",
                           "fa_dkv_kernel")),
               ("paged_attention", "paged_decode_kernel"),
               ("paged_quant", "paged_quant_kernel"),
               ("quantize", "quantize_kernel"),
               ("paged_prefill", "paged_prefill_"),
               ("sampling", ("sample_kernel", "sample_combine_kernel",
                             "threshold_kernel")),
               ("w8a16", "w8a16_"),
               ("grouped_gemm", ("gmm_tf32_kernel", "tgmm_tf32_kernel",
                                 "gmm_wgmma_kernel", "tgmm_bf16_kernel")),
               ("gemm (port)", ("gemm_tf32_kernel", "hgemm_wgmma_kernel")),
               ("gemm (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma")),
               ("memcpy/memset", ("Memcpy", "Memset")))


def _category(name):
    for cat, keys in _CATEGORIES:
        if any(k in name for k in ((keys,) if isinstance(keys, str)
                                   else keys)):
            return cat
    return "other"


def _profile(label, fn, n):
    """Device time of n calls of fn by kernel category (torch.profiler),
    and the device's busy share of the span from first kernel start to
    last kernel end (the profiler's own host cost lowers it). Returns
    (busy ms, {category: ms}) per call, or None without device events."""
    ev = _device_events(fn, n)
    if not ev:
        print(f"[profile] {label}: no device events; device time not "
              "measured")
        return None
    busy, cur_s, cur_e = 0.0, ev[0][0], ev[0][1]
    for s, e, _ in ev[1:]:
        if s > cur_e:
            busy, cur_s = busy + cur_e - cur_s, s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e for _, e, _ in ev) - ev[0][0]
    cats, names = {}, {}
    for s, e, name in ev:
        cats[_category(name)] = cats.get(_category(name), 0.0) + e - s
        names[name] = names.get(name, 0.0) + e - s
    print(f"[profile] {label}: {len(ev) / n:.0f} device ops per call, "
          f"busy {busy / n / 1e3:.3f} ms of a {span / n / 1e3:.3f} ms span "
          f"per call (busy share {busy / span:.3f})")
    print(f"[profile] {label} by category, ms per call: " + ", ".join(
        f"{c} {t / n / 1e3:.3f}" for c, t in
        sorted(cats.items(), key=lambda kv: -kv[1])))
    for name, t in sorted(names.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[profile] {label}   {t / n / 1e3:.4f} ms  {name[:90]}")
    return busy / n / 1e3, {c: t / n / 1e3 for c, t in cats.items()}


def phase_profile(cfg, params, requests, qparams):
    """Where the device time goes: one 512-bucket admission and 8 decode
    steps of 4 active slots, greedy on bf16, int8 and fp8 pools, with the
    w8a16 weights (qparams) and sampled (SAMPLE_T with top_p 0.9, and with
    top_k 50), one chunked admission (chunked_prefill=256) and 2
    speculative rounds (gamma 4, the 2-layer draft) of 4 slots, each under
    torch.profiler."""
    from tpukern_torch.models.batcher import (ContinuousBatcher,
                                              SpeculativeBatcher)

    cb = ContinuousBatcher(params, cfg, **SERVE_KW)
    for rid, prompt in requests[1:4]:
        cb.add_request(rid, prompt)
    cb.step()
    rid, prompt = requests[0]
    _profile(f"prefill (T={len(prompt)}, bucket 512)",
             lambda: cb.add_request(rid, prompt), 1)
    _profile("decode step (4 slots)", cb.step, 8)
    for tier in ("int8", "fp8"):
        cq = ContinuousBatcher(params, cfg, cache_dtype=QUANT_SERVE[tier][0],
                               **SERVE_KW)
        for r, p in requests[:4]:
            cq.add_request(r, p)
        cq.step()
        _profile(f"{tier} decode step (4 slots)", cq.step, 8)
    del cq
    cw = ContinuousBatcher(qparams, cfg, **SERVE_KW)
    for r, p in requests[:4]:
        cw.add_request(r, p)
    cw.step()
    prof = _profile("w8a16 decode step (4 slots)", cw.step, 8)
    print("[w8a16] decode step (4 slots), device time from the profiler: "
          + ("not measured" if prof is None else
             f"#25 {prof[1].get('w8a16', 0.0):.4f} ms of {prof[0]:.4f} ms "
             "busy a step"))
    del cw
    for tag, kw in (("top_p 0.9", dict(top_p=0.9)),
                    ("top_k 50", dict(top_k=50))):
        cb = ContinuousBatcher(params, cfg, greedy=False,
                               temperature=SAMPLE_T, **kw, **SERVE_KW)
        for r, p in requests[:4]:
            cb.add_request(r, p)
        cb.step()
        _profile(f"sampled decode step (4 slots, T {SAMPLE_T}, {tag})",
                 cb.step, 8)
    cb = ContinuousBatcher(params, cfg, chunked_prefill=256, **SERVE_KW)
    _profile(f"chunked admission (T={len(prompt)}, 2 chunks of 256)",
             lambda: cb.add_request(rid, prompt), 1)
    sb = SpeculativeBatcher(params, cfg, dict(params,
                                              layers=params["layers"][:2]),
                            dataclasses.replace(cfg, n_layers=2),
                            gamma=GAMMA, **SERVE_KW)
    for rid, prompt in requests[:4]:
        sb.add_request(rid, prompt)
    sb.step()
    _profile("speculative round (4 slots, 2-layer draft)", sb.step, 2)
    shared = _prefix_requests(cfg, 2)
    cb = ContinuousBatcher(params, cfg, prefix_cache=True, **SERVE_KW)
    cb.add_request(*shared[0])
    _profile(f"prefix-cache hit admission (T={len(shared[1][1])}, 512 "
             "shared)", lambda: cb.add_request(*shared[1]), 1)


def _plain_prefill_logits(params, cfg, tokens, last=None):
    """Logits of a prompt with the plain functions only, with cfg's
    window, sinks and softcap: of the last token (vocab,), or of the last
    `last` tokens (last, vocab)."""
    from tpukern_torch.ops.attention import attention_ref
    from tpukern_torch.ops.rmsnorm import rms_norm_ref
    from tpukern_torch.ops.rope import make_cos_sin, rope_cached_ref

    T, D, Hq, Hkv = len(tokens), cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    cos, sin = make_cos_sin(T, D, device="cuda")
    h = params["embed"][tokens]

    def heads(x, n):
        x = x.reshape(T, n, D).transpose(0, 1).reshape(n * T, D)
        x = rope_cached_ref(x, cos.repeat(n, 1), sin.repeat(n, 1))
        return x.reshape(1, n, T, D)

    for lp in params["layers"]:
        hn = rms_norm_ref(h, lp["ln1"])
        q, k = heads(hn @ lp["wq"], Hq), heads(hn @ lp["wk"], Hkv)
        v = (hn @ lp["wv"]).reshape(T, Hkv, D).transpose(0, 1)[None]
        o = attention_ref(q, k, v, causal=True, window=cfg.window,
                          sinks=cfg.sinks, softcap=cfg.softcap
                          )[0].transpose(0, 1)
        h = h + o.reshape(T, -1) @ lp["wo"]
        hn = rms_norm_ref(h, lp["ln2"])
        h = h + torch.nn.functional.gelu(hn @ lp["w1"],
                                         approximate="tanh") @ lp["w2"]
    rows = h[-1] if last is None else h[-last:]
    return (rms_norm_ref(rows, params["lnf"]) @ params["head"]).float()


def _logits_verdict(out, ref, f32, label):
    """phase_logits's rule for kernel logits `out` against plain f32
    logits `ref` (vocab,): finite; max abs <= E2E_F32_ATOL (f32) or
    relative RMS <= E2E_BF16_REL (bf16); and the argmax is the plain one
    or a token whose plain logit is within the path's max error of the
    plain maximum. Prints one line; returns ok."""
    err = (out - ref).abs().max().item()
    rel = ((out - ref).norm() / ref.norm()).item()
    am = int(out.argmax())
    gap = (ref.max() - ref[am]).item()
    if f32:
        passed, tol = err <= E2E_F32_ATOL, f"max_abs <= {E2E_F32_ATOL:g}"
    else:
        passed, tol = rel <= E2E_BF16_REL, f"rel_rms <= {E2E_BF16_REL:g}"
    passed &= gap <= err and bool(torch.isfinite(out).all())
    print(f"[logits] {label}: max_abs {err:.3e} rel_rms {rel:.3e} argmax "
          f"{am} vs {int(ref.argmax())} (ref gap {gap:.3e}) {tol} "
          f"{'ok' if passed else 'MISS'}")
    return passed


def phase_logits(cfg, params, prompt):
    """One prefill through the kernels (bf16 as served, and f32) against
    the plain functions in f32 on the same card; then, at full depth in
    bf16, one verify_step of 5 tokens after that prefill, plain and with
    the Gemma-2-style window, sinks and softcap, every position against
    the plain functions over the whole sequence."""
    from tpukern_torch.models import params_to, serving

    f32cfg = dataclasses.replace(cfg, param_dtype=torch.float32)
    p32 = params_to(params, torch.float32)
    tokens = torch.from_numpy(prompt).to("cuda")
    ref = _plain_prefill_logits(p32, f32cfg, tokens.long())
    ok = bool(torch.isfinite(ref).all())
    for name, c, p, dt in (("f32", f32cfg, p32, torch.float32),
                           ("bf16", cfg, params, torch.bfloat16)):
        cache = serving.init_cache(c, 1, 8, 128, dtype=dt, device="cuda")
        logits, _ = serving.prefill(p, c, tokens[None], cache)
        out = logits[0]
        require(out.shape == (cfg.vocab,) and bool(torch.isfinite(out).all()),
                f"{name} logits of shape {tuple(out.shape)} not finite")
        ok &= _logits_verdict(out, ref, name == "f32",
                              f"{name} kernels vs f32 plain, T={len(prompt)}")
    # a prompt longer than the window, so the Gemma-2-style band moves
    tokens = torch.cat([tokens, tokens.flip(0)])
    new = torch.from_numpy(np.random.default_rng(SEED + 6).integers(
        0, cfg.vocab, (1, 5))).to("cuda", torch.int32)
    whole = torch.cat([tokens, new[0]]).long()
    for tag, feat in (("plain", {}), ("gemma2", GEMMA2)):
        c = dataclasses.replace(cfg, **feat)
        cache = serving.init_cache(c, 1, 8, 128, device="cuda")
        _, cache = serving.prefill(params, c, tokens[None], cache)
        out, cache = serving.verify_step(params, c, new, cache)
        require(out.shape == (1, 5, cfg.vocab)
                and int(cache.lengths[0]) == len(tokens) + 5,
                f"verify_step gave {tuple(out.shape)}, {cache.lengths}")
        ref = _plain_prefill_logits(
            p32, dataclasses.replace(f32cfg, **feat), whole, last=5)
        for t in range(5):
            ok &= _logits_verdict(out[0, t], ref[t], False,
                                  f"bf16 verify_step {tag} position "
                                  f"{len(tokens) + t} vs f32 plain")
    return ok


def _plain_greedy(params, cfg, prompt, n):
    """n greedy tokens of prompt with the plain functions only, the whole
    sequence recomputed for each token."""
    seq = torch.from_numpy(prompt).to("cuda").long()
    out = []
    for _ in range(n):
        tok = int(_plain_prefill_logits(params, cfg, seq).argmax())
        out.append(tok)
        seq = torch.cat([seq, seq.new_tensor([tok])])
    return out


def phase_exact(cfg, requests):
    """Token-exact checks in f32 at the 7bish widths cut to 2 layers (in
    bf16, argmax near-ties differ between kernels): chunked against
    unchunked admission, the prefix cache on against off, SpeculativeBatcher
    (a 1-layer draft, and the target as its own draft, which must accept
    every proposal) and speculative_generate against ContinuousBatcher,
    windowed serving (GEMMA2, unchunked and chunked) against greedy
    decoding with the plain functions, the int8 tier's paths, w8a16
    through the kernels against the plain functions, ring pools against
    flat pools, and SpeculativeBatcher on a ring against ContinuousBatcher
    on a ring."""
    from tpukern_torch.models import (ContinuousBatcher, SpeculativeBatcher,
                                      init_params, serving,
                                      speculative_generate)

    c2 = dataclasses.replace(cfg, n_layers=2, param_dtype=torch.float32)
    params = init_params(c2, torch.Generator(device="cuda").manual_seed(
        SEED + 4), device="cuda")
    draft = dict(params, layers=params["layers"][:1])
    dcfg = dataclasses.replace(c2, n_layers=1)
    n_new = 16
    kw = dict(SERVE_KW, max_new_tokens=n_new, cache_dtype=torch.float32)
    shared = _prefix_requests(cfg)
    ok = True

    def same(label, a, b):
        nonlocal ok
        good = a == b
        ok &= good
        print(f"[exact] {label}: {sum(len(v) for v in a.values())} tokens "
              f"{'equal' if good else 'DIFFER'}")
        if not good:
            print(f"[exact]   {a}\n[exact]   {b}")

    base = ContinuousBatcher(params, c2, **kw).run(requests)
    same("chunked_prefill=256 vs unchunked", ContinuousBatcher(
        params, c2, chunked_prefill=256, **kw).run(requests), base)
    same("prefix_cache on vs off", ContinuousBatcher(
        params, c2, prefix_cache=True, **kw).run(shared),
        ContinuousBatcher(params, c2, **kw).run(shared))
    same("SpeculativeBatcher (1-layer draft) vs ContinuousBatcher",
         SpeculativeBatcher(params, c2, draft, dcfg, gamma=GAMMA,
                            **kw).run(requests), base)
    sb = SpeculativeBatcher(params, c2, params, c2, gamma=GAMMA, **kw)
    short = _short_rounds(sb, requests)
    same("SpeculativeBatcher (self-draft) vs ContinuousBatcher", sb.finished,
         base)
    ok &= short == 0
    print(f"[exact] self-draft: acceptance {sb.stats.acceptance_rate:.4f}, "
          f"{sb.stats.rounds} rounds, {short} of them with fewer than gamma "
          f"+ 1 = {GAMMA + 1} tokens for a slot {'ok' if not short else 'MISS'}")
    rid, prompt = requests[0]
    out = speculative_generate(params, c2, draft, dcfg,
                               torch.from_numpy(prompt[None]).to("cuda"),
                               n_new, gamma=GAMMA, pages_per_seq=8,
                               cache_dtype=torch.float32)
    same("speculative_generate vs ContinuousBatcher",
         {rid: out[0].tolist()}, {rid: base[rid]})
    gcfg = dataclasses.replace(c2, **GEMMA2)
    ref = {rid: _plain_greedy(params, gcfg, p, n_new) for rid, p in shared}
    for chunk in (None, 256):
        same(f"{GEMMA2} chunked_prefill={chunk} vs plain greedy",
             ContinuousBatcher(params, gcfg, chunked_prefill=chunk,
                               **kw).run(shared), ref)

    # int8 pools, each comparison between paths of one function: a whole
    # prompt's prefill attends over the unquantized K/V (as JAX's does), a
    # chunk or a prefix hit over the quantized pool. So chunked admission
    # is held against other chunk sizes (over the prompts longer than
    # both), the prefix cache against chunked admission without it (the
    # 512 shared tokens are two chunks of 256 on both sides), speculation
    # against whole-prompt decoding; chunked against whole admission is
    # printed, not required
    k8 = dict(kw, cache_dtype=torch.int8)
    long = [(r, p) for r, p in requests if len(p) > 256]
    c256 = ContinuousBatcher(params, c2, chunked_prefill=256, **k8).run(long)
    same("int8 chunked_prefill=256 vs 128", c256, ContinuousBatcher(
        params, c2, chunked_prefill=128, **k8).run(long))
    same("int8 prefix_cache on vs off, chunked_prefill=256",
         ContinuousBatcher(params, c2, prefix_cache=True, chunked_prefill=256,
                           **k8).run(shared),
         ContinuousBatcher(params, c2, chunked_prefill=256, **k8).run(shared))
    base8 = ContinuousBatcher(params, c2, **k8).run(requests)
    same("int8 SpeculativeBatcher (1-layer draft) vs ContinuousBatcher",
         SpeculativeBatcher(params, c2, draft, dcfg, gamma=GAMMA,
                            **k8).run(requests), base8)
    print(f"[exact] int8 chunked_prefill=256 against whole admission (not "
          f"one function): leading tokens equal "
          f"{_agreement(c256, {r: base8[r] for r, _ in long})} of {n_new}; "
          f"int8 against f32 pools: "
          f"{_agreement(base8, base)} of {n_new}")

    # w8a16 through the kernels against the plain functions; ring pools
    # against flat pools over streams that wrap the ring (JAX's own
    # property, tests/test_batcher.py:378), and speculation on a ring
    qp = serving.quantize_model_weights(params)
    w8 = ContinuousBatcher(qp, c2, **kw).run(requests)
    with _plain_serving():
        w8_plain = ContinuousBatcher(qp, c2, **kw).run(requests)
    same("w8a16 kernels vs w8a16 plain functions", w8, w8_plain)
    print(f"[exact] w8a16 against f32 weights: leading tokens equal "
          f"{_agreement(w8, base)} of {n_new}")
    g2, gd = (dataclasses.replace(c, **GEMMA2) for c in (c2, dcfg))
    rreq = _ring_requests(cfg)
    rkw = dict(kw, max_new_tokens=96, prompt_buckets=(640,))
    ring = ContinuousBatcher(params, g2, ring=True,
                             **dict(rkw, pages_per_seq=5)).run(rreq)
    same(f"ring pools (5 pages) vs flat pools (8), {GEMMA2}, 560-620 + 96 "
         f"tokens", ring, ContinuousBatcher(params, g2, **rkw).run(rreq))
    same("SpeculativeBatcher on a ring vs ContinuousBatcher on a ring",
         SpeculativeBatcher(params, g2, draft, gd, gamma=GAMMA, ring=True,
                            **dict(rkw, pages_per_seq=5)).run(rreq), ring)
    return ok


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).to("cuda")
            for _ in range(2))


def _train_label(cfg):
    dt = "" if cfg.param_dtype == torch.float32 else "bf16 parameters, "
    if cfg.window is not None:
        return f"{dt}window {cfg.window} softcap {cfg.softcap:g}"
    return dt + ("fused loss" if cfg.fused_loss else "unfused loss")


def phase_train(cfg, B, S, steps=5):
    """A training main path: `steps` Adam steps of make_train_step on
    one seeded batch (the same parameters and batch for the unfused and
    the fused loss and the window and softcap); launch counts reset just
    before and read just after; then one more step under the profiler.
    With a window the backward must take the two featured kernels, one
    launch of each per layer and step, and never the fused one; without,
    the fused one once per layer and step (its f32 tier: with bf16
    parameters too, matmul_t writes the f32 accumulator, as JAX's does,
    so attention runs on f32 q, k, v). Returns the launches, the losses
    and dict(ms, tokens_s, peak_gib)."""
    from tpukern_torch.models import init_params, make_train_step, param_leaves
    from tpukern_torch.ops import (attention, attention_bwd, cross_entropy,
                                   matmul, rmsnorm, rope, split_tf32)

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                         device="cuda")
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_()
    n_params = sum(t.numel() for t in leaves)
    opt = torch.optim.Adam(leaves, lr=TRAIN_LR, eps=1e-8)
    step = make_train_step(cfg, opt)
    tokens, targets = _batch(cfg, B, S, SEED)
    ops = [matmul.matmul, split_tf32.split_tf32, rope.rope_batched,
           attention.flash_attention, attention_bwd.flash_attention_bwd,
           rmsnorm.rms_norm]
    if cfg.fused_loss:
        ops += [cross_entropy.ce_fwd, cross_entropy.ce_bwd]
    featured = cfg.window is not None or cfg.softcap is not None
    if featured:
        ops += [attention_bwd.flash_attention_dq,
                attention_bwd.flash_attention_dkv]
    label = _train_label(cfg)
    for op in ops:
        op.launches = 0
    attention_bwd.flash_attention_bwd.bf16_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step(params, tokens, targets)
        losses.append(loss.item())  # synchronises
        ms.append(1e3 * (time.perf_counter() - t0))
    launches = {op.__name__: op.launches for op in ops}
    med = float(np.median(ms[1:]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[train] 7bish {str(cfg.param_dtype)[6:]}, {label}, "
          f"{cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f} B parameters, Adam lr {TRAIN_LR:g}, B={B} "
          f"S={S}; peak device memory {peak:.2f} GiB")
    print(f"[train] {label} losses {[round(x, 6) for x in losses]}")
    print(f"[train] {label} step ms {[round(x, 3) for x in ms]}; median of "
          f"steps 2-{steps} {med:.3f} ms = {B * S / med * 1e3:.1f} tokens/s")
    print(f"[train] {label} launches {launches}; #8's bf16 tier "
          f"{attention_bwd.flash_attention_bwd.bf16_launches}")
    require(all(np.isfinite(losses)), f"losses not finite: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    if featured:
        fused_bwd = launches.pop("flash_attention_bwd")
        require(fused_bwd == 0, f"the fused backward launched {fused_bwd} "
                "times under a window/softcap")
        per_run = cfg.n_layers * steps
        require(all(launches[n] == per_run for n in (
            "flash_attention", "flash_attention_dq", "flash_attention_dkv")),
            f"not {per_run} launches of each attention kernel: {launches}")
    else:
        per_run = cfg.n_layers * steps
        require(launches["flash_attention_bwd"] == per_run,
                f"not {per_run} launches of the fused backward: {launches}")
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the training path never launched: {launches}")
    launches["flash_attention_bwd_bf16"] = (
        attention_bwd.flash_attention_bwd.bf16_launches)
    _profile(f"train step ({label})",
             lambda: step(params, tokens, targets).item(), 1)
    return launches, losses, dict(ms=med, tokens_s=B * S / med * 1e3,
                                  peak_gib=peak)


def _plain_loss(params, tokens, targets, cfg):
    """loss_fn with the plain functions only, for torch.autograd; with
    cfg.fused_loss the head and loss are cross_entropy_ref; with
    cfg.n_experts each FFN is _plain_moe."""
    from tpukern_torch.ops.attention import attention_ref
    from tpukern_torch.ops.cross_entropy import cross_entropy_ref
    from tpukern_torch.ops.matmul import matmul_ref
    from tpukern_torch.ops.rmsnorm import rms_norm_ref
    from tpukern_torch.ops.rope import rope_batched_ref

    B, S = tokens.shape
    d, D, Hq, Hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    def heads(x, n, rotate=True):
        x = x.reshape(B, S, n, D).transpose(1, 2)
        if rotate:
            x = rope_batched_ref(x.reshape(B * n * S, D), S)
        return x.reshape(B, n, S, D)

    h = params["embed"][tokens]
    for lp in params["layers"]:
        hn = rms_norm_ref(h, lp["ln1"]).reshape(B * S, d)
        q = heads(matmul_ref(hn, lp["wq"]), Hq)
        k = heads(matmul_ref(hn, lp["wk"]), Hkv)
        v = heads(matmul_ref(hn, lp["wv"]), Hkv, rotate=False)
        o = attention_ref(q, k, v, causal=True, window=cfg.window,
                          softcap=cfg.softcap).transpose(1, 2)
        h = h + matmul_ref(o.reshape(B * S, d), lp["wo"]).reshape(B, S, d)
        hn = rms_norm_ref(h, lp["ln2"]).reshape(B * S, d)
        if cfg.n_experts:
            h = h + _plain_moe(hn, lp["moe"], cfg).reshape(B, S, d)
            continue
        u = torch.nn.functional.gelu(matmul_ref(hn, lp["w1"]),
                                     approximate="tanh")
        h = h + matmul_ref(u, lp["w2"]).reshape(B, S, d)
    hn = rms_norm_ref(h, params["lnf"]).reshape(B * S, d)
    if cfg.fused_loss:
        return cross_entropy_ref(hn, params["head"], targets.reshape(-1)
                                 ).mean()
    logits = matmul_ref(hn, params["head"])
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.reshape(-1, 1)).mean()


def phase_train_parity(cfg, S):
    """One loss-and-grad through the kernels against _plain_loss, at the
    7bish (or Mixtral) widths with 2 layers, B=1, f32, on the same card;
    with cfg.fused_loss also the fused against the unfused kernel loss;
    with cfg.window and cfg.softcap the plain loss masks and caps alike.
    With cfg.n_experts both runs record their routing: the (token,
    choice) routings that part between them are counted, and the loss and
    gradient bounds hold when none part (a routing can part only where a
    router's top-k gap lies within the f32 difference of the layers
    below; then the line says so, and the [moe-dropless] and [gmm] checks
    decide)."""
    import dataclasses
    from tpukern_torch.models import init_params, loss_fn, param_leaves

    cfg = dataclasses.replace(cfg, n_layers=2)
    label = _train_label(cfg)
    widths = "Mixtral widths MoE" if cfg.n_experts else "7bish widths"
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED + 2), device="cuda")
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_()
    tokens, targets = _batch(cfg, 1, S, SEED + 2)
    out, routes = {}, {}
    for name, fn in (("kernels", loss_fn), ("plain", _plain_loss)):
        with _routes() as rec:
            loss = fn(params, tokens, targets, cfg)
            out[name] = (loss.detach(), torch.autograd.grad(loss, leaves))
        routes[name] = [top for top, _ in rec]
    parted = sum(int((a != b).sum()) for a, b in zip(routes["kernels"],
                                                     routes["plain"]))
    if cfg.n_experts:
        n = sum(t.numel() for t in routes["kernels"])
        print(f"[parity] {widths}: {parted} of {n} (token, choice) routings "
              "part between the kernel run and the plain run"
              + ("" if parted == 0 else "; the loss and gradient bounds do "
                 "not apply, the [moe-dropless] and [gmm] checks decide"))
    (lk, gk), (lp, gp) = out["kernels"], out["plain"]
    loss_rel = ((lk - lp).abs() / lp.abs()).item()
    ok = bool(torch.isfinite(lk)) and (loss_rel <= TRAIN_LOSS_REL
                                       or parted > 0)
    print(f"[parity] {widths}, 2 layers, B=1 S={S} f32, {label} loss: "
          f"loss kernels {lk.item():.7f} plain {lp.item():.7f} rel "
          f"{loss_rel:.3e} (<= {TRAIN_LOSS_REL:g}) {'ok' if ok else 'MISS'}")
    if cfg.fused_loss:
        with torch.no_grad():
            lu = loss_fn(params, tokens, targets,
                         dataclasses.replace(cfg, fused_loss=False))
        print(f"[parity] fused kernel loss {lk.item():.7f} unfused kernel "
              f"loss {lu.item():.7f} rel {((lk - lu).abs() / lu.abs()).item():.3e}")

    def names(prefix, tree):
        return [n for k, v in tree.items() for n in (
            names(f"{prefix}{k}.", v) if isinstance(v, dict)
            else [f"{prefix}{k}"])]

    worst = 0.0
    for name, a, b in zip(["embed"] + names("layers.", dict(enumerate(
            params["layers"]))) + ["lnf", "head"], gk, gp):
        rel = ((a - b).norm() / b.norm()).item()
        worst = max(worst, rel)
        good = bool(torch.isfinite(a).all()) and (rel <= TRAIN_GRAD_REL
                                                  or parted > 0)
        ok &= good
        print(f"[parity]   grad {name:20s} rel_rms {rel:.3e} "
              f"{'ok' if good else 'MISS'}")
    print(f"[parity] {label} worst gradient rel_rms {worst:.3e} "
          f"(<= {TRAIN_GRAD_REL:g}) {'ok' if ok else 'MISS'}")
    return ok


# ------------------------------------------------------------------ MoE
# Mixtral-8x7B's published widths (mistralai/Mixtral-8x7B-v0.1
# config.json: hidden 4096, 32/8 heads of 128, expert width 14336, 8
# experts, 2 a token, vocabulary 32000) in the JAX Config's MoE (GELU
# experts of two matrices, RoPE theta 10000, capacity factor 2.0), f32 as
# the training path, cut to 2 layers: with Adam one layer is 981.5 M
# parameters (15.7 GB at 16 B each), and 2 layers with the embedding and
# head about 35.6 GB before activations, the deepest whole-layer cut that
# leaves room on 80 GB
MIXTRAL = dict(vocab=32000, d_model=4096, n_layers=2, n_heads=32,
               n_kv_heads=8, d_ff=14336, max_seq=2048, n_experts=8,
               moe_top_k=2, moe_capacity_factor=2.0)
MOE_B, MOE_S = 2, 2048  # T = 4096 tokens, C = 2048 slots an expert
MOE_PARITY_S = 1024
# the grouped GEMM's own bench shape (T, K, N; bench/ops.py:166-178) and
# the five splits of tools/gmm_tune.py:136-142 (E 8)
GMM_BENCH = (8192, 2048, 1408)
GMM_SPLITS = {"balanced": [1024] * 8,
              "skewed_2x": [2048, 2048, 1024, 1024, 512, 512, 512, 512],
              "hot_expert": [4096, 1536, 1024, 512, 512, 256, 128, 128],
              "two_empty": [2048, 0, 2560, 2048, 0, 1024, 256, 256],
              "one_hot": [8192, 0, 0, 0, 0, 0, 0, 0]}
# the CASES of tests/test_grouped_matmul.py:32-41 (T, K, N, sizes):
# boundaries inside a block, empty groups, E = 1, one group over many
# blocks, sum < T, all groups in one block
GMM_CASES = [(256, 128, 128, [64, 64, 64, 64]),
             (256, 128, 128, [37, 91, 3, 125]),
             (256, 128, 128, [0, 200, 0, 56]),
             (256, 128, 128, [256]),
             (512, 128, 128, [500, 7, 5]),
             (256, 128, 128, [10, 20, 30, 40]),
             (192, 256, 384, [64, 0, 65, 0, 63]),
             (64, 128, 128, [8] * 8)]
# #29 with NaN in the TGMM_NAN_ROWS rows past the groups: last slabs of
# 37, 63, 1, 1 and 20 rows starting off a 64-row boundary (65 and 129
# leave 1), x and dy by TMA (K 128, N 136) and copied (K 130, N 201)
TGMM_NAN_SIZES = [37, 63, 65, 1, 129, 20]
TGMM_NAN_ROWS = 14
TGMM_NAN_KN = ((128, 136), (130, 201))
GMM_LIBRARY = ("torch._grouped_mm (bf16 only: f32 has no grouped call, so "
               "the f32 rows have none; the bf16 times are in the [time] "
               "lines)")


def _gmm_inputs(gen, T, K, N, sizes, dt):
    """x (T, K), w (E, K, N) scaled so each product is of unit size, dy
    (T, N) scaled by the largest group's rows, the int32 sizes."""
    f32 = torch.float32
    x = _randn(gen, T, K, dtype=f32).to(dt)
    w = (_randn(gen, len(sizes), K, N, dtype=f32) / K ** 0.5).to(dt)
    dy = (_randn(gen, T, N, dtype=f32) / max(max(sizes), 1) ** 0.5).to(dt)
    return x, w, dy, torch.tensor(sizes, dtype=torch.int32, device="cuda")


def _gmm_work(sizes, T, K, N, dt, kind):
    """(flops, bytes) of one grouped product on these sizes: 2 Σgs K N
    operations; the live rows of x, the live groups' W slabs (gmm) or dy's
    live rows (tgmm), and the output, once each."""
    es = torch.empty(0, dtype=dt).element_size()
    rows, live = sum(sizes), sum(s > 0 for s in sizes)
    if kind == "tgmm":
        nbytes = es * (rows * K + rows * N + len(sizes) * K * N)
    else:
        nbytes = es * (rows * K + live * K * N + T * N)
    return 2 * rows * K * N, nbytes + 4 * len(sizes)


def _grouped_mm(kind, x, w, dy, gs):
    """The one PyTorch call of each product (bf16), or None with the
    reason printed: torch._grouped_mm over the cumulative offsets."""
    from functools import partial

    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    args = {"gmm": (x, w), "gmm trans_w": (dy, w.transpose(1, 2)),
            "tgmm": (x.t(), dy)}[kind]
    fn = partial(torch._grouped_mm, *args, offs=offs)
    try:
        fn()
    except (RuntimeError, AttributeError, TypeError) as e:
        print(f"[library] torch._grouped_mm {kind}: does not run here "
              f"({type(e).__name__}: {str(e)[:160]}); library_ms none")
        return None
    return fn


def _gmm_check(checks, kind, case, x, w, dy, gs):
    """One call of #28 (kind "gmm", "gmm trans_w") or #29 ("tgmm")
    against its plain version: the live rows (gmm) or every slab (tgmm)
    at the dtype's tolerance; zeros past sum(group_sizes) and in an empty
    group's slab."""
    from tpukern_torch.ops import grouped_matmul as gm

    live = int(gs.sum())
    if kind == "tgmm":
        out, ref = gm.tgmm(x, dy, gs), gm.tgmm_ref(x, dy, gs)
        zero = out[gs == 0]
    else:
        trans = kind == "gmm trans_w"
        a = dy if trans else x
        out, ref = (gm.gmm(a, w, gs, trans_w=trans),
                    gm.gmm_ref(a, w, gs, trans_w=trans))
        zero = out[live:]
        out, ref = out[:live], ref[:live]
    ok, err = _compare(kind, case, out, ref, dtype=x.dtype)
    if kind != "tgmm":
        from collections import Counter

        items = Counter(p for _, _, _, p in gm.gmm_items(
            a, w, gs.tolist(), trans_w=trans))
        # N tiles of 256 columns in bf16, 128 in f32
        n_tiles = -(-out.shape[1] // (256 if x.dtype == torch.bfloat16
                                      else 128))
        print(f"[gmm] {kind} {case}: items by path "
              f"{ {('zeros' if p is None else p): n for p, n in items.items()} }"
              f" in each of {n_tiles} N tiles")
    if zero.numel() and zero.abs().max().item() != 0:
        print(f"[check] {kind:16s} {case}: rows or slabs outside every "
              "group are not zero MISS")
        ok = False
    checks.record("tgmm" if kind == "tgmm" else "gmm", ok, err)


def _tgmm_nan_check(checks, gen, K, N, dt):
    """#29 on TGMM_NAN_SIZES with NaN in every x and dy row past
    sum(group_sizes): each dW finite and within the dtype's tolerance of
    tgmm_ref; prints the bf16 slab plan (tgmm_slabs' paths)."""
    from collections import Counter

    from tpukern_torch.ops import grouped_matmul as gm

    sizes = TGMM_NAN_SIZES
    T = sum(sizes) + TGMM_NAN_ROWS
    x, _, dy, gs = _gmm_inputs(gen, T, K, N, sizes, dt)
    x[-TGMM_NAN_ROWS:] = float("nan")
    dy[-TGMM_NAN_ROWS:] = float("nan")
    out = gm.tgmm(x, dy, gs)
    case = f"NaN past the groups T{T} K{K} N{N} {sizes} {dt}"
    ok, err = _compare("tgmm", case, out, gm.tgmm_ref(x, dy, gs), dtype=dt)
    if not torch.isfinite(out).all():
        print(f"[check] tgmm             {case}: a dW is not finite MISS")
        ok = False
    if dt == torch.bfloat16:
        plan = Counter(p for slabs in gm.tgmm_slabs(x, dy, sizes)
                       for _, _, p in slabs)
        print(f"[tgmm] {case}: slabs by path {dict(plan)}")
    checks.record("tgmm", ok, err)


# #28's work items at their edges: groups of 1, 127, 129 and 255 rows off
# a 128-row boundary, an empty group, GMM_NAN_ROWS rows past the groups
# holding NaN in x and dy; (K, N) that put the operands on every load
# path (NN: tma, mixed (x copied), mixed (W copied), copy; trans_w, whose
# operands' rows are both N wide: tma, tma, copy, copy)
GMM_ITEM_SIZES = [1, 127, 129, 255, 37, 0, 300]
GMM_NAN_ROWS = 20
GMM_EDGE_KN = ((128, 136), (130, 136), (128, 130), (130, 130))
# NaN in every W[e + 1] after a live group e (its own group empty): no
# element of it may enter group e's sum, at K 130 and 136 (a short last
# slab, W by TMA from the 3-D map at N 136)
GMM_NAN_W_SIZES = [100, 0, 160, 0]


def _gmm_edge_checks(checks, gen, dt, tag):
    """#28 (NN and trans_w) at GMM_ITEM_SIZES on every load path with NaN
    past the groups (exact zeros there, the rest finite and within the
    dtype's tolerance), then with NaN in the W[e + 1] that follow live
    groups (GMM_NAN_W_SIZES)."""
    nan = float("nan")
    sizes, live = GMM_ITEM_SIZES, sum(GMM_ITEM_SIZES)
    for K, N in GMM_EDGE_KN:
        x, w, dy, gs = _gmm_inputs(gen, live + GMM_NAN_ROWS, K, N, sizes, dt)
        x[live:] = nan
        dy[live:] = nan
        for kind in ("gmm", "gmm trans_w"):
            _gmm_check(checks, kind, f"edges NaN past the groups K{K} N{N} "
                       f"{tag}", x, w, dy, gs)
    for K in (130, 136):
        x, w, dy, gs = _gmm_inputs(gen, 300, K, 136, GMM_NAN_W_SIZES, dt)
        w[1] = nan
        w[3] = nan
        for kind in ("gmm", "gmm trans_w"):
            _gmm_check(checks, kind, f"NaN W[e + 1] K{K} N136 {tag}", x, w,
                       dy, gs)


def _gmm_gate(checks, gen, cases):
    """The accuracy gate of #28/#29's f32 tier (split-TF32 products): at
    each (label, T, K, N, sizes), for the forward (gmm NN), dx (gmm
    trans_w) and dW (tgmm), the largest error of the kernel and of the
    plain loop (gmm_ref/tgmm_ref: cuBLAS f32 a group, TF32 off) against
    the f64 grouped product of the same inputs (the live rows), the
    kernel's at most SPLIT_GATE times the plain loop's; a second call
    gives the same bits."""
    from tpukern_torch.ops import grouped_matmul as gm

    require(not torch.backends.cuda.matmul.allow_tf32,
            "the gate needs cuBLAS f32 with TF32 off")
    f64 = torch.float64
    for label, T, K, N, sizes in cases:
        x, w, dy, gs = _gmm_inputs(gen, T, K, N, sizes, torch.float32)
        live = sum(sizes)
        calls = {
            "forward": (lambda: gm.gmm(x, w, gs), gm.gmm_ref, x, w),
            "dx": (lambda: gm.gmm(dy, w, gs, trans_w=True), gm.gmm_ref, dy,
                   w.transpose(1, 2)),
            "dW": (lambda: gm.tgmm(x, dy, gs), gm.tgmm_ref, x, dy)}
        for what, (fn, ref, a, b) in calls.items():
            name = "tgmm" if what == "dW" else "gmm"
            out = fn()
            exact = ref(a.double(), b.double(), gs, dtype=f64)
            plain = ref(a, b, gs)
            if name == "gmm":
                out, exact, plain = out[:live], exact[:live], plain[:live]
            err = (out.double() - exact).abs().max().item()
            ref_err = (plain.double() - exact).abs().max().item()
            del exact, plain
            case = f"{label} {what} {T}x{K}x{N} f32"
            checks.record(name, _gate(name, case, err, ref_err,
                                      ref="plain f32"), 0.0)
            again = fn()
            checks.record(name, *_same_bits(
                name, case, out, again[:live] if name == "gmm" else again))
            gate = checks.results[name].setdefault("f64_gate", {})
            gate[case] = dict(kernel=err, plain=ref_err)
            del out, again
        del x, w, dy
        torch.cuda.empty_cache()


def phase_moe_kernels():
    """[gmm]/[tgmm]: #28 (NN and trans_w) and #29 against gmm_ref/tgmm_ref
    in f32 and bf16 at the Mixtral expert products (T·k = 8192 balanced
    rows: w1 K 4096 N 14336, w2 K 14336 N 4096, their dx and dW), at the
    bench shape under the five splits and at the test CASES; the f32
    tier's accuracy gate (_gmm_gate) at the Mixtral products, the bench
    shape's balanced and one_hot splits and two CASES; times at the
    first two beside the plain version, the bound (f32: split-TF32
    products, the f32 FMAs' beside it) and torch._grouped_mm (bf16).
    Returns {kernel: dict(max_abs_err, ms, ...)} and all-ok."""
    from functools import partial

    from tpukern_torch.harness import ops_bench
    from tpukern_torch.ops import grouped_matmul as gm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    checks, timed = _Checks(), {}
    d, ff, E = MIXTRAL["d_model"], MIXTRAL["d_ff"], MIXTRAL["n_experts"]
    rows = MOE_B * MOE_S * MIXTRAL["moe_top_k"]

    def kernel_of(kind, x, w, dy, gs):
        if kind == "tgmm":
            return (partial(gm.tgmm, x, dy, gs), partial(gm.tgmm_ref, x, dy,
                                                         gs))
        trans = kind == "gmm trans_w"
        a = dy if trans else x
        return (partial(gm.gmm, a, w, gs, trans_w=trans),
                partial(gm.gmm_ref, a, w, gs, trans_w=trans))

    def entry(key, kind, inputs, sizes, T, K, N, dt, light=False):
        x, w, dy, gs = inputs
        kernel, plain = kernel_of(kind, x, w, dy, gs)
        lib = (_grouped_mm(kind, x, w, dy, gs) if dt == torch.bfloat16
               else None)
        if kind == "gmm trans_w":  # x is dy here: (T, N) · W[e]ᵀ -> (T, K)
            K, N = N, K
        flops, nbytes = _gmm_work(sizes, T, K, N, dt, kind.split()[0])
        f32 = dt == torch.float32
        timed[key] = _timed_entry(
            "tgmm" if kind == "tgmm" else "gmm", [T, K, N, len(sizes)],
            kernel, plain, lib, {ops_bench.SPLIT_TF32: flops} if f32
            else flops, nbytes, dt, light=light, fma=flops if f32 else None)
        if lib is not None:
            ref = plain()
            got = lib()
            if kind != "tgmm":
                ref, got = ref[:sum(sizes)], got[:sum(sizes)]
            print(f"[library] torch._grouped_mm {key}: max_abs "
                  f"{(got.float() - ref).abs().max().item():.3e} against "
                  "the plain version")

    for dt in (torch.float32, torch.bfloat16):
        tag = "f32" if dt == torch.float32 else "bf16"
        sizes = [rows // E] * E
        # w1: x (rows, d) · W1 (E, d, ff); w2: h (rows, ff) · W2 (E, ff, d)
        for name, K, N in (("w1", d, ff), ("w2", ff, d)):
            inputs = _gmm_inputs(gen, rows, K, N, sizes, dt)
            for kind, what in (("gmm", "forward"), ("gmm trans_w", "dx"),
                               ("tgmm", "dW")):
                case = f"Mixtral {name} {what} {rows}x{K}x{N} E{E} {tag}"
                _gmm_check(checks, kind, case, *inputs)
                entry(f"{kind} Mixtral {name} {tag}", kind, inputs, sizes,
                      rows, K, N, dt, light=True)
            del inputs
        T, K, N = GMM_BENCH
        for split, sizes in GMM_SPLITS.items():
            inputs = _gmm_inputs(gen, T, K, N, sizes, dt)
            for kind in ("gmm", "gmm trans_w", "tgmm"):
                _gmm_check(checks, kind, f"{split} {T}x{K}x{N} {tag}",
                           *inputs)
                if kind != "gmm trans_w" or split == "balanced":
                    entry(f"{kind} {split} {tag}", kind, inputs, sizes, T, K,
                          N, dt)
        for T, K, N, sizes in GMM_CASES:
            inputs = _gmm_inputs(gen, T, K, N, sizes, dt)
            for kind in ("gmm", "gmm trans_w", "tgmm"):
                _gmm_check(checks, kind, f"T{T} K{K} N{N} {sizes} {tag}",
                           *inputs)
        _gmm_edge_checks(checks, gen, dt, tag)
        for K, N in TGMM_NAN_KN:
            _tgmm_nan_check(checks, gen, K, N, dt)
    T, K, N = GMM_BENCH
    _gmm_gate(checks, gen, [
        ("Mixtral w1", rows, d, ff, [rows // E] * E),
        ("Mixtral w2", rows, ff, d, [rows // E] * E),
        *((f"bench {split}", T, K, N, GMM_SPLITS[split])
          for split in ("balanced", "one_hot")),
        *((f"case {sizes}", T_, K_, N_, sizes)
          for T_, K_, N_, sizes in (GMM_CASES[1], GMM_CASES[6]))])
    torch.cuda.synchronize()
    _time_kernels(timed, checks.results)
    return checks.results, checks.ok


@contextlib.contextmanager
def _routes():
    """While open, every moe_dispatch call (the capacity tier's routing)
    records its top-k experts (T, k) and the number of assignments it
    kept, as device tensors: instrumentation of this script only."""
    from tpukern_torch.models import moe

    dispatch, rec = moe.moe_dispatch, []

    def recorded(x, params, *, k=1, e_total=None, **kw):
        E = e_total or params["w1"].shape[0]
        with torch.no_grad():
            probs = torch.softmax((x @ params["router"][:, :E]).float(), -1)
            top = torch.topk(probs, k, dim=-1).indices
        slots, combine = dispatch(x, params, k=k, e_total=e_total, **kw)
        rec.append((top, (combine > 0).sum()))
        return slots, combine

    moe.moe_dispatch = recorded
    try:
        yield rec
    finally:
        moe.moe_dispatch = dispatch


def _drop_share(rec, k):
    routed = sum(top.shape[0] * k for top, _ in rec)
    kept = sum(int(n) for _, n in rec)
    return 1.0 - kept / routed, kept, routed


def phase_moe_train(cfg, B, S, steps=5):
    """[moe-train]: `steps` Adam steps of make_train_step at the Mixtral
    widths (2 layers, f32) on one seeded batch, launch counts reset just
    before and read just after: the capacity-dispatch path, whose expert
    products are matmul launches; #28/#29 must not launch. Then one step
    under the profiler. Returns layer 0's moe weights (detached copies,
    for [moe-dropless]), the launches, the losses and dict(ms, tokens_s,
    peak_gib, drop_share)."""
    from tpukern_torch.models import init_params, make_train_step, param_leaves
    from tpukern_torch.models.moe import expert_capacity
    from tpukern_torch.ops import (attention, attention_bwd, grouped_matmul,
                                   matmul, rmsnorm, rope, split_tf32)

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED + 5), device="cuda")
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_()
    n_params = sum(t.numel() for t in leaves)
    opt = torch.optim.Adam(leaves, lr=TRAIN_LR, eps=1e-8)
    step = make_train_step(cfg, opt)
    tokens, targets = _batch(cfg, B, S, SEED + 5)
    ops = [matmul.matmul, split_tf32.split_tf32, rope.rope_batched,
           attention.flash_attention,
           attention_bwd.flash_attention_bwd, rmsnorm.rms_norm,
           grouped_matmul.gmm, grouped_matmul.tgmm]
    for op in ops:
        op.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    with _routes() as rec:
        for _ in range(steps):
            t0 = time.perf_counter()
            loss = step(params, tokens, targets)
            losses.append(loss.item())  # synchronises
            ms.append(1e3 * (time.perf_counter() - t0))
    launches = {op.__name__: op.launches for op in ops}
    med = float(np.median(ms[1:]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    share, kept, routed = _drop_share(rec, cfg.moe_top_k)
    C = expert_capacity(B * S, cfg.n_experts, cfg.moe_top_k,
                        cfg.moe_capacity_factor)
    print(f"[moe-train] Mixtral widths f32, {cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f} B parameters, {cfg.n_experts} experts top-"
          f"{cfg.moe_top_k}, capacity factor {cfg.moe_capacity_factor:g} "
          f"(C = {C} slots an expert), Adam lr {TRAIN_LR:g}, B={B} S={S}; "
          f"peak device memory {peak:.2f} GiB")
    print(f"[moe-train] losses {[round(x, 6) for x in losses]}")
    print(f"[moe-train] step ms {[round(x, 3) for x in ms]}; median of steps "
          f"2-{steps} {med:.3f} ms = {B * S / med * 1e3:.1f} tokens/s")
    print(f"[moe-train] routed assignments dropped: {routed - kept} of "
          f"{routed} ({share:.4f}) over {len(rec)} dispatches")
    print(f"[moe-train] launches {launches}")
    require(all(np.isfinite(losses)), f"MoE losses not finite: {losses}")
    require(losses[-1] < losses[0], f"MoE loss did not fall: {losses}")
    grouped = {n: launches.pop(n) for n in ("gmm", "tgmm")}
    require(not any(grouped.values()), f"capacity dispatch launched "
            f"#28/#29: {grouped}")
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the MoE training path never launched: {launches}")
    _profile("MoE train step (Mixtral widths, 2 layers)",
             lambda: step(params, tokens, targets).item(), 1)
    moe0 = {k: v.detach().clone() for k, v in
            params["layers"][0]["moe"].items()}
    launches.update(grouped)
    return moe0, launches, losses, dict(ms=med, tokens_s=B * S / med * 1e3,
                                        peak_gib=peak, drop_share=share)


def _dropless_run(x, mp, k, use_kernel):
    """moe_block_dropless and the grads of mean(out²) for x, router, w1,
    w2 (examples/moe_grouped_gemm.py:73-79)."""
    from tpukern_torch.models.moe import moe_block_dropless

    out = moe_block_dropless(x, mp, k=k, use_kernel=use_kernel)
    grads = torch.autograd.grad((out ** 2).mean(),
                                [x, mp["router"], mp["w1"], mp["w2"]])
    return out.detach(), grads


def phase_moe_dropless(mp, cfg, T):
    """[moe-dropless]: moe_block_dropless(use_kernel=True) on layer 0's moe
    weights of [moe-train], T tokens of d, k = cfg.moe_top_k: forward and
    the grads of mean(out²), with #28's 2 forward, 2 trans_w and #29's 2
    launches a call (and, f32, the split-TF32 operand passes' 2 a
    launch, printed); out and the grads of x, router, w1, w2 against
    use_kernel=False (plain ragged products) on the same input; ms
    forward and forward plus backward of both; 3 Adam steps of the layer;
    then once with a router biased so that one expert takes half the
    tokens. Counts reset at the start and read at the end. Returns the
    phase's launches and all-ok."""
    from tpukern_torch.harness import run_benchmark
    from tpukern_torch.models.moe import moe_block_dropless
    from tpukern_torch.ops import grouped_matmul as gm
    from tpukern_torch.ops import split_tf32

    k, d, E = cfg.moe_top_k, cfg.d_model, cfg.n_experts
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    # unit-scale hidden states: a normed layer input, whose grad a layer
    # inside a model needs (so the first product's dx launches too)
    x = _randn(gen, T, d, dtype=torch.float32).requires_grad_()
    mp = {n: v.detach().clone().requires_grad_() for n, v in mp.items()}
    # expert 0's logit gains 100 (x . u) for a unit u: it leads for the
    # half of the tokens with x . u > 0 and drops out for the rest
    u = _randn(gen, d, dtype=torch.float32)
    router = mp["router"].detach().clone()
    router[:, 0] += 100.0 * u / u.norm()
    hot = dict(mp, router=router.requires_grad_())
    for op in (gm.gmm, gm.tgmm, split_tf32.split_tf32):
        op.launches = 0
    gm.gmm.trans_w_launches = 0
    ok = True

    def counts():
        return (gm.gmm.launches - gm.gmm.trans_w_launches,
                gm.gmm.trans_w_launches, gm.tgmm.launches,
                split_tf32.split_tf32.launches)

    for label, params in (("router as trained", mp), ("hot expert", hot)):
        probs = torch.softmax((x.detach() @ params["router"].detach()
                               ).float(), -1)
        sizes = torch.bincount(torch.topk(probs, k).indices.reshape(-1),
                               minlength=E).tolist()
        before = counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out, grads = _dropless_run(x, params, k, True)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        per_call = tuple(a - b for a, b in zip(counts(), before))
        good = per_call[:3] == (2, 2, 2)
        print(f"[moe-dropless] {label}: T={T} d={d} k={k}, group sizes "
              f"{sizes}; launches a forward plus backward: gmm {per_call[0]},"
              f" gmm trans_w {per_call[1]}, tgmm {per_call[2]} "
              f"{'ok' if good else 'MISS (want 2, 2, 2)'}; split-TF32 "
              f"operand passes {per_call[3]}; peak device memory "
              f"{peak:.2f} GiB")
        ok &= good
        rout, rgrads = _dropless_run(x, params, k, False)
        good, err = _compare("moe_dropless", f"{label} out vs plain", out,
                             rout)
        ok &= good
        for name, a, b in zip(("x", "router", "w1", "w2"), grads, rgrads):
            rel = ((a - b).norm() / b.norm()).item()
            good = bool(torch.isfinite(a).all()) and rel <= TRAIN_GRAD_REL
            ok &= good
            print(f"[moe-dropless]   {label} grad {name:6s} rel_rms "
                  f"{rel:.3e} (<= {TRAIN_GRAD_REL:g}) "
                  f"{'ok' if good else 'MISS'}")
        xd = x.detach()
        times = {}
        for tag, uk in (("kernels", True), ("plain", False)):
            with torch.no_grad():
                fwd = run_benchmark(lambda: moe_block_dropless(
                    xd, params, k=k, use_kernel=uk), **LIGHT["bench"])
            both = run_benchmark(lambda: _dropless_run(x, params, k, uk),
                                 **LIGHT["bench"])
            times[tag] = (fwd, both)
        print(f"[moe-dropless] {label} ms forward / forward plus backward: "
              f"kernels {times['kernels'][0]:.3f} / {times['kernels'][1]:.3f}"
              f", plain {times['plain'][0]:.3f} / {times['plain'][1]:.3f}")
    opt = torch.optim.Adam([mp["router"], mp["w1"], mp["w2"]], lr=TRAIN_LR,
                           eps=1e-8)
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss = (moe_block_dropless(x.detach(), mp, k=k, use_kernel=True)
                ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    good = bool(np.all(np.isfinite(losses)))
    ok &= good
    print(f"[moe-dropless] 3 Adam steps of the layer (lr {TRAIN_LR:g}), "
          f"mean(out²) {[f'{v:.6e}' for v in losses]} "
          f"{'ok' if good else 'MISS'}")
    launches = dict(gmm=gm.gmm.launches, tgmm=gm.tgmm.launches,
                    trans_w=gm.gmm.trans_w_launches,
                    split_tf32=split_tf32.split_tf32.launches)
    print(f"[moe-dropless] launches over the phase {launches}")
    require(launches["gmm"] > 0 and launches["tgmm"] > 0,
            f"the dropless path never launched #28/#29: {launches}")
    return launches, ok


def _plain_moe(h, mp, cfg):
    """moe_block_topk from plain functions: the same dispatch (plain torch
    in the port), matmul_ref for each expert's two products."""
    from tpukern_torch.models import moe
    from tpukern_torch.ops.matmul import matmul_ref

    x_slots, combine = moe.moe_dispatch(
        h, mp, k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor)
    ys = torch.stack([matmul_ref(F.gelu(matmul_ref(x_slots[e], mp["w1"][e]),
                                        approximate="tanh"), mp["w2"][e])
                      for e in range(mp["w1"].shape[0])])
    return torch.einsum("tec,ecd->td", combine, ys.float()).to(h.dtype)

# [zoo]: the op-family zoo through the port's registry. The families of
# this slice's kernels, timed and held against their plain versions, and
# the families of earlier slices newly registered (checked only: their
# kernels are timed in the phases above). Each variant maps to the kernels
# it launches (none: a torch baseline).
ZOO_FAMILIES = ["elementwise", "relu", "elu", "gelu", "swish", "sigmoid",
                "hardswish", "hardshrink", "reduce", "dot_product", "rope",
                "rms_norm", "matmul", "softmax", "layer_norm", "embedding",
                "transpose", "histogram", "gemv", "nms"]
ZOO_REGISTERED = ["attention", "paged_attention", "quant", "cross_entropy",
                  "sampling", "grouped_matmul", "matmul_w8a16"]
ZOO_KERNELS = ("ew_call", "reduce_all", "dot_prod", "matmul_naive", "rope",
               "matmul_kpipe", "softmax_per_token", "online_softmax_per_token",
               "softmax_grid_stats", "softmax_grid_norm", "softmax_grid_fused",
               "layer_norm",
               "embedding_prefetch", "embedding_dma", "embedding_onehot",
               "histogram", "transpose", "nms_keep", "gemv")
# the variant (or the call) whose times each zoo kernel's row of the
# kernels line keeps
ZOO_ROW = {"ew_call": "elementwise.add_f32_r256",
           "reduce_all": "reduce.sum_f32_f32_r256",
           "dot_prod": "dot_product.dot_f32_f32_r64",
           "matmul_naive": "matmul.sgemm_naive_f32", "rope": "rope.rope_f32",
           "matmul_kpipe": "kpipe torch.float32",
           "softmax_per_token": "softmax.softmax_safe_f32_per_token",
           "online_softmax_per_token": "softmax.softmax_online_f32_per_token",
           "softmax_grid_stats": "softmax_grid_stats torch.float32",
           "softmax_grid_norm": "softmax_grid_norm torch.float32",
           "softmax_grid_fused": "softmax.softmax_online_f32_grid",
           "layer_norm": "layer_norm.layer_norm_f32_r8",
           "embedding_prefetch": "embedding.embedding_prefetch_f32",
           "embedding_dma": "embedding.embedding_dma_f32",
           "embedding_onehot": "embedding.embedding_onehot_f32",
           "histogram": "histogram.histogram_i32",
           "transpose": "transpose.transpose_f32_row",
           "nms_keep": "nms_keep alone", "gemv": "gemv.gemv_f32_k_full"}
ZOO_TIMING = dict(warmup=2, iters=20, reps=1, flush_l2=True)
# 4095 x 4097 = 2^24 - 1 elements: a tail past the last whole vector in
# every tier of #30 (1, 3 and 7 elements) and in #31/#32's 16-byte packs;
# rows of #33-#37 that are no whole 16-byte packs
ZOO_TAIL = (4095, 4097)
# the families checked at ZOO_TAIL too: #30-#32's, softmax's, layer_norm's,
# the transpose's (a ragged tile edge both ways) and gemv's (a K tail in
# every block_k); softmax and layer_norm also at ops_bench.Size().sampling's
# 64 x 131072, rows wider than #33's and #37's shared memory
ZOO_TAILED = ZOO_FAMILIES[:10] + ["softmax", "layer_norm", "transpose",
                                  "gemv"]
ZOO_WIDE = ("softmax", "layer_norm")
# the gathers' odd shape (V, D, S): rows of 509 elements, no whole 16-byte
# chunks in bf16 or f32, an odd vocabulary, S a multiple of #39's 8
# tokens; #40 is also checked at ops_bench.Size().onehot_vocab, and
# timed at both vocabularies
ZOO_GATHER_ODD = (32767, 509, 8184)
# #16 beyond the ladder's 4096^3 (both operands by TMA in bf16): (M, N,
# K) of each bf16 load path, checked in both dtypes; the first (ZOO_TAIL
# as a product: K and N no multiple of 8) also timed
ZOO_NAIVE_PATHS = {"copy": (4095, 4095, 4097), "mixed": (4096, 4097, 4096)}
# #2's bf16 variant timed on the copy path at ZOO_TAIL (the whole bf16
# ladder is checked there)
ZOO_GEMM_COPY_TIMED = "hgemm_ksliced_bf16"
# #16's f32 tier also checked and timed at these n^3, beside the ladder's
# 4096^3: whether the power-of-two row stride is what costs there. cuBLAS
# sums 4104-term rows in another order than the kernel's (1.07e-3 apart
# at 4104^3 on an H100), so these are held to the f64 product with the
# contraction slack (ops_bench.contraction_slack), as a grouped product is
ZOO_NAIVE_STRIDES = (4088, 4104)
# the redesigned kernels (#16 on TMA + wgmma, #40 as a row selection),
# whose every timed call goes into the kernels line beside the row's
ZOO_REDESIGNED = ("matmul_naive", "embedding_onehot")
# histogram #41 beyond the bench input (2^20 values in 256 bins): (values,
# bins, low, high) of values uniform in [low, high), out of range both
# ways; a 2^26-value call (the bench's 4 MiB call is mostly launch); and
# the bench input with every value in one bin (the atomics' contention)
ZOO_HIST_ODD = (2 ** 20 - 1, 1000, -5, 1006)
ZOO_HIST_LARGE = 2 ** 26
# nms #43 checked at these box counts (a tenth of the boxes in pairs at an
# IoU of exactly 0.5, kept only by the strict >), and its kernel timed
# alone at the bench size on boxes sorted by score
ZOO_NMS_CHECKED = (1000, 4000)
# the grid softmax variant timed on #35 then #36 (the wide rows)
ZOO_GRID_WIDE = "softmax.softmax_online_f32_grid 64x131072 (#35, #36)"
# the cluster kernel (#35 + #36 in one launch) against its plain version:
# (rows, cols, block_cols), ncb 1, 3, 8, 9 and 16 tiles a row, odd
# columns (no whole 16-byte packs in bf16 at 1300, in either dtype at
# 4001 and 4097) and the bench shape; each also with a row of -inf and a
# row whose last tile (of several) is -inf
ZOO_FUSED_SHAPES = ((300, 500, 512), (1000, 1300, 512), (129, 4001, 512),
                    (129, 4097, 512), (100, 8192, 512), (4096, 4096, 512))


def _zoo_fns():
    from tpukern_torch.ops import (_ew, dot_product, embedding, gemv,
                                   histogram, layernorm, matmul, nms, reduce,
                                   rope, transpose)
    from tpukern_torch.ops import softmax as sm
    return {"ew_call": _ew.ew_call, "reduce_all": reduce._reduce_all,
            "dot_prod": dot_product.dot_prod,
            "matmul_naive": matmul.matmul_naive, "rope": rope.rope,
            "matmul_kpipe": matmul.matmul_kpipe,
            "softmax_per_token": sm.softmax_per_token,
            "online_softmax_per_token": sm.online_softmax_per_token,
            "softmax_grid_stats": sm.grid_stats,
            "softmax_grid_norm": sm.grid_norm,
            "softmax_grid_fused": sm.grid_fused,
            "layer_norm": layernorm.layer_norm,
            "embedding_prefetch": embedding.embedding_prefetch,
            "embedding_dma": embedding.embedding_dma,
            "embedding_onehot": embedding.embedding_onehot,
            "histogram": histogram.histogram,
            "transpose": transpose.transpose, "nms_keep": nms.nms_keep,
            "gemv": gemv.gemv}


def _zoo_kernels(v, shape=None):
    """The kernels (ZOO_KERNELS names or an earlier slice's) that variant v
    launches at shape (default: ops_bench.Size()'s S x K): none for a
    torch baseline; the grid softmax one cluster launch or #35 then #36,
    by softmax.grid_plan."""
    if "baseline" in v.tags:
        return ()
    if v.family in ZOO_FAMILIES[:8]:
        return ("ew_call",)
    if v.family in ("reduce", "dot_product"):
        return ("reduce_all",) if v.family == "reduce" else ("dot_prod",)
    if v.family == "rope":
        return ("rope_cached",) if v.name.endswith("cached") else ("rope",)
    if v.family == "matmul":
        return ("matmul_naive",) if "naive" in v.name else ("matmul",)
    if v.family == "softmax":
        if v.name.endswith("_global"):
            return ("reduce_all", "ew_call")
        if v.name.endswith("_grid"):
            from tpukern_torch.harness import ops_bench
            from tpukern_torch.ops import softmax as sm
            size = ops_bench.Size()
            rows, cols = shape or (size.S, size.K)
            if sm.grid_plan(rows, cols).path == "cluster":
                return ("softmax_grid_fused",)
            return ("softmax_grid_stats", "softmax_grid_norm")
        return (("online_softmax_per_token",) if "_online_" in v.name
                else ("softmax_per_token",))
    if v.family == "embedding":  # embedding_<design>_<dtype>
        return (v.name.rsplit("_", 1)[0],)
    if v.family == "nms":
        return ("nms_keep",)
    return (v.family,)


def _zoo_made(fns, before):
    """{kernel: launches} of the zoo kernels launched since the counts were
    `before`."""
    return {n: f.launches - before[n] for n, f in fns.items()
            if f.launches != before[n]}


def _zoo_library(v, args):
    """The one PyTorch call of v's function on args, or None."""
    fam, a = v.family, args
    calls = {"add": torch.add, "mul": torch.mul, "relu": torch.relu,
             "sigmoid": torch.sigmoid, "elu": F.elu, "swish": F.silu,
             "hardswish": F.hardswish,
             "gelu": lambda x: F.gelu(x, approximate="tanh"),
             "hardshrink": lambda x: F.hardshrink(x, lambd=0.5)}
    op = v.name.split("_")[0]
    if op in calls:
        return lambda: calls[op](*a)
    if fam == "reduce":
        acc = {"f32": torch.float32, "f16": torch.float16,
               "bf16": torch.bfloat16, "i32": torch.int32}[v.name.split("_")[2]]
        if a[0].dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            return None  # torch has no sum or max of fp8
        if op == "max":
            return lambda: torch.amax(a[0])
        return lambda: torch.sum(a[0], dtype=acc)
    if fam == "dot_product":
        return lambda: torch.dot(a[0].reshape(-1), a[1].reshape(-1))
    if fam == "matmul" and "_tn_" in v.name:
        return lambda: torch.matmul(a[0], a[1].T)
    if fam == "matmul":
        return lambda: torch.matmul(*a)
    if fam == "rms_norm":
        return lambda: F.rms_norm(a[0], (a[0].shape[-1],), eps=1e-5)
    if fam == "softmax" and v.name.endswith("_global"):
        return lambda: torch.softmax(a[0].reshape(-1), 0)
    if fam == "softmax":
        return lambda: torch.softmax(a[0], -1)
    if fam == "layer_norm":
        return lambda: F.layer_norm(a[0], (a[0].shape[-1],), eps=1e-5)
    if fam == "embedding":
        return lambda: F.embedding(*a)
    if fam == "transpose":
        return lambda: a[0].t().contiguous()
    if fam == "histogram":  # int64 counts; the data lies in range
        return lambda: torch.bincount(a[0], minlength=a[1])
    if fam == "gemv":
        return lambda: torch.mv(*a)
    return None


def _zoo_grid_calls(gen, size):
    """#35 and #36 alone at size.S x size.K f32 with their default tiles
    (64 x 512): [(name, kernel, plain, args, bytes)] for the timing loop.
    #35 reads x and writes the partials; #36 reads x and the partials and
    writes y."""
    from tpukern_torch.ops import softmax as sm
    x = _randn(gen, size.S, size.K, dtype=torch.float32)
    m, d = sm.grid_stats(x)
    return [("softmax_grid_stats", sm.grid_stats, sm.grid_stats_ref, (x,),
             _nbytes(x, m, d)),
            ("softmax_grid_norm", sm.grid_norm, sm.grid_norm_ref, (x, m, d),
             _nbytes(x, m, d, x))]


def _zoo_gathers(checks, gen):
    """Each embedding variant against its plain version, bit for bit
    (torch.equal), at ZOO_GATHER_ODD and on indices outside [0, V) (past
    the end, -1, -V, -V - 1, int32's ends) at the bench shape, and once
    with those indices as int64 under sync debug mode "error" (the int32
    cast and the launch read nothing back); #40 also at the one-hot
    bench vocabulary (ops_bench.Size().onehot_vocab) with all S tokens,
    on indices outside [0, V) too. Returns #40's timed calls at V."""
    from functools import partial

    from tpukern_torch.core import registry
    from tpukern_torch.harness import ops_bench

    V, D, S = ops_bench.Size().embedding
    Vo, Do, So = ZOO_GATHER_ODD
    Vh = ops_bench.Size().onehot_vocab

    def ints(hi, n):
        return torch.randint(0, hi, (n,), generator=gen, device="cuda",
                             dtype=torch.int32)

    def outside(idx, V):
        far = torch.tensor([V, V + 7, -1, -V, -V - 1, 2 ** 31 - 1,
                            -2 ** 31], dtype=torch.int32, device="cuda")
        oob = idx.clone()
        oob[::idx.numel() // 8][:far.numel()] = far
        return oob

    timed = []
    for name, v in sorted(registry.variants("embedding").items()):
        dt = torch.bfloat16 if name.endswith("bf16") else torch.float32
        w = _randn(gen, V, D, dtype=dt)
        idx = ints(V, S)
        oob = outside(idx, V)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out64 = v.fn(oob.long(), w)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        io, wo = ints(Vo, So), _randn(gen, Vo, Do, dtype=dt)
        cases = [(f"V {V} D {D} S {S}", idx, w, v.fn(idx, w)),
                 ("outside [0, V)", oob, w, v.fn(oob, w)),
                 ("int64, no host sync", oob, w, out64),
                 (f"odd V {Vo} D {Do} S {So}", io, wo, v.fn(io, wo))]
        if "_onehot_" in name:
            wh = _randn(gen, Vh, D, dtype=dt)
            oh = outside(ints(Vh, S), Vh)
            cases.append((f"V {Vh} outside [0, V)", oh, wh, v.fn(oh, wh)))
            timed.append((f"embedding.{name} V {V}", _zoo_kernels(v),
                          partial(v.fn, idx, w), partial(v.ref, idx, w),
                          partial(F.embedding, idx, w),
                          partial(ops_bench.work, v, (idx, w))))
        for case, i, ww, out in cases:
            ref = v.ref(i, ww)
            ok = out.shape == ref.shape and torch.equal(out, ref)
            err = ((out.double() - ref.double()).abs().max().item()
                   if out.shape == ref.shape else float("inf"))
            print(f"[zoo] gather {name:24s} {case:28s} max_abs {err:.3e} "
                  f"(bit-equal) {'ok' if ok else 'MISS'}")
            checks.record(_zoo_kernels(v)[0], ok, err)
        del wo
    return timed


def _zoo_memory_ops(checks, gen, timed):
    """histogram #41 (both kernel variants) against its plain version at
    ZOO_HIST_ODD, ZOO_HIST_LARGE and with every value in one bin, the last
    two timed; nms #43 at ZOO_NMS_CHECKED boxes (kept indices equal, every
    threshold-exact pair's second box kept), and its kernel alone at the
    bench size, timed."""
    from functools import partial

    from tpukern_torch.core import registry
    from tpukern_torch.harness import ops_bench
    from tpukern_torch.ops import nms

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device="cuda",
                             dtype=torch.int32)

    n, bins = ops_bench.Size().hist
    n_odd, bins_odd, lo, hi = ZOO_HIST_ODD
    cases = [(f"{n_odd} values {bins_odd} bins, {lo} to {hi - 1}",
              ints(lo, hi, n_odd), bins_odd),
             (f"one bin, {n} values",
              torch.full((n,), 7, dtype=torch.int32, device="cuda"), bins),
             (f"{ZOO_HIST_LARGE} values {bins} bins",
              ints(0, bins, ZOO_HIST_LARGE), bins)]
    for name in ("histogram_i32", "histogram_i32_r128"):
        v = registry.get("histogram", name)
        for k, (case, x, b) in enumerate(cases):
            ok, err, rule = ops_bench.check(v, (x, b))
            print(f"[zoo] histogram.{name:20s} {case:36s} max_abs {err:.3e} "
                  f"({rule}) {'ok' if ok else 'MISS'}")
            checks.record("histogram", ok, err)
            if k:
                timed.append((f"histogram.{name} {case}", ("histogram",),
                              partial(v.fn, x, b), partial(v.ref, x, b),
                              partial(torch.bincount, x, minlength=b),
                              partial(ops_bench.work, v, (x, b))))
    for n_boxes in ZOO_NMS_CHECKED:
        pairs = n_boxes // 10
        boxes, scores = ops_bench.nms_boxes(n_boxes, gen, exact_pairs=pairs)
        out, ref = nms.nms(boxes, scores), nms.nms_plain(boxes, scores)
        kept = set(out.tolist())
        ok = (torch.equal(out, ref)
              and set(range(n_boxes - pairs, n_boxes)) <= kept)
        err = float((out != ref).sum().item())
        print(f"[zoo] nms {n_boxes} boxes, {pairs} pairs at IoU 0.5: "
              f"{len(kept - {-1})} kept, {err:.0f} indices differ (equal, "
              f"pairs kept) {'ok' if ok else 'MISS'}")
        checks.record("nms_keep", ok, err)
    n_boxes = ops_bench.Size().nms
    boxes, scores = ops_bench.nms_boxes(n_boxes, gen)
    ordered = boxes[torch.argsort(-scores, stable=True)]
    keep, ref = nms.nms_keep(ordered), nms.nms_keep_plain(ordered)
    ok = torch.equal(keep, ref)
    print(f"[zoo] nms_keep alone, {n_boxes} sorted boxes: "
          f"{int(keep.sum())} kept {'ok' if ok else 'MISS'}")
    checks.record("nms_keep", ok, float((keep != ref).sum().item()))
    # the bound: nms.py:26-38's 14 operations on each of the N^2 pairs;
    # the boxes read, the int32 flags written
    timed.append(("nms_keep alone", ("nms_keep",),
                  partial(nms.nms_keep, ordered),
                  partial(nms.nms_keep_plain, ordered), None,
                  lambda _: (14 * n_boxes ** 2, torch.float32,
                             _nbytes(ordered) + 4 * n_boxes)))


def _zoo_ew_tiers(checks, gen):
    """#30's every op at ZOO_TAIL elements, aligned and in a view 2
    elements off: the tiers of a dtype compute each element by one f32
    formula, so all give the same bits;
    add, mul and relu also equal the plain version bit for bit, the
    others within TOLS of it."""
    from tpukern_torch.harness import ops_bench
    from tpukern_torch.ops import _ew

    n = ZOO_TAIL[0] * ZOO_TAIL[1]
    base = _randn(gen, 2, n + 2, dtype=torch.float32)
    for dt in (torch.float32, torch.bfloat16):
        b = base.to(dt)
        for view, xs in (("aligned", [b[0, :n], b[1, :n]]),
                         ("2 elements off", [b[0, 2:], b[1, 2:]])):
            for op, (_, nargs, _) in _ew.OPS.items():
                args, sc = xs[:nargs], ()
                if op in ("exp_sub", "div"):  # softmax_global's scalar
                    args, sc = xs[:1], (b[0, :7].float().abs().sum() + 1,)
                ref = _ew.ew_ref(op, *args, scalars=sc)
                outs = [_ew.ew_call(op, *args, scalars=sc, vec=vec)
                        for vec in _ew._VECS[dt]]
                same = all(torch.equal(o, outs[0]) for o in outs)
                err = (outs[0].double() - ref.double()).abs().max().item()
                exact = op in ("add", "mul", "relu")
                rtol, atol = ops_bench.TOLS[dt]
                close = bool((outs[0].double() - ref.double()).abs().le(
                    atol + rtol * ref.double().abs()).all())
                ok = same and (torch.equal(outs[0], ref) if exact else close)
                print(f"[zoo] ew {op:10s} {str(dt):15s} {view:14s} "
                      f"{len(outs)} tier calls bit-equal {same}; against "
                      f"the plain version max_abs {err:.3e} "
                      f"({'bit-equal' if exact else f'rtol {rtol:g}'}) "
                      f"{'ok' if ok else 'MISS'}")
                checks.record("ew_call", ok, err)


def _zoo_grid_fused(checks, gen):
    """The cluster kernel (softmax.grid_fused) against its plain version
    grid_fused_ref at ZOO_FUSED_SHAPES in f32 and bf16
    (ops_bench.softmax_check on the finite rows, the NaN rows of an all
    -inf row where the plain version has them), called twice (bit for
    bit); prints its plan and cudaOccupancyMaxActiveClusters at the bench
    shape."""
    from tpukern_torch.harness import ops_bench
    from tpukern_torch.ops import softmax as sm

    for dt in (torch.float32, torch.bfloat16):
        R, smem, active, launched = sm.fused_plan(4096, 4096, dt)
        print(f"[zoo] cluster kernel {dt} 4096x4096: {R} rows a block of "
              f"{sm.grid_plan(4096, 4096).ncb} "
              f"tiles, {smem} shared bytes a block, "
              f"cudaOccupancyMaxActiveClusters {active}, {launched} "
              f"clusters launched")
        require(active > 0, f"[zoo] no cluster of the {dt} kernel fits")
        for rows, cols, bc in ZOO_FUSED_SHAPES:
            x = 3 * torch.randn(rows, cols, generator=gen, device="cuda")
            x[rows // 2] = -torch.inf
            if cols > bc:
                x[rows // 3, (cols - 1) // bc * bc:] = -torch.inf
            x = x.to(dt)
            out, again = sm.grid_fused(x, block_cols=bc), sm.grid_fused(
                x, block_cols=bc)
            ref = sm.grid_fused_ref(x, bc)
            nan = ref.float().isnan().any(-1)
            ok, err, rule = ops_bench.softmax_check(out[~nan], ref[~nan], dt)
            ok &= torch.equal(out.isnan(), ref.isnan())
            same = torch.equal(out.isnan(), again.isnan()) and torch.equal(
                out.nan_to_num(), again.nan_to_num())
            print(f"[zoo] cluster kernel {dt} {rows}x{cols} block_cols {bc} "
                  f"({sm.grid_plan(rows, cols).ncb} "
                  f"tiles, {int(nan.sum())} NaN rows as the plain version's) "
                  f"max_abs {err:.3e} ({rule}); repeats bit for bit {same} "
                  f"{'ok' if ok and same else 'MISS'}")
            checks.record("softmax_grid_fused", ok and same, err)


def _f64_check(v, args):
    """ops_bench.check's (ok, largest |difference|, rule) for an f32
    product against the f64 product, within TOLS plus the contraction
    slack; the rule also gives torch.matmul's own distance from it."""
    from tpukern_torch.harness import ops_bench

    out, ref = v.fn(*args), torch.matmul(*(t.double() for t in args))
    rtol, atol = ops_bench.TOLS[torch.float32]
    d = (out.double() - ref).abs()
    lim = atol + rtol * ref.abs() + ops_bench.contraction_slack(v, args, out)
    lib = (v.ref(*args).double() - ref).abs().max().item()
    return (bool(torch.isfinite(out).all() and (d <= lim).all()),
            d.max().item(), f"f64 product, rtol {rtol:g} atol {atol:g} + "
            f"{ops_bench.CONTRACTION_F32:g} sqrt(n) u_f32 sum|terms|; "
            f"torch.matmul {lib:.3e} from it")


def _zoo_gemm_tail(checks, gen):
    """The bf16 matmul ladder (#2's kernel) at ZOO_TAIL, K 4097 and N
    4095: no row of A or B is whole 16-byte chunks, so every operand goes
    by the producer's copy; each variant against its plain version
    (ops_bench.check). Returns the timed call of ZOO_GEMM_COPY_TIMED."""
    from functools import partial

    from tpukern_torch.core import registry
    from tpukern_torch.harness import ops_bench
    from tpukern_torch.ops import matmul

    tail, timed = ops_bench.Size(*ZOO_TAIL), []
    for name, v in sorted(registry.variants("matmul").items()):
        if not name.startswith("hgemm") or _zoo_kernels(v) != ("matmul",):
            continue
        args = ops_bench.inputs("matmul", name, tail, gen)
        ok, err, rule = ops_bench.check(v, args)
        path = matmul.load_path(matmul.tma_operands(*args))
        print(f"[zoo] tail matmul.{name:28s} {(tail.S, tail.K)} ({path}) "
              f"max_abs {err:.3e} ({rule}) {'ok' if ok else 'MISS'}")
        checks.ok &= ok
        if name == ZOO_GEMM_COPY_TIMED:
            timed.append((f"matmul.{name} {tail.S}x{tail.K} {path}",
                          ("matmul",), partial(v.fn, *args),
                          partial(v.ref, *args), _zoo_library(v, args),
                          partial(ops_bench.work, v, args)))
    return timed


def _zoo_naive_paths(checks, gen):
    """#16 against its plain version (ops_bench.check, the ladder's
    variants) at ZOO_NAIVE_PATHS in f32 and bf16, against the f64 product
    at ZOO_NAIVE_STRIDES in f32 (_f64_check), and in bf16 at the ladder's 4096^3 with both operands in views
    2 bytes off, so on the threads' copy (element loads), bit-equal to
    the TMA path (the same wgmmas on the same swizzled slabs). Returns the
    timed calls: ZOO_NAIVE_PATHS' first shape's, the strides' and the
    copy's."""
    from functools import partial

    from tpukern_torch.core import registry
    from tpukern_torch.harness import ops_bench
    from tpukern_torch.ops import matmul

    both = ("sgemm_naive_f32", "hgemm_naive_bf16")
    cases = [(mnk, both, k == 0, ops_bench.check) for k, mnk in
             enumerate(ZOO_NAIVE_PATHS.values())]
    cases += [((n, n, n), both[:1], True, _f64_check)
              for n in ZOO_NAIVE_STRIDES]
    timed = []
    for (M, N, K), names, timing, check in cases:
        for name in names:
            v = registry.get("matmul", name)
            dt = ops_bench._in_dtype("matmul", name)
            args = (_randn(gen, M, K, dtype=dt), _randn(gen, K, N, dtype=dt))
            ok, err, rule = check(v, args)
            print(f"[zoo] matmul.{name} {M}x{N}x{K} (bf16 path "
                  f"{matmul.tma_operands(*args)}) max_abs {err:.3e} "
                  f"({rule}) {'ok' if ok else 'MISS'}")
            checks.record("matmul_naive", ok, err)
            if timing:
                timed.append((f"matmul.{name} {M}x{N}x{K}",
                              ("matmul_naive",), partial(v.fn, *args),
                              partial(v.ref, *args),
                              _zoo_library(v, args),
                              partial(ops_bench.work, v, args)))
    n, v = ops_bench.Size().S, registry.get("matmul", "hgemm_naive_bf16")
    a, b = (_randn(gen, n, n, dtype=torch.bfloat16) for _ in range(2))

    def off(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        return buf[1:].view(t.shape).copy_(t)

    copy = partial(matmul.matmul_naive, off(a), off(b))
    ok = torch.equal(copy(), matmul.matmul_naive(a, b))
    print(f"[zoo] matmul.hgemm_naive_bf16 {n}^3 on the threads' copy: "
          f"bit-equal to the TMA path {'ok' if ok else 'MISS'}")
    checks.record("matmul_naive", ok, 0.0 if ok else float("inf"))
    timed.append((f"matmul.hgemm_naive_bf16 {n}^3 element copy",
                  ("matmul_naive",), copy, partial(v.ref, a, b),
                  partial(torch.matmul, a, b),
                  partial(ops_bench.work, v, (a, b))))
    return timed


def phase_zoo():
    """[zoo]: walks the port registry's variants of ZOO_FAMILIES and
    ZOO_REGISTERED on the card at bench/ops.py's shapes (ops_bench.Size:
    4096 x 4096; 16.8 M elements for reduce and dot; 4096^3 for the matmul
    ladder), then matmul_kpipe at 4096^3 in f32 and bf16, #16 at
    ZOO_NAIVE_PATHS and the grid softmax at 64 x 131072, with the launch
    counts of the zoo kernels (and #16's by bf16 load path, each of which
    must be taken) set to 0 just before and read just after, each grid
    softmax call held to one launch of each kernel softmax.grid_plan
    gives its shape and no other; after the read, holds every variant
    against its plain version (ops_bench.check), those of ZOO_TAILED also
    at ZOO_TAIL, whose element count leaves a tail in every tier, and the
    softmax and layer_norm variants also at the sampling logits' 64 x
    131072 (rows wider than #33's and #37's shared memory); #30's tiers against each other and
    the plain version (_zoo_ew_tiers) and the cluster kernel against its
    plain version (_zoo_grid_fused); checks the gathers (_zoo_gathers);
    runs softmax_global once under sync debug mode "error" (a host read
    of its max or sum fails the run); prints every sum's error against
    the f64 sum; then times each variant of ZOO_FAMILIES (the grid
    softmax on the cluster kernel), the grid variant at 64 x 131072 (on
    #35 then #36), and #35 and #36 alone, with the L2 flushed before
    every call beside its plain version, its library call and its bound
    (a gather's counts the distinct rows it reads), and #16 at
    ZOO_NAIVE_PATHS' first shape, at ZOO_NAIVE_STRIDES and on the
    threads' copy, and #40 at V 32768 too.
    Returns ({kernel: dict(max_abs_err, ms, ...)}, {kernel: launches},
    all-ok)."""
    from functools import partial

    from tpukern_torch.core import registry
    from tpukern_torch.harness import ops_bench, run_benchmark
    from tpukern_torch.ops import matmul

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    size = ops_bench.Size()
    checks, timed = _Checks(), []
    n_reg = sum(len(registry.variants(f)) for f in registry.families())
    print(f"[zoo] registry: {n_reg} variants ported, "
          f"{len(registry.PENDING)} pending")
    fns = _zoo_fns()
    for f in fns.values():
        f.launches = 0
    # the grid softmax calls of the walk: (name, the kernels grid_plan
    # gives it, the launches it made)
    grid_calls = []
    paths = matmul.matmul_naive.path_launches
    paths.update(dict.fromkeys(paths, 0))
    gemm_paths = matmul.matmul.path_launches
    gemm_paths.update(dict.fromkeys(gemm_paths, 0))
    for fam in ZOO_FAMILIES + ZOO_REGISTERED:
        for name, v in sorted(registry.variants(fam).items()):
            args = ops_bench.inputs(fam, name, size, gen)
            before = {n: f.launches for n, f in fns.items()}
            ok, err, rule = ops_bench.check(v, args)
            kernels = _zoo_kernels(v)
            if fam == "softmax" and name.endswith("_grid"):
                grid_calls.append((f"{fam}.{name}", kernels,
                                   _zoo_made(fns, before)))
            shape = [list(t.shape) if isinstance(t, torch.Tensor) else t
                     for t in args]
            print(f"[zoo] {fam + '.' + name:40s} {str(shape)[:40]:40s} "
                  f"max_abs {err:.3e} ({rule}) {'ok' if ok else 'MISS'}")
            checks.ok &= ok
            for k in kernels:
                if k in fns:
                    checks.record(k, ok, err)
            if fam in ZOO_FAMILIES:
                timed.append((f"{fam}.{v.name}", kernels, partial(v.fn, *args),
                              partial(v.ref, *args), _zoo_library(v, args),
                              partial(ops_bench.work, v, args)))
            else:
                del args
    for dt in (torch.float32, torch.bfloat16):
        a = _randn(gen, size.S, size.K, dtype=dt)
        b = _randn(gen, size.K, size.S, dtype=dt)
        out = matmul.matmul_kpipe(a, b)
        if dt == torch.bfloat16:
            ok, err = _compare("matmul_kpipe", f"{size.S}x{size.K}x{size.S} "
                               f"{dt}", out, matmul.matmul_ref(a, b).to(dt))
        else:
            # the split-TF32 tier sums in another order than cuBLAS:
            # held to the f64 product by the accuracy gate, as the
            # ladder's f32 variants are (ops_bench.split_gate)
            ok, err, rule = ops_bench.split_gate(out, a, b)
            print(f"[zoo] matmul_kpipe {size.S}x{size.K}x{size.S} {dt} "
                  f"max_abs {err:.3e} ({rule}) {'ok' if ok else 'MISS'}")
        checks.record("matmul_kpipe", ok, err)
        timed.append((f"kpipe {dt}", ("matmul_kpipe",),
                      partial(matmul.matmul_kpipe, a, b),
                      partial(matmul.matmul_ref, a, b),
                      partial(torch.matmul, a, b),
                      lambda _, a=a, b=b: (
                          2 * a.shape[0] * a.shape[1] * b.shape[1],
                          ops_bench.SPLIT_TF32 if a.dtype == torch.float32
                          else a.dtype,
                          _nbytes(a, b) + a.shape[0] * b.shape[1]
                          * a.element_size())))
    timed += _zoo_gemm_tail(checks, gen)
    timed += _zoo_naive_paths(checks, gen)
    # the grid variant at the sampling logits' 64 x 131072: 256 column
    # tiles, more than a cluster holds, so #35 then #36
    wide = ops_bench.Size(*size.sampling)
    grid_wide = registry.get("softmax", "softmax_online_f32_grid")
    wide_args = ops_bench.inputs("softmax", grid_wide.name, wide, gen)
    before = {n: f.launches for n, f in fns.items()}
    ok, err, rule = ops_bench.check(grid_wide, wide_args)
    grid_calls.append((ZOO_GRID_WIDE, _zoo_kernels(grid_wide,
                                                   (wide.S, wide.K)),
                       _zoo_made(fns, before)))
    print(f"[zoo] {ZOO_GRID_WIDE} max_abs {err:.3e} ({rule}) "
          f"{'ok' if ok else 'MISS'}")
    checks.ok &= ok
    for k in grid_calls[-1][1]:
        checks.record(k, ok, err)
    # the walk: the registry at the bench shapes (the grid softmax's
    # 4096^2 on the cluster kernel), kpipe, #16's paths and the grid
    # variant at 64 x 131072 (on #35 then #36)
    torch.cuda.synchronize()
    launches = {n: f.launches for n, f in fns.items()}
    print(f"[zoo] launches in the walk: {launches}; matmul_naive's bf16 "
          f"launches by load path: {paths}; matmul's: {gemm_paths}")
    for n in ZOO_KERNELS:
        require(launches[n] > 0, f"[zoo] {n} was never launched")
    # each grid softmax call made one launch of each kernel grid_plan gives
    # its shape and no other: the cluster kernel alone at 4096^2, #35
    # then #36 at 64 x 131072
    for name, kernels, made in grid_calls:
        print(f"[zoo] {name}: launches {made}")
        require(made == dict.fromkeys(kernels, 1),
                f"[zoo] {name} launched {made}, not one each of {kernels}")
    for path, n in paths.items():
        require(n > 0, f"[zoo] matmul_naive's {path} path was never taken")
    # the ladder at 4096^3 and matmul_kpipe by TMA, the tail by the copy
    for path in ("tma", "copy"):
        require(gemm_paths[path] > 0,
                f"[zoo] matmul's {path} path was never taken")
    checks.results["matmul_naive"]["path_launches"] = dict(paths)
    checks.results["matmul_kpipe"]["zoo_matmul_path_launches"] = dict(
        gemm_paths)
    for fam in ZOO_TAILED:
        for name, v in sorted(registry.variants(fam).items()):
            for sz in (ops_bench.Size(*ZOO_TAIL),) + (
                    (wide,) if fam in ZOO_WIDE else ()):
                ok, err, rule = ops_bench.check(
                    v, ops_bench.inputs(fam, name, sz, gen))
                print(f"[zoo] {'tail' if sz.S == ZOO_TAIL[0] else 'wide'} "
                      f"{fam + '.' + name:35s} {(sz.S, sz.K)} max_abs "
                      f"{err:.3e} ({rule}) {'ok' if ok else 'MISS'}")
                checks.ok &= ok
                for k in _zoo_kernels(v, (sz.S, sz.K)):
                    checks.record(k, ok, err)
    _zoo_ew_tiers(checks, gen)
    _zoo_grid_fused(checks, gen)
    timed += _zoo_gathers(checks, gen)
    _zoo_memory_ops(checks, gen, timed)
    # softmax_global keeps its max and sum on the card: any host read of
    # them raises here
    v = registry.get("softmax", "softmax_f32_global")
    x = ops_bench.inputs("softmax", v.name, size, gen)[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = v.fn(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ok, err, rule = ops_bench.softmax_check(out, v.ref(x), torch.float32,
                                            whole=True)
    print(f"[zoo] softmax_global with no host sync: max_abs {err:.3e} "
          f"({rule}) {'ok' if ok else 'MISS'}")
    for k in _zoo_kernels(v):
        checks.record(k, ok, err)
    # every sum against the f64 sum (a record: the bf16 accumulator is
    # held above to its plain version in the kernel's order)
    for name, v in sorted(registry.variants("reduce").items()):
        if name.startswith("sum"):
            x = ops_bench.inputs("reduce", name, size, gen)[0]
            f64 = x.double().sum().item()
            print(f"[zoo] reduce.{name:33s} against the f64 sum {f64:.1f}: "
                  f"error {abs(v.fn(x).double().item() - f64):.3e}")
    # #35 and #36 alone, each against its plain version, for their rows
    for name, kern, plain, args, nbytes in _zoo_grid_calls(gen, size):
        out, ref = kern(*args), plain(*args)
        if isinstance(out, tuple):  # #35's partials m and d (d >= 1)
            for o, r in zip(out, ref):
                ok, err = _compare(name, f"{size.S}x{size.K} f32", o, r,
                                   tol=ops_bench.TOLS[torch.float32])
                checks.record(name, ok, err)
        else:
            ok, err, rule = ops_bench.softmax_check(out, ref, torch.float32)
            print(f"[zoo] {name} {size.S}x{size.K} f32 max_abs {err:.3e} "
                  f"({rule}) {'ok' if ok else 'MISS'}")
            checks.record(name, ok, err)
        timed.append((f"{name} {args[0].dtype}", (name,), partial(kern, *args),
                      partial(plain, *args), None,
                      lambda _, n=nbytes: (0, torch.float32, n)))
    # the grid variant on #35 then #36: the sampling logits' 64 x 131072
    # (256 column tiles, more than a cluster holds)
    v, args = grid_wide, wide_args
    timed.append((ZOO_GRID_WIDE, _zoo_kernels(v, (wide.S, wide.K)),
                  partial(v.fn, *args), partial(v.ref, *args),
                  _zoo_library(v, args), partial(ops_bench.work, v, args)))

    results = checks.results
    for name, kernels, kern, plain, lib, work in timed:
        # work(out): (operations, their dtype, bytes) of the bound
        flops, dt, nbytes = work(kern())
        ms = run_benchmark(kern, **ZOO_TIMING)
        plain_ms = run_benchmark(plain, **ZOO_TIMING)
        lib_ms = None if lib is None else run_benchmark(lib, **ZOO_TIMING)
        bound, by = ops_bench.bound_ms(flops, dt, nbytes)
        rate = nbytes / ms / 1e6
        print(f"[time] {name:40s} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'} "
              f"bound {bound:.4f} ms by {by} ({bound / ms:.1%}); "
              f"{rate:.1f} GB/s"
              + (f", {flops / ms / 1e9:.2f} TFLOP/s" if flops else "")
              + " (L2 flushed)")
        for k in kernels:
            if ZOO_ROW.get(k) == name:
                results[k].update(
                    ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bound, bound_by=by, variant=name)
            elif k in ZOO_REDESIGNED:
                results[k].setdefault("also_timed", {})[name] = dict(
                    ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bound, bound_by=by)
        if name == ZOO_GRID_WIDE:
            # the variant's two kernels together, beside torch.softmax
            for k in kernels:
                results[k].update(variant_shape=f"{wide.S}x{wide.K}",
                                  variant_ms=ms, variant_plain_ms=plain_ms,
                                  variant_library_ms=lib_ms)
        if name.split("_")[0] in ("elementwise.add", "gelu.gelu"):
            # #30's six tiers of add and of gelu beside their library calls
            results["ew_call"].setdefault("tiers", {})[name] = dict(
                ms=ms, library_ms=lib_ms, bound_ms=bound)
        if name == "nms.nms_f32":
            # the sort, #43 and the compaction together
            results["nms_keep"].update(variant_ms=ms,
                                       variant_plain_ms=plain_ms)
    return results, launches, checks.ok


# ------------------------------------------------------------- parallel
RING_NS = (1, 2, 3, 4, 8)
RING_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
RING_FNS = ("ring_all_gather", "ring_reduce_scatter", "ring_all_reduce_grads")
# the kernels each collective launches (the kernels line's rows)
RING_KERNELS = {"ring_all_gather": ("ring_all_gather",),
                "ring_reduce_scatter": ("ring_reduce_scatter",),
                "ring_all_reduce_grads": ("ring_reduce_scatter",
                                          "ring_all_gather")}
RING_RANKS = 8  # [ring-grads]: data-parallel ranks on the card
RING_GRAD_S = 1024


def _ring_shapes(n):
    """tests/test_parallel.py's (64, 128) rows (66 where n does not divide
    64), a ragged chunk of 37 x 5 elements (no 16-byte unit) and a large
    one of 3 x 2^20 elements (more tiles than a rank has blocks, so blocks
    drift apart)."""
    return {"jax": (64 if 64 % n == 0 else 66, 128), "ragged": (37 * n, 5),
            "large": (n * 3 * 2 ** 17, 8)}


def phase_ring():
    """[ring]: #45, #46 and ring_all_reduce_grads against their plain ring
    walks with torch.equal, every rank's buffer, at n in RING_NS, in f32,
    bf16 and f16, at _ring_shapes; each on x, then on another x', then on
    x again: the later calls run on the flags and slots the earlier ones
    left (the epochs), and a call that read a slot or an output before
    its data arrived would return an earlier call's data. One all-reduce
    under sync debug mode "error". Returns (_Checks, all-ok)."""
    from tpukern_torch.parallel import Mesh, ring_kernels as rk

    checks = _Checks()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for n in RING_NS:
        mesh = Mesh.on_device(n)
        for label, (rows, cols) in _ring_shapes(n).items():
            for fn in RING_FNS:
                full = (rows, cols) if fn == "ring_all_gather" else (
                    n, rows, cols)
                res = []
                for dt in RING_DTYPES:
                    xs = [_randn(gen, *full, dtype=dt) for _ in range(2)]
                    wants = [getattr(rk, fn + "_plain")(x, mesh, ranks=True)
                             for x in xs]
                    order = (0, 1, 0)
                    outs = [getattr(rk, fn)(xs[i], mesh, ranks=True)
                            for i in order]
                    torch.cuda.synchronize()
                    ok = all(o.shape == wants[i].shape
                             and torch.equal(o, wants[i])
                             for o, i in zip(outs, order))
                    err = max((o.float() - wants[i].float()).abs().max()
                              .item() for o, i in zip(outs, order))
                    for k in RING_KERNELS[fn]:
                        checks.record(k, ok, err)
                    res.append(f"{str(dt)[6:]} {'ok' if ok else 'MISS'}")
                print(f"[ring] {fn:22s} n={n} x {tuple(full)} ({label}), "
                      f"on x, x', x, torch.equal: {', '.join(res)}")
    mesh = Mesh.on_device(8)
    x = _randn(gen, 8, 64, 128, dtype=torch.bfloat16)
    want = rk.ring_all_reduce_grads_plain(x, mesh)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = rk.ring_all_reduce_grads(x, mesh)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ok = torch.equal(out, want)
    checks.record("ring_reduce_scatter", ok, 0.0)
    print(f"[ring] ring_all_reduce_grads under sync debug mode \"error\": "
          f"no host sync, {'ok' if ok else 'MISS'}")
    return checks, checks.ok


def phase_ring_grads(cfg):
    """[ring-grads]: the data-parallel gradient all-reduce. At the 7bish
    widths cut to 2 layers (f32), RING_RANKS ranks' gradients (loss_fn
    and autograd, each rank on its own seeded batch, B=1 S=RING_GRAD_S),
    flattened into x (n, R), R padded to a multiple of n, go through
    ring_all_reduce_grads on a mesh of n ranks on the card, with the
    launch counts set to 0 just before and read just after. Every rank's
    copy must equal the plain ring walk bit for bit and match n times the
    gradient of the union batch (B=n; the loss is a mean) per parameter
    within TRAIN_GRAD_REL. Then times #46, #45 (on #46's result) and the
    all-reduce at the 16-layer parameter count (27.9 GB of f32 operands:
    the deepest cut that fits if not), beside the plain walks and the
    library calls (the all-reduce beside its library calls only), with
    bounds by bytes and the peak memory; #46 and #45 are also held to
    their plain walks there. Returns ({kernel: timing},
    {kernel: launches}, all-ok)."""
    from tpukern_torch.harness import run_benchmark
    from tpukern_torch.models import init_params, loss_fn, param_leaves
    from tpukern_torch.parallel import Mesh, ring_kernels as rk

    n, S = RING_RANKS, RING_GRAD_S
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params = init_params(cfg2, torch.Generator(device="cuda").manual_seed(
        SEED + 3), device="cuda")
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_()
    P = sum(t.numel() for t in leaves)
    R = -(-P // n) * n
    batches = [tuple(_batch(cfg2, 1, S, SEED + 10 + r)) for r in range(n)]
    x = torch.zeros((n, R), device="cuda")
    for r, (tokens, targets) in enumerate(batches):
        # rank r's gradients, flattened in param_leaves order (a zero tail)
        loss = loss_fn(params, tokens, targets, cfg2)
        x[r, :P] = torch.cat([g.reshape(-1) for g in torch.autograd.grad(
            loss, leaves)])
    mesh = Mesh.on_device(n)
    rk.ring_all_gather.launches = rk.ring_reduce_scatter.launches = 0
    out = rk.ring_all_reduce_grads(x, mesh, ranks=True)
    torch.cuda.synchronize()
    launches = {"ring_all_gather": rk.ring_all_gather.launches,
                "ring_reduce_scatter": rk.ring_reduce_scatter.launches}
    plain = rk.ring_all_reduce_grads_plain(x, mesh, ranks=True)
    bit = all(torch.equal(out[r], plain[r]) for r in range(n))
    err = (out - plain).abs().max().item()
    del plain
    print(f"[ring-grads] 7bish f32, 2 layers, {P / 1e6:.1f} M parameters "
          f"({P * 4 / 1e9:.3f} GB a rank), {n} ranks on the card, B=1 "
          f"S={S} each: x {tuple(x.shape)}; launches {launches}; every "
          f"rank's copy equals the plain ring walk: "
          f"{'ok' if bit else 'MISS'} (max abs {err:.3e})")
    tokens = torch.cat([b[0] for b in batches])
    targets = torch.cat([b[1] for b in batches])
    union = torch.autograd.grad(loss_fn(params, tokens, targets, cfg2),
                                leaves)
    worst, at = 0.0, 0
    for g in union:
        got = out[0, at:at + g.numel()].reshape(g.shape)
        at += g.numel()
        worst = max(worst, ((got - n * g).norm() / (n * g).norm()).item())
        del got  # a view of out
    good = worst <= TRAIN_GRAD_REL and bool(torch.isfinite(out).all())
    print(f"[ring-grads] against {n}x the union batch's gradient (B={n}): "
          f"worst rel_rms over {len(union)} parameters {worst:.3e} (<= "
          f"{TRAIN_GRAD_REL:g}) {'ok' if good else 'MISS'}")
    ok = bit and good and all(v > 0 for v in launches.values())
    per_layer = sum(t.numel() for t in params["layers"][0].values())
    del params, leaves, x, out, union, batches, g, loss
    torch.cuda.empty_cache()

    # timing at the 16-layer parameter count, or the deepest cut that fits:
    # the plain all-gather holds x, its input, its output and three chunks
    free, _ = torch.cuda.mem_get_info()
    layers = cfg.n_layers
    while layers > 2 and (2 * n + 5) * 4 * (
            P + (layers - 2) * per_layer) > 0.95 * free:
        layers -= 1
    Rt = -(-(P + (layers - 2) * per_layer) // n) * n
    e = 4
    print(f"[ring-grads] timing at {layers} layers (of {cfg.n_layers}): R = "
          f"{Rt} f32, n = {n}: x {n * Rt * e / 1e9:.1f} GB, the all-gathered "
          f"copies {n * Rt * e / 1e9:.1f} GB, the reduce-scatter's output "
          f"{Rt * e / 1e9:.2f} GB; {free / 1e9:.1f} GB free")
    results = {k: dict(max_abs_err=0.0) for k in ("ring_all_gather",
                                                  "ring_reduce_scatter")}
    shape = f"n={n} R={Rt} f32"
    tgen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    torch.cuda.reset_peak_memory_stats()
    x = torch.randn((n, Rt), generator=tgen, device="cuda")
    y = rk.ring_reduce_scatter(x, mesh)
    good = torch.equal(y, rk.ring_reduce_scatter_plain(x, mesh))
    _time_kernels({"ring_reduce_scatter": _timed_entry(
        "ring_reduce_scatter", shape, lambda: rk.ring_reduce_scatter(x, mesh),
        lambda: rk.ring_reduce_scatter_plain(x, mesh), lambda: x.sum(0),
        (n - 1) * Rt, (n + 1) * Rt * e, torch.float32, light=True)}, results)
    del x
    torch.cuda.empty_cache()
    ag = rk.ring_all_gather(y, mesh, ranks=True)
    good &= torch.equal(ag, rk.ring_all_gather_plain(y, mesh, ranks=True))
    del ag
    _time_kernels({"ring_all_gather": _timed_entry(
        "ring_all_gather", shape, lambda: rk.ring_all_gather(y, mesh),
        lambda: rk.ring_all_gather_plain(y, mesh),
        lambda: y.expand(n, -1).contiguous(), 0, (n + 1) * Rt * e,
        torch.float32, light=True)}, results)
    del y
    torch.cuda.empty_cache()
    # the all-reduce beside its library calls; its plain walk is the two
    # plain walks above in turn (timed in one call, its temporaries split
    # the cached output blocks and it no longer fits at 16 layers)
    x = torch.randn((n, Rt), generator=tgen, device="cuda")
    kw = LIGHT["bench"]
    ar = dict(ms=run_benchmark(lambda: rk.ring_all_reduce_grads(x, mesh),
                               **kw),
              library_ms=run_benchmark(
                  lambda: x.sum(0).expand(n, -1).contiguous(), **kw),
              bound_ms=_bound(0, 2 * (n + 1) * Rt * e, torch.float32)[0])
    peak = torch.cuda.max_memory_allocated() / 1e9
    del x
    torch.cuda.empty_cache()
    print(f"[time] ring_all_reduce_grads    at {shape}: kernels {ar['ms']:.4f}"
          f" ms (events); library {ar['library_ms']:.4f} ms (x.sum(0), then "
          f"expand(n, -1).contiguous()); bound {ar['bound_ms']:.4f} ms by "
          "bytes")
    print(f"[ring-grads] at {layers} layers #46 and #45 equal their plain "
          f"walks: {'ok' if good else 'MISS'}; peak device memory "
          f"{peak:.1f} GB (max_memory_allocated)")
    for k in results:
        results[k]["timed_layers"] = layers
    results["ring_reduce_scatter"].update(
        {f"all_reduce_{k}": v for k, v in ar.items()})
    return results, launches, ok and good


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # torch.compile (flex_attention, a library call timed beside the
    # featured kernels) caches in the checkout's build directory
    build = Path(__file__).resolve().parent / "tpukern_torch" / "build"
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(build / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    from tpukern_torch.models import Config, init_params
    from tpukern_torch.ops import (attention, paged_attention, rmsnorm,
                                   rope, split_tf32)

    # the 7bish serving preset of bench/serving.py
    cfg = Config(vocab=32768, d_model=2048, n_layers=16, n_heads=16,
                 n_kv_heads=8, d_ff=8192, max_seq=4096,
                 param_dtype=torch.bfloat16)
    ops = [rmsnorm.rms_norm, rope.rope_cached, attention.flash_attention,
           paged_attention.paged_attention]

    # the same widths in f32 for training (the JAX training default)
    tcfg = dataclasses.replace(cfg, param_dtype=torch.float32)
    TB, TS = 2, 1024

    phase_device()
    phase_build()
    timing, kernels_ok = phase_kernels(cfg)
    train_timing, train_ok = phase_train_kernels(tcfg, TB, TS)
    moe_timing, moe_ok = phase_moe_kernels()
    train_timing.update(moe_timing)
    torch.cuda.empty_cache()
    zoo_timing, zoo_launches, zoo_ok = phase_zoo()
    torch.cuda.empty_cache()
    if not (kernels_ok and train_ok and moe_ok and zoo_ok):
        print("chip_smoke: a kernel disagrees with its plain version",
              file=sys.stderr)
        return 1
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                         device="cuda")
    n_params = sum(t.numel() for t in [params["embed"], params["head"]]
                   + [w for lp in params["layers"] for w in lp.values()])
    print(f"[serve] 7bish: {n_params / 1e9:.3f} B parameters, bf16")
    launches, requests, serve_run = phase_serve(cfg, params, ops)
    serve_ops = ops + [paged_attention.paged_prefill_attention]
    prefix_launches = (
        phase_chunked(cfg, params, requests, serve_run, serve_ops)
        + phase_prefix(cfg, params, serve_ops)
        + phase_spec(cfg, params, requests, serve_ops))
    sample_launches = phase_sample(cfg, params, requests)
    prefix_launches += phase_spec_sample(cfg, params, requests, serve_ops)
    phase_gemma2(cfg, params, serve_ops)
    quant_launches = phase_quant_serve(cfg, params, requests)
    w8a16_launches, qparams = phase_w8a16_serve(cfg, params, requests)
    ring_launches = phase_ring_serve(cfg, params)
    phase_profile(cfg, params, requests, qparams)
    if not (phase_logits(cfg, params, requests[0][1])
            and phase_quant_logits(cfg, params, requests[0][1])
            and phase_w8a16_logits(cfg, qparams, requests[0][1])):
        print("chip_smoke: end-to-end logits disagree", file=sys.stderr)
        return 1
    del params, qparams
    torch.cuda.empty_cache()
    if not phase_exact(cfg, requests):
        print("chip_smoke: a serving stream differs from its reference",
              file=sys.stderr)
        return 1
    torch.cuda.empty_cache()

    train_launches, unfused_losses, unfused_stats = phase_train(tcfg, TB, TS)
    torch.cuda.empty_cache()
    fcfg = dataclasses.replace(tcfg, fused_loss=True)
    fused_launches, fused_losses, fused_stats = phase_train(fcfg, TB, TS)
    require(fused_launches["ce_fwd"] > 0 and fused_launches["ce_bwd"] > 0,
            f"the fused loss never launched its kernels: {fused_launches}")
    print(f"[train] fused against unfused loss: step "
          f"{fused_stats['ms']:.3f} ms against {unfused_stats['ms']:.3f} "
          f"ms ({fused_stats['ms'] / unfused_stats['ms']:.4f}x), peak "
          f"{fused_stats['peak_gib']:.2f} GiB against "
          f"{unfused_stats['peak_gib']:.2f}")
    print(f"[train] fused - unfused loss per step "
          f"{[f'{a - b:.2e}' for a, b in zip(fused_losses, unfused_losses)]}")
    torch.cuda.empty_cache()
    wcfg = dataclasses.replace(tcfg, window=WINDOW, softcap=SOFTCAP)
    featured_launches, _, featured_stats = phase_train(wcfg, TB, TS)
    torch.cuda.empty_cache()
    # the same widths with bf16 parameters (JAX's param_dtype)
    bcfg = dataclasses.replace(tcfg, param_dtype=torch.bfloat16)
    bf16_launches, _, bf16_stats = phase_train(bcfg, TB, TS)
    for name, st in (("featured", featured_stats),
                     ("default", unfused_stats), ("bf16", bf16_stats)):
        print(f"[train] {name:8s} step {st['ms']:.3f} ms = "
              f"{st['tokens_s']:.1f} tokens/s, peak {st['peak_gib']:.2f} GiB")
    torch.cuda.empty_cache()
    for c in (tcfg, fcfg, wcfg):
        if not phase_train_parity(c, TS):
            print("chip_smoke: the training loss or a gradient disagrees",
                  file=sys.stderr)
            return 1
    torch.cuda.empty_cache()
    mcfg = Config(**MIXTRAL)
    moe0, moe_train_launches, _, moe_stats = phase_moe_train(mcfg, MOE_B,
                                                             MOE_S)
    torch.cuda.empty_cache()
    dropless_launches, dropless_ok = phase_moe_dropless(
        moe0, mcfg, MOE_B * MOE_S)
    del moe0
    torch.cuda.empty_cache()
    if not (dropless_ok and phase_train_parity(mcfg, MOE_PARITY_S)):
        print("chip_smoke: the MoE outputs or gradients disagree",
              file=sys.stderr)
        return 1
    torch.cuda.empty_cache()
    ring_checks, ring_ok = phase_ring()
    ring_timing, ring_launches_dp, ring_grads_ok = phase_ring_grads(tcfg)
    if not (ring_ok and ring_grads_ok):
        print("chip_smoke: a ring collective disagrees with its plain walk "
              "or the gradient all-reduce with the union batch",
              file=sys.stderr)
        return 1
    for name, r in ring_timing.items():
        r["max_abs_err"] = max(r["max_abs_err"],
                               ring_checks.results[name]["max_abs_err"])
    print(f"[moe-train] step {moe_stats['ms']:.3f} ms = "
          f"{moe_stats['tokens_s']:.1f} tokens/s, peak "
          f"{moe_stats['peak_gib']:.2f} GiB, dropped share "
          f"{moe_stats['drop_share']:.4f}")
    for name, r in train_timing.items():  # rms_norm, flash_attention: checks
        # at the training shapes
        if name in timing:
            timing[name]["max_abs_err"] = max(timing[name]["max_abs_err"],
                                              r["max_abs_err"])
        else:
            timing[name] = r
    # serving counts for its four, the chunked, prefix and speculative
    # runs for #24, the sampled runs for #26 and #27, the quantized tier's
    # runs for #20-#22 and the quantized #23/#24 (#21 is on no serving
    # path: its count there is 0), the fused phase for the CE kernels, the
    # featured phase for the two-kernel backward, [moe-dropless] for the
    # grouped GEMMs
    launches = {**train_launches, **launches,
                **{n: quant_launches[n] for n in (
                    "quantize_int8", "quantize_fp8", "dequantize_int8",
                    "paged_attention_quantized",
                    "paged_prefill_attention_quantized")},
                "paged_prefill_attention": prefix_launches,
                "sample": sample_launches["sample"],
                "sample_threshold": (sample_launches["count"]
                                     + sample_launches["mass"]),
                **{n: fused_launches[n] for n in ("ce_fwd", "ce_bwd")},
                **{n: featured_launches[n] for n in ("flash_attention_dq",
                                                     "flash_attention_dkv")},
                "matmul_w8a16": w8a16_launches,
                **{n: dropless_launches[n] for n in ("gmm", "tgmm")},
                **zoo_launches, **ring_launches_dp}
    timing.update(zoo_timing)
    timing.update(ring_timing)

    src = {"rms_norm": ("tpukern_torch/csrc/rmsnorm.cu",
                        "tpukern/ops/rmsnorm.py:34"),
           "rope_cached": ("tpukern_torch/csrc/rope.cu",
                           "tpukern/ops/rope.py:118"),
           "flash_attention": ("tpukern_torch/csrc/flash_attention.cu",
                               "tpukern/ops/attention.py:62"),
           "paged_attention": ("tpukern_torch/csrc/paged_attention.cu",
                               "tpukern/ops/paged_attention.py:77"),
           "paged_prefill_attention": ("tpukern_torch/csrc/paged_prefill.cu",
                                       "tpukern/ops/paged_attention.py:513"),
           "matmul": ("tpukern_torch/csrc/matmul.cu",
                      "tpukern/ops/matmul.py:140"),
           "split_tf32": ("tpukern_torch/csrc/split_tf32.cu",
                          "tpukern/ops/matmul.py:140"),
           "rope_batched": ("tpukern_torch/csrc/rope.cu",
                            "tpukern/ops/rope.py:81"),
           "flash_attention_bwd": ("tpukern_torch/csrc/flash_attention_bwd.cu",
                                   "tpukern/ops/attention_bwd.py:339"),
           "flash_attention_bwd_bf16": (
               "tpukern_torch/csrc/flash_attention_bwd_bf16.cu",
               "tpukern/ops/attention_bwd.py:339"),
           "ce_fwd": ("tpukern_torch/csrc/cross_entropy.cu",
                      "tpukern/ops/cross_entropy.py:53"),
           "ce_bwd": ("tpukern_torch/csrc/cross_entropy.cu",
                      "tpukern/ops/cross_entropy.py:95"),
           "flash_attention_dq": (
               "tpukern_torch/csrc/flash_attention_featured_tf32.cu",
               "tpukern/ops/attention_bwd.py:31"),
           "flash_attention_dkv": (
               "tpukern_torch/csrc/flash_attention_featured_tf32.cu",
               "tpukern/ops/attention_bwd.py:110"),
           "sample": ("tpukern_torch/csrc/sampling.cu",
                      "tpukern/ops/sampling.py:45"),
           "sample_threshold": ("tpukern_torch/csrc/sampling.cu",
                                "tpukern/ops/sampling.py:182"),
           "quantize_int8": ("tpukern_torch/csrc/quant.cu",
                             "tpukern/ops/quant.py:36"),
           "dequantize_int8": ("tpukern_torch/csrc/quant.cu",
                               "tpukern/ops/quant.py:89"),
           "quantize_fp8": ("tpukern_torch/csrc/quant.cu",
                            "tpukern/ops/quant.py:128"),
           "paged_attention_quantized": (
               "tpukern_torch/csrc/paged_quant.cu",
               "tpukern/ops/paged_attention.py:77"),
           "paged_prefill_attention_quantized": (
               "tpukern_torch/csrc/paged_quant.cu",
               "tpukern/ops/paged_attention.py:513"),
           "matmul_w8a16": ("tpukern_torch/csrc/matmul_w8a16.cu",
                            "tpukern/ops/matmul_w8a16.py:106"),
           "gmm": ("tpukern_torch/csrc/grouped_matmul.cu",
                   "tpukern/ops/grouped_matmul.py:147"),
           "tgmm": ("tpukern_torch/csrc/grouped_matmul.cu",
                    "tpukern/ops/grouped_matmul.py:235"),
           "ew_call": ("tpukern_torch/csrc/elementwise.cu",
                       "tpukern/ops/_ew.py:57"),
           "reduce_all": ("tpukern_torch/csrc/reduce.cu",
                          "tpukern/ops/reduce.py:68"),
           "dot_prod": ("tpukern_torch/csrc/reduce.cu",
                        "tpukern/ops/dot_product.py:27"),
           "matmul_naive": ("tpukern_torch/csrc/matmul_naive.cu",
                            "tpukern/ops/matmul.py:384"),
           "rope": ("tpukern_torch/csrc/rope.cu", "tpukern/ops/rope.py:38"),
           "matmul_kpipe": ("tpukern_torch/csrc/matmul.cu",
                            "tpukern/ops/matmul.py:311"),
           "softmax_per_token": ("tpukern_torch/csrc/softmax.cu",
                                 "tpukern/ops/softmax.py:49"),
           "online_softmax_per_token": ("tpukern_torch/csrc/softmax.cu",
                                        "tpukern/ops/softmax.py:85"),
           "softmax_grid_stats": ("tpukern_torch/csrc/softmax.cu",
                                  "tpukern/ops/softmax.py:134"),
           "softmax_grid_norm": ("tpukern_torch/csrc/softmax.cu",
                                 "tpukern/ops/softmax.py:172"),
           "softmax_grid_fused": ("tpukern_torch/csrc/softmax.cu",
                                  "tpukern/ops/softmax.py:134"),
           "layer_norm": ("tpukern_torch/csrc/layernorm.cu",
                          "tpukern/ops/layernorm.py:52"),
           "embedding_prefetch": ("tpukern_torch/csrc/embedding.cu",
                                  "tpukern/ops/embedding.py:39"),
           "embedding_dma": ("tpukern_torch/csrc/embedding.cu",
                             "tpukern/ops/embedding.py:71"),
           "embedding_onehot": ("tpukern_torch/csrc/embedding.cu",
                                "tpukern/ops/embedding.py:108"),
           "histogram": ("tpukern_torch/csrc/histogram.cu",
                         "tpukern/ops/histogram.py:47"),
           "transpose": ("tpukern_torch/csrc/transpose.cu",
                         "tpukern/ops/transpose.py:39"),
           "nms_keep": ("tpukern_torch/csrc/nms.cu",
                        "tpukern/ops/nms.py:24"),
           "gemv": ("tpukern_torch/csrc/gemv.cu", "tpukern/ops/gemv.py:37"),
           "ring_all_gather": ("tpukern_torch/csrc/ring.cu",
                               "tpukern/parallel/ring_kernels.py:28"),
           "ring_reduce_scatter": ("tpukern_torch/csrc/ring.cu",
                                   "tpukern/parallel/ring_kernels.py:73")}
    # one backward kernel serves both of the TPU's backward kernels; the
    # two-kernel backward also stands for its transposed-layout twins
    also = {"ce_bwd": "tpukern/ops/cross_entropy.py:132",
            "split_tf32": "tpukern/ops/cross_entropy.py:95",
            "flash_attention_dq": "tpukern/ops/attention_bwd.py:188",
            "flash_attention_dkv": "tpukern/ops/attention_bwd.py:261",
            "softmax_grid_fused": "tpukern/ops/softmax.py:172"}
    # the PyTorch call(s) behind library_ms (null where there is none)
    library = {
        "rms_norm": "F.rms_norm",
        "flash_attention": "F.scaled_dot_product_attention(enable_gqa=True)",
        "paged_attention": "F.scaled_dot_product_attention(enable_gqa=True) "
                           "with a boolean mask of the visible positions on "
                           "a contiguous copy of each sequence's K/V (the "
                           "gather outside the timed call)",
        "paged_prefill_attention": "as paged_attention",
        "matmul": "torch.matmul (cuBLAS, input dtype)",
        "split_tf32": "none: PyTorch has no call that splits a matrix into "
                      "TF32 parts",
        "flash_attention_bwd": "autograd backward of "
                               "F.scaled_dot_product_attention(enable_gqa="
                               "True)",
        "flash_attention_bwd_bf16": "as flash_attention_bwd, in bf16",
        "ce_fwd": "torch.matmul + F.cross_entropy (two calls)",
        "ce_bwd": "autograd backward of torch.matmul + F.cross_entropy "
                  "(two calls)",
        "flash_attention_dq": "autograd backward of torch.compile("
                              "flex_attention) with the softcap score_mod "
                              "and the band block mask (dq, dk, dv together)",
        "flash_attention_dkv": "as flash_attention_dq",
        "sample": "torch.argmax (greedy mode, one call)",
        "sample_threshold": "torch.topk(x, 50) (count mode, one call); the "
                            "mass mode has none (sort, softmax and cumsum)",
        "paged_attention_quantized": "as paged_attention, on pools "
                                     "dequantized outside the timed call",
        "paged_prefill_attention_quantized": "as paged_attention_quantized",
        "matmul_w8a16": "torch.matmul over the weights dequantized to bf16 "
                        "outside the timed call (the bf16 tier's GEMM, "
                        "cuBLAS)",
        "gmm": GMM_LIBRARY,
        "tgmm": GMM_LIBRARY,
        "ew_call": "torch.add (the row's op; the others: torch.mul, "
                   "torch.relu, torch.sigmoid, F.elu, F.gelu(approximate="
                   "'tanh'), F.silu, F.hardswish, F.hardshrink(lambd=0.5))",
        "reduce_all": "torch.sum(dtype=acc) (torch.amax for max; none for "
                      "fp8 inputs)",
        "dot_prod": "torch.dot",
        "matmul_naive": "torch.matmul (cuBLAS, input dtype)",
        "matmul_kpipe": "torch.matmul (cuBLAS, input dtype)",
        "softmax_per_token": "torch.softmax(x, -1)",
        "online_softmax_per_token": "torch.softmax(x, -1)",
        "softmax_grid_stats": "none for the kernel alone (no PyTorch call "
                              "gives per-tile partials); the variant on "
                              "#35 then #36 (64 x 131072) beside "
                              "torch.softmax(x, -1): variant_ms, "
                              "variant_library_ms",
        "softmax_grid_norm": "as softmax_grid_stats",
        "softmax_grid_fused": "torch.softmax(x, -1)",
        "layer_norm": "F.layer_norm(x, (K,), eps=1e-5) in x's dtype",
        "embedding_prefetch": "F.embedding(idx, w) (int32 indices)",
        "embedding_dma": "F.embedding(idx, w) (int32 indices)",
        "embedding_onehot": "F.embedding(idx, w) (int32 indices), the "
                            "gather the one-hot product computes",
        "histogram": "torch.bincount(x, minlength=num_bins) (int64 counts; "
                     "the data lies in [0, num_bins))",
        "transpose": "x.t().contiguous()",
        "nms_keep": "none: PyTorch has no NMS of its own, and torchvision "
                    "(torchvision.ops.nms) is not installed on the host",
        "gemv": "torch.mv(A, x) in the input dtype (cuBLAS)",
        "ring_all_gather": "y.expand(n, -1).contiguous() (one card: the n "
                           "copies, no NVLink or NCCL)",
        "ring_reduce_scatter": "x.sum(0) (torch's own order; one card, no "
                               "NVLink or NCCL)"}
    # #27's launches by mode, the quantized #23's and #24's by tier
    modes = {"sample_threshold": {"count_launches": sample_launches["count"],
                                  "mass_launches": sample_launches["mass"]},
             **{n: {f"{t}_launches": quant_launches[f"{k} {t}"]
                    for t in ("int8", "pv_int8", "fp8")}
                for k, n in (("#23", "paged_attention_quantized"),
                             ("#24", "paged_prefill_attention_quantized"))}}
    # the quantized kernel's split-KV: (slots a split, n_split) by the
    # rule at the serving shapes (a pv_int8 split holds whole page blocks)
    for n, T, B_ in (("paged_attention_quantized", 1, 4),
                     ("paged_prefill_attention_quantized", 5, 4),
                     ("paged_prefill_attention_quantized", 256, 1)):
        splits = modes[n].setdefault("slots_a_split", {})
        for pv in (False, True):
            splits[f"T {T}{' pv_int8 ppb8' if pv else ''}"] = list(
                paged_attention.quant_splits(B_, 16, 8, T, 1024, 1024, pv))
    # the ring instances' launches in [ring-serve]; ALiBi has none to
    # count: no serving path passes slopes (JAX's passes none either)
    for n, v in ring_launches.items():
        modes.setdefault(n, {}).update(
            ring_launches=v,
            alibi="no serving path passes slopes (as in JAX); held against "
                  "the plain version in the kernel phase only")
    # #28's trans_w instance (the VJP's dx) in [moe-dropless]; the
    # capacity-dispatch trainer ([moe-train]) launches neither
    for n in ("gmm", "tgmm"):
        modes[n] = {"moe_train_launches": moe_train_launches[n]}
    modes["gmm"]["trans_w_launches"] = dropless_launches["trans_w"]
    # the zoo's rows: the variant each row's times are of; rope and
    # matmul_kpipe launch the kernels of rope_batched and matmul
    for n in ZOO_KERNELS:
        modes[n] = {k: timing[n][k] for k in (
            "variant", "variant_shape", "variant_ms", "variant_plain_ms",
            "variant_library_ms", "tiers",
            "path_launches", "zoo_matmul_path_launches", "also_timed")
            if k in timing[n]}
    # the ring rows: launches in [ring-grads]'s all-reduce; times at the
    # parameter count of timed_layers; the all-reduce's beside #46's
    for n in ("ring_all_gather", "ring_reduce_scatter"):
        modes[n] = {k: v for k, v in timing[n].items() if k not in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms") and not k.endswith("device_ms")}
    # #23's split (split-KV) and its times at the long shape
    long = timing["paged_attention_long"]
    modes.setdefault("paged_attention", {}).update(
        decode_chunk=paged_attention.DECODE_CHUNK,
        n_split={"serving": paged_attention.decode_splits(8, 128),
                 "long": paged_attention.decode_splits(LONG_PAGES, 128)},
        long_shape=long["shape"],
        **{f"long_{k}": long[k] for k in (
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms")})
    # #2's bf16 launches by load path in [train kernels]; the split-TF32
    # f32 tier's bound on the CUDA cores' FMAs and its accuracy gate (the
    # same for the f32 CE backward); the operand pass: the f32 #2's and
    # #14/#15's first step, no TPU kernel of its own
    modes["matmul"] = {"path_launches": timing["matmul"]["path_launches"]}
    for n in ("matmul", "ce_bwd"):
        modes.setdefault(n, {}).update(
            fma_bound_ms=timing[n]["fma_bound_ms"],
            f64_gate=timing[n]["f64_gate"],
            gate=f"max abs err vs f64 <= {split_tf32.SPLIT_GATE:g} x "
                 "cuBLAS f32's")
    # the f32 tier of #6 as the training step calls it and the f32 #8
    # with GQA inside (split-TF32 products): times beside SDPA, bounds on
    # the FMAs, the accuracy gate
    modes.setdefault("flash_attention", {})["train_f32"] = dict(
        timing["flash_attention_train_f32"], gate=f"max abs err vs f64 <= "
        f"{split_tf32.SPLIT_GATE:g} x the plain f32 version's")
    modes.setdefault("flash_attention_bwd", {}).update(
        fma_bound_ms=timing["flash_attention_bwd"]["fma_bound_ms"],
        f64_gate=timing["flash_attention_bwd"]["f64_gate"],
        gate=f"max abs err vs f64 <= {split_tf32.SPLIT_GATE:g} x the plain "
             "f32 version's")
    # the f32 featured backward (#9, #10: split-TF32 products, GQA
    # inside): bounds on the FMAs, the accuracy gate (D 128) and the
    # ratios at D 32 (printed, not gated)
    for n in ("flash_attention_dq", "flash_attention_dkv"):
        modes.setdefault(n, {}).update(
            fma_bound_ms=timing[n]["fma_bound_ms"],
            f64_gate=timing[n]["f64_gate"],
            f64_ratio_d32=timing[n]["f64_ratio_d32"],
            gate=f"max abs err vs f64 <= {split_tf32.SPLIT_GATE:g} x the "
                 "plain f32 version's, at D 128")
    # the bf16 tier of #8: its own kernel, on no main path (with bf16
    # parameters too the trainer's attention runs on f32 q, k, v:
    # matmul_t writes the f32 accumulator, as JAX's does)
    modes["flash_attention_bwd_bf16"] = dict(
        f64_gate=timing["flash_attention_bwd_bf16"]["f64_gate"],
        gate=f"max abs err vs f64 <= {split_tf32.SPLIT_GATE:g} x the plain "
             "bf16 order's (P and dS rounded to bf16 alike)",
        device_ms=timing["flash_attention_bwd_bf16"]["device_ms"],
        library_device_ms=timing["flash_attention_bwd_bf16"][
            "library_device_ms"],
        bf16_parameters_run_launches=bf16_launches[
            "flash_attention_bwd_bf16"],
        main_path="none: the trainer runs #8's f32 tier at either "
                  "param_dtype (its bf16-parameter run launches #8 "
                  f"{bf16_launches['flash_attention_bwd']} times, f32)")
    modes["split_tf32"] = {
        "part_of": "the f32 tier of matmul (#1-#3, #17) and ce_bwd "
                   "(#14/#15): their operands' hi and lo planes",
        "fused_train_launches": fused_launches["split_tf32"]}
    modes["rope"]["launches_kernel_of"] = "rope_batched"
    modes["matmul_kpipe"]["launches_kernel_of"] = "matmul"
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        dict(name=n, route="cuda", source=src[n][0], replaces=src[n][1],
             launches=launches[n], max_abs_err=timing[n]["max_abs_err"],
             **{k: timing[n][k] for k in keys}, library=library.get(n),
             **({"also_replaces": also[n]} if n in also else {}),
             **modes.get(n, {}))
        for n in src]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
