"""Build, load and launch the hand-written CUDA kernels.

The counterpart of tpukern/core/config.py's dispatch: where the JAX
package picks compiled Mosaic or interpret mode, this package compiles
`csrc/*.cu` with nvcc for sm_90a into one shared library with a plain C
interface and loads it with ctypes. Nothing here runs at import: the
library is built on the first launch, so hosts without nvcc (the CPU
test lane) import every module freely.

- The build directory is `build/<hash>/` beside this file, keyed by a
  hash of the sources and the flags, so a stale library is never
  loaded. The library is written to a temporary name and renamed, so
  concurrent first launches cannot load a half-written file.
- Each source compiles to an object in its own nvcc process, all started
  together, and one more nvcc links them: the build takes about as long
  as its slowest source.
- A failed build raises with nvcc's output.
- Every C entry point returns cudaGetLastError() after its launch, and
  `launch` raises if that is not 0.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD = Path(__file__).parent / "build"
LIB_NAME = "libtpukern_torch.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# dtype codes shared with csrc/common.cuh (enum tk::Dtype): the float
# types of activations, the 1-byte pools of the quantized KV tier, and all
# of them with the storage types of the op-family zoo
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KV_CODES = {torch.int8: 2, torch.float8_e4m3fn: 3}
CODES = {**DTYPE_CODES, **KV_CODES, torch.float16: 4,
         torch.float8_e5m2: 5, torch.int32: 6}

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_U64 = ctypes.c_uint64
_F = ctypes.c_float
# argtypes of every C entry point (csrc/capi.cu); ctypes would otherwise
# pass each pointer as a 32-bit int
SIGNATURES = {
    # x, g (or None), scalar g, y, rows, cols, eps, acc_bf16, x_dtype,
    # g_dtype, stream
    "tk_rms_norm": [_P, _P, _F, _P, _I64, _I64, _F, _I, _I, _I, _P],
    # x, cos, sin, y, rows, head_dim, dtype, stream
    "tk_rope_cached": [_P, _P, _P, _P, _I64, _I, _I, _P],
    # x, y, rows, head_dim, seq_len, sign, dtype, stream
    "tk_rope_batched": [_P, _P, _I64, _I, _I, _F, _I, _P],
    # q, k, v, o, lse (or None), q_seg, kv_seg (or None), B, Hq, Hkv, Sq,
    # Skv, D, sm_scale, causal, window, sinks, softcap, dtype, tile
    # config (0: the kernel's rule; ops/attention.py FWD_TILES), stream
    "tk_flash_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _F, _I, _I, _I, _F, _I, _I, _P],
    # q, k, v, do, lse, di, dq (f32), dk, dv, B, Hq, Hkv, Sq, Skv, D,
    # sm_scale, causal, dtype, stream
    "tk_flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _I, _F, _I, _I, _P],
    # q, k, v, do, lse, di, q_seg, kv_seg (or None), dq, B, Hq, Hkv, Sq,
    # Skv, D, sm_scale, causal, window, softcap, dtype, stream
    "tk_flash_attention_dq": [_P] * 9 + [_I] * 6 + [_F, _I, _I, _F, _I, _P],
    # the same with dk, dv in place of dq
    "tk_flash_attention_dkv": [_P] * 10 + [_I] * 6 + [_F, _I, _I, _F, _I,
                                                       _P],
    # a, b, c32 (or None), c16 (or None), M, N, K, trans_b, dtype, the
    # f32 tier's split-TF32 scratch (or None), its splits of K, tickets
    # (or None at one split), the operand passes' host counter (or None;
    # ops/split_tf32.py launch_counting_passes), stream
    "tk_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P],
    # src (f32), R, C, row stride, planes (or None), their row stride,
    # transposed planes (or None), their row stride, the host counter,
    # stream
    "tk_split_tf32": [_P, _I, _I, _I64, _P, _I64, _P, _I64, _P, _P],
    # x, w, group_sizes (i32), y32 (or None), y16 (or None), T, N, K, E,
    # trans_w, dtype, the f32 tier's split-TF32 scratch (or None), the
    # host counter, stream
    "tk_gmm": [_P] * 5 + [_I] * 6 + [_P, _P, _P],
    # x, dy, group_sizes (i32), o32 (or None), o16 (or None), T, K, N, E,
    # dtype, the f32 tier's split-TF32 scratch (or None), the host
    # counter, stream
    "tk_tgmm": [_P] * 5 + [_I] * 5 + [_P, _P, _P],
    # x, w (int8), s (f32), out, ws (or None), tickets, M, N, K, splits,
    # K slices a split, dtype, out dtype, stream
    "tk_matmul_w8a16": [_P] * 6 + [_I] * 7 + [_P],
    # q, k_pages, v_pages, lengths, page_table, o, B, Hq, Hkv, P,
    # page_size, pages_per_seq, D, sm_scale, window, sinks, softcap,
    # ring (slots a sequence, 0: flat), ALiBi slopes (or None), tokens a
    # split, split workspace (f32) and tickets (i32) (or None at one
    # split), dtype, stream
    "tk_paged_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _F, _I, _I, _F, _I, _P, _I, _P, _P, _I,
                           _P],
    # q, k_pages, v_pages, lengths, page_table, o, B, Hq, Hkv, T (new
    # tokens per sequence), P, page_size, pages_per_seq, D, sm_scale,
    # window, sinks, softcap, ring, ALiBi slopes (or None), slots a split,
    # split workspace (f32) and tickets (i32) (or None at one split),
    # dtype, stream
    "tk_paged_prefill": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _F, _I, _I, _F, _I, _P, _I, _P, _P, _I,
                         _P],
    # q, q_scales (or None), k_pages, k_scales, v_pages, v_scales, lengths,
    # page_table, o, B, Hq, Hkv, T, P, page_size, pages_per_seq, D,
    # block_tokens, sm_scale, window, sinks, softcap, ring, slopes (or
    # None), slots a split, split workspace (f32) and tickets (i32) (or
    # None at one split), the pv_int8 pieces' statistics (f32, or None),
    # dtype, kv_dtype, pv_int8, stream (decode is T = 1)
    "tk_paged_prefill_quantized": [_P] * 9 + [_I] * 9 + [_F, _I, _I, _F,
                                                         _I, _P, _I, _P, _P,
                                                         _P, _I, _I, _I, _P],
    # x, values, scales, S, K, mode (0 int8, 1 int8 stochastic, 2 fp8),
    # seed, dtype, stream
    "tk_quantize": [_P, _P, _P, _I64, _I, _I, _I64, _I, _P],
    # values, scales, out, S, K, out dtype, stream
    "tk_dequantize": [_P, _P, _P, _I64, _I, _I, _P],
    # x, w, targets (i32), part (f32), N, D, V, log2, stream (bf16 inputs)
    "tk_ce_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, w, targets, part (f32), the split-TF32 planes of x and of W's
    # chunk (f32 scratch), N, D, V, v0, vc, the chunk's first partial,
    # split_x, log2, the host counter, stream (f32 inputs; one vocab
    # chunk)
    "tk_ce_fwd_f32": [_P] * 6 + [_I] * 8 + [_P, _P],
    # part, targets, loss, lse, N, n_split, stream
    "tk_ce_combine": [_P, _P, _P, _P, _I, _I, _P],
    # x, w, targets, lse, g, dx (f32), dw (f32), the split-TF32 planes of
    # x, of W's chunk and of dlog (f32 scratch), N, D, V, v0, vc, add,
    # split_x, log2, the host counter, stream (f32 inputs; one vocab
    # chunk)
    "tk_ce_bwd": [_P] * 10 + [_I] * 8 + [_P, _P],
    # x, w, targets, lse, g, dx (f32), dw (f32), dlog scratch (bf16), N,
    # D, V, v0, vc, add, log2, stream (bf16 inputs; one vocab chunk)
    "tk_ce_bwd_chunk": [_P] * 8 + [_I] * 7 + [_P],
    # x, thresholds (or None), noise (or None), mode, seed, inv_temp, B, V,
    # n_split, part (or None), out, dtype, stream
    "tk_sample": [_P, _P, _P, _I, _I64, _F, _I, _I, _I, _P, _P, _I, _P],
    # x (f32), thresholds, B, V, mode (0 count, 1 mass), k, p, inv_temp,
    # stream
    "tk_sample_threshold": [_P, _P, _I, _I, _I, _I, _F, _F, _P],
    # op, x0, x1 (or None), scalar s (f32, or None), y, n, vec, dtype,
    # stream
    "tk_ew": [_I, _P, _P, _P, _P, _I64, _I, _I, _P],
    # x, y (dot, or None), partials, out, n, mode (0 sum, 1 max, 2 dot),
    # in dtype, acc dtype, stream
    "tk_reduce": [_P, _P, _P, _P, _I64, _I, _I, _I, _P],
    # a, b, c, M, N, K, dtype, stream
    "tk_matmul_naive": [_P, _P, _P, _I, _I, _I, _I, _P],
    # x, y, rows, cols, mode (0 safe, 1 online), dtype, stream
    "tk_softmax": [_P, _P, _I64, _I64, _I, _I, _P],
    # x, m, d (f32, rows x ncb), rows, cols, block_rows, block_cols, ncb,
    # dtype, stream
    "tk_softmax_grid_stats": [_P, _P, _P, _I64, _I64, _I, _I, _I, _I, _P],
    # x, m, d, y, rows, cols, block_rows, block_cols, ncb, dtype, stream
    "tk_softmax_grid_norm": [_P, _P, _P, _P, _I64, _I64, _I, _I, _I, _I, _P],
    # x, y, rows, cols, block_cols, ncb, dtype, stream
    "tk_softmax_grid_fused": [_P, _P, _I64, _I64, _I, _I, _I, _P],
    # rows, cols, block_cols, ncb, dtype, out (int32 x 4: rows a block,
    # shared bytes, most active clusters, clusters launched)
    "tk_softmax_grid_fused_plan": [_I64, _I64, _I, _I, _I, _P],
    # x, g (or None), scalar g, b (or None), scalar b, y, rows, cols, eps,
    # acc_bf16, x_dtype, g/b dtype, stream
    "tk_layer_norm": [_P, _P, _F, _P, _F, _P, _I64, _I64, _F, _I, _I, _I,
                      _P],
    # idx (i32), w, out, S, V, D, block_tokens, mode (0 a block a token,
    # 1 block_tokens a block), dtype, stream
    "tk_embedding_gather": [_P, _P, _P, _I64, _I, _I64, _I, _I, _I, _P],
    # idx (i32), w, out, S, V, D, dtype, stream
    "tk_embedding_onehot": [_P, _P, _P, _I, _I, _I, _I, _P],
    # x (i32), n, out (i32, zeroed), bins, block_rows, stream
    "tk_histogram": [_P, _I64, _P, _I, _I, _P],
    # x, out, M, N, bm, bn, order (0 row, 1 col, 2 diag), dtype, stream
    "tk_transpose": [_P, _P, _I64, _I64, _I, _I, _I, _I, _P],
    # A, x, y (f32), M, K, K block, mode (0 vpu, 1 mxu), dtype, stream
    "tk_gemv": [_P, _P, _P, _I, _I64, _I64, _I, _I, _P],
    # boxes (f32, sorted), n, threshold, mask (u64 scratch), keep (i32),
    # stream
    "tk_nms_keep": [_P, _I, _F, _P, _P, _P],
    # x, out, flags (u64), n, chunk bytes, epoch, max_blocks, stream
    "tk_ring_all_gather": [_P, _P, _P, _I, _I64, _U64, _I, _P],
    # x, out, slots, flags (u64), n, chunk (elements), dtype, epoch,
    # max_blocks, stream
    "tk_ring_reduce_scatter": [_P, _P, _P, _P, _I, _I64, _I, _U64, _I, _P],
}


def _nvcc():
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a host with the CUDA toolkit")
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    """build/<hash of sources and flags>/ for the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD / h.hexdigest()[:16]


def build() -> tuple[Path, float]:
    """Compile the library if this source hash has none yet. Returns its
    path and the seconds spent compiling (0.0 when it was already
    built)."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=out_dir))
    t0 = time.perf_counter()
    try:
        objs = [work / (src.stem + ".o") for src in cu]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(cu, objs)]
        logs = [(p.args, p.communicate()[0], p.returncode) for p in procs]
        if all(rc == 0 for _, _, rc in logs):
            link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(work / LIB_NAME),
                    *map(str, objs)]
            proc = subprocess.run(link, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            logs.append((link, proc.stdout, proc.returncode))
        text = "".join(f"$ {' '.join(cmd)}\n{out}" for cmd, out, _ in logs)
        (out_dir / "nvcc.log").write_text(text)
        if any(rc != 0 for _, _, rc in logs):
            raise RuntimeError(f"nvcc failed:\n{text}")
        os.replace(work / LIB_NAME, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tk_error_string.argtypes = [ctypes.c_int]
    lib.tk_error_string.restype = ctypes.c_char_p
    return lib


def launch(name, *args):
    """Call one C entry point; raise if its launch reported an error."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.tk_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    """t's device address, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned (the kernels' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# (device, stream) -> int32 counters, zero between launches: device
# scratch kept across calls, so that a launch needs no zeroing kernel
_TICKETS = {}


def tickets(device, stream, n):
    """n zeroed int32 counters on device for a kernel whose blocks merge
    by ticket (csrc/matmul_w8a16.cu, csrc/paged_attention.cu): the last
    block of a group to finish finds its count there and resets it to 0,
    so every launch on the stream reuses the buffer (launches on one
    stream run in order, one at a time; each stream has its own)."""
    t = _TICKETS.get((device, stream))
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[(device, stream)] = t
    return t


def check_cuda(*tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"kernel needs CUDA tensors, got {dev}")
    if dev.index is not None and dev.index != torch.cuda.current_device():
        # the kernels launch on the current device's stream
        raise ValueError(f"tensors on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
