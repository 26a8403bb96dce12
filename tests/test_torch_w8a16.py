"""tpukern_torch's weight-only int8 GEMM (ops/matmul_w8a16.py) against the
JAX package's on the CPU.

quantize_weights must equal JAX's bit for bit (a true division by 127,
round half to even). matmul_w8a16 at M <= 128 is the kernel's function
(JAX: its Pallas kernel in interpret mode; the port: the plain version),
and at M > 128 both take the dequant-then-dot path, which in bf16 rounds
each dequantized weight and the scale to bf16. The same numpy-seeded x
and weights go to both sides: f32 is held to 2e-5 (sums in another
order), bf16 to the _TOLS bf16 row (outputs rounded to bf16 on both
sides, after sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.ops import matmul_w8a16 as jax_w8
from tpukern_torch.core.tolerances import check_all_close
from tpukern_torch.ops import matmul_w8a16 as w8

K, N = 256, 384
F32 = dict(rtol=2e-5, atol=2e-5)
DTYPES = {"f32": (torch.float32, jnp.float32, F32),
          "bf16": (torch.bfloat16, jnp.bfloat16, {})}


def _inputs(M, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0  # a zero column takes scale 1
    return x, w


def _both(a, dt):
    """numpy f32 a in dtype dt on both sides: (jax array, torch tensor)."""
    tdt, jdt, _ = DTYPES[dt]
    t = torch.from_numpy(a).to(tdt)
    return jnp.asarray(t.float().numpy()).astype(jdt), t


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_quantize_weights_bit_equal(dt):
    _, w = _inputs(1, K, N, seed=1)
    # column 7: scale 0.5, so 0.25 and 0.75 are ties of w / scale (0.5,
    # 1.5), which round half to even (0, 2)
    w[5, 7], w[6, 7], w[8, 7] = 127.0 * 0.5, 0.25, 0.75
    jw, tw = _both(w, dt)
    jq, js = jax_w8.quantize_weights(jw)
    q, s = w8.quantize_weights(tw)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert (q.numpy() == np.asarray(jq)).all()
    assert (s.numpy() == np.asarray(js)).all()
    assert s[3] == 1.0 and s[7] == 0.5 and q[6, 7] == 0 and q[8, 7] == 2


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("M", [1, 4, 8, 9, 20, 64, 100, 128, 129, 256])
def test_matmul_w8a16_matches_jax(M, dt):
    """M <= 128: the kernel's function on both sides (JAX forced to its
    kernel); M > 128: both dispatch to the dequant-then-dot path."""
    x, w = _inputs(M, K, N, seed=M)
    q, s = w8.quantize_weights(torch.from_numpy(w))
    jx, tx = _both(x, dt)
    ref = jax_w8.matmul_w8a16(jx, jnp.asarray(q.numpy()),
                              jnp.asarray(s.numpy()),
                              force_kernel=M <= 128)
    out = w8.matmul_w8a16(tx, q, s)
    assert out.dtype == tx.dtype and out.shape == (M, N)
    check_all_close(out.float(), np.asarray(ref, np.float32),
                    dtype=tx.dtype, name=f"M{M} {dt}", **DTYPES[dt][2])


def test_dispatch_rounds_the_dequant_to_bf16():
    """At M > 128 in bf16 the weights are dequantized in bf16 (JAX's
    w_q.astype(bf16) * scale.astype(bf16)), a different function from the
    kernel's; force_kernel takes the kernel's function at any M."""
    x, w = _inputs(160, K, N, seed=3)
    q, s = w8.quantize_weights(torch.from_numpy(w))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    wd = q.to(torch.bfloat16) * s.to(torch.bfloat16)
    check_all_close(w8.matmul_w8a16(tx, q, s), torch.matmul(tx, wd),
                    rtol=0, atol=0, name="dispatch")
    forced = w8.matmul_w8a16(tx, q, s, force_kernel=True)
    check_all_close(forced, w8.matmul_w8a16_ref(tx, q, s), rtol=0, atol=0,
                    name="forced")


@pytest.mark.parametrize("k", [200, 1100])
def test_k_tail(k):
    """K with no 128-multiple block divisor (JAX raises at 1100, a TPU
    constraint the port does not keep): the plain version against a
    float64 product of the dequantized weights, and against JAX's where
    JAX takes the shape."""
    x, w = _inputs(4, k, 136, seed=k)
    q, s = w8.quantize_weights(torch.from_numpy(w))
    out = w8.matmul_w8a16(torch.from_numpy(x), q, s)
    exact = x.astype(np.float64) @ (q.numpy().astype(np.float64)
                                    * s.numpy().astype(np.float64))
    check_all_close(out, exact, name=f"K{k} f64", **F32)
    if k == 200:
        ref = jax_w8.matmul_w8a16(jnp.asarray(x), jnp.asarray(q.numpy()),
                                  jnp.asarray(s.numpy()))
        check_all_close(out, np.asarray(ref), name=f"K{k} jax", **F32)


def test_out_dtype_and_bad_inputs():
    x, w = _inputs(4, K, N, seed=9)
    q, s = w8.quantize_weights(torch.from_numpy(w))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    out = w8.matmul_w8a16(tx, q, s, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    check_all_close(out.to(torch.bfloat16), w8.matmul_w8a16(tx, q, s),
                    rtol=0, atol=0, name="out_dtype")
    with pytest.raises(TypeError):
        w8.matmul_w8a16(tx, q.float(), s)
    with pytest.raises(ValueError):
        w8.matmul_w8a16(tx[:, :-1], q, s)
    with pytest.raises(ValueError):
        w8.matmul_w8a16(tx, q, s[:-1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_splits_cover_k(dtype):
    """The kernel's K split: every slice of TILE_K rows (64 in bf16, 32 in
    f32) in exactly one split, at least one a split, about two waves of
    132 SMs over the dtype's tiles (bf16: 128 tokens by 128 columns; f32:
    64 by 128); in bf16 at most two waves (rounded down, at least one
    split) and 16 splits (8 from 4 token tiles on)."""
    for M, n, k in [(4, 1024, 2048), (4, 32768, 2048), (4, 2048, 8192),
                    (20, 8192, 2048), (2048, 2048, 2048), (1, 136, 200),
                    (4, 64, 0), (128, 8192, 2048), (64, 2048, 2048)]:
        splits, per = w8._splits(M, n, k, 132, dtype)
        n_kt = -(-k // w8.TILE_K[dtype])
        assert splits >= 1 and splits * per >= n_kt
        assert splits == 1 or (splits - 1) * per < n_kt
        tiles = -(-M // w8.TILE_M[dtype]) * -(-n // w8.TILE_N)
        if dtype == torch.bfloat16:
            want = min(2 * 132 // tiles, 16 if w8.token_tiles(M) <= 2 else 8)
            assert splits <= max(1, want)
            assert 2 * splits > min(n_kt, want)
        else:
            assert tiles * splits >= min(2 * 132,
                                         tiles * max(n_kt, 1)) // 2
    # the 7bish shapes in bf16: the head's 256 column tiles unsplit; wk's
    # 8 tiles in 16 splits at decode, in 8 at M = 128; w1's 64 in 4
    assert w8._splits(4, 32768, 2048, 132) == (1, 32)
    assert w8._splits(4, 1024, 2048, 132) == (16, 2)
    assert w8._splits(128, 1024, 2048, 132) == (8, 4)
    assert w8._splits(4, 8192, 2048, 132) == (4, 8)


def test_splits_lever():
    """SPLITS forces the bf16 kernel's count (clamped to the K slices,
    every split non-empty) and leaves f32's rule alone."""
    try:
        w8.SPLITS = 8
        assert w8._splits(4, 1024, 2048, 132) == (8, 4)
        assert w8._splits(4, 1024, 200, 132) == (4, 1)
        assert w8._splits(4, 1024, 2048, 132, torch.float32) == (
            w8._rule(4, 1024, 2048, 132, torch.float32))
    finally:
        w8.SPLITS = None


@pytest.mark.parametrize("M,tiles", [(1, 1), (4, 1), (8, 1), (9, 2),
                                     (16, 2), (17, 4), (20, 4), (32, 4),
                                     (33, 8), (64, 8), (65, 16), (128, 16),
                                     (129, 16), (2048, 16)])
def test_token_tiles_by_m(M, tiles):
    """The bf16 kernel's instance: n8 token tiles a block, M's first 128
    rows in tiles of 8 rounded up to a power of two (a block takes 128
    tokens at most; a forced M above that launches more blocks)."""
    assert w8.token_tiles(M) == tiles
    assert tiles * 8 >= min(M, 128) > tiles * 4 or M <= 8


def test_workspace_is_reused():
    """The split-K workspace is kept per (device, stream): a call of the
    same or a smaller size gets the same storage, a larger one a new
    buffer that later calls then share; another stream its own."""
    dev = torch.device("cpu")
    w8._WORKSPACE.clear()
    a = w8._workspace(dev, 1, 4096)
    assert w8._workspace(dev, 1, 4096).data_ptr() == a.data_ptr()
    assert w8._workspace(dev, 1, 100).data_ptr() == a.data_ptr()
    b = w8._workspace(dev, 1, 8192)
    assert b.numel() >= 8192 and w8._workspace(dev, 1, 4096).data_ptr() == (
        b.data_ptr())
    assert w8._workspace(dev, 2, 4096).data_ptr() != b.data_ptr()
    w8._WORKSPACE.clear()


def test_widening_is_exact():
    """widen_int8_ref, the bf16 kernel's widening (a byte into bf16's
    mantissa and one bf16x2 subtraction), equals int8 -> bf16 for all 256
    byte values, bit for bit."""
    q = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    out = w8.widen_int8_ref(q)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.view(torch.int16), q.to(torch.bfloat16).view(
        torch.int16))
