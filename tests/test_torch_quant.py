"""tpukern_torch/ops/quant.py against the JAX package on the CPU: the plain
quantize_int8 equals JAX's quantize_ref exactly, scales included (and
the interpret-mode kernel within 1, as tests/test_quant.py allows it),
quantize_fp8 equals quantize_fp8_ref and the interpret-mode kernel bit
for bit, scales to 1e-6 relative (exactly against quantize_fp8_ref);
dequantize_int8 equals JAX's; the round-trip bounds of
tests/test_quant.py; round half to even; stochastic rounding by its
distribution. The kernels against these plain versions are in
tests/test_torch_kernels.py (marker `cuda`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukern.ops import quant as jax_quant
from tpukern_torch.ops import quant


def _rows(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x[3] = 0.0  # a row of zeros: scale 1
    return x


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(64, 256), (33, 32), (8, 100)])
def test_quantize_int8_matches_jax(shape, dtype, rng):
    x = _rows(rng, shape, 3.0)
    xt = torch.from_numpy(x)
    if dtype == "bf16":
        xt = xt.to(torch.bfloat16)
    jx = jnp.asarray(xt.float().numpy()).astype(
        jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    v, s = quant.quantize_int8(xt)
    assert v.dtype == torch.int8 and s.dtype == torch.float32
    v_ref, s_ref = jax_quant.quantize_ref(jx)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    v_k, s_k = jax_quant.quantize_int8(jx)
    assert np.abs(v.numpy().astype(np.int32)
                  - np.asarray(v_k, np.int32)).max() <= 1
    np.testing.assert_allclose(s.numpy(), np.asarray(s_k), rtol=1e-6)


@pytest.mark.parametrize("shape", [(64, 256), (33, 32)])
def test_quantize_fp8_matches_jax(shape, rng):
    x = _rows(rng, shape, 3.0)
    v, s = quant.quantize_fp8(torch.from_numpy(x))
    assert v.dtype == torch.float8_e4m3fn
    bits = v.view(torch.uint8).numpy()
    for jv, js in (jax_quant.quantize_fp8_ref(jnp.asarray(x)),
                   jax_quant.quantize_fp8(jnp.asarray(x))):
        np.testing.assert_array_equal(bits, np.asarray(jv).view(np.uint8))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_array_equal(
        s.numpy(), np.asarray(jax_quant.quantize_fp8_ref(jnp.asarray(x))[1]))


@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_dequantize_int8_matches_jax(out, rng):
    x = _rows(rng, (32, 512), 1.0)
    v, s = quant.quantize_int8(torch.from_numpy(x))
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[out]
    y = quant.dequantize_int8(v, s, tdt)
    ref = jax_quant.dequantize_int8(jnp.asarray(v.numpy()),
                                    jnp.asarray(s.numpy()), out_dtype=jdt)
    assert y.dtype == tdt
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(ref, np.float32))


def test_roundtrip_error_bounded(rng):
    """int8: at most half a step per row (tests/test_quant.py:20-27)."""
    x = rng.standard_normal((32, 512)).astype(np.float32)
    v, s = quant.quantize_int8(torch.from_numpy(x))
    y = quant.dequantize_int8(v, s).numpy()
    step = s.numpy()[:, None]
    assert (np.abs(y - x) <= 0.51 * step + 1e-6).all()


def test_fp8_roundtrip_error_bounded(rng):
    """fp8: a relative step of 2^-3, or 2^-9 of the scale near zero
    (tests/test_quant.py:40-47)."""
    x = rng.standard_normal((32, 512)).astype(np.float32)
    v, s = quant.quantize_fp8(torch.from_numpy(x))
    y = v.float().numpy() * s.numpy()[:, None]
    bound = np.maximum(np.abs(x) * 2.0 ** -3, s.numpy()[:, None] * 2.0 ** -9)
    assert (np.abs(y - x) <= bound + 1e-6).all()


def test_round_half_to_even():
    """x / scale = k + 0.5 rounds to the even neighbour, as jnp.round does
    (roundf would round every one away from zero)."""
    halves = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 100.5, 125.5],
                      np.float32)
    x = np.zeros((1, 16), np.float32)
    x[0, 0] = 127.0  # scale 1
    x[0, 1:1 + len(halves)] = halves
    v, s = quant.quantize_int8(torch.from_numpy(x))
    assert s.item() == 1.0
    want = [0, 2, 2, 0, -2, -2, 100, 126]
    assert v[0, 1:1 + len(halves)].tolist() == want
    v_ref, _ = jax_quant.quantize_ref(jnp.asarray(x))
    assert np.asarray(v_ref)[0, 1:1 + len(halves)].tolist() == want


def test_stochastic_rounding_unbiased():
    """The midpoint test of tests/test_quant.py:54-68 on the plain
    version: 0.505 at scale 0.01 is 50.5, drawn to 50 or 51 with mean
    50.5; draws repeat per seed and differ across seeds."""
    x = np.full((8, 128), 0.505, np.float32)
    x[:, 0] = 1.27
    x = torch.from_numpy(x)
    vals = []
    for seed in range(16):
        v, s = quant.quantize_int8(x, seed=seed, stochastic=True)
        vals.append(quant.dequantize_int8(v, s).numpy()[:, 1:])
        assert set(np.unique(v[:, 1:].numpy())) <= {50, 51}
    vals = np.stack(vals)
    assert abs(vals.mean() - 0.505) < 0.002
    assert vals.std() > 1e-4
    again, _ = quant.quantize_int8(x, seed=3, stochastic=True)
    assert torch.equal(again, quant.quantize_int8(x, seed=3,
                                                  stochastic=True)[0])


def test_bad_inputs_raise():
    with pytest.raises(ValueError):
        quant.quantize_int8(torch.ones(4))
    with pytest.raises(TypeError):
        quant.quantize_fp8(torch.ones(4, 4, dtype=torch.float64))
    with pytest.raises(TypeError):
        quant.dequantize_int8(torch.ones(4, 4), torch.ones(4))
