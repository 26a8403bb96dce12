"""Dtype-matched tolerance table + check_all_close.

A copy of tpukern/core/tolerances.py: the JAX module imports jax, which
this package never does. tests/test_torch_ops.py pins the two tables
equal.
"""

import numpy as np
import torch

_TOLS = {
    "float32": dict(rtol=1e-5, atol=1e-5),
    "bfloat16": dict(rtol=2e-2, atol=2e-2),
    "float16": dict(rtol=2e-3, atol=2e-3),
    "int32": dict(rtol=0, atol=0),
    "int8": dict(rtol=0, atol=0),
    "float8_e4m3fn": dict(rtol=1.5e-1, atol=1.5e-1),
    "float8_e5m2": dict(rtol=3e-1, atol=3e-1),
}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def tol(dtype) -> dict:
    return dict(_TOLS[_dtype_name(dtype)])


def _as_f64(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def check_all_close(out, ref, dtype=None, rtol=None, atol=None, name=""):
    """Assert closeness at dtype-matched tolerance; return (max, mean) abs
    diff. out/ref are torch tensors or numpy arrays."""
    dtype = dtype if dtype is not None else out.dtype
    t = tol(dtype)
    if rtol is not None:
        t["rtol"] = rtol
    if atol is not None:
        t["atol"] = atol
    a, b = _as_f64(out), _as_f64(ref)
    diff = np.abs(a - b)
    max_diff = float(diff.max()) if diff.size else 0.0
    mean_diff = float(diff.mean()) if diff.size else 0.0
    if not np.allclose(a, b, rtol=t["rtol"], atol=t["atol"]):
        bad = int((diff > t["atol"] + t["rtol"] * np.abs(b)).sum())
        raise AssertionError(
            f"{name or 'check'}: {bad}/{a.size} mismatched "
            f"(dtype={_dtype_name(dtype)}, rtol={t['rtol']}, "
            f"atol={t['atol']}, max={max_diff:.3e}, mean={mean_diff:.3e})")
    return max_diff, mean_diff
