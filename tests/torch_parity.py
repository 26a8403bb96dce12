"""The shared parity helper of the port's CPU tests: the same numpy
inputs through a JAX function (Pallas in interpret mode on the CPU) and
its counterpart in tpukern_torch (the plain PyTorch versions, as the
wrappers take them for CPU tensors), compared at the tolerance of a
dtype from tpukern_torch/core/tolerances.py (integers exactly).
"""

import jax.numpy as jnp
import numpy as np
import torch

from tpukern_torch.core.tolerances import check_all_close


def to_numpy(out):
    """A JAX array or torch tensor (or a tuple of them) as numpy: floats
    as f64 (bf16 and fp8 have no numpy type), integers as they are."""
    if isinstance(out, (tuple, list)):
        return tuple(to_numpy(o) for o in out)
    if isinstance(out, torch.Tensor):
        out = out.detach().cpu()
        return (out.numpy() if not out.is_floating_point()
                else out.double().numpy())
    out = jnp.asarray(out)
    return (np.asarray(out) if not jnp.issubdtype(out.dtype, jnp.floating)
            else np.asarray(out.astype(jnp.float32), np.float64))


def assert_parity(jax_fn, torch_fn, *inputs, dtype, rtol=None, atol=None,
                  name=""):
    """jax_fn(*jax arrays) against torch_fn(*torch tensors) of the numpy
    inputs, at the tolerance of `dtype` (a torch dtype or its name), or
    rtol/atol where given; integer outputs must be equal. Returns the
    largest absolute difference."""
    j = to_numpy(jax_fn(*[jnp.asarray(x) for x in inputs]))
    t = to_numpy(torch_fn(*[torch.from_numpy(np.asarray(x)) for x in inputs]))
    j, t = (j, t) if isinstance(j, tuple) else ((j,), (t,))
    assert len(j) == len(t), f"{name}: {len(t)} outputs, JAX {len(j)}"
    worst = 0.0
    for k, (a, b) in enumerate(zip(t, j)):
        assert a.shape == b.shape, f"{name}[{k}]: {a.shape} vs JAX {b.shape}"
        if not np.issubdtype(a.dtype, np.floating):
            np.testing.assert_array_equal(a, b, err_msg=f"{name}[{k}]")
            continue
        worst = max(worst, check_all_close(a, b, dtype=dtype, rtol=rtol,
                                           atol=atol, name=f"{name}[{k}]")[0])
    return worst
