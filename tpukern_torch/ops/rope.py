"""RoPE: rotary position embedding, half-split (NeoX) pairs, theta=10000.

The port of tpukern/ops/rope.py: the cached-table path (serving),
`rope_batched` (training), `rope` and `rope_interleaved` (the registry's
zoo variants). Kernels: csrc/rope.cu, which replaces the Pallas
`kernel`s of rope_cached (rope.py:118) and rope_batched (:81); `rope`
(:38, position = row) computes rope_batched's function at seq_len = S,
so it launches that kernel.
"""

import math

import torch

from tpukern_torch import _build
from tpukern_torch.core.registry import register

_LOG_THETA = math.log(10000.0)


def make_cos_sin(S, D, device="cuda"):
    """f32 (S, D/2) tables on `device` (the card unless the caller asks
    for "cpu"): angle = pos * exp(j * (-2 ln theta / D))."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    return _cos_sin(pos, D)


def _cos_sin(pos, D):
    j = torch.arange(D // 2, dtype=torch.float32, device=pos.device)[None, :]
    ang = pos * torch.exp(j * (-2.0 * _LOG_THETA / D))
    return torch.cos(ang), torch.sin(ang)


def rope_batched(x, seq_len, sign=1.0):
    """Rotate (N*seq_len, D) rows at position row % seq_len, computing the
    angles as make_cos_sin does; sign=-1 is the inverse rotation (the
    backward). Output in x.dtype.

    A CPU tensor takes rope_batched_ref; a CUDA tensor launches the kernel
    (bf16 or f32 x)."""
    R, D = x.shape
    if D % 2 or seq_len <= 0 or R % seq_len:
        raise ValueError(f"rope_batched: x {tuple(x.shape)} needs an even D "
                         f"and rows a multiple of seq_len={seq_len}")
    if x.device.type == "cpu":
        return rope_batched_ref(x, seq_len, sign)
    _build.check_cuda(x)
    x = x.contiguous()
    y = torch.empty_like(x)
    _build.launch("tk_rope_batched", x.data_ptr(), y.data_ptr(), R, D,
                  seq_len, float(sign), _build.dtype_code(x),
                  _build.stream(x))
    rope_batched.launches += 1
    return y


rope_batched.launches = 0


def rope_batched_ref(x, seq_len, sign=1.0):
    pos = (torch.arange(x.shape[0], device=x.device) % seq_len).to(
        torch.float32)[:, None]
    cos, sin = _cos_sin(pos, x.shape[1])
    return rope_cached_ref(x, cos, sign * sin)


def rope_cached(x, cos, sin):
    """Rotate (R, D) rows: (x1, x2) -> (x1 cos - x2 sin, x1 sin + x2 cos),
    x1 = x[:, :D/2], x2 = x[:, D/2:], with the f32 (R, D/2) cos/sin rows
    gathered at each row's position. Output in x.dtype.

    A CPU tensor takes rope_cached_ref; a CUDA tensor launches the kernel
    (bf16 or f32 x)."""
    if x.device.type == "cpu":
        return rope_cached_ref(x, cos, sin)
    _build.check_cuda(x, cos, sin)
    R, D = x.shape
    if D % 2 or cos.shape != (R, D // 2) or sin.shape != (R, D // 2):
        raise ValueError(f"x {tuple(x.shape)} needs (R, D/2) tables, got "
                         f"{tuple(cos.shape)}, {tuple(sin.shape)}")
    if cos.dtype != torch.float32 or sin.dtype != torch.float32:
        raise TypeError("cos/sin tables must be float32")
    x, cos, sin = x.contiguous(), cos.contiguous(), sin.contiguous()
    y = torch.empty_like(x)
    _build.launch("tk_rope_cached", x.data_ptr(), cos.data_ptr(),
                  sin.data_ptr(), y.data_ptr(), R, D, _build.dtype_code(x),
                  _build.stream(x))
    rope_cached.launches += 1
    return y


rope_cached.launches = 0


def rope_cached_ref(x, cos, sin):
    half = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[:, :half], xf[:, half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def rope(x):
    """Half-split RoPE on (S, D), position = row index: rope_batched with
    seq_len = S (the same angles, computed in the kernel). Output in
    x.dtype; a CPU tensor takes rope_ref."""
    y = rope_batched(x, x.shape[0], 1.0)
    if x.device.type != "cpu":
        rope.launches += 1
    return y


rope.launches = 0


def rope_interleaved(x):
    """Reference-layout RoPE: pairs (x[2i], x[2i+1]). De-interleaved in
    torch, rotated by `rope`, re-interleaved (rope.py:143-151)."""
    S, D = x.shape
    xs = x.reshape(S, D // 2, 2)
    y = rope(torch.cat([xs[:, :, 0], xs[:, :, 1]], dim=-1))
    return torch.stack([y[:, :D // 2], y[:, D // 2:]], dim=-1).reshape(S, D)


def rope_ref(x):
    """Plain half-split reference with make_cos_sin's tables."""
    S, D = x.shape
    return rope_cached_ref(x, *make_cos_sin(S, D, device=x.device))


def rope_interleaved_ref(x):
    S, D = x.shape
    cos, sin = make_cos_sin(S, D, device=x.device)
    xf = x.float().reshape(S, D // 2, 2)
    x1, x2 = xf[:, :, 0], xf[:, :, 1]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(S, D).to(x.dtype)


def _cached(x):
    S, D = x.shape
    return rope_cached(x, *make_cos_sin(S, D, device=x.device))


# (suffix, function, dtype, plain version) — rope.py:181-203; the
# TPU block heights (_r64, _r128) are aliases
_VARIANTS = [
    ("f32", rope, torch.float32, rope_ref),
    ("f32_r64", rope, torch.float32, rope_ref),
    ("bf16", rope, torch.bfloat16, rope_ref),
    ("bf16_r128", rope, torch.bfloat16, rope_ref),
    ("f32_interleaved", rope_interleaved, torch.float32,
     rope_interleaved_ref),
    ("f32_cached", _cached, torch.float32, rope_ref),
    ("bf16_cached", _cached, torch.bfloat16, rope_ref),
]

for _sfx, _impl, _dt, _ref in _VARIANTS:
    register("rope", f"rope_{_sfx}",
             ref=lambda x, _dt=_dt, _ref=_ref: _ref(x.to(_dt)),
             bytes_moved=lambda x: 2 * x.numel() * x.element_size())(
        lambda x, _impl=_impl, _dt=_dt: _impl(x.to(_dt)))
