"""Softmax suite (tpukern/ops/softmax.py): safe per-token, online per-token,
grid-streamed and global softmax.

Kernels: csrc/softmax.cu.

- `softmax_per_token` (#33, replaces softmax.py:49 `kernel`): the safe
  softmax with the whole row on chip (max, then exp and sum, then
  normalize; x read from HBM once, staged in shared memory).
- `online_softmax_per_token` (#34, replaces :85): one pass keeps a
  running (max, denominator) pair for each thread, merged across the warp
  and the block; a normalize pass reads x again.
- `online_softmax_grid` (#35 stats, replaces :134; #36 normalize,
  replaces :172): for rows too wide to hold on chip. JAX walks a row
  block's column blocks one after another and carries (m, d) from step to
  step. CUDA blocks run in no order, so #35 gives every (block_rows x
  block_cols) tile its own block, which writes each row's partial (m, d)
  of its columns, f32 (rows, n_col_blocks); #36, one block a tile again,
  merges a row's partials in a fixed order by the reference's rule m =
  max(ma, mb), d = da exp(ma - m) + db exp(mb - m) and writes exp(x - m)
  / d for its tile. The merged pair is JAX's final (m, d) up to rounding,
  the row's max and its sum of exp(x - m), so the function is the same.
- `softmax_global` composes #31 and #30: max_all, ew_call("exp_sub"),
  sum_all, ew_call("div"); the max and the sum stay 0-d CUDA tensors, so
  nothing is read back on the host.

All statistics are f32 whatever the input dtype; f16 is storage-only
(core/config.py): the kernels read it directly and round the output to it
once. The normalization is e / d, a true division. The running max of
#34 and #35 starts at JAX's NEG_BIG. Inputs keep their natural shape:
`_pad_cols`'s 128-lane padding and #35's (S, 128) broadcast stats are
Mosaic workarounds. Every merge runs in a fixed order, so a call repeats
bit for bit.

The TPU's block shapes on Hopper:

- `block_rows` of the per-token functions is the TPU's block height in
  sublanes. On Hopper the rows a CUDA block takes follow the row's width:
  a row of up to 1024 elements (csrc/softmax.cu SM_WARP_ROW_MAX) is one
  warp's, 8 rows a block of 256 threads; a longer one a whole block's,
  128-1024 threads with about four 16-byte packs a thread. block_rows is
  checked and has no other effect: `_r64` and `_r128` are aliases of one
  kernel instance.
- `chunk` of `online_softmax_per_token` is the TPU's lane chunk, the step
  of its online update. On Hopper the step is each thread's 16-byte pack
  of strided elements; chunk is checked and has no other effect.
- `block_rows` and `block_cols` of `online_softmax_grid` keep their
  meaning: the tile one CUDA block streams.

A row wider than #33's shared-memory budget (200 KiB: 51200 f32 or
102400 bf16 elements) is read from global memory again in each phase,
inside the same kernel, so every width gives the right result.

On a CPU tensor each function returns its plain version: `softmax_ref`
(JAX's `_ref_per_token`), and `softmax_global_ref` (`_ref_global`) for
`softmax_global`'s parts; #35 and #36 have plain versions of their own,
`grid_stats_ref` and `grid_norm_ref`.
"""

import torch

from tpukern_torch import _build
from tpukern_torch.core.config import STORAGE_ONLY_DTYPES
from tpukern_torch.core.registry import register
from tpukern_torch.core.tiling import cdiv
from tpukern_torch.ops import _ew, reduce

# the running max's start of #34 and #35 (tpukern/ops/softmax.py:29)
NEG_BIG = -1e30
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_MODES = {"safe": 0, "online": 1}


def _check(x, fn, **sizes):
    if x.dim() != 2:
        raise ValueError(f"{fn}: softmax over the last dim of a 2-D array, "
                         f"got shape {tuple(x.shape)}")
    for name, v in sizes.items():
        if v is not None and (not isinstance(v, int) or v <= 0):
            raise ValueError(f"{fn}: {name} must be a positive int, got {v!r}")


def _cuda_input(x, fn):
    _build.check_cuda(x)
    if x.dtype not in _DTYPES:
        raise TypeError(f"{fn} takes float32, bfloat16 or float16, got "
                        f"{x.dtype}")
    return _build.aligned(x)


def _rows(x, mode):
    x = _cuda_input(x, f"softmax ({mode})")
    y = torch.empty_like(x)
    _build.launch("tk_softmax", x.data_ptr(), y.data_ptr(), x.shape[0],
                  x.shape[1], _MODES[mode], _build.CODES[x.dtype],
                  _build.stream(x))
    return y


def softmax_per_token(x, block_rows=None):
    """Safe softmax along the last dim of a 2-D array (#33), rounded once
    to x's dtype. A CPU tensor takes softmax_ref; a CUDA tensor (f32, bf16
    or f16) launches the kernel."""
    _check(x, "softmax_per_token", block_rows=block_rows)
    if x.device.type == "cpu":
        return softmax_ref(x)
    y = _rows(x, "safe")
    softmax_per_token.launches += 1
    return y


softmax_per_token.launches = 0


def online_softmax_per_token(x, block_rows=None, chunk=128):
    """Online softmax along the last dim of a 2-D array (#34): one pass for
    the (max, denominator) pair, one to normalize. CPU: softmax_ref."""
    _check(x, "online_softmax_per_token", block_rows=block_rows, chunk=chunk)
    if x.device.type == "cpu":
        return softmax_ref(x)
    y = _rows(x, "online")
    online_softmax_per_token.launches += 1
    return y


online_softmax_per_token.launches = 0


def _tiles(x, block_rows, block_cols):
    """(block rows, block columns, column blocks) of x's tiles."""
    S, H = x.shape
    br, bc = min(block_rows, max(S, 1)), min(block_cols, max(H, 1))
    return br, bc, cdiv(H, bc)


def grid_stats(x, block_rows=64, block_cols=512):
    """#35: each row's partial (m, d) over each column block of block_cols,
    two f32 (rows, n_col_blocks) tensors. CPU: grid_stats_ref."""
    _check(x, "grid_stats", block_rows=block_rows, block_cols=block_cols)
    if x.device.type == "cpu":
        return grid_stats_ref(x, block_cols)
    x = _cuda_input(x, "grid_stats")
    br, bc, ncb = _tiles(x, block_rows, block_cols)
    m = torch.empty((x.shape[0], ncb), dtype=torch.float32, device=x.device)
    d = torch.empty_like(m)
    _build.launch("tk_softmax_grid_stats", x.data_ptr(), m.data_ptr(),
                  d.data_ptr(), x.shape[0], x.shape[1], br, bc, ncb,
                  _build.CODES[x.dtype], _build.stream(x))
    grid_stats.launches += 1
    return m, d


grid_stats.launches = 0


def grid_norm(x, m, d, block_rows=64, block_cols=512):
    """#36: exp(x - M) / D with (M, D) each row's merged partials (m, d) of
    grid_stats at the same block_cols, rounded once to x's dtype. CPU:
    grid_norm_ref."""
    _check(x, "grid_norm", block_rows=block_rows, block_cols=block_cols)
    if x.device.type == "cpu":
        return grid_norm_ref(x, m, d)
    x = _cuda_input(x, "grid_norm")
    _build.check_cuda(x, m, d)
    br, bc, ncb = _tiles(x, block_rows, block_cols)
    for t in (m, d):
        if t.shape != (x.shape[0], ncb) or t.dtype != torch.float32:
            raise ValueError(f"grid_norm: partials of shape "
                             f"{(x.shape[0], ncb)} in float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    m, d = m.contiguous(), d.contiguous()
    y = torch.empty_like(x)
    _build.launch("tk_softmax_grid_norm", x.data_ptr(), m.data_ptr(),
                  d.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1], br,
                  bc, ncb, _build.CODES[x.dtype], _build.stream(x))
    grid_norm.launches += 1
    return y


grid_norm.launches = 0


def online_softmax_grid(x, block_rows=64, block_cols=512):
    """Grid-streamed online softmax (#35 then #36): tiles of block_rows x
    block_cols, for rows too wide to hold on chip. CPU: softmax_ref."""
    _check(x, "online_softmax_grid", block_rows=block_rows,
           block_cols=block_cols)
    if x.device.type == "cpu":
        return softmax_ref(x)
    m, d = grid_stats(x, block_rows, block_cols)
    return grid_norm(x, m, d, block_rows, block_cols)


def softmax_global(x):
    """Softmax over every element of x (tpukern/ops/softmax.py:195-206):
    max_all (#31), ew_call("exp_sub") (#30), sum_all (#31), ew_call("div")
    (#30). The max and the sum are 0-d tensors on x's device, never read
    on the host; e is rounded to x's dtype, as JAX's is. Each part takes
    its plain version on a CPU tensor."""
    m = reduce.max_all(x)
    e = _ew.ew_call("exp_sub", x, scalars=(m,))
    t = reduce.sum_all(e)
    return _ew.ew_call("div", e, scalars=(t,))


def softmax_ref(x):
    """JAX's _ref_per_token: torch.softmax of the f32 cast along the last
    dim, rounded to x's dtype."""
    return torch.softmax(x.float(), dim=-1).to(x.dtype)


def softmax_global_ref(x):
    """JAX's _ref_global: torch.softmax over every element of the f32 cast,
    rounded to x's dtype."""
    return torch.softmax(x.float().reshape(-1), dim=0).reshape(
        x.shape).to(x.dtype)


def grid_stats_ref(x, block_cols=512):
    """#35's plain version: per column block, m = max(NEG_BIG, the block's
    max) and d = sum(exp(x - m)), in f32."""
    S, H = x.shape
    bc = min(block_cols, max(H, 1))
    ncb = cdiv(H, bc)
    xf = torch.nn.functional.pad(x.float(), (0, ncb * bc - H),
                                 value=-torch.inf).reshape(S, ncb, bc)
    m = xf.amax(-1).clamp_min(NEG_BIG)
    return m, torch.exp(xf - m[..., None]).sum(-1)


def grid_norm_ref(x, m, d):
    """#36's plain version: (M, D) merged from a row's partials, then
    exp(x - M) / D rounded to x's dtype."""
    M = m.amax(-1, keepdim=True)
    D = (d * torch.exp(m - M)).sum(-1, keepdim=True)
    return (torch.exp(x.float() - M) / D).to(x.dtype)


_F32, _BF16, _F16 = torch.float32, torch.bfloat16, torch.float16

# JAX's ten variants (softmax.py:217-235)
_VARIANTS = [
    ("safe_f32_per_token", softmax_per_token, _F32, {}),
    ("safe_f32_r64_per_token", softmax_per_token, _F32, {"block_rows": 64}),
    ("safe_bf16_per_token", softmax_per_token, _BF16, {}),
    ("safe_bf16_r128_per_token", softmax_per_token, _BF16,
     {"block_rows": 128}),
    ("safe_f16_f32_per_token", softmax_per_token, _F16, {}),
    ("online_f32_per_token", online_softmax_per_token, _F32, {}),
    ("online_bf16_per_token", online_softmax_per_token, _BF16, {}),
    ("online_f32_grid", online_softmax_grid, _F32, {}),
    ("online_bf16_grid", online_softmax_grid, _BF16, {}),
]


def _bytes(dt):
    def bytes_moved(x, **_):
        return 2 * x.numel() * dt.itemsize  # x read once, y written once
    return bytes_moved


for _sfx, _impl, _dt, _kw in _VARIANTS:
    register("softmax", f"softmax_{_sfx}",
             ref=lambda x, _dt=_dt: softmax_ref(x.to(_dt)),
             bytes_moved=_bytes(_dt),
             tags=("storage-only",) if _dt in STORAGE_ONLY_DTYPES else ())(
        lambda x, _impl=_impl, _dt=_dt, _kw=_kw, **kw:
        _impl(x.to(_dt), **{**_kw, **kw}))

register("softmax", "softmax_f32_global",
         ref=lambda x: softmax_global_ref(x.to(_F32)),
         bytes_moved=_bytes(_F32))(lambda x: softmax_global(x.to(_F32)))
