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
- `grid_fused` (#35 + #36 in one cluster launch, replaces :134 and
  :172): where a row's ncb column tiles fit one thread-block cluster
  (ncb <= CLUSTER_LIMIT, 16, and a tile row of f32 of at most 64 KiB,
  16 KiB in a cluster of more than 8),
  `online_softmax_grid` launches one kernel instead of the two: a
  cluster of ncb blocks of a warp a row spans a block of R rows, block k
  holds tile k in shared memory, posts its rows' partials, reads the
  cluster's ncb partials through distributed shared memory after a
  cluster barrier,
  merges them in the fixed order k = 0 ... ncb - 1 (`grid_fused_ref`
  models it) and writes its tile as exp(x - m_k) (kept from the partial)
  times exp(m_k - M) / D: x is read once, one exp an element. As many
  clusters as fit on the card walk the row blocks, the next tile's
  copies in flight while one is used. `grid_plan` mirrors the launcher's
  shape rule (which path, the rows a block), `grid_tiles` the tiles each
  block owns; a shape with more tiles keeps #35 then #36. The rule is
  never a retry: a refused cluster launch raises. `fused_plan` reads the
  launcher's configuration (rows a block, shared memory, the clusters
  that fit) from the C rule itself.
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
`grid_stats_ref` and `grid_norm_ref`, and the cluster kernel
`grid_fused_ref`.
"""

import collections

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

# the cluster kernel's rule (csrc/softmax.cu SM_FUSED_*, SM_CLUSTER_*)
FUSED_TILE_BYTES = 8 * 1024  # of x a tile
FUSED_ROWS_MAX = 32
FUSED_ROW_BYTES_MAX = 64 * 1024
FUSED_ROW_BYTES_WIDE = 16 * 1024  # in a cluster of more than 8
CLUSTER_PORTABLE = 8
CLUSTER_LIMIT = 16  # non-portable above CLUSTER_PORTABLE

GridPlan = collections.namedtuple(
    "GridPlan", "path rows_a_block block_cols ncb blocks")


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


def grid_plan(rows, cols, block_rows=64, block_cols=512, itemsize=4):
    """The path online_softmax_grid takes on a (rows, cols) array of
    itemsize-byte elements, by csrc/softmax.cu fused_rows: "cluster" (one
    launch, rows_a_block R rows a row block, FUSED_TILE_BYTES of x a tile;
    blocks the row blocks times ncb: the tiles) where the row's ncb tiles
    of block_cols fit one cluster and a tile row of f32 (the kernel keeps
    exp(x - m) in f32, whatever the dtype) fits FUSED_ROW_BYTES_MAX
    (FUSED_ROW_BYTES_WIDE in a cluster of more than 8); else "two" (#35
    then #36, each a block a tile of block_rows rows)."""
    br, bc = min(block_rows, max(rows, 1)), min(block_cols, max(cols, 1))
    ncb = cdiv(cols, bc)
    row_max = (FUSED_ROW_BYTES_WIDE if ncb > CLUSTER_PORTABLE
               else FUSED_ROW_BYTES_MAX)
    if ncb <= CLUSTER_LIMIT and bc * 4 <= row_max:
        R = FUSED_TILE_BYTES // (bc * itemsize)
        R = min(max(R, 1), FUSED_ROWS_MAX, max(rows, 1))
        return GridPlan("cluster", R, bc, ncb, cdiv(rows, R) * ncb)
    return GridPlan("two", br, bc, ncb, cdiv(rows, br) * ncb)


def grid_tiles(plan, rows, cols, clusters=None):
    """[(block, first row, end row, first column, end column)] of every
    tile of plan's launch (each launch of the two-launch path), in the
    order each block takes them: the cluster kernel's clusters (clusters
    of them, default one a row block) walk the row blocks c, c +
    clusters, ..., and the block of rank k takes column tile k, so row
    block i's tile j is block (i % clusters) * ncb + j's; #35's and #36's
    block (x = j, y = i) is tile j of row block i."""
    R, bc, ncb = plan.rows_a_block, plan.block_cols, plan.ncb
    row_blocks = plan.blocks // ncb
    n = clusters if plan.path == "cluster" and clusters else row_blocks
    out = []
    for c in range(min(n, row_blocks)):
        for i in range(c, row_blocks, n):
            for j in range(ncb):
                out.append((c * ncb + j, i * R, min(i * R + R, rows),
                            j * bc, min(j * bc + bc, cols)))
    return out


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


def grid_fused(x, block_rows=64, block_cols=512):
    """#35 + #36 in one cluster launch: exp(x - M) / D with (M, D) each
    row's partials over column blocks of block_cols merged in the order
    k = 0 ... ncb - 1, rounded once to x's dtype. Only for a shape that
    grid_plan gives the cluster path (ValueError else). CPU:
    grid_fused_ref."""
    _check(x, "grid_fused", block_rows=block_rows, block_cols=block_cols)
    if x.device.type == "cpu":
        return grid_fused_ref(x, block_cols)
    x = _cuda_input(x, "grid_fused")
    plan = grid_plan(*x.shape, block_rows, block_cols, x.element_size())
    if plan.path != "cluster":
        raise ValueError(f"grid_fused: {tuple(x.shape)} at block_cols "
                         f"{block_cols} has {plan.ncb} column tiles, more "
                         f"than a cluster of {CLUSTER_LIMIT} holds (or a "
                         f"tile row past {FUSED_ROW_BYTES_MAX} bytes): "
                         f"#35 then #36 take it")
    y = torch.empty_like(x)
    _build.launch("tk_softmax_grid_fused", x.data_ptr(), y.data_ptr(),
                  x.shape[0], x.shape[1], plan.block_cols, plan.ncb,
                  _build.CODES[x.dtype], _build.stream(x))
    grid_fused.launches += 1
    return y


grid_fused.launches = 0


def fused_plan(rows, cols, dtype, block_cols=512, device="cuda"):
    """The cluster kernel's (rows a block, shared bytes a block, most
    active clusters by cudaOccupancyMaxActiveClusters, clusters a launch
    runs) for the shape, from the C launcher's own rule: rows a block 0
    where the shape takes #35 then #36."""
    bc = min(block_cols, max(cols, 1))
    out = torch.zeros(4, dtype=torch.int32)
    with torch.cuda.device(device):
        _build.launch("tk_softmax_grid_fused_plan", rows, cols, bc,
                      cdiv(cols, bc), _build.CODES[dtype], out.data_ptr())
    return tuple(out.tolist())


def online_softmax_grid(x, block_rows=64, block_cols=512):
    """Grid-streamed online softmax: tiles of block_rows x block_cols, for
    rows too wide to hold on chip. One cluster launch (grid_fused) where
    grid_plan gives the shape the cluster path, else #35 then #36. CPU:
    softmax_ref."""
    _check(x, "online_softmax_grid", block_rows=block_rows,
           block_cols=block_cols)
    if x.device.type == "cpu":
        return softmax_ref(x)
    if grid_plan(*x.shape, block_rows, block_cols,
                 x.element_size()).path == "cluster":
        return grid_fused(x, block_rows, block_cols)
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


def grid_fused_ref(x, block_cols=512):
    """The cluster kernel's plain version: each column block's partial m_k
    = max(NEG_BIG, its max), e = exp(x - m_k) in f32 and d_k = sum(e)
    (#35's); M = max_k m_k, D = the sum of d_k exp(m_k - M) over k = 0 ...
    ncb - 1 in that order; then e s_k with s_k = exp(m_k - M) / D, rounded
    to x's dtype."""
    S, H = x.shape
    bc = min(block_cols, max(H, 1))
    ncb = cdiv(H, bc)
    xf = torch.nn.functional.pad(x.float(), (0, ncb * bc - H),
                                 value=-torch.inf).reshape(S, ncb, bc)
    m = xf.amax(-1).clamp_min(NEG_BIG)
    e = torch.exp(xf - m[..., None])
    M = m.amax(-1, keepdim=True)
    t = e.sum(-1) * torch.exp(m - M)
    D = t[:, :1]
    for k in range(1, ncb):
        D = D + t[:, k:k + 1]
    s = torch.exp(m - M) / D
    return (e * s[..., None]).reshape(S, ncb * bc)[:, :H].to(x.dtype)


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
