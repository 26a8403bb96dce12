"""Embedding: row gather from a weight table (tpukern/ops/embedding.py).

Kernels: csrc/embedding.cu, the three gather designs of the JAX module:

- `embedding_prefetch` (#38, replaces embedding.py:39 `kernel`): one
  block a token copies the row its index names, with 16-byte loads and
  stores where the row allows them.
- `embedding_dma` (#39, replaces :71): one block a `block_tokens` tokens
  issues every row's 16-byte `cp.async` copies into shared memory, waits
  for all of them at once, then stores the rows out. S must be a multiple
  of block_tokens (JAX's assert at :67, a ValueError here).
- `embedding_onehot` (#40, replaces :108): JAX computes onehot(idx) . W
  on the matrix unit; each one-hot row has one nonzero term, so the
  kernel selects the row instead: a block of 16 tokens loads their
  indices, then moves the rows in 16-byte units, several rows in flight
  a warp, and writes a zero row for an index outside [0, V). No product,
  so its time does not grow with V. Its `block_tokens` is the TPU's
  block height, checked and otherwise unused.

Every result is bit-equal to a row of the table (or zeros). `idx` is a
1-D int32 or int64 tensor, made int32 on the device (no host read), as
JAX's `astype(int32)`. Indices outside [0, V) never read outside the
table; each variant returns what its JAX variant returns in interpret
mode: #38 and #39 count a negative index from the end and clamp the
result to [0, V - 1]; #40 gives a zero row; `embedding_ref` (JAX's
jnp.take) wraps [-V, 0) and gives NaN rows past that. Each variant's
plain version (`*_plain`, the registry's `ref`) computes its own rule;
#40's selects the row where JAX multiplies by the one-hot, which is the
same for a finite table (an inf in the table makes JAX's product NaN in
that column for every token: ROADMAP.md §3, "not a bit-exact oracle").

On a CPU tensor each function returns its plain version.
"""

import torch

from tpukern_torch import _build
from tpukern_torch.core.registry import register

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_ONEHOT_DTYPES = (torch.float32, torch.bfloat16)
_DMA_MAX_TOKENS = 1024  # csrc/embedding.cu DMA_MAX_TOKENS


def _check(idx, weight, fn):
    if idx.dim() != 1 or weight.dim() != 2:
        raise ValueError(f"{fn}: idx (S,) and weight (V, D), got "
                         f"{tuple(idx.shape)} and {tuple(weight.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{fn}: int32 or int64 indices, got {idx.dtype}")
    if not 0 < weight.shape[0] < 2 ** 31:
        raise ValueError(f"{fn}: V = {weight.shape[0]} rows; the kernels "
                         "take 1 to 2^31 - 1")


def _check_dma(idx, block_tokens):
    if not isinstance(block_tokens, int) or block_tokens <= 0:
        raise ValueError(f"embedding_dma: block_tokens must be a positive "
                         f"int, got {block_tokens!r}")
    if idx.shape[0] % block_tokens:
        raise ValueError(f"embedding_dma: pad the token count to the block "
                         f"size (S = {idx.shape[0]}, block_tokens = "
                         f"{block_tokens})")


def _cuda_args(idx, weight, fn, dtypes=_DTYPES):
    _build.check_cuda(idx, weight)
    if weight.dtype not in dtypes:
        raise TypeError(f"{fn} takes a {' or '.join(map(str, dtypes))} "
                        f"table, got {weight.dtype}")
    out = torch.empty((idx.shape[0], weight.shape[1]), dtype=weight.dtype,
                      device=weight.device)
    return idx.to(torch.int32).contiguous(), weight.contiguous(), out


def _gather(idx, weight, block_tokens, mode, fn):
    idx32, w, out = _cuda_args(idx, weight, fn)
    _build.launch("tk_embedding_gather", idx32.data_ptr(), w.data_ptr(),
                  out.data_ptr(), idx32.shape[0], w.shape[0], w.shape[1],
                  block_tokens, mode, _build.CODES[w.dtype],
                  _build.stream(w))
    return out


def embedding_prefetch(idx, weight):
    """weight[idx] by one block a token (#38). CPU: embedding_prefetch_plain."""
    _check(idx, weight, "embedding_prefetch")
    if idx.device.type == "cpu":
        return embedding_prefetch_plain(idx, weight)
    out = _gather(idx, weight, 0, 0, "embedding_prefetch")
    embedding_prefetch.launches += 1
    return out


embedding_prefetch.launches = 0


def embedding_dma(idx, weight, block_tokens=8):
    """weight[idx] by block_tokens concurrent row copies a block (#39); S
    a multiple of block_tokens (at most 1024 on the card). CPU:
    embedding_dma_plain."""
    _check(idx, weight, "embedding_dma")
    _check_dma(idx, block_tokens)
    if idx.device.type == "cpu":
        return embedding_dma_plain(idx, weight, block_tokens)
    if block_tokens > _DMA_MAX_TOKENS:
        raise ValueError(f"embedding_dma: block_tokens at most "
                         f"{_DMA_MAX_TOKENS} on the card, got {block_tokens}")
    out = _gather(idx, weight, block_tokens, 1, "embedding_dma")
    embedding_dma.launches += 1
    return out


embedding_dma.launches = 0


def embedding_onehot(idx, weight, block_tokens=128):
    """onehot(idx) . weight (#40) as the row selection it computes: the
    row where 0 <= idx < V, else zeros; f32 or bf16 tables. CPU:
    embedding_onehot_plain."""
    _check(idx, weight, "embedding_onehot")
    if not isinstance(block_tokens, int) or block_tokens <= 0:
        raise ValueError(f"embedding_onehot: block_tokens must be a "
                         f"positive int, got {block_tokens!r}")
    if idx.device.type == "cpu":
        return embedding_onehot_plain(idx, weight, block_tokens)
    idx32, w, out = _cuda_args(idx, weight, "embedding_onehot",
                               _ONEHOT_DTYPES)
    S, (V, D) = idx32.shape[0], w.shape
    if S >= 2 ** 31 or D >= 2 ** 31:
        raise ValueError(f"embedding_onehot: S = {S}, D = {D} past int32")
    _build.launch("tk_embedding_onehot", idx32.data_ptr(), w.data_ptr(),
                  out.data_ptr(), S, V, D, _build.CODES[w.dtype],
                  _build.stream(w))
    embedding_onehot.launches += 1
    return out


embedding_onehot.launches = 0


def _rows(idx, V):
    """#38/#39's rule: a negative index counts from the end, then the row
    is clamped to [0, V - 1]."""
    i = idx.to(torch.int32).long()
    return torch.where(i < 0, i + V, i).clamp(0, V - 1)


def embedding_prefetch_plain(idx, weight):
    _check(idx, weight, "embedding_prefetch")
    return weight[_rows(idx, weight.shape[0])]


def embedding_dma_plain(idx, weight, block_tokens=8):
    _check(idx, weight, "embedding_dma")
    _check_dma(idx, block_tokens)
    return weight[_rows(idx, weight.shape[0])]


def embedding_onehot_plain(idx, weight, block_tokens=128):
    """The row where 0 <= idx < V, else zeros."""
    _check(idx, weight, "embedding_onehot")
    V = weight.shape[0]
    i = idx.to(torch.int32).long()
    inside = (i >= 0) & (i < V)
    return torch.where(inside[:, None], weight[i.clamp(0, V - 1)],
                       torch.zeros((), dtype=weight.dtype,
                                   device=weight.device))


def embedding_ref(idx, weight):
    """JAX's embedding_ref, jnp.take: [-V, 0) counts from the end; rows
    past that are NaN."""
    V = weight.shape[0]
    i = idx.to(torch.int32).long()
    inside = (i >= -V) & (i < V)
    return torch.where(inside[:, None], weight[torch.where(
        inside, torch.where(i < 0, i + V, i), 0)],
        torch.full((), torch.nan, dtype=weight.dtype, device=weight.device))


_F32, _BF16 = torch.float32, torch.bfloat16

# embedding.py:137-144
_VARIANTS = [
    ("prefetch_f32", embedding_prefetch, embedding_prefetch_plain, _F32),
    ("prefetch_bf16", embedding_prefetch, embedding_prefetch_plain, _BF16),
    ("dma_f32", embedding_dma, embedding_dma_plain, _F32),
    ("dma_bf16", embedding_dma, embedding_dma_plain, _BF16),
    ("onehot_f32", embedding_onehot, embedding_onehot_plain, _F32),
    ("onehot_bf16", embedding_onehot, embedding_onehot_plain, _BF16),
]


def _read_rows(idx, V, onehot):
    """The distinct table rows a call must read: #40's in [0, V) (a zero
    row reads nothing), #38/#39's after their wrap and clamp."""
    if onehot:
        i = idx.to(torch.int32).long()
        return i[(i >= 0) & (i < V)].unique().numel()
    return _rows(idx, V).unique().numel()


def _bytes(dt, onehot):
    def bytes_moved(idx, weight, **_):
        # the gather's: each distinct row it reads once, S rows written,
        # the indices (the table is never read whole; a repeated row
        # comes from the L2)
        rows = _read_rows(idx, weight.shape[0], onehot) + idx.shape[0]
        return (rows * weight.shape[1] * dt.itemsize
                + idx.numel() * idx.element_size())
    return bytes_moved


for _sfx, _impl, _plain, _dt in _VARIANTS:
    register("embedding", f"embedding_{_sfx}",
             ref=lambda idx, weight, _plain=_plain, _dt=_dt, **kw: _plain(
                 idx, weight.to(_dt), **kw),
             bytes_moved=_bytes(_dt, _sfx.startswith("onehot")))(
        lambda idx, weight, _impl=_impl, _dt=_dt, **kw: _impl(
            idx, weight.to(_dt), **kw))
