"""Variant registry: family -> variant name -> Variant (tpukern/core/registry.py).

The JAX package registers every kernel variant under (family, name) with
its function, its reference and its cost model; harnesses and tests walk
the table. This is the port's table, with the same fields and names:
`ref` is the plain PyTorch version of the variant, taking the same
arguments as `fn`. Importing `tpukern_torch.ops` fills it, as importing
`tpukern.ops` fills the JAX one.

PENDING lists every JAX variant that has no counterpart in the port yet,
with its reason: the ROADMAP.md item that ports it, or the "Do not port"
line that keeps it out. tests/test_torch_registry.py holds the two tables
to the JAX registry: every JAX variant is registered here or pending.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass
class Variant:
    family: str
    name: str
    fn: Callable
    ref: Callable | None = None          # plain PyTorch version
    flops: Callable | None = None        # (*args) -> flop count
    bytes_moved: Callable | None = None  # (*args) -> bytes touched in HBM
    tags: tuple[str, ...] = ()
    doc: str = ""

    def __call__(self, *args: Any, **kw: Any):
        return self.fn(*args, **kw)


_REGISTRY: dict[str, dict[str, Variant]] = {}


def register(family: str, name: str, *, ref=None, flops=None, bytes_moved=None,
             tags=(), doc=""):
    """Decorator registering a kernel variant under (family, name)."""
    def deco(fn):
        fam = _REGISTRY.setdefault(family, {})
        fam[name] = Variant(family, name, fn, ref=ref, flops=flops,
                            bytes_moved=bytes_moved, tags=tuple(tags), doc=doc)
        return fn
    return deco


def get(family: str, name: str) -> Variant:
    return _REGISTRY[family][name]


def variants(family: str) -> dict[str, Variant]:
    return dict(_REGISTRY.get(family, {}))


def families() -> list[str]:
    return sorted(_REGISTRY)


_ZOO = "ROADMAP.md queue 1 item 12 (the op-family zoo)"
_MM = "ROADMAP.md queue 1 item 2 (ops/matmul.py, the rest)"
_FA = "ROADMAP.md queue 1 item 5 (flash_attention, the rest)"

# (family, name) -> why the JAX variant has no port variant yet
PENDING: dict[tuple[str, str], str] = {
    **{("softmax", f"softmax_{s}"): f"{_ZOO}: softmax, kernels #33-#36"
       for s in ("safe_f32_per_token", "safe_f32_r64_per_token",
                 "safe_bf16_per_token", "safe_bf16_r128_per_token",
                 "safe_f16_f32_per_token", "online_f32_per_token",
                 "online_bf16_per_token", "online_f32_grid",
                 "online_bf16_grid", "f32_global")},
    **{("layer_norm", f"layer_norm_{s}"): f"{_ZOO}: layer_norm, kernel #37"
       for s in ("f32_r8", "f32_r64", "bf16_bf16_r16", "bf16_f32_r16",
                 "bf16_f32_r128", "f16_f16_r16", "f16_f32_r16",
                 "f16_f32_r128")},
    **{("embedding", f"embedding_{s}"): f"{_ZOO}: embedding, kernels #38-#40"
       for s in ("prefetch_f32", "prefetch_bf16", "dma_f32", "dma_bf16",
                 "onehot_f32", "onehot_bf16")},
    **{("histogram", s): f"{_ZOO}: histogram, kernel #41"
       for s in ("histogram_i32", "histogram_i32_r128",
                 "histogram_i32_sorted")},
    **{("transpose", f"transpose_{s}"): f"{_ZOO}: transpose, kernel #42"
       for s in ("f32_row", "f32_row_b256", "f32_row_b512", "f32_col",
                 "f32_diag", "bf16_row", "bf16_row_b256", "bf16_diag")},
    ("nms", "nms_f32"): f"{_ZOO}: nms, kernel #43",
    **{("gemv", f"gemv_{s}"): f"{_ZOO}: gemv, kernel #44"
       for s in ("f32_k512", "f32_k2048", "f32_k_full", "f32_mxu",
                 "bf16_k512", "bf16_k_full", "bf16_mxu", "f16_k512",
                 "f16_k_full")},
    ("matmul", "hgemm_accbf16_bf16"): f"{_MM}: a bf16 accumulator in #1-#3",
    ("matmul", "hgemm_f16"): f"{_MM}: f16 inputs in #1-#3",
    ("matmul", "qgemm_i8_i32"): f"{_MM}: the int8 path of qgemm_i8_i32",
    ("attention", "mha_splitq_f16"): f"{_FA}: f16 inputs in #6",
    ("attention", "mha_splitq_bf16_accbf16"): f"{_FA}: a bf16 accumulator "
                                              "in #6",
    ("attention", "mha_splitkv_bf16"): f"{_FA}: flash_attention_splitkv",
    **{("attention", s): "ROADMAP.md Do not port: JAX's own TPU library "
                         "kernels (jax.experimental.pallas.ops.tpu), "
                         "baselines of the TPU harness"
       for s in ("mha_jax_flash", "mha_splash", "mha_splash_tuned")},
}
