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


_MM = "ROADMAP.md queue 1 item 2 (ops/matmul.py, the rest)"
_FA = "ROADMAP.md queue 1 item 5 (flash_attention, the rest)"

# (family, name) -> why the JAX variant has no port variant yet
PENDING: dict[tuple[str, str], str] = {
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
