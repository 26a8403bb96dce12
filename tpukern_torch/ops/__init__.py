"""Ops: one module per op family, each a kernel wrapper plus its plain
PyTorch version (the `*_ref` function beside it). Importing this package
imports every ported family and so fills the variant registry
(tpukern_torch.core.registry), as tpukern/ops/__init__.py does."""

from tpukern_torch.ops import (  # noqa: F401
    elementwise,
    activations,
    reduce,
    dot_product,
    softmax,
    layernorm,
    embedding,
    histogram,
    transpose,
    gemv,
    nms,
    rmsnorm,
    rope,
    matmul,
    matmul_w8a16,
    grouped_matmul,
    attention,
    attention_bwd,
    paged_attention,
    quant,
    cross_entropy,
    sampling,
    trainable,
)
