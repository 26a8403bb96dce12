"""Ops: one module per op family, each a kernel wrapper plus its plain
PyTorch version (the `*_ref` function beside it)."""
