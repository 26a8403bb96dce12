"""Elementwise vector add and mul (tpukern/ops/elementwise.py), on the
shared template of ops/_ew.py (kernel #30, csrc/elementwise.cu)."""

from tpukern_torch.ops._ew import ew_call, stamp_ew_variants


def add(x, y, **kw):
    """c = a + b (a scalar operand: ew_call("add", x, scalars=(s,)))."""
    return ew_call("add", x, y, **kw)


def mul(x, y, **kw):
    return ew_call("mul", x, y, **kw)


stamp_ew_variants("elementwise", "add")
stamp_ew_variants("elementwise", "mul")
