"""Activation suite: relu, elu, gelu, swish, sigmoid, hardswish, hardshrink
(tpukern/ops/activations.py), on the shared template of ops/_ew.py
(kernel #30, csrc/elementwise.cu). The JAX kernels' formulas: ELU alpha
1.0 as exp(x) - 1, hardshrink lambda 0.5, gelu in its tanh form; all in
f32, rounded once to the input's dtype. Each family keeps JAX's six
variants."""

from tpukern_torch.ops._ew import ew_call, stamp_ew_variants

ACTIVATIONS = ("relu", "elu", "gelu", "swish", "sigmoid", "hardswish",
               "hardshrink")

for _name in ACTIVATIONS:
    stamp_ew_variants(_name, _name)


def relu(x, **kw):
    return ew_call("relu", x, **kw)


def elu(x, **kw):
    return ew_call("elu", x, **kw)


def gelu(x, **kw):
    return ew_call("gelu", x, **kw)


def swish(x, **kw):
    return ew_call("swish", x, **kw)


def sigmoid(x, **kw):
    return ew_call("sigmoid", x, **kw)


def hardswish(x, **kw):
    return ew_call("hardswish", x, **kw)


def hardshrink(x, **kw):
    return ew_call("hardshrink", x, **kw)
