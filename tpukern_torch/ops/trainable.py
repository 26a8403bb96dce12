"""Differentiable wrappers around the kernels (tpukern/ops/trainable.py).

Each is a torch.autograd.Function whose forward and backward run the
kernel wrappers, so on a CUDA tensor both directions launch kernels and
on a CPU tensor both take the plain versions:

- matmul_t: forward one GEMM writing the f32 accumulator (acc_in_out);
  backward two more GEMMs, dA = g·Bᵀ and dB = Aᵀ·g, cast back to the
  input dtypes (trainable.py:23-53).
- rms_norm_t: kernel forward; backward by autograd of rms_norm_ref, as
  in JAX (trainable.py:56-74).
- rope_t: kernel forward; backward is the inverse rotation, sign=-1
  (trainable.py:77-92).
- flash_attention_trainable: the forward saves (q, k, v, o, lse,
  segment_ids); the backward runs flash_attention_bwd on the KV heads as
  they are: the fused kernel walks each GQA group inside and sums dK/dV
  over it (JAX repeats K/V and sums in XLA, attention.py:1001-1047); the
  two-kernel featured backward (a window, softcap or segment_ids) repeats
  them itself.
"""

import torch

from tpukern_torch.ops.attention import flash_attention
from tpukern_torch.ops.attention_bwd import flash_attention_bwd
from tpukern_torch.ops.matmul import matmul
from tpukern_torch.ops.rmsnorm import rms_norm, rms_norm_ref
from tpukern_torch.ops.rope import rope_batched


class _MatmulT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return matmul(a, b, acc_in_out=True)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = matmul(g, b, trans_b=True, acc_in_out=True)
        db = matmul(a.T, g, acc_in_out=True)
        return da.to(a.dtype), db.to(b.dtype)


def matmul_t(a, b):
    """C = A @ B in f32 (whatever the input dtype); backward = two GEMMs."""
    return _MatmulT.apply(a, b)


class _RmsNormT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, eps):
        ctx.save_for_backward(x, g)
        ctx.eps = eps
        return rms_norm(x, g, eps)

    @staticmethod
    def backward(ctx, dy):
        x, g = ctx.saved_tensors
        with torch.enable_grad():
            x_, g_ = x.detach().requires_grad_(), g.detach().requires_grad_()
            y = rms_norm_ref(x_, g_, ctx.eps)
        dx, dg = torch.autograd.grad(y, (x_, g_), dy)
        return dx, dg, None


def rms_norm_t(x, g, eps=1e-5):
    return _RmsNormT.apply(x, g, eps)


class _RopeT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq_len):
        ctx.seq_len = seq_len
        return rope_batched(x, seq_len)

    @staticmethod
    def backward(ctx, dy):
        return rope_batched(dy, ctx.seq_len, sign=-1.0), None


def rope_t(x, seq_len):
    """Batched half-split RoPE on (N*seq_len, D) rows; backward is the
    inverse rotation (rotations are orthogonal)."""
    return _RopeT.apply(x, seq_len)


class _FlashAttentionT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, window, softcap,
                segment_ids):
        o, lse = flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                                 window=window, softcap=softcap,
                                 segment_ids=segment_ids, return_stats=True)
        ctx.save_for_backward(q, k, v, o, lse, *(segment_ids or ()))
        ctx.kw = dict(causal=causal, sm_scale=sm_scale, window=window,
                      softcap=softcap)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse, *seg = ctx.saved_tensors
        kw = dict(ctx.kw, segment_ids=tuple(seg) or None)
        none = (None,) * 5  # causal, sm_scale, window, softcap, segment_ids
        return (*flash_attention_bwd(q, k, v, o, lse, g, **kw), *none)


def flash_attention_trainable(q, k, v, causal=False, sm_scale=None,
                              window=None, softcap=None, segment_ids=None):
    """Differentiable FA-2: kernel forward saving (o, lse), kernel
    backward. window (causal sliding window), softcap (logit cap) and
    segment_ids ((q_seg (B, Sq), kv_seg (B, Skv)) ints, no gradient) run
    the featured forward and the two-kernel backward."""
    return _FlashAttentionT.apply(q, k, v, causal, sm_scale, window, softcap,
                                  segment_ids)
