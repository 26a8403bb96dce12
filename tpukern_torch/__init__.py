"""tpukern_torch — the PyTorch / CUDA port of tpukern for NVIDIA Hopper.

The JAX package `tpukern` stays the reference. This package mirrors its
layout (core/ ops/ models/ harness/) and its module and function names,
so every piece has one counterpart there. Plain tensor code is PyTorch;
every Pallas kernel on the ported path is a kernel written by hand for
sm_90a under `csrc/`, built at first use by `tpukern_torch._build`.

Each kernel wrapper in `ops/` dispatches on the device of its input: a
CPU tensor takes the plain PyTorch version beside it, a CUDA tensor
launches the kernel (or raises). Each wrapper counts its launches in a
`launches` attribute. The entry points that build tensors
(`models.init_params`, `models.serving.init_cache`) build them on the
card unless the caller passes device="cpu"; the rest follow the device
of their inputs.

Ported so far: the paged serving path (`models.serving`,
`models.batcher`) with its four kernels: rms_norm, rope_cached,
flash_attention (forward) and paged_attention (decode); the
single-device training step (`models.transformer` forward, loss_fn,
make_train_step, through `ops.trainable`), which adds matmul,
rope_batched, the flash_attention lse and flash_attention_bwd; and its
`Config.fused_loss` option (`ops.cross_entropy`), which adds the fused
cross-entropy's forward and backward kernels.
"""

__version__ = "0.1.0"
