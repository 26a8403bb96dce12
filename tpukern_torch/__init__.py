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
cross-entropy's forward and backward kernels. Later slices added the
rest of serving and training (featured attention, chunked prefill, the
prefix cache, speculation, sampling, the quantized KV tier, w8a16
weights, ring pools, MoE).

The op-family zoo runs through `core.registry`, the counterpart of
tpukern's variant registry: importing `tpukern_torch.ops` registers each
ported (family, name) with its function and plain version, and
`core.registry.PENDING` gives every other JAX variant's reason. The
zoo's own kernels so far: the elementwise template (`ops._ew`, behind
the elementwise and activation families), the two-pass reduction and dot
product (`ops.reduce`, `ops.dot_product`) and the naive GEMM
(`ops.matmul.matmul_naive`); `harness.ops_bench` walks the registry on
the card.
"""

__version__ = "0.1.0"
