"""Models: the decoder's parameters, its single-device training step
(with the unfused or the fused LM-head loss), the paged serving path with
greedy or sampled decoding, and speculative decoding, greedy or sampled.

init_params and serving.init_cache build on the card unless the caller
passes device="cpu"; params_from_jax converts to CPU tensors; the rest
runs on the device of its inputs."""

from tpukern_torch.models.transformer import (Config, forward, init_params,
                                              loss_fn, make_train_step,
                                              param_leaves, params_from_jax,
                                              params_to)
from tpukern_torch.models.batcher import ContinuousBatcher, SpeculativeBatcher
from tpukern_torch.models.serving import generate
from tpukern_torch.models.speculative import (speculative_generate,
                                              speculative_sample_generate)

__all__ = ["Config", "forward", "init_params", "loss_fn", "make_train_step",
           "param_leaves", "params_from_jax", "params_to",
           "ContinuousBatcher", "SpeculativeBatcher", "generate",
           "speculative_generate", "speculative_sample_generate"]
