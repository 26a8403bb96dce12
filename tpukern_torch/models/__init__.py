"""Models: the decoder's parameters, its single-device training step and
the paged serving path."""

from tpukern_torch.models.transformer import (Config, forward, init_params,
                                              loss_fn, make_train_step,
                                              param_leaves, params_from_jax,
                                              params_to)
from tpukern_torch.models.batcher import ContinuousBatcher

__all__ = ["Config", "forward", "init_params", "loss_fn", "make_train_step",
           "param_leaves", "params_from_jax", "params_to",
           "ContinuousBatcher"]
