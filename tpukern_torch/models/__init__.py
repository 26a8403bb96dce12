"""Models: the decoder's parameters and the paged serving path."""

from tpukern_torch.models.transformer import (Config, init_params,
                                              params_from_jax, params_to)
from tpukern_torch.models.batcher import ContinuousBatcher

__all__ = ["Config", "init_params", "params_from_jax", "params_to",
           "ContinuousBatcher"]
