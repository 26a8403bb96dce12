"""Core: tiling math, dtype-matched tolerances and the storage-only dtype
policy (tpukern.core's twin)."""

from tpukern_torch.core.config import (STORAGE_ONLY_DTYPES, kernel_dtype,
                                       to_kernel_dtype)
from tpukern_torch.core.tiling import cdiv, round_up
from tpukern_torch.core.tolerances import check_all_close, tol

__all__ = ["cdiv", "round_up", "check_all_close", "tol",
           "STORAGE_ONLY_DTYPES", "kernel_dtype", "to_kernel_dtype"]
