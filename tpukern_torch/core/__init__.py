"""Core: tiling math and dtype-matched tolerances (tpukern.core's twin)."""

from tpukern_torch.core.tiling import cdiv, round_up
from tpukern_torch.core.tolerances import check_all_close, tol

__all__ = ["cdiv", "round_up", "check_all_close", "tol"]
