"""Integer tiling helpers (tpukern/core/tiling.py)."""


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m
