"""Closed-form smoothing parameter of Z^n (the part of the JAX package's
`ops/theta.py` that the sampling path needs)."""

from __future__ import annotations

import math


def smoothing_parameter_zn(n: int, eps: float = 0.01) -> float:
    """eta_eps(Z^n) = sqrt(ln(2n(1+1/eps)) / pi)."""
    return math.sqrt(math.log(2 * n * (1 + 1 / eps)) / math.pi)
