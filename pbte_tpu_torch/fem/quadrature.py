"""Gauss quadrature on the reference hex and its quad faces.

This package's own copy of the hex rules of ``pbte_tpu/fem/quadrature.py``:
tensor Gauss-Legendre products on [0, 1]^d, exact to the requested degree
(the assembly asks for 2p + 1).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def _gauss01(n: int) -> tuple[np.ndarray, np.ndarray]:
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


@lru_cache(maxsize=None)
def quad_rule(degree: int):
    """Rule on the unit square (the hex's faces): total weight 1."""
    n = max(1, (degree + 2) // 2)
    x, wx = _gauss01(n)
    X, Y = np.meshgrid(x, x, indexing="ij")
    WX, WY = np.meshgrid(wx, wx, indexing="ij")
    pts = np.stack([X.reshape(-1), Y.reshape(-1)], axis=-1)
    return pts, (WX * WY).reshape(-1)


@lru_cache(maxsize=None)
def hex_rule(degree: int):
    """Rule on the unit cube: total weight 1."""
    n = max(1, (degree + 2) // 2)
    x, wx = _gauss01(n)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    WX, WY, WZ = np.meshgrid(wx, wx, wx, indexing="ij")
    pts = np.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], axis=-1)
    return pts, (WX * WY * WZ).reshape(-1)
