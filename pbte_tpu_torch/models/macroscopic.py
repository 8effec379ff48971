"""Macroscopic closure on tensors: Tc / Tv reductions and the residual.

Port of ``pbte_tpu/models/macroscopic.py``. The weight functions are numpy
host math and are re-exported from there unchanged.
"""

from __future__ import annotations

import torch

from pbte_tpu.models.macroscopic import flux_weights, macro_weights

__all__ = ["compute_tc", "compute_tv", "flux_weights", "macro_weights",
           "residual"]


def compute_tc(u: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """u (K, BS, ne, D), weights (K, BS) -> Tc (ne, D)."""
    return torch.einsum("kb,kbei->ei", weights, u)


def compute_tv(Tc: torch.Tensor, basis_int: torch.Tensor) -> torch.Tensor:
    """Tc (ne, D), basis integrals (ne, D) -> cell integrals Tv (ne,)."""
    return torch.einsum("ei,ei->e", Tc, basis_int)


def residual(Tv: torch.Tensor, Tv_prev: torch.Tensor) -> torch.Tensor:
    """||Tv - Tv_prev|| / ||Tv||, computed scale-invariantly.

    Tv holds cell integrals, ~1e-22 for micron-scale 3D cells: squaring
    them underflows float32, so both vectors are divided by max|Tv| first
    (exact in the ratio)."""
    tiny = torch.finfo(Tv.dtype).tiny
    scale = torch.clamp(Tv.abs().max(), min=tiny)
    a = Tv / scale
    b = Tv_prev / scale
    return torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(a)
