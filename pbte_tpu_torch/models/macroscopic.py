"""Macroscopic closure: the weights (numpy), Tc / Tv reductions and the
residual (tensors).

Port of ``pbte_tpu/models/macroscopic.py``; the weight functions are this
package's own copies of its numpy host math:

    factor[k, bs] = invKn[bs] * w[k] * dw[bs] / C_V
    Tc[e, i]      = sum_{k,bs} factor * u[k, bs, e, i]
    Qc[d, e, i]   = sum_{k,bs} factor * vg[bs] * s[k, d] * u[k, bs, e, i]
    Tv[e]         = sum_i Tc[e, i] * int_K p_i      (cell integrals)
    residual      = ||Tv - Tv_prev||_2 / ||Tv||_2
"""

from __future__ import annotations

import numpy as np
import torch


def macro_weights(quad, tables) -> np.ndarray:
    """(K, BS) temperature accumulation weights."""
    inv_kn = tables.flat("inv_kn")
    dw = tables.flat("dw")
    return np.outer(quad.weights, inv_kn * dw) / tables.heat_cap_v


def slot_weights(quad, tables, dirs_pad, dim: int):
    """The macroscopic and heat-flux weights per direction slot of a
    (G, Km) slot table ``dirs_pad`` (-1 = padded slot, zero weight):
    ``(G, Km, BS)`` and ``(G, Km, BS, dim)``."""
    G, Km = dirs_pad.shape
    valid = dirs_pad >= 0
    safe = np.where(valid, dirs_pad, 0)
    mw = macro_weights(quad, tables)
    fw = flux_weights(quad, tables, dim)
    mw_slots = np.where(valid[..., None], mw[safe], 0.0)
    fw_slots = np.where(valid[None, ..., None],
                        fw[:, safe.reshape(-1)].reshape(dim, G, Km, -1), 0.0)
    return mw_slots, np.moveaxis(fw_slots, 0, -1)


def flux_weights(quad, tables, dim: int) -> np.ndarray:
    """(dim, K, BS) heat-flux accumulation weights."""
    base = macro_weights(quad, tables)  # (K, BS)
    vg = tables.flat("vg")
    return np.einsum("kd,kb,b->dkb", quad.directions[:, :dim], base, vg)


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
