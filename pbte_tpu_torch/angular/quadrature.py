"""Solid-angle (discrete ordinates) quadrature.

This package's own copy of ``pbte_tpu/angular/quadrature.py``: options,
``build``, the config reader and the golden-format writer. 3D polar nodes discretize mu = cos(theta) on [-1, 1] and
azimuth nodes phi on [0, 2 pi] (Gauss-Legendre or uniform midpoint); 2D
has the one in-plane polar node theta = pi / 2. Directions are the tensor
product, polar-major, and the weights are renormalized to total exactly
4 pi (3D) or 2 pi (2D).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

from pbte_tpu_torch import tracing

Scheme = Literal["gauss", "uniform"]


@dataclasses.dataclass(frozen=True)
class AngularOptions:
    dimension: int = 3
    polar_points: int = 8
    azimuth_points: int = 16
    polar_scheme: Scheme = "gauss"
    azimuth_scheme: Scheme = "gauss"


@dataclasses.dataclass(frozen=True)
class AngularQuad:
    dimension: int
    polar: np.ndarray  # (K,) theta per direction
    azimuth: np.ndarray  # (K,) phi per direction
    weights: np.ndarray  # (K,)
    directions: np.ndarray  # (K, 3) unit vectors
    polar_nodes: np.ndarray  # (n_theta,) distinct theta values
    polar_weights: np.ndarray
    azimuth_nodes: np.ndarray  # (n_phi,)
    azimuth_weights: np.ndarray

    @property
    def num_directions(self) -> int:
        return self.directions.shape[0]

    @property
    def total_weight(self) -> float:
        return float(np.sum(self.weights))


def uniform_midpoint_rule(points: int, a: float, b: float):
    if points <= 0:
        raise ValueError("uniform rule requires positive point count")
    h = (b - a) / points
    x = a + (np.arange(points) + 0.5) * h
    return x, np.full(points, h)


def gauss_legendre_rule(points: int, a: float, b: float):
    if points <= 0:
        raise ValueError("Gauss-Legendre rule requires positive point count")
    x, w = np.polynomial.legendre.leggauss(points)
    half = 0.5 * (b - a)
    mid = 0.5 * (b + a)
    return mid + half * x, half * w


def _rule(scheme: Scheme, points: int, a: float, b: float):
    if scheme == "uniform":
        return uniform_midpoint_rule(points, a, b)
    if scheme == "gauss":
        return gauss_legendre_rule(points, a, b)
    raise ValueError(f"unknown discretization scheme: {scheme}")


def parse_scheme(name: str) -> Scheme:
    key = name.strip().lower()
    if key == "uniform":
        return "uniform"
    if key in ("gauss", "gauss-legendre", "legendre"):
        return "gauss"
    raise ValueError(f"unknown discretization scheme: {name}")


@tracing.stage("pbte.setup.angles")
def build(opts: AngularOptions) -> AngularQuad:
    """Build the product quadrature."""
    if opts.dimension not in (2, 3):
        raise ValueError("angular quadrature dimension must be 2 or 3")

    if opts.dimension == 2:
        mu = np.array([0.0])
        w_mu = np.array([1.0])
    else:
        mu, w_mu = _rule(opts.polar_scheme, opts.polar_points, -1.0, 1.0)
    theta = np.arccos(np.clip(mu, -1.0, 1.0))

    phi, w_phi = _rule(opts.azimuth_scheme, opts.azimuth_points, 0.0,
                       2.0 * np.pi)

    T, P = np.meshgrid(theta, phi, indexing="ij")
    WT, WP = np.meshgrid(w_mu, w_phi, indexing="ij")
    polar = T.reshape(-1)
    azim = P.reshape(-1)
    weights = (WT * WP).reshape(-1)

    sin_t = np.sin(polar)
    cos_t = np.cos(polar)
    dirs = np.stack(
        [
            sin_t * np.cos(azim),
            sin_t * np.sin(azim),
            cos_t if opts.dimension == 3 else np.zeros_like(polar),
        ],
        axis=-1,
    )

    expected_total = 4.0 * np.pi if opts.dimension == 3 else 2.0 * np.pi
    total = float(np.sum(weights))
    if total > 0.0:
        weights = weights * (expected_total / total)

    return AngularQuad(
        dimension=opts.dimension,
        polar=polar,
        azimuth=azim,
        weights=weights,
        directions=dirs,
        polar_nodes=theta,
        polar_weights=w_mu,
        azimuth_nodes=phi,
        azimuth_weights=w_phi,
    )


def options_from_config(cfg: dict) -> AngularOptions:
    """Options from a parsed config.yaml's ``angles:`` block."""
    a = cfg.get("angles", {}) or {}
    return AngularOptions(
        dimension=int(a.get("dimension", 3)),
        polar_points=int(a.get("polar_points", 8)),
        azimuth_points=int(a.get("azimuth_points", 16)),
        polar_scheme=parse_scheme(str(a.get("polar_scheme", "gauss"))),
        azimuth_scheme=parse_scheme(str(a.get("azimuth_scheme", "gauss"))),
    )


def write_quadrature(quad: AngularQuad, path: str) -> None:
    """The reference's golden-format angles dump (``angles_*.txt``)."""
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("Angular quadrature summary\n")
        f.write(f"  dimension        : {quad.dimension}\n")
        f.write(f"  polar points     : {len(quad.polar_nodes)}\n")
        f.write(f"  azimuth points   : {len(quad.azimuth_nodes)}\n")
        f.write(f"  directions       : {quad.num_directions}\n")
        f.write(f"  total weight     : {quad.total_weight:g}\n\n")
        f.write("Directions (idx, theta, phi, weight, dir_x, dir_y, dir_z)\n")
        for i in range(quad.num_directions):
            f.write(
                f"{i} {quad.polar[i]:g} {quad.azimuth[i]:g} {quad.weights[i]:g} "
                f"{quad.directions[i, 0]:g} {quad.directions[i, 1]:g} "
                f"{quad.directions[i, 2]:g}\n"
            )
