"""Frozen copy of the solver port's host layer ``fem/quadrature.py`` for the plain
reference: the benchmark works the element operators, angles and
phonon tables out again with it, and never imports the program.

Quadrature rules on reference elements.

Like the port's copy of ``pbte_tpu/fem/quadrature.py``. Simplex rules
are collapsed (Duffy) tensor Gauss/Gauss-Jacobi products — exact to the
requested polynomial degree, which is all the assembly needs (volume
integrands on affine elements are polynomials of degree <= 2p+1).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
from scipy.special import roots_jacobi

from . import mesh_core


def _gauss01(n: int) -> tuple[np.ndarray, np.ndarray]:
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def _gauss_jacobi01(n: int, alpha: int) -> tuple[np.ndarray, np.ndarray]:
    """Nodes/weights for int_0^1 f(x) (1-x)^alpha dx."""
    x, w = roots_jacobi(n, alpha, 0.0)
    # map from [-1,1] with weight (1-x)^alpha: dx scaling 1/2, weight scaling (1/2)^alpha
    return 0.5 * (x + 1.0), w * 0.5 ** (alpha + 1)


@lru_cache(maxsize=None)
def segment_rule(degree: int):
    n = max(1, (degree + 2) // 2)
    x, w = _gauss01(n)
    return x.reshape(-1, 1), w


@lru_cache(maxsize=None)
def triangle_rule(degree: int):
    """Collapsed rule on the unit triangle {x,y>=0, x+y<=1}: total weight 1/2."""
    n = max(1, (degree + 2) // 2)
    u, wu = _gauss01(n)
    v, wv = _gauss_jacobi01(n, 1)
    U, V = np.meshgrid(u, v, indexing="ij")
    WU, WV = np.meshgrid(wu, wv, indexing="ij")
    x = U * (1.0 - V)
    y = V
    pts = np.stack([x.reshape(-1), y.reshape(-1)], axis=-1)
    w = (WU * WV).reshape(-1)
    return pts, w


@lru_cache(maxsize=None)
def quad_rule(degree: int):
    n = max(1, (degree + 2) // 2)
    x, wx = _gauss01(n)
    X, Y = np.meshgrid(x, x, indexing="ij")
    WX, WY = np.meshgrid(wx, wx, indexing="ij")
    pts = np.stack([X.reshape(-1), Y.reshape(-1)], axis=-1)
    return pts, (WX * WY).reshape(-1)


@lru_cache(maxsize=None)
def tet_rule(degree: int):
    """Collapsed rule on the unit tet: total weight 1/6."""
    n = max(1, (degree + 2) // 2)
    u, wu = _gauss01(n)
    v, wv = _gauss_jacobi01(n, 1)
    t, wt = _gauss_jacobi01(n, 2)
    U, V, T = np.meshgrid(u, v, t, indexing="ij")
    WU, WV, WT = np.meshgrid(wu, wv, wt, indexing="ij")
    x = U * (1.0 - V) * (1.0 - T)
    y = V * (1.0 - T)
    z = T
    pts = np.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], axis=-1)
    return pts, (WU * WV * WT).reshape(-1)


@lru_cache(maxsize=None)
def hex_rule(degree: int):
    n = max(1, (degree + 2) // 2)
    x, wx = _gauss01(n)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    WX, WY, WZ = np.meshgrid(wx, wx, wx, indexing="ij")
    pts = np.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], axis=-1)
    return pts, (WX * WY * WZ).reshape(-1)


@lru_cache(maxsize=None)
def prism_rule(degree: int):
    """Triangle x segment tensor rule on the reference wedge: total 1/2."""
    tpts, tw = triangle_rule(degree)
    n = max(1, (degree + 2) // 2)
    zpts, zw = _gauss01(n)
    pts = np.concatenate(
        [
            np.repeat(tpts, len(zpts), axis=0),
            np.tile(zpts, len(tpts))[:, None],
        ],
        axis=-1,
    )
    return pts, (tw[:, None] * zw[None, :]).reshape(-1)


@lru_cache(maxsize=None)
def pyramid_rule(degree: int):
    """Collapsed rule on the reference pyramid (base unit square, apex at
    (0,0,1)): map (u,v,w) in [0,1]^3 to (u(1-w), v(1-w), w) with Jacobian
    (1-w)^2, absorbed EXACTLY by a Gauss-Jacobi alpha=2 rule in w — so any
    polynomial of total degree <= `degree` integrates exactly (the same
    Duffy idea as the tet rule). Total weight 1/3."""
    n = max(1, (degree + 2) // 2)
    u, wu = _gauss01(n)
    v, wv = _gauss01(n)
    t, wt = _gauss_jacobi01(n, 2)
    U, V, T = np.meshgrid(u, v, t, indexing="ij")
    WU, WV, WT = np.meshgrid(wu, wv, wt, indexing="ij")
    x = U * (1.0 - T)
    y = V * (1.0 - T)
    z = T
    pts = np.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], axis=-1)
    return pts, (WU * WV * WT).reshape(-1)


def volume_rule(geom: str, degree: int):
    return {
        mesh_core.GEOM_TRIANGLE: triangle_rule,
        mesh_core.GEOM_QUAD: quad_rule,
        mesh_core.GEOM_TET: tet_rule,
        mesh_core.GEOM_HEX: hex_rule,
        mesh_core.GEOM_PRISM: prism_rule,
        mesh_core.GEOM_PYRAMID: pyramid_rule,
    }[geom](degree)


def face_rule(geom: str, degree: int):
    """Rule on the reference *face* (segment for 2D, tri/quad for 3D).

    Points are barycentric-style parameters: (s,) for segments, (s, t) for
    2D faces; weights integrate over the unit face (total 1, 1/2, 1).
    Only valid for uniform-face geometries; prism/pyramid faces mix types —
    use face_rule_nv with the actual face's vertex count."""
    if geom in (mesh_core.GEOM_TRIANGLE, mesh_core.GEOM_QUAD):
        return segment_rule(degree)
    if geom == mesh_core.GEOM_TET:
        return triangle_rule(degree)
    if geom in (mesh_core.GEOM_PRISM, mesh_core.GEOM_PYRAMID):
        raise ValueError(f"{geom} faces mix types; use face_rule_nv")
    return quad_rule(degree)


def face_rule_nv(face_nv: int, degree: int):
    """Face rule by the face's vertex count: 2 = segment, 3 = triangle,
    4 = (bilinear) quad. The mixed-geometry assembly path uses this, since
    an element's faces can mix shapes (prism: 2 triangles + 3 quads)."""
    return {2: segment_rule, 3: triangle_rule, 4: quad_rule}[face_nv](degree)
