"""The reference hex: MFEM-compatible L2 nodal basis and trilinear map.

This package's own copy of the hex parts of ``pbte_tpu/fem/reference.py``.
The basis is Lagrange on the tensor product of the (p+1)-point open
Gauss-Legendre nodes on [0, 1] (MFEM's L2 default), DOFs x fastest, and is
evaluated as monomials times an inverse-Vandermonde coefficient matrix.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

from pbte_tpu_torch.mesh import core as mesh_core


def open_gauss_points(p: int) -> np.ndarray:
    """(p+1)-point Gauss-Legendre nodes on [0, 1]."""
    x, _ = np.polynomial.legendre.leggauss(p + 1)
    return 0.5 * (x + 1.0)


def _hex_only(geom):
    if geom != mesh_core.GEOM_HEX:
        raise ValueError(f"only the hex is supported here, got {geom}")


def nodes(geom: str, p: int) -> np.ndarray:
    """L2 nodal points on the reference hex, MFEM DOF order, (D, 3)."""
    _hex_only(geom)
    op = open_gauss_points(p)
    return np.array([
        (op[i], op[j], op[k])
        for k in range(p + 1) for j in range(p + 1) for i in range(p + 1)
    ])


def exponents(geom: str, p: int) -> np.ndarray:
    """Tensor monomial exponents (D, 3), x fastest."""
    _hex_only(geom)
    rng = np.arange(p + 1)
    K, J, I = np.meshgrid(rng, rng, rng, indexing="ij")
    return np.stack([I.reshape(-1), J.reshape(-1), K.reshape(-1)], axis=-1)


def monomials(expo: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Monomials x^a y^b z^c. pts (..., dim) -> (..., D)."""
    pts = np.asarray(pts, dtype=np.float64)
    out = np.ones(pts.shape[:-1] + (len(expo),))
    for d in range(pts.shape[-1]):
        out = out * pts[..., d:d + 1] ** expo[:, d]
    return out


def monomial_gradients(expo: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """d(monomial)/dr. pts (..., dim) -> (..., D, dim)."""
    pts = np.asarray(pts, dtype=np.float64)
    dim = pts.shape[-1]
    D = len(expo)
    out = np.zeros(pts.shape[:-1] + (D, dim))
    for d in range(dim):
        e = expo.copy()
        coef = e[:, d].astype(np.float64)
        e[:, d] = np.maximum(e[:, d] - 1, 0)
        term = np.ones(pts.shape[:-1] + (D,))
        for dd in range(dim):
            term = term * pts[..., dd:dd + 1] ** e[:, dd]
        out[..., d] = coef * term
    return out


@dataclasses.dataclass(frozen=True)
class Basis:
    """Lagrange basis on an L2 node set: phi_i(x) = sum_k coeff[i,k] m_k(x)."""

    geom: str
    order: int
    nodes: np.ndarray  # (D, dim)
    expo: np.ndarray  # (D, dim)
    coeff: np.ndarray  # (D, D) inverse-Vandermonde transpose

    @property
    def ndof(self) -> int:
        return len(self.nodes)

    def eval(self, pts: np.ndarray) -> np.ndarray:
        """Shape values. pts (..., dim) -> (..., D)."""
        return monomials(self.expo, pts) @ self.coeff.T

    def eval_grad(self, pts: np.ndarray) -> np.ndarray:
        """Reference-coordinate gradients. pts (..., dim) -> (..., D, dim)."""
        dm = monomial_gradients(self.expo, pts)
        return np.einsum("ik,...kd->...id", self.coeff, dm)


@lru_cache(maxsize=None)
def basis(geom: str, p: int) -> Basis:
    nds = nodes(geom, p)
    expo = exponents(geom, p)
    V = monomials(expo, nds)  # V[i, k] = m_k(node_i)
    coeff = np.linalg.inv(V).T  # phi_i(node_j) = delta_ij
    return Basis(geom=geom, order=p, nodes=nds, expo=expo, coeff=coeff)


_HEX_CORNERS = (
    (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
)


def vertex_shape(geom: str, pts: np.ndarray) -> np.ndarray:
    """Trilinear geometry shape functions at ref points: (..., 8)."""
    _hex_only(geom)
    pts = np.asarray(pts, dtype=np.float64)
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    return np.stack(
        [
            (1 - x) * (1 - y) * (1 - z), x * (1 - y) * (1 - z),
            x * y * (1 - z), (1 - x) * y * (1 - z),
            (1 - x) * (1 - y) * z, x * (1 - y) * z,
            x * y * z, (1 - x) * y * z,
        ],
        axis=-1,
    )


def vertex_shape_grad(geom: str, pts: np.ndarray) -> np.ndarray:
    """d(vertex shape)/dr at ref points: (..., 8, 3)."""
    _hex_only(geom)
    pts = np.asarray(pts, dtype=np.float64)
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    out = np.empty(pts.shape[:-1] + (8, 3))
    for vi, (sx, sy, sz) in enumerate(_HEX_CORNERS):
        fx = x if sx else (1 - x)
        fy = y if sy else (1 - y)
        fz = z if sz else (1 - z)
        dfx = 1.0 if sx else -1.0
        dfy = 1.0 if sy else -1.0
        dfz = 1.0 if sz else -1.0
        out[..., vi, 0] = dfx * fy * fz
        out[..., vi, 1] = fx * dfy * fz
        out[..., vi, 2] = fx * fy * dfz
    return out
