"""Frozen copy of the solver port's host layer ``fem/reference.py`` for the plain
reference: the benchmark works the element operators, angles and
phonon tables out again with it, and never imports the program.

Reference elements: MFEM-compatible L2 nodal bases.

Like the port's copy of ``pbte_tpu/fem/reference.py``: Lagrange bases on
*open* Gauss-Legendre node sets (MFEM's L2 default), with the same node
placement and DOF ordering:

- 1D open nodes: op[0..p] = (p+1)-point Gauss-Legendre nodes on [0, 1].
- triangle: for j<=p, i<=p-j:
    w = op[i]+op[j]+op[p-i-j]; node = (op[i]/w, op[j]/w);  j outer, i inner.
- tetrahedron: analogous with 3 indices, k outer.
- quad/hex: tensor product, x fastest.
- prism: triangle x segment, height outer; pyramid: P_p on the tet's nodes.

Shape functions are evaluated as monomials times an inverse-Vandermonde
coefficient matrix.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

from . import mesh_core

# Reference-element vertex coordinates (MFEM ordering).
REF_VERTS = {
    mesh_core.GEOM_TRIANGLE: np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
    mesh_core.GEOM_QUAD: np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]),
    mesh_core.GEOM_TET: np.array(
        [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    ),
    mesh_core.GEOM_HEX: np.array(
        [
            [0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 1.0, 0.0], [0.0, 1.0, 0.0],
            [0.0, 0.0, 1.0], [1.0, 0.0, 1.0], [1.0, 1.0, 1.0], [0.0, 1.0, 1.0],
        ]
    ),
    mesh_core.GEOM_PRISM: np.array(
        [
            [0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
            [0.0, 0.0, 1.0], [1.0, 0.0, 1.0], [0.0, 1.0, 1.0],
        ]
    ),
    mesh_core.GEOM_PYRAMID: np.array(
        [
            [0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 1.0, 0.0], [0.0, 1.0, 0.0],
            [0.0, 0.0, 1.0],
        ]
    ),
}


def open_gauss_points(p: int) -> np.ndarray:
    """MFEM poly1d.OpenPoints(p, GaussLegendre): (p+1)-point GL nodes on [0,1]."""
    x, _ = np.polynomial.legendre.leggauss(p + 1)
    return 0.5 * (x + 1.0)


def _simplex_exponents(p: int, dim: int) -> np.ndarray:
    """Graded exponent multi-indices matching MFEM's L2 simplex DOF order."""
    out = []
    if dim == 2:
        for j in range(p + 1):
            for i in range(p + 1 - j):
                out.append((i, j))
    else:
        for k in range(p + 1):
            for j in range(p + 1 - k):
                for i in range(p + 1 - k - j):
                    out.append((i, j, k))
    return np.array(out, dtype=np.int64)


def _tensor_exponents(p: int, dim: int) -> np.ndarray:
    rng = np.arange(p + 1)
    if dim == 2:
        I, J = np.meshgrid(rng, rng, indexing="xy")
        return np.stack([I.reshape(-1), J.reshape(-1)], axis=-1)
    K, J, I = np.meshgrid(rng, rng, rng, indexing="ij")
    return np.stack([I.reshape(-1), J.reshape(-1), K.reshape(-1)], axis=-1)


def nodes(geom: str, p: int) -> np.ndarray:
    """L2 nodal points on the reference element, MFEM DOF order. (D, dim)."""
    op = open_gauss_points(p)
    if geom == mesh_core.GEOM_TRIANGLE:
        pts = []
        for j in range(p + 1):
            for i in range(p + 1 - j):
                w = op[i] + op[j] + op[p - i - j]
                pts.append((op[i] / w, op[j] / w))
        return np.array(pts)
    if geom == mesh_core.GEOM_TET:
        pts = []
        for k in range(p + 1):
            for j in range(p + 1 - k):
                for i in range(p + 1 - k - j):
                    w = op[i] + op[j] + op[k] + op[p - i - j - k]
                    pts.append((op[i] / w, op[j] / w, op[k] / w))
        return np.array(pts)
    if geom == mesh_core.GEOM_QUAD:
        return np.array([(op[i], op[j]) for j in range(p + 1) for i in range(p + 1)])
    if geom == mesh_core.GEOM_HEX:
        return np.array(
            [
                (op[i], op[j], op[k])
                for k in range(p + 1)
                for j in range(p + 1)
                for i in range(p + 1)
            ]
        )
    if geom == mesh_core.GEOM_PRISM:
        # tensor triangle(p) x open-GL segment(p): k (height) outer, the
        # triangle's (j, i) inner — matching the hex's z-outer convention.
        # The reference has no wedge coefficient goldens (its committed
        # meshes are tri/quad/tet/hex only), so this ordering is this
        # framework's own convention, documented here.
        pts = []
        for k in range(p + 1):
            for j in range(p + 1):
                for i in range(p + 1 - j):
                    w = op[i] + op[j] + op[p - i - j]
                    pts.append((op[i] / w, op[j] / w, op[k]))
        return np.array(pts)
    if geom == mesh_core.GEOM_PYRAMID:
        # P_p (total-degree) local space with the TET's open-GL lattice as
        # the nodal set: those nodes lie inside the pyramid (x+z<=1 and
        # y+z<=1 follow from x+y+z<=1) and are unisolvent for P_p. DG-L2
        # needs only a linearly-independent local space with exact
        # integrals — the conforming pyramid's rational (Fuentes-style)
        # basis is unnecessary here, and P_p keeps the tet's approximation
        # order. No reference golden exists for pyramids (same note as the
        # prism above).
        return nodes(mesh_core.GEOM_TET, p)
    raise ValueError(f"unsupported geometry: {geom}")


def exponents(geom: str, p: int) -> np.ndarray:
    dim = mesh_core.GEOM_DIM[geom]
    if geom in (mesh_core.GEOM_TRIANGLE, mesh_core.GEOM_TET,
                mesh_core.GEOM_PYRAMID):
        return _simplex_exponents(p, dim)
    if geom == mesh_core.GEOM_PRISM:
        # {x^a y^b z^c : a+b <= p, c <= p} — triangle total-degree in the
        # cross-section, tensor in the extrusion axis (dim (p+1)^2(p+2)/2)
        out = [
            (i, j, k)
            for k in range(p + 1)
            for j in range(p + 1)
            for i in range(p + 1 - j)
        ]
        return np.array(out, dtype=np.int64)
    return _tensor_exponents(p, dim)


def monomials(expo: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Evaluate monomials x^a [y^b [z^c]]. pts (..., dim) -> (..., D)."""
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
        dm = monomial_gradients(self.expo, pts)  # (..., D, dim)
        return np.einsum("ik,...kd->...id", self.coeff, dm)


@lru_cache(maxsize=None)
def basis(geom: str, p: int) -> Basis:
    nds = nodes(geom, p)
    expo = exponents(geom, p)
    V = monomials(expo, nds)  # (D, D): V[i,k] = m_k(node_i)
    coeff = np.linalg.inv(V).T  # phi_i(node_j) = delta_ij
    return Basis(geom=geom, order=p, nodes=nds, expo=expo, coeff=coeff)


def vertex_shape(geom: str, pts: np.ndarray) -> np.ndarray:
    """Multilinear geometry shape functions at ref points: (..., n_verts)."""
    pts = np.asarray(pts, dtype=np.float64)
    x = pts[..., 0]
    y = pts[..., 1]
    if geom == mesh_core.GEOM_TRIANGLE:
        return np.stack([1 - x - y, x, y], axis=-1)
    if geom == mesh_core.GEOM_QUAD:
        return np.stack(
            [(1 - x) * (1 - y), x * (1 - y), x * y, (1 - x) * y], axis=-1
        )
    z = pts[..., 2]
    if geom == mesh_core.GEOM_TET:
        return np.stack([1 - x - y - z, x, y, z], axis=-1)
    if geom == mesh_core.GEOM_HEX:
        return np.stack(
            [
                (1 - x) * (1 - y) * (1 - z), x * (1 - y) * (1 - z),
                x * y * (1 - z), (1 - x) * y * (1 - z),
                (1 - x) * (1 - y) * z, x * (1 - y) * z,
                x * y * z, (1 - x) * y * z,
            ],
            axis=-1,
        )
    if geom == mesh_core.GEOM_PRISM:
        return np.stack(
            [
                (1 - x - y) * (1 - z), x * (1 - z), y * (1 - z),
                (1 - x - y) * z, x * z, y * z,
            ],
            axis=-1,
        )
    if geom == mesh_core.GEOM_PYRAMID:
        # The standard rational pyramid shapes (apex at (0,0,1)); the 0/0 at
        # the apex is resolved by its limit (0,0,0,0,1). Quadrature points
        # and L2 nodes are strictly interior, so the clamp only matters for
        # evaluations exactly at the apex vertex (e.g. VTU corner output).
        zc = np.minimum(z, 1.0 - 1e-12)
        inv = 1.0 / (1.0 - zc)
        N = np.stack(
            [
                (1 - x - zc) * (1 - y - zc) * inv,
                x * (1 - y - zc) * inv,
                x * y * inv,
                y * (1 - x - zc) * inv,
                z * np.ones_like(x),
            ],
            axis=-1,
        )
        apex = z >= 1.0 - 1e-12
        if np.any(apex):
            N[apex] = np.array([0.0, 0.0, 0.0, 0.0, 1.0])
        return N
    raise ValueError(f"unsupported geometry: {geom}")


def vertex_shape_grad(geom: str, pts: np.ndarray) -> np.ndarray:
    """d(vertex shape)/dr at ref points: (..., n_verts, dim)."""
    pts = np.asarray(pts, dtype=np.float64)
    shp = pts.shape[:-1]
    if geom == mesh_core.GEOM_TRIANGLE:
        g = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
        return np.broadcast_to(g, shp + g.shape).copy()
    if geom == mesh_core.GEOM_TET:
        g = np.array([[-1.0, -1.0, -1.0], [1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]])
        return np.broadcast_to(g, shp + g.shape).copy()
    x, y = pts[..., 0], pts[..., 1]
    if geom == mesh_core.GEOM_QUAD:
        out = np.empty(shp + (4, 2))
        out[..., 0, 0] = -(1 - y); out[..., 0, 1] = -(1 - x)
        out[..., 1, 0] = (1 - y);  out[..., 1, 1] = -x
        out[..., 2, 0] = y;        out[..., 2, 1] = x
        out[..., 3, 0] = -y;       out[..., 3, 1] = (1 - x)
        return out
    z = pts[..., 2]
    if geom == mesh_core.GEOM_HEX:
        out = np.empty(shp + (8, 3))
        signs = [
            (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
            (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
        ]
        for vi, (sx, sy, sz) in enumerate(signs):
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
    if geom == mesh_core.GEOM_PRISM:
        out = np.empty(shp + (6, 3))
        lam = [1 - x - y, x, y]
        dlam = [(-1.0, -1.0), (1.0, 0.0), (0.0, 1.0)]
        for t in range(3):
            fz, dfz = (1 - z, -1.0)
            out[..., t, 0] = dlam[t][0] * fz
            out[..., t, 1] = dlam[t][1] * fz
            out[..., t, 2] = dfz * lam[t]
            fz, dfz = (z, 1.0)
            out[..., 3 + t, 0] = dlam[t][0] * fz
            out[..., 3 + t, 1] = dlam[t][1] * fz
            out[..., 3 + t, 2] = dfz * lam[t]
        return out
    if geom == mesh_core.GEOM_PYRAMID:
        # gradients of the rational shapes (see vertex_shape); with
        # u = 1-z, a = 1-x-z, b = 1-y-z:
        #   dN0 = (-b/u, -a/u, xy/u^2 - 1)      dN1 = (b/u, -x/u, -xy/u^2)
        #   dN2 = (y/u, x/u, xy/u^2)            dN3 = (-y/u, a/u, -xy/u^2)
        #   dN4 = (0, 0, 1)
        # genuinely singular at the apex — quadrature/L2 nodes never sit
        # there (clamp matches vertex_shape's)
        zc = np.minimum(z, 1.0 - 1e-12)
        u = 1.0 - zc
        a = 1.0 - x - zc
        b = 1.0 - y - zc
        xyu2 = x * y / (u * u)
        out = np.empty(shp + (5, 3))
        out[..., 0, 0] = -b / u
        out[..., 0, 1] = -a / u
        out[..., 0, 2] = xyu2 - 1.0
        out[..., 1, 0] = b / u
        out[..., 1, 1] = -x / u
        out[..., 1, 2] = -xyu2
        out[..., 2, 0] = y / u
        out[..., 2, 1] = x / u
        out[..., 2, 2] = xyu2
        out[..., 3, 0] = -y / u
        out[..., 3, 1] = a / u
        out[..., 3, 2] = -xyu2
        out[..., 4, 0] = 0.0
        out[..., 4, 1] = 0.0
        out[..., 4, 2] = 1.0
        return out
    raise ValueError(f"unsupported geometry: {geom}")
