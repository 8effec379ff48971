"""Exact monomial integrals over affine simplices.

This package's own copy of ``pbte_tpu/fem/exact.py``, the closed-form
backend of ``assemble(..., volume_mode="exact")``. On the unit reference
simplex {x_i >= 0, sum x_i <= 1}

    int x1^a1 ... xd^ad dx = a1! ... ad! / (a1 + ... + ad + d)!

and affine elements scale by |det J| with a constant J^-1 for gradients,
so basis_int, mass and stiffness are exact in closed form. The default
2p+1 quadrature is exact for them too; this backend is a cross-check.
"""

from __future__ import annotations

from math import factorial

import numpy as np

from pbte_tpu_torch.fem import reference as ref
from pbte_tpu_torch.mesh import core as mesh_core


def monomial_integrals_simplex(expo: np.ndarray, dim: int) -> np.ndarray:
    """Exact integrals of the monomials x^e over the unit simplex.
    expo (M, dim) integer exponents -> (M,)."""
    out = np.empty(len(expo))
    for i, e in enumerate(expo):
        num = 1.0
        for a in e:
            num *= factorial(int(a))
        out[i] = num / factorial(int(e.sum()) + dim)
    return out


def volume_operators(geom: str, order: int, verts: np.ndarray):
    """Exact per-element volume operators for affine simplex elements.

    verts (ne, nv, dim) physical vertices of triangles/tets. Returns
    (basis_int (ne, D), mass (ne, D, D), stiff (ne, dim, D, D)) with the same
    conventions as fem.assembly.assemble.
    """
    if geom not in (mesh_core.GEOM_TRIANGLE, mesh_core.GEOM_TET):
        raise ValueError("exact volume operators require simplex geometry")
    dim = mesh_core.GEOM_DIM[geom]
    b = ref.basis(geom, order)
    expo = b.expo  # (D, dim)
    C = b.coeff  # (D, D): phi_i = sum_k C[i, k] m_k

    # pairwise monomial products: exponents e_k + e_l
    D = len(expo)
    pair = expo[:, None, :] + expo[None, :, :]  # (D, D, dim)
    Mmono = monomial_integrals_simplex(pair.reshape(D * D, dim), dim).reshape(
        D, D
    )
    mass_ref = C @ Mmono @ C.T  # (D, D)
    bint_ref = C @ monomial_integrals_simplex(expo, dim)

    # reference-gradient cross integrals: int dm_k/dr_d * m_l
    grad_ref = np.zeros((dim, D, D))
    for d in range(dim):
        e = expo.copy()
        coef = e[:, d].astype(float)
        e[:, d] = np.maximum(e[:, d] - 1, 0)
        pair_d = e[:, None, :] + expo[None, :, :]
        I = monomial_integrals_simplex(
            pair_d.reshape(D * D, dim), dim
        ).reshape(D, D)
        grad_ref[d] = coef[:, None] * I
    # stiff_ref[d, i, j] = int dphi_i/dr_d phi_j (reference coords)
    stiff_ref = np.einsum("ik,dkl,jl->dij", C, grad_ref, C)

    # affine geometry: J constant per element
    ne = len(verts)
    J = verts[:, 1:, :] - verts[:, :1, :]  # (ne, dim, dim): rows d x/d r
    J = np.swapaxes(J, 1, 2)
    detJ = np.abs(np.linalg.det(J))
    Jinv = np.linalg.inv(J)

    basis_int = detJ[:, None] * bint_ref[None, :]
    mass = detJ[:, None, None] * mass_ref[None]
    # physical gradient: dphi/dx_d = Jinv[k, d] dphi/dr_k
    stiff = np.einsum(
        "e,ekd,kij->edij", detJ, Jinv, stiff_ref
    )
    return basis_int, mass, stiff
