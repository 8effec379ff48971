"""Sequential numpy oracle: a direct mirror of the reference serial solver.

This package's own copy of ``pbte_tpu/validation/oracle.py::solve_oracle``,
an independent second reference for the tests: greedy sweep order,
per-element dense solves, in-place coefficient updates. Slow (pure Python
loops) — use only on tiny problems.
"""

from __future__ import annotations

import numpy as np

from pbte_tpu_torch.models import macroscopic
from pbte_tpu_torch.solver.lattice_tables import mirror_direction_map
from pbte_tpu_torch.sweep import planner


def solve_oracle(ops, quad, tables, bc_temps, tol=1e-7, max_iter=101, record=None,
                 part=None, dirichlet=None, diffuse=None, specular=None):
    """Returns (u, Tc, Tv, residual, iters). u shape (K, BS, ne, D).

    If `part` (ne,) is given, cross-partition neighbor reads use the PREVIOUS
    iteration's coefficients (block-Jacobi lagged interfaces) while
    within-partition reads stay Gauss-Seidel — the legacy MPI solver's
    semantics (ref: reference/DGSolver/PBTE_NonGraySMRT_MPI.cpp:403-506).

    `diffuse` / `specular` are iterables of boundary attrs carrying the
    legacy BC types 2/3 — which BOTH reference trees parse but reject at
    solve time (ref: Reference Project/config/control/Control.yaml:23-30;
    PBTE_NonGraySMRT.cpp:125-127) — implemented here as LAGGED couplings
    (previous outer iterate), exactly like periodic wraps:
    - diffuse: the incoming intensity is face-isotropic per band, sized so
      the face's net energy flux per band is zero (Lambert reflection):
      u_in(b) = [sum_k w_k (s_k.n)^+ int_F u_k] / (|F| sum_k w_k (s_k.n)^-)
    - specular: u_in(s) = own-element trace at the mirrored direction
      s' = s - 2(s.n)n, which must land exactly on another quadrature
      node (axis-aligned faces + mirror-symmetric quadratures)."""
    ne, D, nf = ops.num_elements, ops.ndof, ops.faces_per_elem
    dim = ops.dim
    K = quad.num_directions
    inv_kn = tables.flat("inv_kn")
    vg_t = tables.flat("vg")
    heat_cap = tables.flat("heat_cap")
    BS = len(inv_kn)
    omega = quad.total_weight
    dt_inv = inv_kn.max()
    dirs = quad.directions[:, :dim]

    # periodic faces are masked from the sweep order (they would close
    # cycles) and read lagged below, like cross-partition interfaces
    has_periodic = bool(ops.periodic.any())
    orders = planner.greedy_orders(ops.sweep_neighbor, ops.normals, dirs)
    fdot = np.einsum("efd,kd->kef", ops.normals, dirs)  # (K, ne, nf)

    mass_t = np.swapaxes(ops.mass, -1, -2)
    bc_T = np.zeros((ne, nf))
    for attr, T in bc_temps.items():
        bc_T[ops.face_attr == int(attr)] = float(T)
    # Dirichlet (legacy type 7): prescribed incoming intensity g per attr
    dvec = np.zeros((ne, nf, D))
    for attr, gval in (dirichlet or {}).items():
        sel = ops.face_attr == int(attr)
        dvec[sel] = float(gval) * ops.face_int[sel]

    w_k = quad.weights
    is_diffuse = np.zeros((ne, nf), dtype=bool)
    for attr in diffuse or ():
        is_diffuse |= ops.face_attr == int(attr)
    is_specular = np.zeros((ne, nf), dtype=bool)
    for attr in specular or ():
        is_specular |= ops.face_attr == int(attr)
    mirror_of = None
    if is_specular.any():
        n_spec = ops.normals[is_specular]
        ax_err = np.abs(np.abs(n_spec).max(axis=-1) - 1.0).max()
        if ax_err > 1e-9:
            raise ValueError("specular faces must be axis-aligned")
        axes = set(int(np.argmax(np.abs(n))) for n in n_spec)
        mirror_of = mirror_direction_map(quad, dim, axes=axes)

    # A and factorization per (k, bs, e)
    G = -np.einsum("kd,edij->keij", dirs, ops.stiff) + np.einsum(
        "kef,efij->keij", np.maximum(fdot, 0.0), ops.face_mass
    )
    A = dt_inv * ops.mass[None, None] + vg_t[None, :, None, None, None] * G[:, None]
    A_inv = np.linalg.inv(A)  # (K, BS, ne, D, D)

    u = np.zeros((K, BS, ne, D))
    Tc = np.zeros((ne, D))
    Tv = np.zeros(ne)
    prev_Tv = Tv.copy()
    macro_w = macroscopic.macro_weights(quad, tables)  # (K, BS)

    need_lag = (
        part is not None or has_periodic
        or is_diffuse.any() or is_specular.any()
    )
    res = np.inf
    for it in range(1, max_iter + 1):
        prev_Tc = Tc
        u_lag = u.copy() if need_lag else None
        # lagged diffuse closure: per (face, band) isotropic incoming
        # intensity balancing the previous iterate's outgoing flux
        u_diff = None
        if is_diffuse.any():
            u_diff = np.zeros((ne, nf, BS))
            for e, f in np.argwhere(is_diffuse):
                wplus = w_k * np.maximum(fdot[:, e, f], 0.0)  # (K,)
                cnorm = float((w_k * np.maximum(-fdot[:, e, f], 0.0)).sum())
                areaF = float(ops.face_int[e, f].sum())  # int_F 1
                out_flux = np.einsum(
                    "k,kbi,i->b", wplus, u_lag[:, :, e], ops.face_int[e, f]
                )
                u_diff[e, f] = out_flux / max(cnorm * areaF, 1e-300)
        for k in range(K):
            for bs in range(BS):
                for e in orders[k]:
                    rhs = (inv_kn[bs] * heat_cap[bs] / omega) * (mass_t[e] @ prev_Tc[e])
                    rhs += (dt_inv - inv_kn[bs]) * (mass_t[e] @ u[k, bs, e])
                    for f in range(nf):
                        coeff_in = vg_t[bs] * min(fdot[k, e, f], 0.0)
                        if coeff_in == 0.0:
                            continue
                        nbr = ops.neighbor[e, f]
                        if nbr < 0:
                            if is_diffuse[e, f]:
                                rhs += (
                                    -coeff_in * u_diff[e, f, bs]
                                    * ops.face_int[e, f]
                                )
                                continue
                            if is_specular[e, f]:
                                ax = int(np.argmax(np.abs(ops.normals[e, f])))
                                km = mirror_of[ax, k]
                                rhs += -coeff_in * (
                                    ops.face_mass[e, f] @ u_lag[km, bs, e]
                                )
                                continue
                            rhs += (
                                -coeff_in
                                * heat_cap[bs]
                                / omega
                                * bc_T[e, f]
                                * ops.face_int[e, f]
                            )
                            rhs += -coeff_in * dvec[e, f]
                        else:
                            lagged = (
                                part is not None and part[nbr] != part[e]
                            ) or ops.periodic[e, f]
                            u_src = u_lag if lagged else u
                            rhs += -coeff_in * (ops.coupling[e, f] @ u_src[k, bs, nbr])
                    u[k, bs, e] = A_inv[k, bs, e] @ rhs
        Tc = np.einsum("kb,kbei->ei", macro_w, u)
        Tv = np.einsum("ei,ei->e", Tc, ops.basis_int)
        res = np.linalg.norm(Tv - prev_Tv) / np.linalg.norm(Tv)
        if record is not None:
            record.append((it, res, Tc.copy()))
        if res < tol:
            break
        prev_Tv = Tv.copy()
    return u, Tc, Tv, res, it
