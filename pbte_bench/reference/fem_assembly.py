"""Frozen copy of the solver port's host layer ``fem/assembly.py`` for the plain
reference: the benchmark works the element operators, angles and
phonon tables out again with it, and never imports the program.

Batched DG element assembly: volume + face integral tensors.

Like the port's copy of ``pbte_tpu/fem/assembly.py``: one
``ElementOps`` of batched float64 tensors shaped (ne, ...) per mesh, for
every single-geometry mesh.

Tensors (D = DOFs per element, nf = faces per element):

    basis_int  (ne, D)            int_K phi_i
    mass       (ne, D, D)         int_K phi_i phi_j
    stiff      (ne, dim, D, D)    int_K dphi_i/dx_d phi_j
    face_mass  (ne, nf, D, D)     int_F phi_i phi_j      (self side)
    face_int   (ne, nf, D)        int_F phi_i
    coupling   (ne, nf, D, D)     int_F phi_i phi^nbr_j  (0 on boundary)

Face slot ordering follows MeshTopology.elem_face (global face id
ascending). Quadrature degrees default to 2p+1 (volume and faces), exact
for affine elements.

Face modes
----------
The reference's face assembly evaluates the element shapes at the
reference-element origin for every face quadrature point (it never sets
the element integration points), so all of its face tensors are rank one:

    face_mass = |F| c c^T,  face_int = |F| c,  coupling = |F| c c^T,
    with c = phi(origin).

- face_mode="mfem-parity" (default): reproduce that exactly, as golden
  parity needs.
- face_mode="consistent": the textbook upwind-DG face integrals (shapes
  traced onto the face).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import fem_quadrature as quad
from . import fem_reference as ref
from . import mesh_core


@dataclasses.dataclass
class ElementOps:
    geom: str
    order: int
    dim: int
    basis_int: np.ndarray
    mass: np.ndarray
    stiff: np.ndarray
    face_mass: np.ndarray
    face_int: np.ndarray
    coupling: np.ndarray
    # connectivity mirrors (from MeshTopology, for the solver)
    normals: np.ndarray  # (ne, nf, dim)
    neighbor: np.ndarray  # (ne, nf), -1 boundary
    face_attr: np.ndarray  # (ne, nf), 0 interior
    # periodic faces: neighbor >= 0 there, but the coupling must be LAGGED
    # (previous outer iterate) — periodic wrap would create upwind-DAG cycles
    periodic: np.ndarray = None  # (ne, nf) bool
    # global face id per (element, local face) — MFEM's first-seen face
    # numbering, carried only for the integrals_all.txt golden dump
    # (ref: src/Utils.cpp:100-148 prints face_id per coupling block)
    elem_face: np.ndarray = None  # (ne, nf) int32, or None

    def __post_init__(self):
        if self.periodic is None:
            self.periodic = np.zeros(self.neighbor.shape, dtype=bool)

    @property
    def sweep_neighbor(self) -> np.ndarray:
        """Neighbor table with periodic couplings masked out — the one the
        sweep planner must use (periodic faces are lagged, not swept)."""
        if not self.periodic.any():
            return self.neighbor
        return np.where(self.periodic, -1, self.neighbor)

    @property
    def num_elements(self) -> int:
        return self.mass.shape[0]

    @property
    def ndof(self) -> int:
        return self.mass.shape[1]

    @property
    def faces_per_elem(self) -> int:
        return self.face_mass.shape[1]

    @property
    def face_valid(self) -> np.ndarray:
        """(ne, nf) bool — False on the padded face slots of mixed-geometry
        meshes (zero normals, -1 neighbor, zero operators: no-ops in sweep
        and rhs). Single-geometry meshes are all-True."""
        return np.abs(self.normals).sum(axis=-1) > 0.0


def _map_jacobian(geom: str, Xv: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """J[..., d, k] = d x_d / d r_k at ref points. Xv (E, nv, dim),
    pts (Q, dim) -> (E, Q, dim, dim)."""
    vg = ref.vertex_shape_grad(geom, pts)  # (Q, nv, dim)
    return np.einsum("evd,qvk->eqdk", Xv, vg)


def inverse_map(geom: str, Xv: np.ndarray, X: np.ndarray, iters: int = 8) -> np.ndarray:
    """Invert the (multi)linear geometry map.

    Xv (..., nv, dim) element vertex coords; X (..., Q, dim) physical points
    (the leading batch dims of both must match). Exact in one step for affine
    simplices; Newton otherwise."""
    Xb = np.broadcast_to(Xv[..., None, :, :], X.shape[:-1] + Xv.shape[-2:])
    init = {
        mesh_core.GEOM_TRIANGLE: (1.0 / 3.0,) * 2,
        mesh_core.GEOM_TET: (0.25,) * 3,
        # strictly inside their reference cells (the prism's triangle
        # cross-section needs x+y<1; the pyramid needs x,y < 1-z and its
        # rational map is singular at the apex)
        mesh_core.GEOM_PRISM: (1.0 / 3.0, 1.0 / 3.0, 0.5),
        mesh_core.GEOM_PYRAMID: (0.35, 0.35, 0.25),
    }.get(geom, (0.5,) * 3)
    r = np.empty(X.shape)
    r[...] = np.asarray(init[: X.shape[-1]])
    n_iter = 1 if geom in (mesh_core.GEOM_TRIANGLE, mesh_core.GEOM_TET) else iters
    for _ in range(n_iter):
        sh = ref.vertex_shape(geom, r)  # (..., Q, nv)
        F = np.einsum("...v,...vd->...d", sh, Xb) - X
        vg = ref.vertex_shape_grad(geom, r)  # (..., Q, nv, dim)
        J = np.einsum("...vd,...vk->...dk", Xb, vg)
        r = r - np.linalg.solve(J, F[..., None])[..., 0]
        if n_iter > 1:
            # safeguard the Newton iterates: every true preimage lies in
            # the reference cell, so clamping overshoots keeps the
            # Jacobians finite (the pyramid's rational map is singular at
            # z=1 — an unclamped overshoot past the apex makes J
            # inf/singular and poisons the whole batch)
            r = np.clip(r, -1.0, 2.0)
            if geom == mesh_core.GEOM_PYRAMID:
                r[..., 2] = np.minimum(r[..., 2], 1.0 - 1e-6)
    return r


def _face_bary(face_geom_nv: int, pts: np.ndarray) -> np.ndarray:
    """Barycentric/bilinear weights of reference-face points over face verts."""
    if face_geom_nv == 2:
        s = pts[:, 0]
        return np.stack([1 - s, s], axis=-1)
    if face_geom_nv == 3:
        s, t = pts[:, 0], pts[:, 1]
        return np.stack([1 - s - t, s, t], axis=-1)
    s, t = pts[:, 0], pts[:, 1]
    return np.stack([(1 - s) * (1 - t), s * (1 - t), s * t, (1 - s) * t], axis=-1)


def _face_measure(Xf: np.ndarray, face_nv: int, fpts: np.ndarray) -> np.ndarray:
    """|dX/ds| (x |dX/dt|) at each face quad point. Xf (E, nv_f, dim) face
    vertex coords -> (E, Q)."""
    E = Xf.shape[0]
    Q = fpts.shape[0]
    if face_nv == 2:
        d = Xf[:, 1] - Xf[:, 0]  # (E, dim)
        return np.broadcast_to(np.linalg.norm(d, axis=-1)[:, None], (E, Q)).copy()
    if face_nv == 3:
        n = np.cross(Xf[:, 1] - Xf[:, 0], Xf[:, 2] - Xf[:, 0])
        return np.broadcast_to(np.linalg.norm(n, axis=-1)[:, None], (E, Q)).copy()
    # bilinear quad face: tangents vary with (s, t)
    s, t = fpts[:, 0], fpts[:, 1]
    # X(s,t) = (1-s)(1-t) F0 + s(1-t) F1 + st F2 + (1-s)t F3
    dXds = np.einsum(
        "qv,evd->eqd",
        np.stack([-(1 - t), (1 - t), t, -t], axis=-1),
        Xf,
    )
    dXdt = np.einsum(
        "qv,evd->eqd",
        np.stack([-(1 - s), -s, s, (1 - s)], axis=-1),
        Xf,
    )
    return np.linalg.norm(np.cross(dXds, dXdt), axis=-1)


def assemble(
    topo: mesh_core.MeshTopology,
    order: int,
    volume_degree: int | None = None,
    face_degree: int | None = None,
    chunk: int = 4096,
    face_mode: str = "mfem-parity",
    volume_mode: str = "quadrature",
) -> ElementOps:
    """Element operators of a single-geometry mesh, volume and face
    operators by 2p+1 quadrature."""
    if face_mode not in ("mfem-parity", "consistent"):
        raise ValueError(f"unknown face_mode: {face_mode}")
    if topo.mesh.geom == mesh_core.GEOM_MIXED or volume_mode != "quadrature":
        raise ValueError("the reference assembles single-geometry meshes "
                         "by quadrature only")
    mesh = topo.mesh
    geom = mesh.geom
    dim = mesh.dim
    ne = mesh.num_elements
    nf = topo.faces_per_elem
    b = ref.basis(geom, order)
    D = b.ndof

    vdeg = volume_degree if volume_degree is not None else 2 * order + 1
    fdeg = face_degree if face_degree is not None else 2 * order + 1

    vpts, vw = quad.volume_rule(geom, vdeg)
    S = b.eval(vpts)  # (Q, D)
    Gref = b.eval_grad(vpts)  # (Q, D, dim)

    fpts, fw = quad.face_rule(geom, fdeg)
    face_nv = topo.face_verts.shape[1]
    fbary = _face_bary(face_nv, fpts)  # (Qf, nv_f)

    basis_int = np.zeros((ne, D))
    mass = np.zeros((ne, D, D))
    stiff = np.zeros((ne, dim, D, D))
    face_mass = np.zeros((ne, nf, D, D))
    face_int = np.zeros((ne, nf, D))
    coupling = np.zeros((ne, nf, D, D))

    verts = mesh.vertices
    ev = mesh.elem_verts

    for start in range(0, ne, chunk):
        sl = slice(start, min(start + chunk, ne))
        E = sl.stop - sl.start
        Xv = verts[ev[sl]]  # (E, nv, dim)

        # --- volume ---
        J = _map_jacobian(geom, Xv, vpts)  # (E, Q, dim, dim)
        detJ = np.linalg.det(J)
        Jinv = np.linalg.inv(J)
        wdet = vw[None, :] * detJ  # (E, Q)

        basis_int[sl] = np.einsum("eq,qi->ei", wdet, S)
        mass[sl] = np.einsum("eq,qi,qj->eij", wdet, S, S)
        gphys = np.einsum("qik,eqkd->eqid", Gref, Jinv)  # (E, Q, D, dim)
        stiff[sl] = np.einsum("eq,eqid,qj->edij", wdet, gphys, S)

        # --- faces ---
        fids = topo.elem_face[sl]  # (E, nf)
        fverts = topo.face_verts[fids]  # (E, nf, nv_f)
        Xf = verts[fverts]  # (E, nf, nv_f, dim)
        # physical quad points on each face
        Xq = np.einsum("qv,efvd->efqd", fbary, Xf)  # (E, nf, Qf, dim)
        meas = _face_measure(
            Xf.reshape(E * nf, face_nv, dim), face_nv, fpts
        ).reshape(E, nf, -1)  # (E, nf, Qf)
        wf = fw[None, None, :] * meas  # (E, nf, Qf)

        nbr = topo.elem_neighbor[sl]  # (E, nf)
        has_nbr = nbr >= 0
        if face_mode == "mfem-parity":
            # shapes frozen at the reference origin (see module docstring)
            c = b.eval(np.zeros((1, dim)))[0]  # (D,)
            measure = wf.sum(axis=-1)  # (E, nf) total face measure
            face_int[sl] = measure[..., None] * c
            cc = np.outer(c, c)
            face_mass[sl] = measure[..., None, None] * cc
            coupling[sl] = np.where(
                has_nbr[..., None, None], measure[..., None, None] * cc, 0.0
            )
        else:
            # self-side shape values at the true face quadrature points
            Xv_rep = np.broadcast_to(Xv[:, None], (E, nf) + Xv.shape[1:])
            r_self = inverse_map(geom, Xv_rep, Xq)  # (E, nf, Qf, dim)
            S_self = b.eval(r_self)  # (E, nf, Qf, D)

            face_int[sl] = np.einsum("efq,efqi->efi", wf, S_self)
            face_mass[sl] = np.einsum("efq,efqi,efqj->efij", wf, S_self, S_self)

            # neighbor-side shape values (interior faces only); periodic
            # neighbors live across the domain — translate the face quad
            # points by the periodic offset before inverse-mapping into them
            nbr_safe = np.where(has_nbr, nbr, 0)
            Xv_nbr = verts[ev[nbr_safe]]  # (E, nf, nv, dim)
            Xq_nbr = Xq + topo.periodic_offset[sl][:, :, None, :]
            r_nbr = inverse_map(geom, Xv_nbr, Xq_nbr)
            S_nbr = b.eval(r_nbr)  # (E, nf, Qf, D)
            cpl = np.einsum("efq,efqi,efqj->efij", wf, S_self, S_nbr)
            coupling[sl] = np.where(has_nbr[..., None, None], cpl, 0.0)

    return ElementOps(
        geom=geom,
        order=order,
        dim=dim,
        basis_int=basis_int,
        mass=mass,
        stiff=stiff,
        face_mass=face_mass,
        face_int=face_int,
        coupling=coupling,
        normals=topo.normals.copy(),
        neighbor=topo.elem_neighbor.copy(),
        face_attr=topo.elem_face_attr.copy(),
        periodic=topo.elem_face_periodic.copy(),
        elem_face=topo.elem_face.copy(),
    )


