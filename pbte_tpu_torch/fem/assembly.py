"""Batched DG element assembly: volume + face integral tensors.

This package's own copy of ``pbte_tpu/fem/assembly.py``: one
``ElementOps`` of batched float64 tensors shaped (ne, ...) per mesh, for
every geometry and mixed meshes, and the geometry-class helpers the solver
collapses translation-invariant meshes with.
tests/test_torch_host_layers.py holds every tensor to pbte_tpu's.

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

from pbte_tpu_torch import tracing
from pbte_tpu_torch.fem import quadrature as quad
from pbte_tpu_torch.fem import reference as ref
from pbte_tpu_torch.mesh import core as mesh_core


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


@tracing.stage("pbte.setup.face_trace")
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


@tracing.stage("pbte.setup.assemble")
def assemble(
    topo: mesh_core.MeshTopology,
    order: int,
    volume_degree: int | None = None,
    face_degree: int | None = None,
    chunk: int = 4096,
    face_mode: str = "mfem-parity",
    volume_mode: str = "quadrature",
) -> ElementOps:
    """Element operators of any single-geometry or mixed mesh, volume
    operators by 2p+1 quadrature; ``volume_mode="exact"`` computes them
    from closed-form monomial integrals instead (affine simplices only,
    ``fem.exact``: the same values to machine precision, a cross-check)."""
    if face_mode not in ("mfem-parity", "consistent"):
        raise ValueError(f"unknown face_mode: {face_mode}")
    if volume_mode not in ("quadrature", "exact"):
        raise ValueError(f"unknown volume_mode: {volume_mode}")
    if topo.mesh.geom == mesh_core.GEOM_MIXED:
        if volume_mode == "exact":
            raise ValueError(
                "volume_mode='exact' is affine-simplex only; mixed meshes "
                "contain quads"
            )
        return _assemble_mixed(
            topo, order, volume_degree, face_degree, chunk, face_mode
        )
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

    if volume_mode == "exact":
        from pbte_tpu_torch.fem import exact

        basis_int, mass, stiff = exact.volume_operators(
            geom, order, verts[ev]
        )

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


def _assemble_mixed(
    topo: mesh_core.MeshTopology,
    order: int,
    volume_degree: int | None,
    face_degree: int | None,
    chunk: int,
    face_mode: str,
) -> ElementOps:
    """assemble() for 2D mixed triangle+quad meshes (mesh.geom == "mixed").

    Operators are assembled per geometry group and right-padded to
    Dmax = max ndof over member geometries and nf_max face slots:
    - padded DOF rows/cols are zero in every operator EXCEPT mass, which
      gets 1.0 on the padded diagonal so per-element transport matrices
      stay invertible; padded dofs receive zero rhs everywhere (basis_int,
      face_int, coupling rows are zero) and therefore remain exactly 0
      through the solve and the macroscopic mass-solves.
    - padded face slots (a triangle's 4th) carry zero normals, -1 neighbor,
      attr 0 and zero face operators — no-ops in sweep and rhs alike.
    Cross-geometry interior faces integrate the self basis against the
    NEIGHBOR's own-geometry basis on the shared segment, so upwind coupling
    is exact across the tri/quad interface. The reference's MFEM tree gets
    mixed meshes for free from mfem::FiniteElementSpace; the legacy tree is
    single-geometry (ref: Reference Project/include/SpatialMesh/
    SpatialMesh.hpp element templates).
    """
    mesh = topo.mesh
    dim = mesh.dim
    ne = mesh.num_elements
    nf = topo.faces_per_elem
    egeom = mesh.elem_geom
    codes = [int(c) for c in np.unique(egeom)]
    geoms = {c: mesh_core.MFEM_GEOM_CODES[c] for c in codes}
    bases = {c: ref.basis(g, order) for c, g in geoms.items()}
    Dmax = max(b.ndof for b in bases.values())
    origin_c = {c: bases[c].eval(np.zeros((1, dim)))[0] for c in codes}

    vdeg = volume_degree if volume_degree is not None else 2 * order + 1
    fdeg = face_degree if face_degree is not None else 2 * order + 1

    basis_int = np.zeros((ne, Dmax))
    mass = np.zeros((ne, Dmax, Dmax))
    stiff = np.zeros((ne, dim, Dmax, Dmax))
    face_mass = np.zeros((ne, nf, Dmax, Dmax))
    face_int = np.zeros((ne, nf, Dmax))
    coupling = np.zeros((ne, nf, Dmax, Dmax))

    verts = mesh.vertices
    ev = mesh.elem_verts
    nbr_all = topo.elem_neighbor
    nbr_code = np.where(nbr_all >= 0, egeom[np.maximum(nbr_all, 0)], -1)
    first_of_code = {c: int(np.flatnonzero(egeom == c)[0]) for c in codes}

    for c in codes:
        g = geoms[c]
        b = bases[c]
        D = b.ndof
        nv = mesh_core.GEOM_NV[g]
        nfg = mesh_core.GEOM_NF[g]
        es = np.flatnonzero(egeom == c)
        rD = np.arange(D)
        vpts, vw = quad.volume_rule(g, vdeg)
        S = b.eval(vpts)  # (Q, D)
        Gref = b.eval_grad(vpts)  # (Q, D, dim)

        for start in range(0, len(es), chunk):
            sel = es[start : start + chunk]
            Xv = verts[ev[sel][:, :nv]]  # (E, nv, dim)

            J = _map_jacobian(g, Xv, vpts)
            detJ = np.linalg.det(J)
            Jinv = np.linalg.inv(J)
            wdet = vw[None, :] * detJ  # (E, Q)

            basis_int[sel[:, None], rD] = np.einsum("eq,qi->ei", wdet, S)
            mass[np.ix_(sel, rD, rD)] = np.einsum(
                "eq,qi,qj->eij", wdet, S, S
            )
            gphys = np.einsum("qik,eqkd->eqid", Gref, Jinv)
            stiff[np.ix_(sel, np.arange(dim), rD, rD)] = np.einsum(
                "eq,eqid,qj->edij", wdet, gphys, S
            )

            # --- faces: slots 0..nfg-1 are the real ones (connect() sorts
            # -1 padding to the end). Face SHAPES can differ per slot (3D
            # prism: 2 triangles + 3 quads; and the global-face-id sort
            # makes slot -> shape element-dependent), so faces are
            # processed FLAT per vertex-count with that shape's own rule.
            fids = topo.elem_face[sel][:, :nfg]  # (E, nfg), all valid
            fverts = topo.face_verts[fids]  # (E, nfg, fw_max), -1 padded
            ftype = (fverts >= 0).sum(axis=-1)  # (E, nfg) in {2, 3, 4}
            nbr = nbr_all[sel][:, :nfg]
            ncode = nbr_code[sel][:, :nfg]

            for t in np.unique(ftype):
                t = int(t)
                el, fl = np.nonzero(ftype == t)  # local rows (R,)
                ge = sel[el]  # global element ids
                R = len(el)
                fpts, fw_r = quad.face_rule_nv(t, fdeg)
                fbary = _face_bary(t, fpts)  # (Qf, t)
                Xf = verts[fverts[el, fl][:, :t]]  # (R, t, dim)
                Xq = np.einsum("qv,rvd->rqd", fbary, Xf)  # (R, Qf, dim)
                meas = _face_measure(Xf, t, fpts)  # (R, Qf)
                wf = fw_r[None, :] * meas  # (R, Qf)
                rnbr = nbr[el, fl]
                rhas = rnbr >= 0
                rcode = ncode[el, fl]

                if face_mode == "mfem-parity":
                    cself = origin_c[c]
                    measure = wf.sum(axis=-1)  # (R,)
                    face_int[ge, fl, :D] = measure[:, None] * cself
                    face_mass[ge, fl, :D, :D] = measure[
                        :, None, None
                    ] * np.outer(cself, cself)
                    cn = np.zeros((R, Dmax))
                    for cc in codes:
                        mk = rcode == cc
                        cn[mk, : bases[cc].ndof] = origin_c[cc]
                    cpl = np.einsum("r,i,rj->rij", measure, cself, cn)
                else:
                    Xv_r = Xv[el]  # (R, nv, dim)
                    r_self = inverse_map(g, Xv_r, Xq)  # (R, Qf, dim)
                    S_self = b.eval(r_self)  # (R, Qf, D)
                    face_int[ge, fl, :D] = np.einsum(
                        "rq,rqi->ri", wf, S_self
                    )
                    face_mass[ge, fl, :D, :D] = np.einsum(
                        "rq,rqi,rqj->rij", wf, S_self, S_self
                    )
                    Xq_nbr = (
                        Xq + topo.periodic_offset[ge, fl][:, None, :]
                    )
                    cpl = np.zeros((R, D, Dmax))
                    for cc in codes:
                        mk = rcode == cc
                        if not mk.any():
                            continue
                        gn, bn = geoms[cc], bases[cc]
                        nvn, Dn = mesh_core.GEOM_NV[gn], bn.ndof
                        nbr_eval = np.where(mk, rnbr, first_of_code[cc])
                        Xv_nbr = verts[ev[nbr_eval][:, :nvn]]
                        r_nbr = inverse_map(gn, Xv_nbr, Xq_nbr)
                        S_nbr = bn.eval(r_nbr)  # (R, Qf, Dn)
                        cpl_cc = np.einsum(
                            "rq,rqi,rqj->rij", wf, S_self, S_nbr
                        )
                        cpl[mk, :, :Dn] = cpl_cc[mk]
                cpl = np.where(rhas[:, None, None], cpl, 0.0)
                coupling[ge, fl, :D, :] = cpl

        # identity-pad the mass diagonal (invertibility; see docstring)
        for d in range(D, Dmax):
            mass[es, d, d] = 1.0

    return ElementOps(
        geom=mesh_core.GEOM_MIXED,
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


# element_classes and class_coupling pass over the elements (or the class
# representatives) in chunks of this many rows: no temporary is larger than
# a chunk of the largest per-element part (0.2 GB of face_mass at p = 3)
CLASS_CHUNK = 1024


def _chunks(n, chunk):
    return (slice(i, min(i + chunk, n)) for i in range(0, n, chunk))


def _class_parts(ops):
    """The per-element tensors element_classes compares, each with whether
    its axis 1 is the local-face axis."""
    return [(ops.mass, False), (ops.stiff, False), (ops.face_mass, True),
            (ops.face_int, True), (ops.basis_int, False),
            (ops.normals, True)]


def _part_rows(part, rows, perm):
    """``rows`` (a slice or an index array) of a part, faces re-ordered by
    the face permutation ``perm`` (ne, nf) where given, flattened to (n,
    cols)."""
    arr, faces = part
    a = arr[rows]
    if faces and perm is not None:
        idx = perm[rows]
        a = np.take_along_axis(a, idx.reshape(idx.shape + (1,) * (a.ndim - 2)),
                               axis=1)
    return a.reshape(len(a), -1)


def element_classes(
    ops: ElementOps, grain: float = 1e-11, merge: bool = True,
    perm: np.ndarray | None = None,
) -> np.ndarray:
    """Geometry-class index per element: elements whose volume/face operator
    tensors and outward normals agree (to relative `grain`) share a class.

    On translation-invariant meshes (Cartesian builtins, uniform refinements)
    there are only a handful of classes — 1 for hex/quad, 2 for the tri split,
    6 for the 6-tet split — which lets the solver store transport factors per
    CLASS instead of per element: the A^-1 / eigendecomposition cache shrinks
    by a factor of ne/ncls (e.g. 4096x for hex 16^3) and setup stops being
    O(ne) dense factorizations. Boundary-face coupling zeroing is EXCLUDED
    from the signature (the solver masks inflow with cin=0 on boundary faces,
    so class coupling entries there are never read).

    ``perm`` (ne, nf): the classes of ``permute_faces(ops, perm)``, without
    that copy. The elements pass in chunks of ``CLASS_CHUNK`` rows; the
    result does not depend on it.

    Returns class_of_elem (ne,) int64; classes are numbered by first
    occurrence. Correctness does not depend on tight classing — an
    over-split classing only costs performance, and callers fall back to
    per-element operators when the count is large.
    """
    ne = ops.num_elements
    chunk = CLASS_CHUNK
    parts = _class_parts(ops)
    # exact row dedup via two independent wrap-around polynomial hashes,
    # accumulated part by part and chunk by chunk (no (ne, ~6000)
    # concatenation, and no part-sized temporary).
    # Each part quantizes against its OWN scale: normals are O(1) while mass
    # entries are O(volume) ~ 1e-22 after micron scaling — one global scale
    # made every volume-dependent operator invisible to the hash and falsely
    # merged elements that differ only in size (caught by a stretched-lattice
    # oracle test: 1e11 relative field error).
    rng = np.random.default_rng(0x5EED)
    h1 = np.zeros(ne, dtype=np.int64)
    h2 = np.zeros(ne, dtype=np.int64)
    scales = []
    with np.errstate(over="ignore"):
        for part in parts:
            arr = part[0]
            scale = max(max((float(np.abs(arr[sl]).max())
                             for sl in _chunks(ne, chunk)), default=0.0),
                        1e-300)
            scales.append(scale)
            cols = arr[:1].size
            r1 = rng.integers(1, 2**62, size=cols, dtype=np.int64) | 1
            r2 = rng.integers(1, 2**62, size=cols, dtype=np.int64) | 1
            for sl in _chunks(ne, chunk):
                q = np.rint(_part_rows(part, sl, perm)
                            * (1.0 / (scale * grain))).astype(np.int64)
                h1[sl] += q @ r1
                h2[sl] += q @ r2
    hh = np.empty((ne, 2), dtype=np.int64)
    hh[:, 0], hh[:, 1] = h1, h2
    key = hh.view([("a", np.int64), ("b", np.int64)]).ravel()
    _, first_idx, cls = np.unique(
        key, return_index=True, return_inverse=True
    )
    # renumber by first occurrence for determinism (vectorized)
    rank = np.empty(len(first_idx), dtype=np.int64)
    rank[np.argsort(first_idx, kind="stable")] = np.arange(len(first_idx))
    cls = rank[cls]
    if not merge:
        # fine (pre-merge) classes: cheaper, still correct for relative
        # comparisons like "does canonical face ordering reduce the count"
        return cls
    first_elem = np.empty(len(first_idx), dtype=np.int64)
    first_elem[rank] = first_idx
    return _merge_noise_classes(parts, scales, perm, cls, first_elem, chunk)


def _merge_noise_classes(parts, scales, perm, cls, first_elem, chunk,
                         merge_rel: float = 1e-9):
    """Merge classes whose representatives agree to `merge_rel` relative.

    The fine 1e-11 hash grain over-splits when assembly noise straddles a
    quantization boundary: at p=3 the face-trace Newton converges with
    ~4e-12 relative spread across exact translates, which split a
    translation-invariant 8^3 hex mesh into 355 "classes" — disabling the
    ring sweep (ncls gate) and exploding the class-factor build. Unlike
    coarsening the hash grain (which risks silently merging genuinely
    different elements), this pass COMPARES representative rows directly:
    candidate groups come from a coarse two-offset hash over the
    representatives, and every member is then VERIFIED against its group's
    first representative — violators stay separate. Residual over-splits
    (noise straddling both coarse grids in some column) are possible but
    rare, and over-splitting is a performance concern only.

    The representatives' rows (each part over its scale ``scales``, faces
    re-ordered by ``perm`` where given) are read chunk by chunk, never held
    whole, so the pass takes any number of fine classes: the split grows
    with the lattice (355 classes at 8^3, 2793 at 16^3, 9906 of hex 28^3
    p=3's 21,952 elements), and pbte_tpu's cap of 8192 classes, set for the
    memory of the whole (classes, columns) matrix, left that lattice with
    9906 classes (and so on the scan) instead of one."""
    ncls = len(first_elem)
    if ncls <= 1:
        return cls

    def rows(i, idx):
        return _part_rows(parts[i], idx, perm) * (1.0 / scales[i])

    rng = np.random.default_rng(0xC0A15E)
    h1 = np.zeros(ncls, dtype=np.int64)
    h2 = np.zeros(ncls, dtype=np.int64)
    with np.errstate(over="ignore"):
        for i, part in enumerate(parts):
            r1 = rng.integers(1, 2**62, size=part[0][:1].size,
                              dtype=np.int64) | 1
            for sl in _chunks(ncls, chunk):
                pr = rows(i, first_elem[sl])  # (n, cols) normalized
                q1 = np.rint(pr / merge_rel).astype(np.int64)
                q2 = np.rint(pr / merge_rel + 0.49).astype(np.int64)
                h1[sl] += q1 @ r1
                h2[sl] += q2 @ r1
    parent = np.arange(ncls)
    for h in (h1, h2):
        order = np.argsort(h, kind="stable")
        hs = h[order]
        starts = np.flatnonzero(np.r_[True, hs[1:] != hs[:-1]])
        for s, e in zip(starts, np.r_[starts[1:], len(hs)]):
            if e - s < 2:
                continue
            grp = order[s:e]
            base = grp[0]
            # each member's largest deviation from the group's first
            # representative, over every part
            dev = np.zeros(len(grp))
            for i in range(len(parts)):
                ref_row = rows(i, first_elem[base:base + 1])
                for sl in _chunks(len(grp), chunk):
                    np.maximum(dev[sl], np.abs(
                        rows(i, first_elem[grp[sl]]) - ref_row).max(axis=1),
                        out=dev[sl])
            for g in grp[dev <= merge_rel]:
                parent[g] = min(parent[g], parent[base])
    # resolve one level (parents point at smaller ids whose parents are
    # themselves resolved in index order)
    for c in range(ncls):
        parent[c] = parent[parent[c]]
    uniq, merged = np.unique(parent, return_inverse=True)
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[np.argsort(uniq, kind="stable")] = np.arange(len(uniq))
    return rank[merged][cls]


def canonical_face_perm(ops: ElementOps, grain: float = 1e-9) -> np.ndarray:
    """Per-element local-face permutation sorting faces by quantized outward
    normal (lexicographic), breaking ties by original slot.

    On Cartesian meshes the only thing distinguishing translated elements is
    the LOCAL FACE ORDER (faces are globally numbered first-seen, so an
    element's face list order depends on its position). Re-ordering faces by
    normal direction makes every translated copy bit-identical in all
    per-face tensors, collapsing the geometry-class count (hex: 6 -> 1) —
    which turns the sweep's per-element transport solve into ONE dense
    batched matmul. The permutation is pure solver-internal bookkeeping: all
    per-(element, face) arrays must be permuted consistently
    (permute_faces); physics and dump layouts are untouched.
    """
    n = ops.normals  # (ne, nf, dim)
    scale = max(float(np.abs(n).max()), 1.0)
    q = np.round(n / (scale * grain)).astype(np.int64)  # (ne, nf, dim)
    dim = q.shape[-1]
    # primary key = component 0; np.lexsort's LAST key is primary; stable, so
    # ties keep the original slot order
    return np.lexsort(
        tuple(q[:, :, d] for d in range(dim - 1, -1, -1)), axis=-1
    )  # (ne, nf)


def permute_faces(ops: ElementOps, perm: np.ndarray) -> ElementOps:
    """Copy of ops with each element's local-face axis re-ordered by perm
    (ne, nf). Volume tensors are untouched."""
    idx = perm
    return dataclasses.replace(
        ops,
        face_mass=np.take_along_axis(
            ops.face_mass, idx[:, :, None, None], axis=1
        ),
        face_int=np.take_along_axis(ops.face_int, idx[:, :, None], axis=1),
        coupling=np.take_along_axis(
            ops.coupling, idx[:, :, None, None], axis=1
        ),
        normals=np.take_along_axis(ops.normals, idx[:, :, None], axis=1),
        neighbor=np.take_along_axis(ops.neighbor, idx, axis=1),
        face_attr=np.take_along_axis(ops.face_attr, idx, axis=1),
        periodic=np.take_along_axis(ops.periodic, idx, axis=1),
    )


def class_coupling(ops: ElementOps, cls: np.ndarray) -> np.ndarray | None:
    """Per-class neighbor coupling (ncls, nf, D, D), or None if elements of
    one class disagree on any interior face (then coupling must stay
    per-element). Boundary faces contribute nothing (solver masks them).
    Each face's members are compared in chunks of ``CLASS_CHUNK`` rows; the
    result does not depend on it."""
    ncls = int(cls.max()) + 1
    nf, D = ops.faces_per_elem, ops.ndof
    chunk = CLASS_CHUNK
    out = np.zeros((ncls, nf, D, D))
    interior = ops.neighbor >= 0  # (ne, nf)
    for c in range(ncls):
        sel = cls == c
        for f in range(nf):
            idx = np.flatnonzero(sel & interior[:, f])
            if len(idx) == 0:
                continue
            ref_row = ops.coupling[idx[0], f]
            scale = max(np.abs(ref_row).max(), 1e-300)
            for sl in _chunks(len(idx), chunk):
                if (np.abs(ops.coupling[idx[sl], f] - ref_row).max()
                        > 1e-10 * scale):
                    return None
            out[c, f] = ref_row
    return out
