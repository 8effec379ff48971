"""Batched DG element assembly on hex meshes: volume and face integrals.

This package's own copy of the parts of ``pbte_tpu/fem/assembly.py`` the
lattice path uses: ``assemble`` with the textbook (``"consistent"``) upwind-DG
face integrals on a hex mesh, and the geometry-class helpers the solver
collapses translation-invariant meshes with. One ``ElementOps`` holds
batched float64 tensors shaped (ne, ...):

    basis_int (ne, D)          = int_K p_i
    mass      (ne, D, D)       = int_K p_i p_j
    stiff     (ne, dim, D, D)  = int_K d_d p_i p_j
    face_mass (ne, nf, D, D)   = int_F p_i p_j            (self-self)
    face_int  (ne, nf, D)      = int_F p_i                (isothermal rhs)
    coupling  (ne, nf, D, D)   = int_F p_i p_j^nbr        (0 on boundary)

Face slots follow MeshTopology.elem_face (global face id ascending);
quadrature degrees are 2p + 1, exact for affine elements.
tests/test_torch_host_layers.py holds every tensor to pbte_tpu's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

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
    # periodic faces: neighbor >= 0 there, but the coupling is lagged (from
    # the previous outer iterate); a swept wrap would close the upwind DAG
    periodic: np.ndarray = None  # (ne, nf) bool

    def __post_init__(self):
        if self.periodic is None:
            self.periodic = np.zeros(self.neighbor.shape, dtype=bool)

    @property
    def sweep_neighbor(self) -> np.ndarray:
        """Neighbor table with the periodic couplings masked out: the one
        the sweep planner uses."""
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
        """(ne, nf) bool: every face slot of a single-geometry mesh."""
        return np.abs(self.normals).sum(axis=-1) > 0.0


def _map_jacobian(geom: str, Xv: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """J[..., d, k] = d x_d / d r_k at ref points. Xv (E, nv, dim),
    pts (Q, dim) -> (E, Q, dim, dim)."""
    vg = ref.vertex_shape_grad(geom, pts)  # (Q, nv, dim)
    return np.einsum("evd,qvk->eqdk", Xv, vg)


def inverse_map(geom: str, Xv: np.ndarray, X: np.ndarray,
                iters: int = 8) -> np.ndarray:
    """Invert the trilinear geometry map by Newton's method.

    Xv (..., nv, dim) element vertex coords; X (..., Q, dim) physical points
    (the leading batch dims of both must match)."""
    Xb = np.broadcast_to(Xv[..., None, :, :], X.shape[:-1] + Xv.shape[-2:])
    r = np.empty(X.shape)
    r[...] = np.asarray((0.5,) * 3)[: X.shape[-1]]
    for _ in range(iters):
        sh = ref.vertex_shape(geom, r)  # (..., Q, nv)
        F = np.einsum("...v,...vd->...d", sh, Xb) - X
        vg = ref.vertex_shape_grad(geom, r)  # (..., Q, nv, dim)
        J = np.einsum("...vd,...vk->...dk", Xb, vg)
        r = r - np.linalg.solve(J, F[..., None])[..., 0]
        # every true preimage lies in the reference cell: clamping an
        # overshoot keeps the Jacobians finite
        r = np.clip(r, -1.0, 2.0)
    return r


def _face_bary(pts: np.ndarray) -> np.ndarray:
    """Bilinear weights of reference-face points over the 4 face verts."""
    s, t = pts[:, 0], pts[:, 1]
    return np.stack([(1 - s) * (1 - t), s * (1 - t), s * t, (1 - s) * t],
                    axis=-1)


def _face_measure(Xf: np.ndarray, fpts: np.ndarray) -> np.ndarray:
    """|dX/ds x dX/dt| of bilinear quad faces at each face quad point.
    Xf (E, 4, dim) face vertex coords -> (E, Q)."""
    s, t = fpts[:, 0], fpts[:, 1]
    # X(s,t) = (1-s)(1-t) F0 + s(1-t) F1 + st F2 + (1-s)t F3
    dXds = np.einsum(
        "qv,evd->eqd", np.stack([-(1 - t), (1 - t), t, -t], axis=-1), Xf)
    dXdt = np.einsum(
        "qv,evd->eqd", np.stack([-(1 - s), -s, s, (1 - s)], axis=-1), Xf)
    return np.linalg.norm(np.cross(dXds, dXdt), axis=-1)


def assemble(topo: mesh_core.MeshTopology, order: int,
             chunk: int = 4096) -> ElementOps:
    """Element operators of a hex mesh with consistent DG face integrals
    (shapes traced onto the true face quadrature points; pbte_tpu's
    ``face_mode="consistent"``, the only mode the port assembles)."""
    mesh = topo.mesh
    geom = mesh.geom
    if geom != mesh_core.GEOM_HEX:
        raise ValueError(f"only hex meshes are assembled here, got {geom}")
    dim = mesh.dim
    ne = mesh.num_elements
    nf = topo.faces_per_elem
    b = ref.basis(geom, order)
    D = b.ndof

    deg = 2 * order + 1
    vpts, vw = quad.hex_rule(deg)
    S = b.eval(vpts)  # (Q, D)
    Gref = b.eval_grad(vpts)  # (Q, D, dim)

    fpts, fw = quad.quad_rule(deg)
    face_nv = topo.face_verts.shape[1]
    fbary = _face_bary(fpts)  # (Qf, 4)

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
        Xf = verts[topo.face_verts[fids]]  # (E, nf, 4, dim)
        Xq = np.einsum("qv,efvd->efqd", fbary, Xf)  # (E, nf, Qf, dim)
        meas = _face_measure(
            Xf.reshape(E * nf, face_nv, dim), fpts).reshape(E, nf, -1)
        wf = fw[None, None, :] * meas  # (E, nf, Qf)

        nbr = topo.elem_neighbor[sl]  # (E, nf)
        has_nbr = nbr >= 0
        # self-side shape values at the true face quadrature points
        Xv_rep = np.broadcast_to(Xv[:, None], (E, nf) + Xv.shape[1:])
        S_self = b.eval(inverse_map(geom, Xv_rep, Xq))  # (E, nf, Qf, D)
        face_int[sl] = np.einsum("efq,efqi->efi", wf, S_self)
        face_mass[sl] = np.einsum("efq,efqi,efqj->efij", wf, S_self, S_self)

        # neighbor-side shape values (interior faces only); periodic
        # neighbors lie across the domain: translate the face quadrature
        # points by the periodic offset before mapping into them
        nbr_safe = np.where(has_nbr, nbr, 0)
        Xv_nbr = verts[ev[nbr_safe]]  # (E, nf, nv, dim)
        Xq_nbr = Xq + topo.periodic_offset[sl][:, :, None, :]
        S_nbr = b.eval(inverse_map(geom, Xv_nbr, Xq_nbr))
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
    )


def element_classes(ops, grain: float = 1e-11,
                    merge: bool = True) -> np.ndarray:
    """Geometry-class index per element (ne,) int64, numbered by first
    occurrence: elements whose volume/face operators and outward normals
    agree to relative ``grain`` share a class. Each operator part is
    quantized against its own scale and hashed by two independent
    wrap-around polynomial hashes; with ``merge`` the classes whose
    representatives agree to 1e-9 relative are then merged. Boundary-face
    coupling zeroing is left out of the signature (the solver masks inflow
    on boundary faces)."""
    ne = ops.num_elements
    parts = [
        ops.mass.reshape(ne, -1),
        ops.stiff.reshape(ne, -1),
        ops.face_mass.reshape(ne, -1),
        ops.face_int.reshape(ne, -1),
        ops.basis_int.reshape(ne, -1),
        ops.normals.reshape(ne, -1),
    ]
    rng = np.random.default_rng(0x5EED)
    h1 = np.zeros(ne, dtype=np.int64)
    h2 = np.zeros(ne, dtype=np.int64)
    with np.errstate(over="ignore"):
        for p in parts:
            scale = max(float(np.abs(p).max()), 1e-300)
            q = np.rint(p * (1.0 / (scale * grain))).astype(np.int64)
            r1 = rng.integers(1, 2**62, size=q.shape[1], dtype=np.int64) | 1
            r2 = rng.integers(1, 2**62, size=q.shape[1], dtype=np.int64) | 1
            h1 += q @ r1
            h2 += q @ r2
    hh = np.empty((ne, 2), dtype=np.int64)
    hh[:, 0], hh[:, 1] = h1, h2
    key = hh.view([("a", np.int64), ("b", np.int64)]).ravel()
    _, first_idx, cls = np.unique(key, return_index=True, return_inverse=True)
    rank = np.empty(len(first_idx), dtype=np.int64)
    rank[np.argsort(first_idx, kind="stable")] = np.arange(len(first_idx))
    cls = rank[cls]
    if not merge:
        return cls
    first_elem = np.empty(len(first_idx), dtype=np.int64)
    first_elem[rank] = first_idx
    return _merge_noise_classes(parts, cls, first_elem)


def _merge_noise_classes(parts, cls, first_elem, merge_rel: float = 1e-9):
    """Merge classes whose representatives agree to ``merge_rel`` relative:
    candidate groups from a coarse two-offset hash over the
    representatives, each member verified against its group's first
    representative."""
    ncls = len(first_elem)
    if ncls <= 1 or ncls > 8192:
        return cls
    rng = np.random.default_rng(0xC0A15E)
    h1 = np.zeros(ncls, dtype=np.int64)
    h2 = np.zeros(ncls, dtype=np.int64)
    rep_rows = []
    with np.errstate(over="ignore"):
        for p in parts:
            scale = max(float(np.abs(p).max()), 1e-300)
            pr = p[first_elem] * (1.0 / scale)  # (ncls, cols) normalized
            rep_rows.append(pr)
            q1 = np.rint(pr / merge_rel).astype(np.int64)
            q2 = np.rint(pr / merge_rel + 0.49).astype(np.int64)
            r1 = rng.integers(1, 2**62, size=pr.shape[1], dtype=np.int64) | 1
            h1 += q1 @ r1
            h2 += q2 @ r1
    R = np.concatenate(rep_rows, axis=1)
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
            ok = np.abs(R[grp] - R[base]).max(axis=1) <= merge_rel
            for g in grp[ok]:
                parent[g] = min(parent[g], parent[base])
    for c in range(ncls):
        parent[c] = parent[parent[c]]
    uniq, merged = np.unique(parent, return_inverse=True)
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[np.argsort(uniq, kind="stable")] = np.arange(len(uniq))
    return rank[merged][cls]


def canonical_face_perm(ops, grain: float = 1e-9) -> np.ndarray:
    """Per-element local-face permutation (ne, nf) sorting faces by
    quantized outward normal (lexicographic, ties by original slot). On a
    Cartesian mesh it makes every translated element bit-identical in all
    per-face tensors (hex: 6 classes -> 1)."""
    n = ops.normals  # (ne, nf, dim)
    scale = max(float(np.abs(n).max()), 1.0)
    q = np.round(n / (scale * grain)).astype(np.int64)
    dim = q.shape[-1]
    # primary key = component 0 (np.lexsort's last key); stable
    return np.lexsort(
        tuple(q[:, :, d] for d in range(dim - 1, -1, -1)), axis=-1
    )


def permute_faces(ops, perm: np.ndarray):
    """Copy of ops with each element's local-face axis re-ordered by perm
    (ne, nf). Volume tensors are untouched."""
    idx = perm
    return dataclasses.replace(
        ops,
        face_mass=np.take_along_axis(
            ops.face_mass, idx[:, :, None, None], axis=1),
        face_int=np.take_along_axis(ops.face_int, idx[:, :, None], axis=1),
        coupling=np.take_along_axis(
            ops.coupling, idx[:, :, None, None], axis=1),
        normals=np.take_along_axis(ops.normals, idx[:, :, None], axis=1),
        neighbor=np.take_along_axis(ops.neighbor, idx, axis=1),
        face_attr=np.take_along_axis(ops.face_attr, idx, axis=1),
        periodic=np.take_along_axis(ops.periodic, idx, axis=1),
    )


def class_coupling(ops, cls: np.ndarray) -> np.ndarray | None:
    """Per-class neighbor coupling (ncls, nf, D, D), or None if elements of
    one class disagree on any interior face. Boundary faces contribute
    nothing (the solver masks them)."""
    ncls = int(cls.max()) + 1
    nf, D = ops.faces_per_elem, ops.ndof
    out = np.zeros((ncls, nf, D, D))
    interior = ops.neighbor >= 0
    for c in range(ncls):
        sel = cls == c
        for f in range(nf):
            rows = ops.coupling[sel & interior[:, f], f]
            if len(rows) == 0:
                continue
            ref_row = rows[0]
            scale = max(np.abs(ref_row).max(), 1e-300)
            if np.abs(rows - ref_row).max() > 1e-10 * scale:
                return None
            out[c, f] = ref_row
    return out
