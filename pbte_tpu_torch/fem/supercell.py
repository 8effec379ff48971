"""Macro-cell ("supercell") detection: simplex lattice meshes as block lattices.

This package's own copy of ``detect`` and ``verify_acyclic`` of
``pbte_tpu/fem/supercell.py`` (its checks, without the merged operators),
which ``SourceIterationSolver`` needs to resolve ``sweep_mode="auto"`` as
pbte_tpu does: where a 6-tet (3D) or 2-triangle (2D) split of a Cartesian
lattice is detected, pbte_tpu merges each macro cell into one super
element and ring-sweeps the macro lattice (ROADMAP.md queue 1, item 6b,
not yet in this package).

Everything is detected and verified, never assumed: connected components
over non-axis faces must tile the mesh into equal cells containing one
element of each geometry class; the (class, face) -> (axis step | intra,
neighbor class) map must be globally static; all member operator tensors
must be translation-invariant; boundary attributes must agree across the
member faces of a super face. Any mismatch returns None.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pbte_tpu_torch.fem import assembly as _assembly


@dataclasses.dataclass
class SuperCell:
    """A verified macro-cell structure: what ``verify_acyclic`` and the
    solver's supercell gate read (pbte_tpu's ``SuperCell`` less the merged
    operators, which its supercell ring builds)."""

    gsz: int  # member elements per cell (== geometry class count)
    ncell: int
    # intra-cell face list (each geometric intra face once per SIDE, with
    # that side's outward normal): destination and source classes
    int_normals: np.ndarray  # (n_int, dim)
    int_dst: np.ndarray  # (n_int,)
    int_src: np.ndarray  # (n_int,)
    lat_dims: tuple = ()  # verified macro box extents


def _axis_face_mask(normals: np.ndarray, tol: float = 1e-9) -> np.ndarray:
    """(ne, nf) True where the outward normal is a unit axis vector."""
    a = np.abs(normals)
    mx = a.max(axis=-1)
    rest = a.sum(axis=-1) - mx
    return (np.abs(mx - 1.0) <= tol) & (rest <= tol)


def detect(ops, cls: np.ndarray | None = None) -> SuperCell | None:
    """Detect + verify the macro-cell structure of `ops`. Returns None when
    any structural requirement fails (the caller keeps the general path).

    `cls` is the element_classes() labeling (computed if not given); the
    class count must equal the cell size with exactly one member per class
    in every cell — the operator-level statement of translation invariance.
    """
    ne, nf = ops.neighbor.shape
    dim = ops.dim
    if ne < 4 or ops.periodic.any() or not ops.face_valid.all():
        return None
    normals = ops.normals
    axis_face = _axis_face_mask(normals)
    if axis_face.all():
        return None  # already a box lattice; nothing to merge
    nbr = ops.neighbor
    # every non-axis face must be interior (a diagonal face on the domain
    # boundary breaks the box structure)
    if ((~axis_face) & (nbr < 0)).any():
        return None

    if cls is None:
        cls = _assembly.element_classes(ops)
    cls = np.asarray(cls)
    gsz = int(cls.max()) + 1
    if gsz < 2 or gsz > 8 or ne % gsz:
        return None

    # ---- macro cells = connected components over non-axis faces ----------
    parent = np.arange(ne)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    ee, ff = np.nonzero(~axis_face)
    for e, f in zip(ee.tolist(), ff.tolist()):
        n = int(nbr[e, f])
        ra, rb = find(e), find(n)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    roots = np.array([find(e) for e in range(ne)])
    uniq, cell_of = np.unique(roots, return_inverse=True)
    ncell = len(uniq)
    if ncell * gsz != ne:
        return None
    counts = np.bincount(cell_of, minlength=ncell)
    if (counts != gsz).any():
        return None
    # one element of each class per cell
    key = cell_of * gsz + cls
    if len(np.unique(key)) != ne:
        return None
    elem_at = np.empty((ncell, gsz), dtype=np.int64)
    elem_at[cell_of, cls] = np.arange(ne)

    # ---- static (class, face) maps ---------------------------------------
    # intra faces: (c, f) -> src class, identical normal (class-guaranteed)
    # axis faces:  (c, f) -> (axis, sign, src class) with one macro step
    reps = np.array([int(np.flatnonzero(cls == c)[0]) for c in range(gsz)])
    int_rows = []  # (dst, f, src)
    ax_rows = {}  # (c, f) -> (axis, sign, src_cls or -1)
    for c in range(gsz):
        els = np.flatnonzero(cls == c)
        for f in range(nf):
            nb = nbr[els, f]
            if not axis_face[reps[c], f]:
                # intra: same cell, one consistent source class
                if (nb < 0).any():
                    return None
                if not (cell_of[nb] == cell_of[els]).all():
                    return None
                sc = np.unique(cls[nb])
                if len(sc) != 1:
                    return None
                int_rows.append((c, f, int(sc[0])))
            else:
                nvec = normals[reps[c], f]
                ax = int(np.argmax(np.abs(nvec)))
                sign = int(np.sign(nvec[ax]))
                interior = nb >= 0
                src_cls = -1
                if interior.any():
                    ei = els[interior]
                    nbi = nb[interior]
                    if (cell_of[nbi] == cell_of[ei]).any():
                        return None
                    scs = np.unique(cls[nbi])
                    if len(scs) != 1:
                        return None
                    src_cls = int(scs[0])
                ax_rows[(c, f)] = (ax, sign, src_cls)

    # ---- coupling translation invariance (excluded from element_classes) --
    interior = nbr >= 0
    for c in range(gsz):
        sel = cls == c
        for f in range(nf):
            rows = ops.coupling[sel & interior[:, f], f]
            if len(rows) < 2:
                continue
            scale = max(float(np.abs(rows[0]).max()), 1e-300)
            if float(np.abs(rows - rows[0]).max()) > 1e-9 * scale:
                return None

    # ---- super faces: group axis (c, f) by (axis, sign) -------------------
    nfp = 2 * dim
    slot_of = {}  # (axis, sign) -> super face slot, ordered canonically
    for ax in range(dim):
        for sign, off in ((-1, 0), (1, 1)):
            slot_of[(ax, sign)] = ax * 2 + off
    members = [[] for _ in range(nfp)]  # slot -> [(c, f, src_cls)]
    for (c, f), (ax, sign, src_cls) in ax_rows.items():
        members[slot_of[(ax, sign)]].append((c, f, src_cls))
    if any(len(m) == 0 for m in members):
        return None

    # super neighbours; member faces agree per (cell, slot) in their
    # neighbour cell and attribute
    s_nbr = np.full((ncell, nfp), -1, dtype=np.int64)
    for slot, mem in enumerate(members):
        nbc_all = None
        att_all = None
        for (c, f, _src) in mem:
            els = elem_at[:, c]
            nb = nbr[els, f]
            nbc = np.where(nb >= 0, cell_of[np.clip(nb, 0, None)], -1)
            att = ops.face_attr[els, f]
            if nbc_all is None:
                nbc_all, att_all = nbc, att
            else:
                if not np.array_equal(nbc_all, nbc):
                    return None
                if not np.array_equal(att_all, att):
                    return None
        s_nbr[:, slot] = nbc_all

    # ---- lattice coordinates (verified box) --------------------------------
    from pbte_tpu_torch.sweep import planner as _planner

    s_normals_row = np.zeros((nfp, dim))
    for (ax, sign), slot in slot_of.items():
        s_normals_row[slot, ax] = float(sign)
    lat = _planner.detect_lattice(
        s_nbr, np.broadcast_to(s_normals_row, (ncell, nfp, dim))
    )
    if lat is None:
        return None

    return SuperCell(
        gsz=gsz,
        ncell=ncell,
        int_normals=np.asarray([normals[reps[c], f]
                                for (c, f, _src) in int_rows]),
        int_dst=np.asarray([r[0] for r in int_rows], dtype=np.int64),
        int_src=np.asarray([r[2] for r in int_rows], dtype=np.int64),
        lat_dims=lat.dims,
    )


def verify_acyclic(sc: SuperCell, directions: np.ndarray) -> bool:
    """The block solve is equivalent to the fine-mesh sweep only when the
    intra-cell upwind graph is acyclic for every quadrature direction (a
    cyclic orientation would make the fine sweep itself impossible —
    ref: src/AngularSweepOrder.cpp:138-142 throws there). For the 6-tet
    split all intra normals contain the cube diagonal, so any direction
    yields <= 2 sign changes around the 6-cycle (always acyclic); this
    check keeps the guarantee for arbitrary detected splits. Edges with
    s.n == 0 carry zero coupling and are ignored."""
    dim = sc.int_normals.shape[1]
    fd = directions[:, :dim] @ sc.int_normals.T  # (K, n_int)
    gsz = sc.gsz
    for k in range(fd.shape[0]):
        # dst depends on src where the dst side is inflow (s.n < 0)
        dep = [[] for _ in range(gsz)]
        for j in np.flatnonzero(fd[k] < -1e-14):
            dep[int(sc.int_dst[j])].append(int(sc.int_src[j]))
        rank = [None] * gsz
        for _ in range(gsz + 1):
            changed = False
            for c in range(gsz):
                vals = [rank[d] for d in dep[c]]
                if any(v is None for v in vals):
                    continue
                r = max(vals) + 1 if vals else 0
                if rank[c] != r:
                    rank[c] = r
                    changed = True
            if not changed:
                break
        if any(r is None for r in rank):
            return False
    return True
