"""Macro-cell ("supercell") merge: simplex lattice meshes as block lattices.

This package's own copy of ``pbte_tpu/fem/supercell.py`` (less the box
merge ``detect_box``, which pbte_tpu resolves off), with
``block_triangular_factor`` as a function of torch tensors.

The 6-tet marching split of a Cartesian cuboid (the reference's production
mesh) levelizes into many ragged direction groups on the fine mesh. The
``gsz`` simplices carved from one cube form a SUPER-ELEMENT with gsz*D
DOFs, and the super-element adjacency is exactly the Cartesian box
lattice. Within a cube the diagonal (non-axis) faces couple the member
simplices one way for any direction (the intra-cell upwind graph is
acyclic), so the per-cube block system

    A_super u' = rhs',   A_super = blockdiag(A_c)
                         + vg~ * sum_{intra faces} min(s.n, 0) * C_{c<-c'}

is block-triangular in the intra topological order, and solving it
reproduces the sequential simplex sweep. ``SourceIterationSolver`` then
ring-sweeps the macro lattice (``solver/super_ring.py``): 2^dim octant
groups, unit upwind gap, D' = gsz*D.

Everything is detected and verified, never assumed: connected components
over non-axis faces must tile the mesh into equal cells containing one
element of each geometry class; the (class, face) -> (axis step | intra,
neighbor class) map must be globally static; all member operator tensors
must be translation-invariant; boundary attributes must agree across the
member faces of a super face. Any mismatch returns None and the solver
keeps the fine-mesh paths. The 2D 2-triangle split of a quad lattice
(gsz = 2) merges the same way.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbte_tpu_torch.fem import assembly as _assembly


@dataclasses.dataclass
class SuperCell:
    """Verified macro-cell structure + the merged ElementOps."""

    gsz: int  # member elements per cell (== geometry class count)
    ncell: int
    D: int  # member (fine) DOF count
    Dp: int  # gsz * D
    cell_of: np.ndarray  # (ne,) cell index per fine element
    cls_of: np.ndarray  # (ne,) class index per fine element
    elem_at: np.ndarray  # (ncell, gsz) fine element of class c in cell m
    super_ops: "_assembly.ElementOps"
    # intra-cell face list (each geometric intra face appears once per SIDE,
    # carrying that side's outward normal, its own outflow face-mass and its
    # inflow coupling to the other side): compact (D, D) blocks + class ids
    int_normals: np.ndarray  # (n_int, dim)
    int_fmass: np.ndarray  # (n_int, D, D) outflow block at (dst, dst)
    int_cpl: np.ndarray  # (n_int, D, D) inflow block at (dst, src)
    int_dst: np.ndarray  # (n_int,)
    int_src: np.ndarray  # (n_int,)
    # fine-element basis integrals arranged per (cell, class) for the
    # per-element Tv reduction (residual semantics follow the FINE mesh:
    # ref src/MacroscopicQuantities.cpp:130-166)
    basis_int_cells: np.ndarray  # (ncell, gsz, D)
    lat_dims: tuple = ()  # verified macro box extents

    @property
    def ne_fine(self) -> int:
        return self.ncell * self.gsz

    def scatter_fine(self) -> np.ndarray:
        """(ncell * gsz,) fine element id of flattened (cell, class) blocks:
        fine_array[scatter] = cell_blocked_array.reshape(-1, ...)."""
        return self.elem_at.reshape(-1)

    def to_fine(self, a_super: np.ndarray) -> np.ndarray:
        """(ncell, Dp, ...) block layout -> (ne, D, ...) fine layout."""
        lead = a_super.shape[:1]
        rest = a_super.shape[2:]
        blk = a_super.reshape(lead + (self.gsz, self.D) + rest)
        out = np.empty((self.ne_fine, self.D) + rest, a_super.dtype)
        out[self.scatter_fine()] = blk.reshape(
            (self.ncell * self.gsz, self.D) + rest
        )
        return out

    def gmat_internal(self, dirs: np.ndarray) -> np.ndarray:
        """Intra-cell contribution to the super transport operator:
        (nk, Dp, Dp) with G[k] += max(s.n_j, 0) * fmass_j at (dst, dst)
        + min(s.n_j, 0) * cpl_j at (dst, src) for every intra side j.
        Matches the member-element outflow/inflow terms the sequential
        sweep applies (ref: src/PBTESolver.cpp:146-168, 261-300), with the
        inflow neighbor now an unknown of the same block system."""
        nk = dirs.shape[0]
        dim = self.int_normals.shape[1]
        G = np.zeros((nk, self.Dp, self.Dp))
        fd = dirs[:, :dim] @ self.int_normals.T  # (nk, n_int)
        D = self.D
        for j in range(self.int_normals.shape[0]):
            c, cp = int(self.int_dst[j]), int(self.int_src[j])
            r = slice(c * D, (c + 1) * D)
            G[:, r, r] += (
                np.maximum(fd[:, j], 0.0)[:, None, None] * self.int_fmass[j]
            )
            G[:, r, cp * D : (cp + 1) * D] += (
                np.minimum(fd[:, j], 0.0)[:, None, None] * self.int_cpl[j]
            )
        return G


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
    D = ops.ndof
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

    # super neighbor / attrs; verify member faces agree per (cell, slot)
    s_nbr = np.full((ncell, nfp), -1, dtype=np.int64)
    s_attr = np.zeros((ncell, nfp), dtype=ops.face_attr.dtype)
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
        s_attr[:, slot] = att_all

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

    # ---- merged operator tensors (translation-invariant: one representative
    # cell, broadcast views — no O(ncell * Dp^2) host memory) ----------------
    Dp = gsz * D
    mass_r = np.zeros((Dp, Dp))
    stiff_r = np.zeros((dim, Dp, Dp))
    basis_r = np.zeros(Dp)
    for c in range(gsz):
        r = slice(c * D, (c + 1) * D)
        mass_r[r, r] = ops.mass[reps[c]]
        stiff_r[:, r, r] = ops.stiff[reps[c]]
        basis_r[r] = ops.basis_int[reps[c]]
    fmass_r = np.zeros((nfp, Dp, Dp))
    cpl_r = np.zeros((nfp, Dp, Dp))
    fint_r = np.zeros((nfp, Dp))
    for slot, mem in enumerate(members):
        for (c, f, src_cls) in mem:
            r = slice(c * D, (c + 1) * D)
            fmass_r[slot, r, r] = ops.face_mass[reps[c], f]
            fint_r[slot, r] = ops.face_int[reps[c], f]
            if src_cls >= 0:
                e0 = elem_at[:, c][nbr[elem_at[:, c], f] >= 0]
                if len(e0):
                    cpl_r[
                        slot, r, src_cls * D : (src_cls + 1) * D
                    ] = ops.coupling[e0[0], f]

    int_normals, int_fm, int_cp, int_dst, int_src = [], [], [], [], []
    for (c, f, src_cls) in int_rows:
        int_normals.append(normals[reps[c], f])
        int_fm.append(ops.face_mass[reps[c], f])
        int_cp.append(ops.coupling[elem_at[0, c], f])
        int_dst.append(c)
        int_src.append(src_cls)

    super_ops = _assembly.ElementOps(
        geom=f"super[{ops.geom}x{gsz}]",
        order=ops.order,
        dim=dim,
        basis_int=np.broadcast_to(basis_r, (ncell, Dp)),
        mass=np.broadcast_to(mass_r, (ncell, Dp, Dp)),
        stiff=np.broadcast_to(stiff_r, (ncell, dim, Dp, Dp)),
        face_mass=np.broadcast_to(fmass_r, (ncell, nfp, Dp, Dp)),
        face_int=np.broadcast_to(fint_r, (ncell, nfp, Dp)),
        # coupling blocks are position-independent; the solver masks
        # boundary faces with cin=0, so a broadcast interior pattern is safe
        coupling=np.broadcast_to(cpl_r, (ncell, nfp, Dp, Dp)),
        normals=np.broadcast_to(s_normals_row, (ncell, nfp, dim)),
        neighbor=s_nbr,
        face_attr=s_attr,
    )
    return SuperCell(
        gsz=gsz,
        ncell=ncell,
        D=D,
        Dp=Dp,
        cell_of=cell_of,
        cls_of=cls,
        elem_at=elem_at,
        super_ops=super_ops,
        int_normals=np.asarray(int_normals),
        int_fmass=np.asarray(int_fm),
        int_cpl=np.asarray(int_cp),
        int_dst=np.asarray(int_dst, dtype=np.int64),
        int_src=np.asarray(int_src, dtype=np.int64),
        basis_int_cells=ops.basis_int[elem_at],  # (ncell, gsz, D)
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
        if any(r is None for r in _topo_rank(dep)):
            return False
    return True


def block_triangular_factor(sc: SuperCell, A: torch.Tensor, dirs: np.ndarray,
                            massT: torch.Tensor) -> torch.Tensor:
    """B = blockdiag(massT_c) @ A^{-1} by block forward substitution, on
    A's device and in its dtype.

    A (Km, BS, Dp, Dp) is the super transport operator for the Km
    directions ``dirs`` (Km, dim) (numpy); it is block lower-triangular in
    each direction's intra-cell topological class order with at most two
    sub-diagonal blocks per row, so A^{-1} costs gsz batched D x D
    inverses and a few batched D x D products per (k, b) instead of one
    dense (gsz*D)^3 inverse. massT (gsz, D, D) are the per-class M^T
    blocks (the ring carries v = M^T u). Directions are grouped by their
    intra-face sign pattern, which fixes the elimination order; rows and
    columns stay in class order throughout. pbte_tpu's numpy
    ``block_triangular_factor`` does the same operations."""
    Dp = A.shape[-1]
    gsz, D = sc.gsz, sc.D
    assert Dp == gsz * D
    fd = dirs[:, : sc.int_normals.shape[1]] @ sc.int_normals.T  # (Km, n_int)
    inflow = fd < -1e-14  # dst depends on src
    pats, pat_of = np.unique(inflow, axis=0, return_inverse=True)
    pat_of = pat_of.reshape(-1)
    out = torch.zeros_like(A)
    for pi in range(len(pats)):
        ks = torch.as_tensor(np.flatnonzero(pat_of == pi), device=A.device)
        dep = [[] for _ in range(gsz)]
        for j in np.flatnonzero(pats[pi]):
            dep[int(sc.int_dst[j])].append(int(sc.int_src[j]))
        order = sorted(range(gsz), key=_topo_rank(dep).__getitem__)
        Ak = A[ks]  # (nk, BS, Dp, Dp)

        def blk(i, j):
            return Ak[..., i * D:(i + 1) * D, j * D:(j + 1) * D]

        X = {}  # (i, j) -> (nk, BS, D, D) blocks of A^{-1}
        done = []
        Bk = torch.zeros_like(Ak)
        for i in order:
            Lii_inv = torch.linalg.inv(blk(i, i))
            X[(i, i)] = Lii_inv
            for j in done:
                # sum over the already-eliminated sources k of i
                S = None
                for k in dep[i]:
                    if (k, j) in X:
                        t = torch.matmul(blk(i, k), X[(k, j)])
                        S = t if S is None else S + t
                if S is not None:
                    X[(i, j)] = -torch.matmul(Lii_inv, S)
            done.append(i)
            for j in done:
                if (i, j) in X:
                    Bk[..., i * D:(i + 1) * D, j * D:(j + 1) * D] = (
                        torch.matmul(massT[i], X[(i, j)]))
        out[ks] = Bk
    return out


def _topo_rank(dep):
    """Longest-path rank of each class in the dependency lists ``dep``
    (dst -> [src]); None for a class on a cycle."""
    gsz = len(dep)
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
    return rank
