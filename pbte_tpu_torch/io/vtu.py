"""ParaView VTU output of DG fields.

This package's own copy of ``pbte_tpu/io/vtu.py``. Each element is its own
disconnected block of cells, so the discontinuous L2 field renders
faithfully. Elements are subdivided ``lod`` times (the reference element
red-refined by ``mesh.refine``, the DG basis sampled on the refined
lattice, 4^lod or 8^lod linear sub-cells an element), so a p = 2 or 3
field is not linearized; lod = 0 samples the vertices. ``write_pvtu``
writes one piece per partition under a .pvtu index, and
``ParaViewCollection`` a time series (.pvd and cycle directories, the
layout of mfem::ParaViewDataCollection).
"""

from __future__ import annotations

import os

import numpy as np

from pbte_tpu_torch.fem import reference as fref
from pbte_tpu_torch.mesh import core as mesh_core

_VTK_CELL = {
    mesh_core.GEOM_TRIANGLE: 5,
    mesh_core.GEOM_QUAD: 9,
    mesh_core.GEOM_TET: 10,
    mesh_core.GEOM_HEX: 12,
    mesh_core.GEOM_PRISM: 13,  # VTK_WEDGE: same vertex order as MFEM PRISM
    mesh_core.GEOM_PYRAMID: 14,  # VTK_PYRAMID: base quad + apex, identical
}


def _ref_lattice(geom: str, lod: int):
    """Reference-element sample points + sub-cell connectivity.

    Returns (ref_pts (P, dim), sub_conn (C, nv_e)): the reference element
    red-refined `lod` times via mesh.refine.uniform_refine (single-element
    MeshData on the reference coordinates)."""
    if lod <= 0:
        rv = fref.REF_VERTS[geom]
        return rv, np.arange(len(rv), dtype=np.int64)[None, :]
    from pbte_tpu_torch.mesh.refine import uniform_refine

    rv = fref.REF_VERTS[geom]
    nv_f = 2 if mesh_core.GEOM_DIM[geom] == 2 else (
        3 if geom == mesh_core.GEOM_TET else 4
    )
    m = mesh_core.MeshData(
        dim=mesh_core.GEOM_DIM[geom],
        geom=geom,
        vertices=rv.astype(float),
        elem_verts=np.arange(len(rv), dtype=np.int32)[None, :],
        elem_attr=np.ones(1, dtype=np.int32),
        bdry_verts=np.zeros((0, nv_f), dtype=np.int32),
        bdry_attr=np.zeros(0, dtype=np.int32),
    )
    m = uniform_refine(m, lod)
    return m.vertices, m.elem_verts.astype(np.int64)


def write_vtu(mesh, order, scalar_fields=None, vector_fields=None,
              prefix="fields", lod: int | None = None):
    """scalar_fields: {name: (ne, D) coeffs}; vector_fields: {name: (dim, ne, D)}.

    lod: subdivision levels per element (None -> enough for the basis order:
    0 for p<=1, 1 for p<=3, 2 beyond). Writes `{prefix}.vtu` and returns its
    path."""
    scalar_fields = scalar_fields or {}
    vector_fields = vector_fields or {}
    if lod is None:
        lod = 0 if order <= 1 else (1 if order <= 3 else 2)
    ne = mesh.num_elements
    dim = mesh.dim

    # Geometry groups: one for single-geometry meshes, one per member
    # geometry for mixed (cells may interleave freely in VTU; only the
    # point/connectivity bookkeeping must stay consistent).
    if mesh.geom == mesh_core.GEOM_MIXED:
        groups = [
            (mesh_core.MFEM_GEOM_CODES[int(c)],
             np.flatnonzero(mesh.elem_geom == c))
            for c in np.unique(mesh.elem_geom)
        ]
    else:
        groups = [(mesh.geom, np.arange(ne))]

    pts_blocks, conn_rows, ctype_blocks, eval_plan = [], [], [], []
    base = 0
    for g, es in groups:
        b = fref.basis(g, order)
        # prism/pyramid red refinement produces mixed children (a refined
        # pyramid is 6 pyramids + 4 tets), which the per-group uniform
        # sub-cell bookkeeping here cannot express — emit them unrefined
        # (corner sampling; high-order variation renders linearly per cell)
        g_lod = 0 if g in (
            mesh_core.GEOM_PRISM, mesh_core.GEOM_PYRAMID
        ) else lod
        ref_pts, sub_conn = _ref_lattice(g, g_lod)
        P = len(ref_pts)  # sample points per element
        C = len(sub_conn)  # sub-cells per element
        shape = b.eval(ref_pts)  # (P, Dg) DG basis at sample points
        vshape = fref.vertex_shape(g, ref_pts)  # (P, nv_e) geometry map
        nv = mesh_core.GEOM_NV[g]
        Xv = mesh.vertices[mesh.elem_verts[es][:, :nv]]
        pts_blocks.append(
            np.einsum("pv,evd->epd", vshape, Xv).reshape(len(es) * P, dim)
        )
        conn = (
            sub_conn[None, :, :]
            + base
            + P * np.arange(len(es))[:, None, None]
        ).reshape(len(es) * C, -1)
        conn_rows.extend(conn)
        ctype_blocks.append(np.full(len(es) * C, _VTK_CELL[g]))
        eval_plan.append((es, shape))
        base += len(es) * P

    pts = np.vstack(pts_blocks)
    if dim == 2:
        pts = np.hstack([pts, np.zeros((len(pts), 1))])
    npts = base
    ncells = len(conn_rows)
    offsets = np.cumsum([len(r) for r in conn_rows])
    ctype = np.concatenate(ctype_blocks)

    def eval_at_pts(coeffs):
        coeffs = np.asarray(coeffs)
        return np.concatenate([
            np.einsum(
                "ei,pi->ep", coeffs[es][:, : shape.shape[1]], shape
            ).reshape(-1)
            for es, shape in eval_plan
        ])

    path = prefix + ".vtu"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n')
        f.write("  <UnstructuredGrid>\n")
        f.write(f'    <Piece NumberOfPoints="{npts}" NumberOfCells="{ncells}">\n')
        f.write("      <Points>\n")
        f.write('        <DataArray type="Float64" NumberOfComponents="3" '
                'format="ascii">\n')
        for p in pts:
            f.write(f"          {p[0]:.16g} {p[1]:.16g} {p[2]:.16g}\n")
        f.write("        </DataArray>\n      </Points>\n")
        f.write("      <Cells>\n")
        f.write('        <DataArray type="Int64" Name="connectivity" format="ascii">\n')
        for row in conn_rows:
            f.write("          " + " ".join(map(str, row)) + "\n")
        f.write("        </DataArray>\n")
        f.write('        <DataArray type="Int64" Name="offsets" format="ascii">\n')
        f.write("          " + " ".join(map(str, offsets)) + "\n")
        f.write("        </DataArray>\n")
        f.write('        <DataArray type="UInt8" Name="types" format="ascii">\n')
        f.write("          " + " ".join(map(str, ctype)) + "\n")
        f.write("        </DataArray>\n      </Cells>\n")
        f.write("      <PointData>\n")
        for name, coeffs in scalar_fields.items():
            vals = eval_at_pts(coeffs)
            f.write(f'        <DataArray type="Float64" Name="{name}" format="ascii">\n')
            f.write("          " + " ".join(f"{v:.16g}" for v in vals) + "\n")
            f.write("        </DataArray>\n")
        for name, comp in vector_fields.items():
            comp = np.asarray(comp)  # (dim, ne, D)
            vecs = np.stack([eval_at_pts(comp[d]) for d in range(comp.shape[0])], -1)
            if vecs.shape[-1] == 2:
                vecs = np.hstack([vecs, np.zeros((len(vecs), 1))])
            f.write(f'        <DataArray type="Float64" Name="{name}" '
                    'NumberOfComponents="3" format="ascii">\n')
            for v in vecs:
                f.write(f"          {v[0]:.16g} {v[1]:.16g} {v[2]:.16g}\n")
            f.write("        </DataArray>\n")
        f.write("      </PointData>\n")
        f.write("    </Piece>\n  </UnstructuredGrid>\n</VTKFile>\n")
    return path


def _submesh(mesh, elem_ids):
    """Element-restricted view of a MeshData (for per-partition pieces)."""
    import dataclasses

    elem_ids = np.asarray(elem_ids)
    kw = dict(
        elem_verts=mesh.elem_verts[elem_ids],
        elem_attr=mesh.elem_attr[elem_ids],
    )
    if mesh.geom == mesh_core.GEOM_MIXED:
        kw["elem_geom"] = mesh.elem_geom[elem_ids]
    return dataclasses.replace(mesh, **kw)


def write_pvtu(mesh, order, pieces, prefix="fields", lod=None,
               piece_name=None):
    """Partitioned ParaView output: one .vtu piece per partition plus the
    .pvtu index — the analog of the reference's parallel WriteParaView,
    which saves per-rank ParGridFunction pieces under one collection
    (ref: src/MacroscopicQuantities.cpp:168-271, parallel branch writing a
    ParMesh-backed ParaViewDataCollection).

    pieces: list of (elem_ids, scalar_fields, vector_fields) — fields are
    LOCAL to the piece ({name: (ne_p, D)} / {name: (dim, ne_p, D)}), so a
    domain-decomposed solver can write each shard's block without ever
    assembling the global (ne, D) field on the host.

    piece_name: format string with {p} for the piece index; default
    "{base}.{p:06d}.vtu" next to the .pvtu. Returns the .pvtu path."""
    path = prefix + ".pvtu"
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    base = os.path.basename(prefix)
    if piece_name is None:
        piece_name = base + ".{p:06d}.vtu"
    names_s, names_v = [], []
    piece_files = []
    for p, (elem_ids, sf, vf) in enumerate(pieces):
        sf, vf = sf or {}, vf or {}
        if p == 0:
            names_s, names_v = list(sf.keys()), list(vf.keys())
        elif list(sf.keys()) != names_s or list(vf.keys()) != names_v:
            raise ValueError("pvtu pieces must carry identical field sets")
        fn = piece_name.format(p=p)
        write_vtu(_submesh(mesh, elem_ids), order, sf, vf,
                  prefix=os.path.join(d, fn[:-4]), lod=lod)
        piece_files.append(fn)
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="PUnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n')
        f.write('  <PUnstructuredGrid GhostLevel="0">\n')
        f.write('    <PPoints>\n      <PDataArray type="Float64" '
                'NumberOfComponents="3" Name="Points"/>\n    </PPoints>\n')
        f.write("    <PPointData>\n")
        for nm in names_s:
            f.write(f'      <PDataArray type="Float64" Name="{nm}"/>\n')
        for nm in names_v:
            f.write(f'      <PDataArray type="Float64" Name="{nm}" '
                    'NumberOfComponents="3"/>\n')
        f.write("    </PPointData>\n")
        for fn in piece_files:
            f.write(f'    <Piece Source="{fn}"/>\n')
        f.write("  </PUnstructuredGrid>\n</VTKFile>\n")
    return path


class ParaViewCollection:
    """Time-series ParaView collection mirroring mfem::ParaViewDataCollection
    (ref: src/MacroscopicQuantities.cpp:168-271 writes a collection with
    SetPrefixPath + cycle directories). Layout:

        <root>/<name>/<name>.pvd
        <root>/<name>/Cycle%06d/data.pvtu
        <root>/<name>/Cycle%06d/proc000000.vtu

    The .pvd indexes every saved cycle with its time value; each cycle's
    .pvtu wraps the single-process piece, so the tree opens in ParaView
    exactly like the reference's output. save() may be called with any
    monotonically increasing cycle numbers (e.g. outer-iteration counts)."""

    def __init__(self, mesh, order, name="pbte_fields", root="output/vis",
                 lod=None, part=None):
        self.mesh = mesh
        self.order = order
        self.name = name
        self.base = os.path.join(root, name)
        self.lod = lod
        # part: (ne,) partition id per element -> distributed layout with one
        # proc%06d.vtu piece per partition (the reference's parallel
        # WriteParaView writes one piece per MPI rank,
        # ref: src/MacroscopicQuantities.cpp:168-271)
        self.part = None if part is None else np.asarray(part)
        self._cycles = []  # (cycle, time)

    def save(self, scalar_fields=None, vector_fields=None, cycle=0,
             time=None):
        """Write one cycle and refresh the .pvd index. Returns the pvd path.

        Fields are GLOBAL (ne, D) / (dim, ne, D); with `part` set they are
        sliced into per-partition pieces. For shard-local data (no global
        assembly), use save_pieces()."""
        scalar_fields = scalar_fields or {}
        vector_fields = vector_fields or {}
        if self.part is not None:
            nparts = int(self.part.max()) + 1
            pieces = []
            for p in range(nparts):
                ids = np.flatnonzero(self.part == p)
                pieces.append((
                    ids,
                    {k: np.asarray(v)[ids] for k, v in scalar_fields.items()},
                    {k: np.asarray(v)[:, ids]
                     for k, v in vector_fields.items()},
                ))
            return self.save_pieces(pieces, cycle=cycle, time=time)
        pieces = [(np.arange(self.mesh.num_elements), scalar_fields,
                   vector_fields)]
        return self.save_pieces(pieces, cycle=cycle, time=time)

    def save_pieces(self, pieces, cycle=0, time=None):
        """Write one cycle from per-partition LOCAL field blocks (see
        write_pvtu) and refresh the .pvd index. Returns the pvd path."""
        time = float(cycle) if time is None else float(time)
        cdir = os.path.join(self.base, f"Cycle{cycle:06d}")
        os.makedirs(cdir, exist_ok=True)
        write_pvtu(
            self.mesh, self.order, pieces,
            prefix=os.path.join(cdir, "data"), lod=self.lod,
            piece_name="proc{p:06d}.vtu",
        )
        self._cycles.append((int(cycle), time))
        pvd = os.path.join(self.base, f"{self.name}.pvd")
        with open(pvd, "w") as f:
            f.write('<?xml version="1.0"?>\n')
            f.write('<VTKFile type="Collection" version="0.1" '
                    'byte_order="LittleEndian">\n')
            f.write("  <Collection>\n")
            for cyc, t in self._cycles:
                f.write(
                    f'    <DataSet timestep="{t:.16g}" group="" part="0" '
                    f'file="Cycle{cyc:06d}/data.pvtu"/>\n'
                )
            f.write("  </Collection>\n</VTKFile>\n")
        return pvd

