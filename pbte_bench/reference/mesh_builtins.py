"""Frozen copy of the solver port's host layer ``mesh/builtins.py`` for the plain
reference: the benchmark works the element operators, angles and
phonon tables out again with it, and never imports the program.

The 3D Cartesian mesh generator (the equivalent of
mfem::Mesh::MakeCartesian3D). Vertex numbering is lexicographic x-fastest;
boundary attributes follow MFEM's convention: bottom(z=0)=1, front(y=0)=2,
right(x=1)=3, back(y=1)=4, left(x=0)=5, top(z=1)=6.
"""

from __future__ import annotations

import numpy as np

from . import mesh_core as core

_SIX_TET_SPLIT = (
    (0, 1, 2, 6),
    (0, 2, 3, 6),
    (0, 3, 7, 6),
    (0, 7, 4, 6),
    (0, 4, 5, 6),
    (0, 5, 1, 6),
)


def make_cartesian_3d(
    nx: int,
    ny: int,
    nz: int,
    geom: str = core.GEOM_TET,
    sx: float = 1.0,
    sy: float = 1.0,
    sz: float = 1.0,
) -> core.MeshData:
    xs = np.linspace(0.0, sx, nx + 1)
    ys = np.linspace(0.0, sy, ny + 1)
    zs = np.linspace(0.0, sz, nz + 1)
    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
    vertices = np.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], axis=-1)

    def vid(i, j, k):
        return (k * (ny + 1) + j) * (nx + 1) + i

    elems = []
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                c = [
                    vid(i, j, k), vid(i + 1, j, k), vid(i + 1, j + 1, k), vid(i, j + 1, k),
                    vid(i, j, k + 1), vid(i + 1, j, k + 1), vid(i + 1, j + 1, k + 1),
                    vid(i, j + 1, k + 1),
                ]
                if geom == core.GEOM_TET:
                    for t in _SIX_TET_SPLIT:
                        elems.append([c[t[0]], c[t[1]], c[t[2]], c[t[3]]])
                elif geom == core.GEOM_HEX:
                    elems.append(c)
                elif geom == core.GEOM_PRISM:
                    # 2-prism split of the cube (bottom triangles match the
                    # 2D tri split: (v0,v1,v2) + (v0,v2,v3), extruded in z)
                    elems.append([c[0], c[1], c[2], c[4], c[5], c[6]])
                    elems.append([c[0], c[2], c[3], c[4], c[6], c[7]])
                else:
                    raise ValueError(f"unsupported 3D geometry: {geom}")

    bdry, battr = [], []

    def add_quad_bdry(q, attr):
        # prisms keep whole quads on their x/y sides but split z-faces
        z0 = vertices[q[0]][2]
        quad_face = geom == core.GEOM_HEX or (
            geom == core.GEOM_PRISM
            and not np.allclose([vertices[v][2] for v in q], z0)
        )
        if quad_face:
            bdry.append(q)
            battr.append(attr)
        else:
            # split the boundary quad consistently with the 6-tet cube
            # split (same diagonal as the prism bottom/top triangles)
            bdry.append([q[0], q[1], q[2]])
            battr.append(attr)
            bdry.append([q[0], q[2], q[3]])
            battr.append(attr)

    for j in range(ny):
        for i in range(nx):
            add_quad_bdry([vid(i, j, 0), vid(i + 1, j, 0), vid(i + 1, j + 1, 0), vid(i, j + 1, 0)], 1)
            add_quad_bdry([vid(i, j, nz), vid(i, j + 1, nz), vid(i + 1, j + 1, nz), vid(i + 1, j, nz)], 6)
    for k in range(nz):
        for i in range(nx):
            add_quad_bdry([vid(i, 0, k), vid(i, 0, k + 1), vid(i + 1, 0, k + 1), vid(i + 1, 0, k)], 2)
            add_quad_bdry([vid(i, ny, k), vid(i + 1, ny, k), vid(i + 1, ny, k + 1), vid(i, ny, k + 1)], 4)
    for k in range(nz):
        for j in range(ny):
            add_quad_bdry([vid(0, j, k), vid(0, j + 1, k), vid(0, j + 1, k + 1), vid(0, j, k + 1)], 5)
            add_quad_bdry([vid(nx, j, k), vid(nx, j, k + 1), vid(nx, j + 1, k + 1), vid(nx, j + 1, k)], 3)

    elem_geom = None
    mesh_geom = geom
    if geom == core.GEOM_PRISM:
        # prisms always route through the mixed pipeline (their faces mix
        # triangle and quad shapes) — see mesh/core.py GEOM_MIXED notes
        mesh_geom = core.GEOM_MIXED
        elem_geom = np.full(
            len(elems), core.MFEM_CODE_OF_GEOM[core.GEOM_PRISM],
            dtype=np.int32,
        )
    bw = max(len(b) for b in bdry)
    bdry = [b + [-1] * (bw - len(b)) for b in bdry]
    mesh = core.MeshData(
        dim=3,
        geom=mesh_geom,
        vertices=vertices,
        elem_verts=np.asarray(elems, dtype=np.int32),
        elem_attr=np.ones(len(elems), dtype=np.int32),
        bdry_verts=np.asarray(bdry, dtype=np.int32),
        bdry_attr=np.asarray(battr, dtype=np.int32),
        source=f"builtin-cartesian3d-{geom}-{nx}x{ny}x{nz}",
        elem_geom=elem_geom,
    )
    return core.finalize(mesh)
