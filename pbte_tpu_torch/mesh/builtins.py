"""Built-in Cartesian hex mesh generator.

This package's own copy of ``pbte_tpu/mesh/builtins.py::make_cartesian_3d``
for hex meshes (the equivalent of mfem::Mesh::MakeCartesian3D). Vertex
numbering is lexicographic, x fastest; boundary attributes follow MFEM:
bottom (z=0) 1, front (y=0) 2, right (x=1) 3, back (y=1) 4, left (x=0) 5,
top (z=1) 6.
"""

from __future__ import annotations

import numpy as np

from pbte_tpu_torch.mesh import core


def make_cartesian_3d(nx: int, ny: int, nz: int, geom: str = core.GEOM_HEX,
                      sx: float = 1.0, sy: float = 1.0,
                      sz: float = 1.0) -> core.MeshData:
    if geom != core.GEOM_HEX:
        raise ValueError(f"only hex meshes are built here, got {geom}")
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
                elems.append([
                    vid(i, j, k), vid(i + 1, j, k), vid(i + 1, j + 1, k),
                    vid(i, j + 1, k), vid(i, j, k + 1), vid(i + 1, j, k + 1),
                    vid(i + 1, j + 1, k + 1), vid(i, j + 1, k + 1),
                ])

    bdry, battr = [], []

    def add(q, attr):
        bdry.append(q)
        battr.append(attr)

    for j in range(ny):
        for i in range(nx):
            add([vid(i, j, 0), vid(i + 1, j, 0), vid(i + 1, j + 1, 0),
                 vid(i, j + 1, 0)], 1)
            add([vid(i, j, nz), vid(i, j + 1, nz), vid(i + 1, j + 1, nz),
                 vid(i + 1, j, nz)], 6)
    for k in range(nz):
        for i in range(nx):
            add([vid(i, 0, k), vid(i, 0, k + 1), vid(i + 1, 0, k + 1),
                 vid(i + 1, 0, k)], 2)
            add([vid(i, ny, k), vid(i + 1, ny, k), vid(i + 1, ny, k + 1),
                 vid(i, ny, k + 1)], 4)
    for k in range(nz):
        for j in range(ny):
            add([vid(0, j, k), vid(0, j + 1, k), vid(0, j + 1, k + 1),
                 vid(0, j, k + 1)], 5)
            add([vid(nx, j, k), vid(nx, j, k + 1), vid(nx, j + 1, k + 1),
                 vid(nx, j + 1, k)], 3)

    return core.MeshData(
        dim=3,
        geom=geom,
        vertices=vertices,
        elem_verts=np.asarray(elems, dtype=np.int32),
        elem_attr=np.ones(len(elems), dtype=np.int32),
        bdry_verts=np.asarray(bdry, dtype=np.int32),
        bdry_attr=np.asarray(battr, dtype=np.int32),
        source=f"builtin-cartesian3d-{geom}-{nx}x{ny}x{nz}",
    )
