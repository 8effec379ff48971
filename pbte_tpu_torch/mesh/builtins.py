"""Built-in Cartesian mesh generators.

This package's own copy of ``pbte_tpu/mesh/builtins.py`` (the equivalents of
mfem::Mesh::MakeCartesian2D/3D). Vertex numbering is lexicographic
x-fastest; boundary attributes follow MFEM's convention:

- 2D: bottom=1, right=2, top=3, left=4
- 3D: bottom(z=0)=1, front(y=0)=2, right(x=1)=3, back(y=1)=4, left(x=0)=5,
      top(z=1)=6

Built-in names and default sizes: unit-square[-tri/-quad] 8x8,
unit-cube[-tet/-hex] 4x4x4, and the mixed demos unit-square-mixed,
unit-cube-prism and unit-cube-mixed.
"""

from __future__ import annotations

import numpy as np

from pbte_tpu_torch.mesh import core

DEFAULT_N2D = 8
DEFAULT_N3D = 4


def make_cartesian_2d(
    nx: int, ny: int, geom: str = core.GEOM_TRIANGLE, sx: float = 1.0, sy: float = 1.0
) -> core.MeshData:
    xs = np.linspace(0.0, sx, nx + 1)
    ys = np.linspace(0.0, sy, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    vertices = np.stack([X.reshape(-1), Y.reshape(-1)], axis=-1)

    def vid(i, j):
        return j * (nx + 1) + i

    elems = []
    for j in range(ny):
        for i in range(nx):
            v0, v1, v2, v3 = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
            if geom == core.GEOM_TRIANGLE:
                elems.append([v0, v1, v2])
                elems.append([v0, v2, v3])
            elif geom == core.GEOM_QUAD:
                elems.append([v0, v1, v2, v3])
            else:
                raise ValueError(f"unsupported 2D geometry: {geom}")

    bdry, battr = [], []
    for i in range(nx):  # bottom=1, top=3
        bdry.append([vid(i, 0), vid(i + 1, 0)])
        battr.append(1)
        bdry.append([vid(i + 1, ny), vid(i, ny)])
        battr.append(3)
    for j in range(ny):  # right=2, left=4
        bdry.append([vid(nx, j), vid(nx, j + 1)])
        battr.append(2)
        bdry.append([vid(0, j + 1), vid(0, j)])
        battr.append(4)

    mesh = core.MeshData(
        dim=2,
        geom=geom,
        vertices=vertices,
        elem_verts=np.asarray(elems, dtype=np.int32),
        elem_attr=np.ones(len(elems), dtype=np.int32),
        bdry_verts=np.asarray(bdry, dtype=np.int32),
        bdry_attr=np.asarray(battr, dtype=np.int32),
        source=f"builtin-cartesian2d-{geom}-{nx}x{ny}",
    )
    return core.finalize(mesh)


def make_mixed_2d(
    nx: int, ny: int, sx: float = 1.0, sy: float = 1.0
) -> core.MeshData:
    """Mixed 2D mesh: quads on the left half of the grid (i < nx // 2),
    each right-half cell split into two triangles — a conforming
    triangle/quad interface along the mid-line. Boundary attributes follow
    the Cartesian convention (bottom=1, right=2, top=3, left=4)."""
    xs = np.linspace(0.0, sx, nx + 1)
    ys = np.linspace(0.0, sy, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    vertices = np.stack([X.reshape(-1), Y.reshape(-1)], axis=-1)

    def vid(i, j):
        return j * (nx + 1) + i

    elems, geoms = [], []
    tri = core.MFEM_CODE_OF_GEOM[core.GEOM_TRIANGLE]
    qd = core.MFEM_CODE_OF_GEOM[core.GEOM_QUAD]
    for j in range(ny):
        for i in range(nx):
            v0, v1, v2, v3 = (
                vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
            )
            if i < nx // 2:
                elems.append([v0, v1, v2, v3])
                geoms.append(qd)
            else:
                elems.append([v0, v1, v2, -1])
                geoms.append(tri)
                elems.append([v0, v2, v3, -1])
                geoms.append(tri)

    bdry, battr = [], []
    for i in range(nx):  # bottom=1, top=3
        bdry.append([vid(i, 0), vid(i + 1, 0)])
        battr.append(1)
        bdry.append([vid(i + 1, ny), vid(i, ny)])
        battr.append(3)
    for j in range(ny):  # right=2, left=4
        bdry.append([vid(nx, j), vid(nx, j + 1)])
        battr.append(2)
        bdry.append([vid(0, j + 1), vid(0, j)])
        battr.append(4)

    mesh = core.MeshData(
        dim=2,
        geom=core.GEOM_MIXED,
        vertices=vertices,
        elem_verts=np.asarray(elems, dtype=np.int32),
        elem_attr=np.ones(len(elems), dtype=np.int32),
        bdry_verts=np.asarray(bdry, dtype=np.int32),
        bdry_attr=np.asarray(battr, dtype=np.int32),
        source=f"builtin-mixed2d-{nx}x{ny}",
        elem_geom=np.asarray(geoms, dtype=np.int32),
    )
    return core.finalize(mesh)


# The 6-tet split of a cube used by MFEM's Make3D — matches the committed
# unit-cube-tet-iso.mesh asset exactly (tets over local corners 0..7).
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


def make_mixed_3d() -> core.MeshData:
    """Conforming unit-cube mesh containing ALL FOUR 3D geometries:
    a hex slab (x < 1/3), a 6-pyramid split of the middle slab (apex at the
    cube center (0.5, 0.5, 0.5)) with its -y pyramid further split into two
    tets, and a 2-prism split of the right slab (x > 2/3). Every internal
    interface is exactly conforming: hex/prism quad faces meet pyramid quad
    bases, pyramid triangles meet tet triangles. Boundary attributes follow
    the MFEM box convention (z0=1, y0=2, x1=3, y1=4, x0=5, z1=6).

    The reference's MFEM tree accepts such meshes through mfem::Mesh; its
    committed assets are single-geometry, so this builtin (name
    "unit-cube-mixed") is this framework's own demo/test asset."""
    third = 1.0 / 3.0
    corners = [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)]  # (y, z)
    vertices = np.array(
        [
            (px * third, y, z)
            for px in range(4)
            for (y, z) in corners
        ]
        + [(0.5, 0.5, 0.5)]
    )
    C = 16  # center vertex (pyramid apex)
    # vid(p, c): plane p in 0..3 (x = p/3), corner c in 0..3 per `corners`

    def v(p, c):
        return p * 4 + c

    hexes = [[v(0, 0), v(1, 0), v(1, 1), v(0, 1),
              v(0, 3), v(1, 3), v(1, 2), v(0, 2)]]
    # middle slab: pyramids with bases = the slab's 6 faces (base quads CCW
    # seen from the apex, so the MFEM pyramid Jacobian is positive); the
    # -y pyramid is replaced by its 2-tet split
    pyramids = [
        [v(1, 0), v(1, 1), v(1, 2), v(1, 3), C],  # -x base (the hex's face)
        [v(2, 0), v(2, 3), v(2, 2), v(2, 1), C],  # +x base (the prisms')
        [v(1, 1), v(2, 1), v(2, 2), v(1, 2), C],  # +y
        [v(1, 0), v(2, 0), v(2, 1), v(1, 1), C],  # -z
        [v(1, 3), v(1, 2), v(2, 2), v(2, 3), C],  # +z
    ]
    tets = [
        [v(1, 0), v(1, 3), v(2, 3), C],  # -y pyramid split along (v10, v23)
        [v(1, 0), v(2, 3), v(2, 0), C],
    ]
    prisms = [
        [v(2, 0), v(3, 0), v(3, 1), v(2, 3), v(3, 3), v(3, 2)],
        [v(2, 0), v(3, 1), v(2, 1), v(2, 3), v(3, 2), v(2, 2)],
    ]
    elems = hexes + pyramids + tets + prisms
    geoms = (
        [core.MFEM_CODE_OF_GEOM[core.GEOM_HEX]]
        + [core.MFEM_CODE_OF_GEOM[core.GEOM_PYRAMID]] * 5
        + [core.MFEM_CODE_OF_GEOM[core.GEOM_TET]] * 2
        + [core.MFEM_CODE_OF_GEOM[core.GEOM_PRISM]] * 2
    )
    nv_max = max(len(e) for e in elems)
    elems = [e + [-1] * (nv_max - len(e)) for e in elems]

    bdry, battr = [], []

    def add(verts, attr):
        bdry.append(list(verts))
        battr.append(attr)

    # z=0 (attr 1): hex quad, -z pyramid base, prism bottom triangles
    add([v(0, 0), v(1, 0), v(1, 1), v(0, 1)], 1)
    add([v(1, 0), v(2, 0), v(2, 1), v(1, 1)], 1)
    add([v(2, 0), v(3, 0), v(3, 1)], 1)
    add([v(2, 0), v(3, 1), v(2, 1)], 1)
    # z=1 (attr 6)
    add([v(0, 3), v(1, 3), v(1, 2), v(0, 2)], 6)
    add([v(1, 3), v(2, 3), v(2, 2), v(1, 2)], 6)
    add([v(2, 3), v(3, 3), v(3, 2)], 6)
    add([v(2, 3), v(3, 2), v(2, 2)], 6)
    # y=0 (attr 2): hex quad, TET triangles (the split -y pyramid), prism quad
    add([v(0, 0), v(1, 0), v(1, 3), v(0, 3)], 2)
    add([v(1, 0), v(1, 3), v(2, 3)], 2)
    add([v(1, 0), v(2, 3), v(2, 0)], 2)
    add([v(2, 0), v(3, 0), v(3, 3), v(2, 3)], 2)
    # y=1 (attr 4)
    add([v(0, 1), v(1, 1), v(1, 2), v(0, 2)], 4)
    add([v(1, 1), v(2, 1), v(2, 2), v(1, 2)], 4)
    add([v(2, 1), v(3, 1), v(3, 2), v(2, 2)], 4)
    # x=0 (attr 5), x=1 (attr 3)
    add([v(0, 0), v(0, 1), v(0, 2), v(0, 3)], 5)
    add([v(3, 0), v(3, 1), v(3, 2), v(3, 3)], 3)

    bw = max(len(b) for b in bdry)
    bdry = [b + [-1] * (bw - len(b)) for b in bdry]
    mesh = core.MeshData(
        dim=3,
        geom=core.GEOM_MIXED,
        vertices=vertices,
        elem_verts=np.asarray(elems, dtype=np.int32),
        elem_attr=np.ones(len(elems), dtype=np.int32),
        bdry_verts=np.asarray(bdry, dtype=np.int32),
        bdry_attr=np.asarray(battr, dtype=np.int32),
        source="builtin-mixed3d",
        elem_geom=np.asarray(geoms, dtype=np.int32),
    )
    return core.finalize(mesh)


def load_builtin(name: str) -> core.MeshData:
    """Built-in names accepted by the reference CLI
    (ref: src/SpatialMesh.cpp:305-340)."""
    if name in ("unit-square", "unit-square-tri"):
        return make_cartesian_2d(DEFAULT_N2D, DEFAULT_N2D, core.GEOM_TRIANGLE)
    if name == "unit-square-quad":
        return make_cartesian_2d(DEFAULT_N2D, DEFAULT_N2D, core.GEOM_QUAD)
    if name in ("unit-cube", "unit-cube-tet"):
        return make_cartesian_3d(DEFAULT_N3D, DEFAULT_N3D, DEFAULT_N3D, core.GEOM_TET)
    if name == "unit-cube-hex":
        return make_cartesian_3d(DEFAULT_N3D, DEFAULT_N3D, DEFAULT_N3D, core.GEOM_HEX)
    if name == "unit-square-mixed":  # this repo only: tri+quad interface demo
        return make_mixed_2d(DEFAULT_N2D, DEFAULT_N2D)
    if name == "unit-cube-prism":  # this repo only: 2-prism cube split
        return make_cartesian_3d(
            DEFAULT_N3D, DEFAULT_N3D, DEFAULT_N3D, core.GEOM_PRISM
        )
    if name == "unit-cube-mixed":  # this repo only: all four 3D geometries
        return make_mixed_3d()
    raise ValueError(f"unrecognized built-in mesh name: {name}")
