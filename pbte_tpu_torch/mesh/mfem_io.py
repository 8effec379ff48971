"""Parser and writer for the "MFEM mesh v1.0" ASCII format.

This package's own copy of ``pbte_tpu/mesh/mfem_io.py`` (for
files like config/mesh/unit-square-iso.mesh). Uniform-face geometries
(tri/quad/tet/hex) load directly; mixed meshes — 2D triangle+quad, 3D any
mix of tet/hex/prism/pyramid — and pure prism/pyramid meshes load as
geom="mixed" with per-element geometry codes (mesh/core.py GEOM_MIXED).
"""

from __future__ import annotations

import numpy as np

from pbte_tpu_torch.mesh import core


def _read_ints(tokens):
    return [int(t) for t in tokens]


def parse_mfem_mesh(text: str, source: str = "") -> core.MeshData:
    lines = [ln.split("#")[0].strip() for ln in text.splitlines()]
    lines = [ln for ln in lines if ln]
    if not lines or not lines[0].startswith("MFEM mesh v1."):
        raise ValueError("not an MFEM mesh v1.x file")

    idx = {}
    for i, ln in enumerate(lines):
        if ln in ("dimension", "elements", "boundary", "vertices"):
            idx[ln] = i
    for key in ("dimension", "elements", "vertices"):
        if key not in idx:
            raise ValueError(f"missing '{key}' section")

    dim = int(lines[idx["dimension"] + 1])

    def read_entities(start):
        count = int(lines[start + 1])
        attrs, geoms, conn = [], [], []
        for j in range(count):
            parts = _read_ints(lines[start + 2 + j].split())
            attrs.append(parts[0])
            geoms.append(parts[1])
            conn.append(parts[2:])
        return attrs, geoms, conn

    e_attrs, e_geoms, e_conn = read_entities(idx["elements"])
    codes = sorted(set(e_geoms))
    for c in codes:
        if core.MFEM_GEOM_CODES.get(c) not in (
            core.GEOM_TRIANGLE, core.GEOM_QUAD, core.GEOM_TET,
            core.GEOM_HEX, core.GEOM_PRISM, core.GEOM_PYRAMID,
        ):
            raise ValueError(f"unsupported element geometry code {c}")
    gdims = {core.GEOM_DIM[core.MFEM_GEOM_CODES[c]] for c in codes}
    if len(gdims) > 1:
        raise ValueError("mesh mixes 2D and 3D element geometries")
    elem_geom = None
    uniform = len(codes) == 1 and core.MFEM_GEOM_CODES[codes[0]] in (
        core.GEOM_TRIANGLE, core.GEOM_QUAD, core.GEOM_TET, core.GEOM_HEX
    )
    if uniform:
        geom = core.MFEM_GEOM_CODES[codes[0]]
    else:
        # any mix — and pure prism/pyramid meshes, whose per-element faces
        # mix triangle/quad shapes — routes through the mixed pipeline
        geom = core.GEOM_MIXED
        elem_geom = np.asarray(e_geoms, dtype=np.int32)
        nv_max = max(len(c) for c in e_conn)
        e_conn = [c + [-1] * (nv_max - len(c)) for c in e_conn]

    if "boundary" in idx:
        b_attrs, b_geoms, b_conn = read_entities(idx["boundary"])
        bnv = max((len(c) for c in b_conn), default=0)
        b_conn = [c + [-1] * (bnv - len(c)) for c in b_conn]
    else:
        b_attrs, b_conn = [], []

    vstart = idx["vertices"]
    nv = int(lines[vstart + 1])
    vdim = int(lines[vstart + 2])
    vertices = np.array(
        [[float(x) for x in lines[vstart + 3 + j].split()] for j in range(nv)],
        dtype=np.float64,
    )
    if vertices.shape != (nv, vdim):
        raise ValueError("vertex section shape mismatch")

    mesh = core.MeshData(
        dim=dim,
        geom=geom,
        vertices=vertices,
        elem_verts=np.asarray(e_conn, dtype=np.int32),
        elem_attr=np.asarray(e_attrs, dtype=np.int32),
        bdry_verts=np.asarray(b_conn, dtype=np.int32).reshape(len(b_conn), -1),
        bdry_attr=np.asarray(b_attrs, dtype=np.int32),
        source=source,
        elem_geom=elem_geom,
    )
    return core.finalize(mesh)


def load_mfem_mesh(path: str) -> core.MeshData:
    with open(path) as f:
        return parse_mfem_mesh(f.read(), source=path)


def write_mfem_mesh(mesh: core.MeshData, path: str) -> None:
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if mesh.geom == core.GEOM_MIXED:
        codes = mesh.elem_geom
    else:
        codes = np.full(
            mesh.num_elements, core.MFEM_CODE_OF_GEOM[mesh.geom]
        )
    # boundary geometry per row by vertex count (3D mixed meshes can have
    # both triangle and quad boundary faces)
    bcode_of_nv = {2: 1, 3: 2, 4: 3}
    with open(path, "w") as f:
        f.write("MFEM mesh v1.0\n\ndimension\n%d\n\n" % mesh.dim)
        f.write("elements\n%d\n" % mesh.num_elements)
        for attr, code, verts in zip(mesh.elem_attr, codes, mesh.elem_verts):
            vs = [int(v) for v in verts if v >= 0]
            f.write(f"{attr} {int(code)} " + " ".join(map(str, vs)) + "\n")
        f.write("\nboundary\n%d\n" % len(mesh.bdry_verts))
        for attr, verts in zip(mesh.bdry_attr, mesh.bdry_verts):
            vs = [int(v) for v in verts if v >= 0]
            f.write(
                f"{attr} {bcode_of_nv[len(vs)]} "
                + " ".join(map(str, vs)) + "\n"
            )
        f.write("\nvertices\n%d\n%d\n" % (mesh.num_vertices, mesh.dim))
        for v in mesh.vertices:
            f.write(" ".join(repr(float(x)) for x in v) + "\n")
