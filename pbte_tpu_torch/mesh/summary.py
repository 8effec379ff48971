"""Mesh and DG-space summary in the reference's golden format
(``mesh_*.txt``).

This package's own copy of ``pbte_tpu/mesh/summary.py``."""

from __future__ import annotations

from pbte_tpu_torch.mesh import core

_GEOM_NAMES = {
    core.GEOM_TRIANGLE: "Triangle",
    core.GEOM_QUAD: "Square",
    core.GEOM_TET: "Tetrahedron",
    core.GEOM_HEX: "Cube",
    core.GEOM_PRISM: "Prism",
    core.GEOM_PYRAMID: "Pyramid",
}


def _geom_name(mesh: core.MeshData) -> str:
    if mesh.geom != core.GEOM_MIXED:
        return _GEOM_NAMES[mesh.geom]
    import numpy as np

    members = sorted(
        {core.MFEM_GEOM_CODES[int(c)] for c in np.unique(mesh.elem_geom)},
        key=core.MFEM_CODE_OF_GEOM.get,
    )
    return "Mixed(" + "+".join(_GEOM_NAMES[g] for g in members) + ")"


def _fmt(x: float) -> str:
    return f"{x:g}"


def make_summary(topo: core.MeshTopology, order: int, ndofs: int) -> str:
    mesh = topo.mesh
    ne = mesh.num_elements
    out = []
    out.append("Mesh and DG space summary")
    out.append(f"  mesh source          : {mesh.source}")
    out.append(f"  dimension            : {mesh.dim}")
    out.append(f"  element count        : {ne}")
    out.append(f"  boundary elem count  : {len(mesh.bdry_verts)}")
    out.append(f"  vertex count         : {mesh.num_vertices}")
    out.append(f"  element geometry     : {_geom_name(mesh)}")
    out.append(f"  DG polynomial order  : {order}")
    out.append(f"  FE space ndofs       : {ndofs}")
    out.append("  FE space vdim        : 1")
    out.append("  ordering             : byNODES")
    out.append("Element details (vertices and faces):")
    for e in range(ne):
        out.append(f"  elem {e}")
        parts = []
        for v in mesh.elem_verts[e]:
            if v < 0:  # mixed-mesh padding
                continue
            coords = ",".join(_fmt(x) for x in mesh.vertices[v])
            parts.append(f"v{v}({coords})")
        out.append("    vertices: " + " ".join(parts))
        for lf in range(topo.faces_per_elem):
            fid = topo.elem_face[e, lf]
            if fid < 0:  # mixed-mesh padding
                continue
            nbr = topo.elem_neighbor[e, lf]
            if nbr < 0:
                out.append(
                    f"    face {fid} neigh=-1 boundary attr={topo.elem_face_attr[e, lf]}"
                )
            else:
                out.append(f"    face {fid} neigh={nbr} interior")
    return "\n".join(out) + "\n"


def write_summary(topo: core.MeshTopology, order: int, ndofs: int, path: str) -> None:
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(make_summary(topo, order, ndofs))
