"""gmsh 2.2 ASCII mesh parser.

This package's own copy of ``pbte_tpu/mesh/gmsh_io.py``: $MeshFormat 2.2
check, $PhysicalNames -> boundary name map, $Nodes, $Elements (boundary
entities become boundary faces with their physical tag, volume entities
become elements), $Periodic node pairs.

gmsh element type codes: 1=line, 2=triangle, 3=quad, 4=tet, 5=hex, 15=point.
"""

from __future__ import annotations

import numpy as np

from pbte_tpu_torch.mesh import core

# gmsh prism/pyramid node ordering coincides with MFEM's (prism: bottom
# triangle 0-2 then top 3-5; pyramid: base quad 0-3 then apex 4)
_GMSH_GEOM = {
    2: core.GEOM_TRIANGLE, 3: core.GEOM_QUAD, 4: core.GEOM_TET,
    5: core.GEOM_HEX, 6: core.GEOM_PRISM, 7: core.GEOM_PYRAMID,
}
_GMSH_DIM = {1: 1, 2: 2, 3: 2, 4: 3, 5: 3, 6: 3, 7: 3, 15: 0}  # entity dim per type


def parse_gmsh_mesh(text: str, source: str = "") -> core.MeshData:
    lines = iter(text.splitlines())
    physical_names: dict[int, str] = {}
    nodes: dict[int, np.ndarray] = {}
    vol_elems: list[tuple[int, int, list[int]]] = []  # (geom_code, tag, verts)
    bdry: list[tuple[int, list[int]]] = []  # (tag, verts)
    periodic_node_pairs: dict[int, int] = {}
    periodic_node_maps: list[dict[int, int]] = []  # one per $Periodic entity
    periodic_face_tags: list[tuple[int, int]] = []

    for line in lines:
        line = line.strip()
        if line == "$MeshFormat":
            parts = next(lines).split()
            version, is_binary = float(parts[0]), int(parts[1])
            if abs(version - 2.2) > 1e-9 or is_binary:
                raise ValueError(
                    f"unsupported gmsh format {version} (need ASCII 2.2)"
                )
        elif line == "$PhysicalNames":
            n = int(next(lines))
            for _ in range(n):
                parts = next(lines).split(None, 2)
                physical_names[int(parts[1])] = parts[2].strip().strip('"')
        elif line == "$Nodes":
            n = int(next(lines))
            for _ in range(n):
                parts = next(lines).split()
                nodes[int(parts[0])] = np.array([float(x) for x in parts[1:4]])
        elif line == "$Elements":
            n = int(next(lines))
            entities = []
            for _ in range(n):
                parts = [int(x) for x in next(lines).split()]
                etype = parts[1]
                ntags = parts[2]
                tag = parts[3] if ntags >= 1 else 0
                verts = [v - 1 for v in parts[3 + ntags:]]
                if etype in _GMSH_DIM:
                    entities.append((etype, tag, verts))
            # triangles/quads are volume elements in 2D but boundary in 3D:
            # classify by the maximum entity dimension present
            voldim = max(_GMSH_DIM[e[0]] for e in entities)
            for etype, tag, verts in entities:
                if _GMSH_DIM[etype] == voldim:
                    vol_elems.append((etype, tag, verts))
                elif _GMSH_DIM[etype] == voldim - 1:
                    bdry.append((tag, verts))
        elif line == "$Periodic":
            n_entities = int(next(lines).split()[0])
            for _ in range(n_entities):
                parts = next(lines).split()
                _, slave, master = int(parts[0]), int(parts[1]), int(parts[2])
                periodic_face_tags.append((slave, master))
                peek = next(lines).strip()
                if peek.startswith("Affine"):
                    peek = next(lines).strip()
                npairs = int(peek)
                entity_map = {}
                for _ in range(npairs):
                    a, b = (int(x) for x in next(lines).split()[:2])
                    periodic_node_pairs[a - 1] = b - 1
                    periodic_node_pairs[b - 1] = a - 1
                    entity_map[a - 1] = b - 1
                    entity_map[b - 1] = a - 1
                if entity_map:
                    periodic_node_maps.append(entity_map)

    if not vol_elems:
        raise ValueError("gmsh file contains no volume elements")
    geom_codes = {e[0] for e in vol_elems}
    elem_geom = None
    gdims = {core.GEOM_DIM[_GMSH_GEOM[c]] for c in geom_codes}
    if len(gdims) > 1:
        raise ValueError("gmsh mesh mixes 2D and 3D volume elements")
    dim = gdims.pop()
    uniform = len(geom_codes) == 1 and _GMSH_GEOM[
        next(iter(geom_codes))
    ] in (core.GEOM_TRIANGLE, core.GEOM_QUAD, core.GEOM_TET, core.GEOM_HEX)
    if not uniform:
        # any mix — and pure prism/pyramid meshes, whose faces mix
        # triangle/quad shapes — routes through the mixed pipeline
        geom = core.GEOM_MIXED
        elem_geom = np.asarray(
            [core.MFEM_CODE_OF_GEOM[_GMSH_GEOM[e[0]]] for e in vol_elems],
            dtype=np.int32,
        )
        nv_max = max(len(e[2]) for e in vol_elems)
        vol_elems = [
            (et, tag, v + [-1] * (nv_max - len(v)))
            for (et, tag, v) in vol_elems
        ]
    else:
        geom = _GMSH_GEOM[next(iter(geom_codes))]

    # boundary entities of codim 1 only (3D mixed meshes can carry both
    # triangle and quad boundary faces; right-pad the rows with -1)
    bfa = {2: (2,), 3: (3,) if geom == core.GEOM_TET else (
        (3, 4) if geom == core.GEOM_MIXED else (4,)
    )}[dim]
    bdry = [(t, v) for (t, v) in bdry if len(v) in bfa]
    face_nv = max(bfa)
    bdry = [(t, v + [-1] * (face_nv - len(v))) for (t, v) in bdry]

    nv = max(nodes) if nodes else 0
    vertices = np.zeros((nv, dim))
    for nid, xyz in nodes.items():
        vertices[nid - 1] = xyz[:dim]

    mesh = core.MeshData(
        dim=dim,
        geom=geom,
        vertices=vertices,
        elem_verts=np.asarray([e[2] for e in vol_elems], dtype=np.int32),
        elem_attr=np.asarray([e[1] for e in vol_elems], dtype=np.int32),
        bdry_verts=np.asarray([v for _, v in bdry], dtype=np.int32).reshape(
            len(bdry), face_nv
        ),
        bdry_attr=np.asarray([t for t, _ in bdry], dtype=np.int32),
        source=source,
        periodic_node_maps=periodic_node_maps or None,
        elem_geom=elem_geom,
    )
    mesh = core.finalize(mesh)
    # stash gmsh extras for consumers (periodic BCs, physical names)
    mesh.physical_names = physical_names  # type: ignore[attr-defined]
    mesh.periodic_node_pairs = periodic_node_pairs  # type: ignore[attr-defined]
    mesh.periodic_face_tags = periodic_face_tags  # type: ignore[attr-defined]
    return mesh


def load_gmsh_mesh(path: str) -> core.MeshData:
    with open(path) as f:
        return parse_gmsh_mesh(f.read(), source=path)
