"""Uniform (red) mesh refinement, MFEM's layout.

This package's own copy of ``pbte_tpu/mesh/refine.py``, the refinement of
the reference CLI's ``-r`` flag (mfem::Mesh::UniformRefinement), for
triangle, quad, tet and hex meshes and mixed meshes. The vertex and
element order is MFEM's, so the sweep-order logs of refined meshes match
the reference's:

- new vertices after the originals: edge midpoints in edge-id order, then
  face centers (quad interiors, 3D quad faces), then cell centers;
- the children of parent i sit at nchild*i + c; a triangle's in the order
  [corner@v0, center, corner@v1, corner@v2];
- edge and face ids are first-seen over the elements in order, with
  MFEM's local edge and face order (core.LOCAL_EDGES, core.LOCAL_FACES).
"""

from __future__ import annotations

import numpy as np

from pbte_tpu_torch.mesh import core


def _build_entity_table(elem_verts: np.ndarray, local_entities) -> tuple[dict, list]:
    index: dict = {}
    ordered: list = []
    for ev in elem_verts:
        for loc in local_entities:
            verts = tuple(int(ev[i]) for i in loc)
            key = tuple(sorted(verts))
            if key not in index:
                index[key] = len(ordered)
                ordered.append(verts)
    return index, ordered


def uniform_refine(mesh: core.MeshData, levels: int = 1) -> core.MeshData:
    for _ in range(max(0, levels)):
        mesh = _refine_once(mesh)
    return mesh


def _refine_once(mesh: core.MeshData) -> core.MeshData:
    geom = mesh.geom
    if geom == core.GEOM_MIXED:
        return _refine_once_mixed(mesh)
    ev = mesh.elem_verts
    ne = mesh.num_elements
    nv = mesh.num_vertices
    verts = mesh.vertices

    edge_index, edges = _build_entity_table(ev, core.LOCAL_EDGES[geom])
    nedges = len(edges)
    new_coords = [verts[list(e)].mean(axis=0) for e in edges]
    oedge = nv

    def emid(a: int, b: int) -> int:
        return oedge + edge_index[tuple(sorted((int(a), int(b))))]

    face_index: dict = {}
    ofa = oedge + nedges
    if geom == core.GEOM_HEX:
        face_index, faces = _build_entity_table(ev, core.LOCAL_FACES[geom])
        new_coords += [verts[list(f)].mean(axis=0) for f in faces]
        ocell = ofa + len(faces)
    elif geom == core.GEOM_QUAD:
        ocell = ofa  # per-element centers only
    else:
        ocell = ofa

    def fctr(quad_verts) -> int:
        return ofa + face_index[tuple(sorted(int(v) for v in quad_verts))]

    children = [[] for _ in range(ne)]  # nchild consecutive children per parent

    if geom == core.GEOM_TRIANGLE:
        for e in range(ne):
            v0, v1, v2 = (int(x) for x in ev[e])
            m0, m1, m2 = emid(v0, v1), emid(v1, v2), emid(v2, v0)
            # MFEM order: corner@v0, center, corner@v1, corner@v2
            children[e] = [[v0, m0, m2], [m0, m1, m2], [m0, v1, m1], [m2, m1, v2]]
    elif geom == core.GEOM_QUAD:
        for e in range(ne):
            v0, v1, v2, v3 = (int(x) for x in ev[e])
            m0, m1, m2, m3 = emid(v0, v1), emid(v1, v2), emid(v2, v3), emid(v3, v0)
            c = ocell + e
            children[e] = [
                [v0, m0, c, m3], [m0, v1, m1, c], [c, m1, v2, m2], [m3, c, m2, v3],
            ]
        new_coords += [verts[list(ev[e])].mean(axis=0) for e in range(ne)]
    elif geom == core.GEOM_TET:
        for e in range(ne):
            v0, v1, v2, v3 = (int(x) for x in ev[e])
            m01, m02, m03 = emid(v0, v1), emid(v0, v2), emid(v0, v3)
            m12, m13, m23 = emid(v1, v2), emid(v1, v3), emid(v2, v3)
            # corners then Bey's octahedron split along the m02-m13
            # diagonal. Octahedron children 5 and 7 are listed with their
            # first two vertices SWAPPED relative to the naive labeling:
            # the naive order gives those two a NEGATIVE Jacobian on every
            # positively-oriented parent (verified on the reference tet) —
            # the point sets tile either way, which is why sweep orders and
            # connectivity never caught it, but detJ<0 flips the volume
            # operators' signs in assembly.
            children[e] = [
                [v0, m01, m02, m03],
                [m01, v1, m12, m13],
                [m02, m12, v2, m23],
                [m03, m13, m23, v3],
                [m01, m02, m03, m13],
                [m02, m01, m12, m13],
                [m02, m03, m13, m23],
                [m12, m02, m13, m23],
            ]
    elif geom == core.GEOM_HEX:
        local_faces = core.LOCAL_FACES[geom]
        # lattice coords (units of 1/2) for the 8 MFEM hex corners
        corner_xyz = [
            (0, 0, 0), (2, 0, 0), (2, 2, 0), (0, 2, 0),
            (0, 0, 2), (2, 0, 2), (2, 2, 2), (0, 2, 2),
        ]
        child_pattern = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                         (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]
        for e in range(ne):
            c = [int(x) for x in ev[e]]
            lattice: dict = {}
            for li, xyz in enumerate(corner_xyz):
                lattice[xyz] = c[li]
            for (a, b) in core.LOCAL_EDGES[geom]:
                xyz = tuple((corner_xyz[a][d] + corner_xyz[b][d]) // 2 for d in range(3))
                lattice[xyz] = emid(c[a], c[b])
            for loc in local_faces:
                xyz = tuple(sum(corner_xyz[i][d] for i in loc) // 4 for d in range(3))
                lattice[xyz] = fctr([c[i] for i in loc])
            lattice[(1, 1, 1)] = ocell + e
            kids = []
            for (ox, oy, oz) in child_pattern:
                kid = [
                    lattice[(ox + dx, oy + dy, oz + dz)]
                    for (dx, dy, dz) in child_pattern
                ]
                kids.append(kid)
            children[e] = kids
        new_coords += [verts[list(ev[e])].mean(axis=0) for e in range(ne)]
    else:
        raise ValueError(f"unsupported geometry: {geom}")

    new_elems = []
    new_attrs = []
    for e in range(ne):
        new_elems.extend(children[e])
        new_attrs.extend([int(mesh.elem_attr[e])] * len(children[e]))

    # Boundary elements split with the same midpoint ids.
    new_bdry, new_battr = [], []
    for bv, attr in zip(mesh.bdry_verts, mesh.bdry_attr):
        b = [int(x) for x in bv]
        a = int(attr)
        if len(b) == 2:
            m = emid(b[0], b[1])
            new_bdry += [[b[0], m], [m, b[1]]]
            new_battr += [a, a]
        elif len(b) == 3:
            m01, m12, m20 = emid(b[0], b[1]), emid(b[1], b[2]), emid(b[2], b[0])
            new_bdry += [
                [b[0], m01, m20], [m01, b[1], m12], [m20, m12, b[2]], [m01, m12, m20],
            ]
            new_battr += [a] * 4
        elif len(b) == 4:
            m0, m1 = emid(b[0], b[1]), emid(b[1], b[2])
            m2, m3 = emid(b[2], b[3]), emid(b[3], b[0])
            c = fctr(b)
            new_bdry += [
                [b[0], m0, c, m3], [m0, b[1], m1, c], [c, m1, b[2], m2], [m3, c, m2, b[3]],
            ]
            new_battr += [a] * 4
        else:
            raise ValueError("unsupported boundary element arity")

    return core.MeshData(
        dim=mesh.dim,
        geom=geom,
        vertices=np.vstack([verts, np.asarray(new_coords)]) if new_coords else verts.copy(),
        elem_verts=np.asarray(new_elems, dtype=np.int32),
        elem_attr=np.asarray(new_attrs, dtype=np.int32),
        bdry_verts=(
            np.asarray(new_bdry, dtype=np.int32).reshape(len(new_bdry), -1)
            if new_bdry
            else mesh.bdry_verts[:0].copy()
        ),
        bdry_attr=np.asarray(new_battr, dtype=np.int32),
        source=mesh.source,
    )


def _refine_once_mixed(mesh: core.MeshData) -> core.MeshData:
    """Red refinement of a mixed-geometry mesh.

    2D: tri -> 4 tris, quad -> 4 quads. 3D: tet -> 8 tets (Bey), hex -> 8
    hexes, prism -> 8 prisms (4-tri cross-section split x height bisection),
    pyramid -> 6 pyramids + 4 tets (4 corner pyramids with the base-edge
    midpoints as apexes is NOT a valid red split; the standard conforming
    decomposition keeps 4 corner + 1 top + 1 inverted-central pyramid and
    fills the 4 gaps above the base edges with tets — so refining a pyramid
    mesh GROWS the geometry mix, which is why per-element `elem_geom` is
    carried). All shared entities (edge midpoints, quad-face centers) are
    resolved through global sorted-vertex-key tables, so every
    cross-geometry interface stays conforming — tri faces refine 4-way
    identically from both sides, quad faces 4-way through the shared face
    center. Vertex layout: originals, then edge midpoints (first-seen over
    each element's OWN local edges), then quad-FACE centers (first-seen:
    2D quad cells / 3D hex+prism side+pyramid base faces), then hex body
    centers in element order."""
    ev = mesh.elem_verts
    ne = mesh.num_elements
    nv = mesh.num_vertices
    verts = mesh.vertices
    egeom = mesh.elem_geom
    code_of = core.MFEM_CODE_OF_GEOM
    geom_of = [core.MFEM_GEOM_CODES[int(c)] for c in egeom]

    # shared edge-midpoint table (first-seen over each element's own edges)
    index: dict = {}
    ordered: list = []
    for e in range(ne):
        for loc in core.LOCAL_EDGES[geom_of[e]]:
            vv = tuple(int(ev[e][i]) for i in loc)
            key = tuple(sorted(vv))
            if key not in index:
                index[key] = len(ordered)
                ordered.append(vv)
    new_coords = [verts[list(p)].mean(axis=0) for p in ordered]
    oedge = nv

    def emid(a: int, b: int) -> int:
        return oedge + index[tuple(sorted((int(a), int(b))))]

    # shared quad-FACE center table: 2D quad cells; 3D quad faces of
    # hex (all 6) / prism (3 sides) / pyramid (base)
    ofa = oedge + len(ordered)
    find: dict = {}
    ford: list = []
    for e in range(ne):
        g = geom_of[e]
        quad_faces = (
            [tuple(range(4))] if g == core.GEOM_QUAD
            else [f for f in core.LOCAL_FACES.get(g, ()) if len(f) == 4]
            if mesh.dim == 3 else []
        )
        for loc in quad_faces:
            vv = tuple(int(ev[e][i]) for i in loc)
            key = tuple(sorted(vv))
            if key not in find:
                find[key] = len(ford)
                ford.append(vv)
    new_coords += [verts[list(p)].mean(axis=0) for p in ford]

    def fctr(vv) -> int:
        return ofa + find[tuple(sorted(int(x) for x in vv))]

    # hex body centers
    ocell = ofa + len(ford)
    hex_ids = [e for e in range(ne) if geom_of[e] == core.GEOM_HEX]
    hex_center = {e: ocell + i for i, e in enumerate(hex_ids)}
    new_coords += [
        verts[[int(x) for x in ev[e][:8]]].mean(axis=0) for e in hex_ids
    ]

    new_elems, new_geoms, new_attrs = [], [], []

    def add_kids(kids, gname, attr):
        new_elems.extend(kids)
        new_geoms.extend([code_of[gname]] * len(kids))
        new_attrs.extend([attr] * len(kids))

    _HEX_CORNER = [
        (0, 0, 0), (2, 0, 0), (2, 2, 0), (0, 2, 0),
        (0, 0, 2), (2, 0, 2), (2, 2, 2), (0, 2, 2),
    ]
    _HEX_CHILD = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                  (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]

    for e in range(ne):
        a = int(mesh.elem_attr[e])
        g = geom_of[e]
        v = [int(x) for x in ev[e] if x >= 0]
        if g == core.GEOM_TRIANGLE:
            v0, v1, v2 = v
            m0, m1, m2 = emid(v0, v1), emid(v1, v2), emid(v2, v0)
            add_kids(
                [[v0, m0, m2], [m0, m1, m2], [m0, v1, m1], [m2, m1, v2]],
                g, a,
            )
        elif g == core.GEOM_QUAD:
            v0, v1, v2, v3 = v
            m0, m1 = emid(v0, v1), emid(v1, v2)
            m2, m3 = emid(v2, v3), emid(v3, v0)
            c = fctr(v)
            add_kids(
                [[v0, m0, c, m3], [m0, v1, m1, c],
                 [c, m1, v2, m2], [m3, c, m2, v3]],
                g, a,
            )
        elif g == core.GEOM_TET:
            v0, v1, v2, v3 = v
            m01, m02, m03 = emid(v0, v1), emid(v0, v2), emid(v0, v3)
            m12, m13, m23 = emid(v1, v2), emid(v1, v3), emid(v2, v3)
            # children 5/7 vertex order flipped for positive Jacobians —
            # see the single-geometry tet branch
            add_kids(
                [[v0, m01, m02, m03], [m01, v1, m12, m13],
                 [m02, m12, v2, m23], [m03, m13, m23, v3],
                 [m01, m02, m03, m13], [m02, m01, m12, m13],
                 [m02, m03, m13, m23], [m12, m02, m13, m23]],
                g, a,
            )
        elif g == core.GEOM_HEX:
            lattice: dict = {}
            for li, xyz in enumerate(_HEX_CORNER):
                lattice[xyz] = v[li]
            for (p, q) in core.LOCAL_EDGES[g]:
                xyz = tuple(
                    (_HEX_CORNER[p][d] + _HEX_CORNER[q][d]) // 2
                    for d in range(3)
                )
                lattice[xyz] = emid(v[p], v[q])
            for loc in core.LOCAL_FACES[g]:
                xyz = tuple(
                    sum(_HEX_CORNER[i][d] for i in loc) // 4
                    for d in range(3)
                )
                lattice[xyz] = fctr([v[i] for i in loc])
            lattice[(1, 1, 1)] = hex_center[e]
            kids = [
                [lattice[(ox + dx, oy + dy, oz + dz)]
                 for (dx, dy, dz) in _HEX_CHILD]
                for (ox, oy, oz) in _HEX_CHILD
            ]
            add_kids(kids, g, a)
        elif g == core.GEOM_PRISM:
            v0, v1, v2, v3, v4, v5 = v
            b0, b1, b2 = emid(v0, v1), emid(v1, v2), emid(v2, v0)
            t0, t1, t2 = emid(v3, v4), emid(v4, v5), emid(v5, v3)
            w0, w1, w2 = emid(v0, v3), emid(v1, v4), emid(v2, v5)
            q01 = fctr([v0, v1, v4, v3])
            q12 = fctr([v1, v2, v5, v4])
            q20 = fctr([v2, v0, v3, v5])
            # 4-tri cross-section split (corner@v0, center, corner@v1,
            # corner@v2 — same as the 2D triangle) x height bisection
            lo_b = [[v0, b0, b2], [b0, b1, b2], [b0, v1, b1], [b2, b1, v2]]
            mid = [[w0, q01, q20], [q01, q12, q20],
                   [q01, w1, q12], [q20, q12, w2]]
            hi_t = [[v3, t0, t2], [t0, t1, t2], [t0, v4, t1], [t2, t1, v5]]
            add_kids(
                [bl + ml for bl, ml in zip(lo_b, mid)]
                + [ml + tl for ml, tl in zip(mid, hi_t)],
                g, a,
            )
        elif g == core.GEOM_PYRAMID:
            v0, v1, v2, v3, v4 = v
            b0, b1 = emid(v0, v1), emid(v1, v2)
            b2, b3 = emid(v2, v3), emid(v3, v0)
            l0, l1 = emid(v0, v4), emid(v1, v4)
            l2, l3 = emid(v2, v4), emid(v3, v4)
            c = fctr([v0, v1, v2, v3])
            add_kids(
                [[v0, b0, c, b3, l0], [v1, b1, c, b0, l1],
                 [v2, b2, c, b1, l2], [v3, b3, c, b2, l3],
                 [l0, l1, l2, l3, v4], [l0, l3, l2, l1, c]],
                g, a,
            )
            add_kids(
                [[b0, l0, l1, c], [b1, l1, l2, c],
                 [b2, l2, l3, c], [b3, l3, l0, c]],
                core.GEOM_TET, a,
            )
        else:
            raise ValueError(f"unsupported mixed member geometry: {g}")

    nv_max = max(len(k) for k in new_elems)
    new_elems = [k + [-1] * (nv_max - len(k)) for k in new_elems]

    new_bdry, new_battr = [], []
    for bv, attr in zip(mesh.bdry_verts, mesh.bdry_attr):
        b = [int(x) for x in bv if x >= 0]
        a = int(attr)
        if len(b) == 2:
            m = emid(b[0], b[1])
            new_bdry += [[b[0], m], [m, b[1]]]
            new_battr += [a, a]
        elif len(b) == 3:
            m01, m12, m20 = emid(b[0], b[1]), emid(b[1], b[2]), emid(b[2], b[0])
            new_bdry += [
                [b[0], m01, m20], [m01, b[1], m12],
                [m20, m12, b[2]], [m01, m12, m20],
            ]
            new_battr += [a] * 4
        else:
            m0, m1 = emid(b[0], b[1]), emid(b[1], b[2])
            m2, m3 = emid(b[2], b[3]), emid(b[3], b[0])
            c = fctr(b)
            new_bdry += [
                [b[0], m0, c, m3], [m0, b[1], m1, c],
                [c, m1, b[2], m2], [m3, c, m2, b[3]],
            ]
            new_battr += [a] * 4
    bw = max(len(b) for b in new_bdry) if new_bdry else 2
    new_bdry = [b + [-1] * (bw - len(b)) for b in new_bdry]

    return core.MeshData(
        dim=mesh.dim,
        geom=core.GEOM_MIXED,
        vertices=np.vstack([verts, np.asarray(new_coords)]),
        elem_verts=np.asarray(new_elems, dtype=np.int32),
        elem_attr=np.asarray(new_attrs, dtype=np.int32),
        bdry_verts=np.asarray(new_bdry, dtype=np.int32).reshape(
            len(new_bdry), -1
        ),
        bdry_attr=np.asarray(new_battr, dtype=np.int32),
        source=mesh.source,
        elem_geom=np.asarray(new_geoms, dtype=np.int32),
    )
