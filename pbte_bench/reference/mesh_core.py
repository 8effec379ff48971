"""Frozen copy of the solver port's host layer ``mesh/core.py`` for the plain
reference: the benchmark works the element operators, angles and
phonon tables out again with it, and never imports the program.

Mesh data model: flat numpy arrays instead of object graphs.

Like the port's copy of ``pbte_tpu/mesh/core.py``:

- `MeshData`    — raw geometry: vertices, element/boundary connectivity.
- `MeshTopology`— derived face tables: per-element neighbors, boundary
                  attributes and outward unit normals, shaped (ne, nf).

for triangle, quad, tet and hex meshes and mixed meshes (triangles and
quads in 2D; tets, hexes, prisms and pyramids in 3D), and periodic pairing.
The conventions are pbte_tpu's (MFEM's):
- triangles are rotated so their longest edge is (v0, v1), and tets are
  marked as MFEM marks them for refinement,
- global faces are numbered first-seen while iterating elements in order and
  local faces in geometry order,
- per-element face lists are sorted by global face id,
- outward normals are computed from face vertices + element-centroid
  orientation test.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# ---------------------------------------------------------------------------
# Reference geometry tables (local vertex numbering follows MFEM's
# mfem::Geometry constants so mesh files are interpreted identically).
# ---------------------------------------------------------------------------

GEOM_TRIANGLE = "triangle"
GEOM_QUAD = "quad"
GEOM_TET = "tet"
GEOM_HEX = "hex"
GEOM_PRISM = "prism"  # wedge: tri bottom/top, 3 quad sides
GEOM_PYRAMID = "pyramid"  # quad base, apex

# MFEM geometry type codes used in "MFEM mesh v1.0" files
# (mfem::Geometry::{SEGMENT..PYRAMID}).
MFEM_GEOM_CODES = {
    1: "segment", 2: GEOM_TRIANGLE, 3: GEOM_QUAD, 4: GEOM_TET, 5: GEOM_HEX,
    6: GEOM_PRISM, 7: GEOM_PYRAMID,
}
MFEM_CODE_OF_GEOM = {v: k for k, v in MFEM_GEOM_CODES.items()}

# Local faces (codim-1 entities), MFEM ordering (Geometry::Constants
# FaceVert tables; vertex order gives the OUTWARD normal by the right-hand
# rule — verified by the centroid orientation test in connect()).
LOCAL_FACES = {
    GEOM_TRIANGLE: ((0, 1), (1, 2), (2, 0)),
    GEOM_QUAD: ((0, 1), (1, 2), (2, 3), (3, 0)),
    GEOM_TET: ((1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1)),
    GEOM_HEX: (
        (3, 2, 1, 0),
        (0, 1, 5, 4),
        (1, 2, 6, 5),
        (2, 3, 7, 6),
        (3, 0, 4, 7),
        (4, 5, 6, 7),
    ),
    GEOM_PRISM: (
        (0, 2, 1),
        (3, 4, 5),
        (0, 1, 4, 3),
        (1, 2, 5, 4),
        (2, 0, 3, 5),
    ),
    GEOM_PYRAMID: (
        (3, 2, 1, 0),
        (0, 1, 4),
        (1, 2, 4),
        (2, 3, 4),
        (3, 0, 4),
    ),
}

# Local edges (for refinement), MFEM ordering.
LOCAL_EDGES = {
    GEOM_TRIANGLE: ((0, 1), (1, 2), (2, 0)),
    GEOM_QUAD: ((0, 1), (1, 2), (2, 3), (3, 0)),
    GEOM_TET: ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)),
    GEOM_HEX: (
        (0, 1), (1, 2), (3, 2), (0, 3),
        (4, 5), (5, 6), (7, 6), (4, 7),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ),
    GEOM_PRISM: (
        (0, 1), (1, 2), (2, 0),
        (3, 4), (4, 5), (5, 3),
        (0, 3), (1, 4), (2, 5),
    ),
    GEOM_PYRAMID: (
        (0, 1), (1, 2), (3, 2), (0, 3),
        (0, 4), (1, 4), (2, 4), (3, 4),
    ),
}

GEOM_DIM = {
    GEOM_TRIANGLE: 2, GEOM_QUAD: 2,
    GEOM_TET: 3, GEOM_HEX: 3, GEOM_PRISM: 3, GEOM_PYRAMID: 3,
}
GEOM_NV = {
    GEOM_TRIANGLE: 3, GEOM_QUAD: 4,
    GEOM_TET: 4, GEOM_HEX: 8, GEOM_PRISM: 6, GEOM_PYRAMID: 5,
}
GEOM_NF = {
    GEOM_TRIANGLE: 3, GEOM_QUAD: 4,
    GEOM_TET: 4, GEOM_HEX: 6, GEOM_PRISM: 5, GEOM_PYRAMID: 5,
}

# Mixed-geometry meshes: 2D triangle+quad, and 3D any mix of
# tet/hex/prism/pyramid (prisms and pyramids are exactly what makes a
# conforming tet/hex interface possible). `MeshData.geom == GEOM_MIXED`,
# per-element geometry in `elem_geom` (MFEM codes), `elem_verts`
# right-padded with -1 to the widest member geometry. Pure prism / pyramid
# meshes also use GEOM_MIXED (their per-element faces mix triangle and quad
# types, which is the mixed pipeline's whole job), so GEOM_PRISM /
# GEOM_PYRAMID never appear as MeshData.geom — only in per-entity tables.
GEOM_MIXED = "mixed"

# Geometries whose faces are all the same shape (eligible for the
# single-geometry fast paths); prism/pyramid always route through mixed.
_UNIFORM_FACE_GEOMS = (GEOM_TRIANGLE, GEOM_QUAD, GEOM_TET, GEOM_HEX)


@dataclasses.dataclass
class MeshData:
    """Raw mesh: geometry + element/boundary connectivity (host, numpy)."""

    dim: int
    geom: str
    vertices: np.ndarray  # (nv, dim) float64
    elem_verts: np.ndarray  # (ne, nv_e) int32
    elem_attr: np.ndarray  # (ne,) int32
    bdry_verts: np.ndarray  # (nb, nv_f) int32
    bdry_attr: np.ndarray  # (nb,) int32
    source: str = ""
    # periodic vertex maps (one bidirectional dict per transform/axis), from
    # gmsh $Periodic records or make_periodic(); consumed by connect().
    # Survives scaled()/replace().
    periodic_node_maps: list = None
    # geom == GEOM_MIXED only: per-element MFEM geometry code (ne,) int32;
    # elem_verts is right-padded with -1 to the widest member geometry
    elem_geom: np.ndarray = None

    @property
    def num_elements(self) -> int:
        return self.elem_verts.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    def scaled(self, factor: float) -> "MeshData":
        """Coordinate scaling (ref: src/SpatialMesh.cpp:24-64)."""
        return dataclasses.replace(self, vertices=self.vertices * float(factor))


@dataclasses.dataclass
class MeshTopology:
    """Derived connectivity consumed by assembly/sweeps (host, numpy)."""

    mesh: MeshData
    # global face tables
    face_verts: np.ndarray  # (nfaces, nv_f) int32, first-seen orientation
    face_elems: np.ndarray  # (nfaces, 2) int32, -1 where absent
    face_attr: np.ndarray  # (nfaces,) int32, 0 interior
    # per-element tables, faces sorted by global face id; shape (ne, nf)
    elem_face: np.ndarray  # global face id
    elem_neighbor: np.ndarray  # neighbor element, -1 boundary
    elem_face_attr: np.ndarray  # boundary attribute (0 interior)
    normals: np.ndarray  # (ne, nf, dim) outward unit normals
    centroids: np.ndarray  # (ne, dim) element vertex centroids
    # periodic face pairing (zeros/False when the mesh has none):
    # paired faces appear as interior neighbors in elem_neighbor with
    # elem_face_periodic True; periodic_offset is the translation that maps
    # points of this face onto the partner face (for neighbor-basis traces)
    elem_face_periodic: np.ndarray = None  # (ne, nf) bool
    periodic_offset: np.ndarray = None  # (ne, nf, dim) float64

    def __post_init__(self):
        if self.elem_face_periodic is None:
            self.elem_face_periodic = np.zeros(self.elem_face.shape, dtype=bool)
        if self.periodic_offset is None:
            self.periodic_offset = np.zeros(
                self.elem_face.shape + (self.mesh.dim,)
            )

    @property
    def has_periodic(self) -> bool:
        return bool(self.elem_face_periodic.any())

    @property
    def num_faces(self) -> int:
        return self.face_verts.shape[0]

    @property
    def faces_per_elem(self) -> int:
        return self.elem_face.shape[1]

    @property
    def is_boundary(self) -> np.ndarray:
        return self.elem_neighbor < 0


def _rotate_triangles(elem_verts: np.ndarray, vertices: np.ndarray) -> np.ndarray:
    """Rotate each triangle so its longest edge is (v0, v1).

    Mirrors MFEM's MarkTriMeshForRefinement (strict > comparisons; first
    occurrence wins on ties), which the reference runs on load — visible in
    output/log/mesh_unit-square-iso_p1_dim2.txt where element 0 appears as
    (v2, v0, v1).
    """
    v = vertices[elem_verts]  # (ne, 3, dim)
    l0 = np.linalg.norm(v[:, 1] - v[:, 0], axis=-1)
    l1 = np.linalg.norm(v[:, 2] - v[:, 1], axis=-1)
    l2 = np.linalg.norm(v[:, 0] - v[:, 2], axis=-1)
    j = np.zeros(len(elem_verts), dtype=np.int64)
    best = l0.copy()
    upd = l1 > best
    j[upd] = 1
    best[upd] = l1[upd]
    upd = l2 > best
    j[upd] = 2
    out = elem_verts.copy()
    for shift in (1, 2):
        m = j == shift
        out[m] = np.roll(elem_verts[m], -shift, axis=1)
    return out


_TET_EDGE_TO_FRONT = {
    # orientation-preserving (even) permutations bringing edge -> (0, 1)
    (0, 1): (0, 1, 2, 3),
    (0, 2): (2, 0, 1, 3),
    (0, 3): (0, 3, 1, 2),
    (1, 2): (1, 2, 0, 3),
    (1, 3): (1, 3, 2, 0),
    (2, 3): (2, 3, 0, 1),
}


def _mark_tets(elem_verts: np.ndarray, vertices: np.ndarray) -> np.ndarray:
    """Rotate each tet so its longest edge is (v0, v1), preserving orientation.

    Functional analog of MFEM's MarkTetMeshForRefinement. (MFEM additionally
    ranks ties via a global edge-length sort; with no committed 3D coefficient
    goldens, first-occurrence tie-breaking is used here. Physics outputs are
    independent of this ordering.)
    """
    edges = LOCAL_EDGES[GEOM_TET]
    v = vertices[elem_verts]  # (ne, 4, dim)
    lengths = np.stack(
        [np.linalg.norm(v[:, b] - v[:, a], axis=-1) for (a, b) in edges], axis=-1
    )
    longest = np.argmax(lengths, axis=-1)
    out = np.empty_like(elem_verts)
    for ei, edge in enumerate(edges):
        m = longest == ei
        if np.any(m):
            perm = _TET_EDGE_TO_FRONT[edge]
            out[m] = elem_verts[np.ix_(m.nonzero()[0], list(perm))]
    return out


def finalize(mesh: MeshData) -> MeshData:
    """Apply MFEM's on-load element marking (triangle rotation, tet marking)."""
    if mesh.geom == GEOM_TRIANGLE:
        ev = _rotate_triangles(mesh.elem_verts, mesh.vertices)
        return dataclasses.replace(mesh, elem_verts=ev)
    if mesh.geom == GEOM_TET:
        ev = _mark_tets(mesh.elem_verts, mesh.vertices)
        return dataclasses.replace(mesh, elem_verts=ev)
    if mesh.geom == GEOM_MIXED:
        tri = mesh.elem_geom == MFEM_CODE_OF_GEOM[GEOM_TRIANGLE]
        tet = mesh.elem_geom == MFEM_CODE_OF_GEOM[GEOM_TET]
        if tri.any() or tet.any():
            ev = mesh.elem_verts.copy()
            if tri.any():
                ev[tri, :3] = _rotate_triangles(ev[tri, :3], mesh.vertices)
            if tet.any():
                ev[tet, :4] = _mark_tets(ev[tet, :4], mesh.vertices)
            return dataclasses.replace(mesh, elem_verts=ev)
    return mesh


def _face_normal_from_verts(fv: np.ndarray, vertices: np.ndarray, dim: int) -> np.ndarray:
    """Unit normal of faces from their stored vertex order
    (ref: src/Utils.cpp:262-304). fv: (nfaces, nv_f)."""
    if dim == 2:
        d = vertices[fv[:, 1]] - vertices[fv[:, 0]]
        n = np.stack([d[:, 1], -d[:, 0]], axis=-1)
    else:
        e1 = vertices[fv[:, 1]] - vertices[fv[:, 0]]
        e2 = vertices[fv[:, 2]] - vertices[fv[:, 0]]
        n = np.cross(e1, e2)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.where(norm > 0, norm, 1.0)


def _masked_vertex_mean(vertices: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Mean of vertices[idx] over the last index axis, ignoring -1 pads."""
    ok = idx >= 0
    pts = vertices[np.where(ok, idx, 0)] * ok[..., None]
    return pts.sum(axis=-2) / np.maximum(ok.sum(axis=-1), 1)[..., None]


def _face_keys(verts: np.ndarray) -> np.ndarray:
    """Orientation-independent face keys: vertex ids sorted within each row,
    viewed as opaque fixed-width byte records for O(n log n) matching."""
    keys = np.sort(np.ascontiguousarray(verts, dtype=np.int64), axis=1)
    return keys.view([("", np.int64)] * keys.shape[1]).ravel()


def connect(mesh: MeshData) -> MeshTopology:
    """Build global/per-element face tables and outward normals.

    Sort-based (vectorized) face matching; semantics identical to the naive
    per-element dict scan the reference implies (faces numbered FIRST-SEEN
    while iterating elements in order, local faces in geometry order —
    MFEM GetElementToFaceTable): ~O(ne log ne) host setup instead of a
    Python loop, ~100x faster at ne=1e5 (see tests/test_mesh.py cross-check
    against the retained dict implementation)."""
    if mesh.geom == GEOM_MIXED:
        raise ValueError("the reference connects single-geometry meshes only")
    geom = mesh.geom
    local_faces = LOCAL_FACES[geom]
    nf = len(local_faces)
    ne = mesh.num_elements
    dim = mesh.dim

    ev = mesh.elem_verts
    # (ne*nf, nv_f) face-vertex lists in (element, local-face) scan order
    all_fv = ev[:, np.asarray(local_faces)].reshape(ne * nf, -1)
    keys = _face_keys(all_fv)
    uniq, first_slot, inv, counts = np.unique(
        keys, return_index=True, return_inverse=True, return_counts=True
    )
    # renumber unique faces by first occurrence (first-seen numbering)
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[np.argsort(first_slot, kind="stable")] = np.arange(len(uniq))
    fid_flat = rank[inv]  # (ne*nf,) global face id per scan slot
    nfaces = len(uniq)

    first_seen = np.empty(nfaces, dtype=np.int64)
    first_seen[rank] = first_slot  # scan slot that introduced each face
    face_verts = all_fv[first_seen].astype(np.int32)  # first-seen orientation

    # face -> (first element, second element or -1); each key occurs 1-2x
    grouped = np.argsort(fid_flat, kind="stable")  # slots grouped by fid
    starts = np.searchsorted(fid_flat[grouped], np.arange(nfaces))
    cnt = np.empty(nfaces, dtype=np.int64)
    cnt[rank] = counts  # occurrence counts in first-seen numbering
    face_elems = np.full((nfaces, 2), -1, dtype=np.int32)
    face_elems[:, 0] = grouped[starts] // nf
    two = cnt >= 2
    face_elems[two, 1] = grouped[starts[two] + 1] // nf

    elem_face = fid_flat.reshape(ne, nf).astype(np.int32)

    # Boundary attributes from boundary-element list (later entries win,
    # matching the sequential scan).
    face_attr = np.zeros(nfaces, dtype=np.int32)
    if len(mesh.bdry_verts):
        bkeys = _face_keys(mesh.bdry_verts)
        pos = np.searchsorted(uniq, bkeys)
        pos_c = np.minimum(pos, len(uniq) - 1)
        hit = uniq[pos_c] == bkeys
        face_attr[rank[pos_c[hit]]] = mesh.bdry_attr[hit]

    # Per-element lists sorted by global face id (assembly/dump order).
    order = np.argsort(elem_face, axis=1)
    elem_face = np.take_along_axis(elem_face, order, axis=1)

    e1 = face_elems[elem_face, 0]
    e2 = face_elems[elem_face, 1]
    own = np.arange(ne, dtype=np.int32)[:, None]
    elem_neighbor = np.where(e1 == own, e2, e1).astype(np.int32)
    elem_face_attr = face_attr[elem_face]
    elem_face_attr = np.where(elem_neighbor < 0, elem_face_attr, 0)

    # Outward unit normals via centroid orientation test
    # (ref: src/Utils.cpp:306-354).
    base_normals = _face_normal_from_verts(face_verts, mesh.vertices, dim)  # (nfaces, dim)
    centroids = mesh.vertices[ev].mean(axis=1)  # (ne, dim)
    face_centroids = mesh.vertices[face_verts].mean(axis=1)  # (nfaces, dim)
    n = base_normals[elem_face]  # (ne, nf, dim)
    to_face = face_centroids[elem_face] - centroids[:, None, :]
    flip = np.sum(n * to_face, axis=-1) < 0.0
    normals = np.where(flip[..., None], -n, n)

    topo = MeshTopology(
        mesh=mesh,
        face_verts=face_verts,
        face_elems=face_elems,
        face_attr=face_attr,
        elem_face=elem_face,
        elem_neighbor=elem_neighbor,
        elem_face_attr=elem_face_attr,
        normals=normals,
        centroids=centroids,
    )
    if mesh.periodic_node_maps or getattr(mesh, "periodic_node_pairs", None):
        raise ValueError("the reference has no periodic faces")
    return topo
