"""Mesh data model: flat numpy arrays, hex meshes only.

This package's own copy of ``pbte_tpu/mesh/core.py``, trimmed to what the
lattice path builds: a single-geometry hex mesh, its face tables and
outward normals, and periodic pairing of opposite box faces. The
conventions are pbte_tpu's (MFEM's): global faces numbered first-seen
while iterating elements in order, local faces in geometry order,
per-element face lists sorted by global face id, outward normals from the
face vertices and an element-centroid orientation test.
tests/test_torch_host_layers.py holds every array to pbte_tpu's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

GEOM_HEX = "hex"

# local faces of a hex, MFEM ordering (vertex order gives the outward
# normal by the right-hand rule)
LOCAL_FACES = {
    GEOM_HEX: (
        (3, 2, 1, 0),
        (0, 1, 5, 4),
        (1, 2, 6, 5),
        (2, 3, 7, 6),
        (3, 0, 4, 7),
        (4, 5, 6, 7),
    ),
}


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
    # periodic vertex maps (one bidirectional dict per axis) from
    # make_periodic(); consumed by connect()
    periodic_node_maps: list = None

    @property
    def num_elements(self) -> int:
        return self.elem_verts.shape[0]

    def scaled(self, factor: float) -> "MeshData":
        """Coordinate scaling."""
        return dataclasses.replace(self, vertices=self.vertices * float(factor))


@dataclasses.dataclass
class MeshTopology:
    """Derived connectivity consumed by assembly and sweeps (host, numpy)."""

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
    # periodic face pairing: paired faces appear as interior neighbors in
    # elem_neighbor with elem_face_periodic True; periodic_offset maps points
    # of this face onto the partner face
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
    def faces_per_elem(self) -> int:
        return self.elem_face.shape[1]


def _face_normal_from_verts(fv: np.ndarray, vertices: np.ndarray) -> np.ndarray:
    """Unit normal of 3D faces from their stored vertex order."""
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
    viewed as opaque fixed-width records for sort-based matching."""
    keys = np.sort(np.ascontiguousarray(verts, dtype=np.int64), axis=1)
    return keys.view([("", np.int64)] * keys.shape[1]).ravel()


def connect(mesh: MeshData) -> MeshTopology:
    """Build global and per-element face tables and outward normals by
    sort-based face matching (faces numbered first-seen over the
    (element, local face) scan)."""
    if mesh.geom != GEOM_HEX or mesh.dim != 3:
        raise ValueError(f"only 3D hex meshes are supported, got {mesh.geom}")
    local_faces = LOCAL_FACES[mesh.geom]
    nf = len(local_faces)
    ne = mesh.num_elements

    ev = mesh.elem_verts
    # (ne*nf, nv_f) face-vertex lists in (element, local-face) scan order
    all_fv = ev[:, np.asarray(local_faces)].reshape(ne * nf, -1)
    keys = _face_keys(all_fv)
    uniq, first_slot, inv, counts = np.unique(
        keys, return_index=True, return_inverse=True, return_counts=True
    )
    # renumber unique faces by first occurrence
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[np.argsort(first_slot, kind="stable")] = np.arange(len(uniq))
    fid_flat = rank[inv]  # (ne*nf,) global face id per scan slot
    nfaces = len(uniq)

    first_seen = np.empty(nfaces, dtype=np.int64)
    first_seen[rank] = first_slot
    face_verts = all_fv[first_seen].astype(np.int32)

    # face -> (first element, second element or -1)
    grouped = np.argsort(fid_flat, kind="stable")
    starts = np.searchsorted(fid_flat[grouped], np.arange(nfaces))
    cnt = np.empty(nfaces, dtype=np.int64)
    cnt[rank] = counts
    face_elems = np.full((nfaces, 2), -1, dtype=np.int32)
    face_elems[:, 0] = grouped[starts] // nf
    two = cnt >= 2
    face_elems[two, 1] = grouped[starts[two] + 1] // nf

    elem_face = fid_flat.reshape(ne, nf).astype(np.int32)

    # boundary attributes from the boundary-element list (later entries win)
    face_attr = np.zeros(nfaces, dtype=np.int32)
    if len(mesh.bdry_verts):
        bkeys = _face_keys(mesh.bdry_verts)
        pos = np.searchsorted(uniq, bkeys)
        pos_c = np.minimum(pos, len(uniq) - 1)
        hit = uniq[pos_c] == bkeys
        face_attr[rank[pos_c[hit]]] = mesh.bdry_attr[hit]

    # per-element lists sorted by global face id
    order = np.argsort(elem_face, axis=1)
    elem_face = np.take_along_axis(elem_face, order, axis=1)

    e1 = face_elems[elem_face, 0]
    e2 = face_elems[elem_face, 1]
    own = np.arange(ne, dtype=np.int32)[:, None]
    elem_neighbor = np.where(e1 == own, e2, e1).astype(np.int32)
    elem_face_attr = face_attr[elem_face]
    elem_face_attr = np.where(elem_neighbor < 0, elem_face_attr, 0)

    # outward unit normals via the centroid orientation test
    base_normals = _face_normal_from_verts(face_verts, mesh.vertices)
    centroids = mesh.vertices[ev].mean(axis=1)
    face_centroids = mesh.vertices[face_verts].mean(axis=1)
    n = base_normals[elem_face]
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
    if mesh.periodic_node_maps:
        _wire_periodic(topo, mesh.periodic_node_maps)
    return topo


def _wire_periodic(topo: MeshTopology, node_maps) -> None:
    """Pair periodic boundary faces through the vertex maps and patch the
    per-element tables so paired faces look like interior neighbors
    (elem_neighbor, elem_face_attr -> 0, elem_face_periodic, and
    periodic_offset = partner-face centroid - own-face centroid). The global
    face_attr / face_elems tables are left as they are."""
    vertices = topo.mesh.vertices

    # boundary faces: global id -> (element, local slot)
    bdry = np.argwhere(topo.elem_neighbor < 0)
    fid_of = {}
    for e, lf in bdry:
        fid_of[int(topo.elem_face[e, lf])] = (int(e), int(lf))

    key_of = {}
    for fid in fid_of:
        key_of[
            tuple(sorted(int(v) for v in topo.face_verts[fid] if v >= 0))
        ] = fid

    face_cent = _masked_vertex_mean(vertices, topo.face_verts)
    for fid, (e, lf) in fid_of.items():
        if topo.elem_face_periodic[e, lf]:
            continue
        verts = [int(v) for v in topo.face_verts[fid] if v >= 0]
        for nm in node_maps:
            try:
                mapped = tuple(sorted(nm[v] for v in verts))
            except KeyError:
                continue
            pid = key_of.get(mapped)
            if pid is None or pid == fid:
                continue
            e2, lf2 = fid_of[pid]
            topo.elem_neighbor[e, lf] = e2
            topo.elem_neighbor[e2, lf2] = e
            topo.elem_face_attr[e, lf] = 0
            topo.elem_face_attr[e2, lf2] = 0
            topo.elem_face_periodic[e, lf] = True
            topo.elem_face_periodic[e2, lf2] = True
            topo.periodic_offset[e, lf] = face_cent[pid] - face_cent[fid]
            topo.periodic_offset[e2, lf2] = face_cent[fid] - face_cent[pid]
            break


def make_periodic(mesh: MeshData, axes) -> MeshData:
    """Mark opposite boundaries of an axis-aligned box mesh periodic: one
    vertex map per axis in ``axes``, matching boundary vertices at
    coord == min with coord == max on the other coordinates, stored on the
    mesh for connect(). Returns the same mesh object."""
    v = mesh.vertices
    maps = list(mesh.periodic_node_maps or [])
    span = v.max(axis=0) - v.min(axis=0)
    tol = 1e-9 * max(float(span.max()), 1.0)
    for ax in np.atleast_1d(axes).astype(int):
        lo_v = np.flatnonzero(np.abs(v[:, ax] - v[:, ax].min()) < tol)
        hi_v = np.flatnonzero(np.abs(v[:, ax] - v[:, ax].max()) < tol)
        if len(lo_v) != len(hi_v):
            raise ValueError(
                f"axis {ax}: {len(lo_v)} low-side vs {len(hi_v)} high-side "
                "boundary vertices: the mesh is not translation-periodic"
            )
        other = [d for d in range(mesh.dim) if d != ax]
        lo_key = np.round(v[np.ix_(lo_v, other)] / tol).astype(np.int64)
        hi_key = np.round(v[np.ix_(hi_v, other)] / tol).astype(np.int64)
        lo_sorted = lo_v[np.lexsort(lo_key.T[::-1])]
        hi_sorted = hi_v[np.lexsort(hi_key.T[::-1])]
        if not np.array_equal(
            np.sort(lo_key, axis=0), np.sort(hi_key, axis=0)
        ):
            raise ValueError(f"axis {ax}: boundary vertex patterns differ")
        m = {}
        for a, b in zip(lo_sorted, hi_sorted):
            m[int(a)] = int(b)
            m[int(b)] = int(a)
        maps.append(m)
    mesh.periodic_node_maps = maps
    return mesh
