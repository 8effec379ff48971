"""Sweep planning: upwind DAG levelization and lattice detection.

This package's own copy of ``pbte_tpu/sweep/planner.py`` (less the sweep
log writer). For each direction, element e depends on its neighbour
across face f iff outward_normal(e, f) . s < 0; the dependency graph is
Kahn-layered into wavefront levels. Directions with the same upwind sign
pattern share one DAG and one level table (a group). As in pbte_tpu,
``compute_levels`` and ``greedy_orders`` run the native C++ kernels
(``pbte_tpu_torch.native``, built with g++ at first use) and fall back to
their numpy forms, which give the same integers, where the library does not
build (logged once).
"""

from __future__ import annotations

import dataclasses

import numpy as np


class SweepCycleError(RuntimeError):
    """The upwind precedence graph contains a cycle."""


def upwind_inflow(neighbor: np.ndarray, normals: np.ndarray,
                  directions: np.ndarray) -> np.ndarray:
    """inflow[k, e, f] = True iff element e's face f receives from an
    interior neighbor for direction k (outward normal . dir < 0, strict)."""
    dim = normals.shape[-1]
    dots = np.einsum("efd,kd->kef", normals, directions[:, :dim])
    return (dots < 0.0) & (neighbor >= 0)[None, :, :]


def compute_levels(neighbor: np.ndarray, normals: np.ndarray,
                   directions: np.ndarray) -> np.ndarray:
    """Wavefront level of each element per direction, (K, ne) int32:
    level[k, e] = 1 + max(level[k, upwind neighbors]) (0 when none).
    The native Kahn kernel where it builds, else the numpy fixpoint."""
    from pbte_tpu_torch import native as _native

    try:
        return _native.compute_levels(neighbor, normals, directions)
    except ValueError:
        raise SweepCycleError(
            "upwind sweep levelization found a cycle (native kernel)")
    except RuntimeError as e:
        _native.log_fallback("compute_levels", e)
    return _levels_numpy(neighbor, normals, directions)


def _levels_numpy(neighbor, normals, directions):
    K = directions.shape[0]
    ne, nf = neighbor.shape
    inflow = upwind_inflow(neighbor, normals, directions)  # (K, ne, nf)
    nbr_safe = np.where(neighbor >= 0, neighbor, 0)

    level = np.zeros((K, ne), dtype=np.int64)
    for _ in range(ne + 1):
        cand = np.where(inflow, level[:, nbr_safe] + 1, 0)
        new = cand.max(axis=-1)
        if np.array_equal(new, level):
            return level.astype(np.int32)
        level = new
    raise SweepCycleError(
        "upwind sweep levelization did not converge; the precedence graph "
        "contains a cycle (check mesh connectivity)"
    )


@dataclasses.dataclass
class SweepPlan:
    """Padded level tables, deduplicated by upwind sign pattern:
    levels[g, l, w] = element id (or -1) of slot w in level l of group g."""

    group_of_dir: np.ndarray  # (K,) int32
    dirs_of_group: list  # list of (Kg,) int arrays
    levels: np.ndarray  # (G, L_max, W_max) int32, -1 padded
    n_levels: np.ndarray  # (G,) int32
    level_of_elem: np.ndarray  # (G, ne) int32

    @property
    def num_groups(self) -> int:
        return self.levels.shape[0]

    @property
    def max_levels(self) -> int:
        return self.levels.shape[1]

    @property
    def max_width(self) -> int:
        return self.levels.shape[2]

    def padding_ratio(self) -> float:
        """Fraction of padded slots in the level tables (diagnostic)."""
        total = self.levels.size
        real = int((self.levels >= 0).sum())
        return 1.0 - real / total


def dir_slot_maps(dirs_pad: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of the padded (group, slot) -> global-direction table: per
    global direction its group and slot indices."""
    K = int(dirs_pad.max()) + 1
    g_of = np.zeros(K, dtype=np.int64)
    k_of = np.zeros(K, dtype=np.int64)
    gg, kk = np.nonzero(dirs_pad >= 0)
    g_of[dirs_pad[gg, kk]] = gg
    k_of[dirs_pad[gg, kk]] = kk
    return g_of, k_of


def build_plan(neighbor: np.ndarray, normals: np.ndarray,
               directions: np.ndarray) -> SweepPlan:
    K = directions.shape[0]
    inflow = upwind_inflow(neighbor, normals, directions)

    # group directions by identical dependency pattern
    flat = np.packbits(inflow.reshape(K, -1), axis=1)
    _, group_idx, inverse = np.unique(
        flat, axis=0, return_index=True, return_inverse=True
    )
    G = len(group_idx)
    levels_g = compute_levels(neighbor, normals, directions[group_idx])

    n_levels = levels_g.max(axis=1) + 1
    L_max = int(n_levels.max())
    W_max = 1
    for g in range(G):
        counts = np.bincount(levels_g[g], minlength=L_max)
        W_max = max(W_max, int(counts.max()))

    tables = np.full((G, L_max, W_max), -1, dtype=np.int32)
    for g in range(G):
        for l in range(int(n_levels[g])):
            elems = np.flatnonzero(levels_g[g] == l)
            tables[g, l, : len(elems)] = elems

    return SweepPlan(
        group_of_dir=inverse.astype(np.int32),
        dirs_of_group=[np.flatnonzero(inverse == g) for g in range(G)],
        levels=tables,
        n_levels=n_levels.astype(np.int32),
        level_of_elem=levels_g.astype(np.int32),
    )


@dataclasses.dataclass
class LatticeInfo:
    """Cartesian-lattice structure of a hex mesh: with wavefront level
    l = sum of sweep-transformed integer coordinates, the upwind neighbor
    of every element sits in the previous level's slab at a static per-axis
    offset."""

    dims: tuple  # (n_0, ..., n_{dim-1}) lattice extents
    coords: np.ndarray  # (ne, dim) integer coordinates
    face_minus: np.ndarray  # (dim,) local-face slot with normal -e_d
    face_plus: np.ndarray  # (dim,) slot with outward normal +e_d


def detect_lattice(neighbor: np.ndarray, normals: np.ndarray,
                   tol: float = 1e-9) -> LatticeInfo | None:
    """Whether (neighbor, normals) describe a Cartesian box lattice: 2 dim
    faces per element, every element's face-slot normals identical and
    axis-aligned, integer coordinates from following -e_d neighbors forming
    a bijective box whose +-e_d adjacency reproduces the neighbor table
    exactly. Returns None on any mismatch. Periodic faces must already be
    masked to -1 (ops.sweep_neighbor)."""
    ne, nf = neighbor.shape
    dim = normals.shape[-1]
    if nf != 2 * dim or ne < 1:
        return None
    n0 = normals[0]
    scale = max(float(np.abs(n0).max()), 1e-300)
    if float(np.abs(normals - n0).max()) > tol * scale:
        return None
    face_minus = np.full(dim, -1, dtype=np.int64)
    face_plus = np.full(dim, -1, dtype=np.int64)
    for f in range(nf):
        v = n0[f]
        ax = int(np.argmax(np.abs(v)))
        unit = np.zeros(dim)
        unit[ax] = np.sign(v[ax])
        if float(np.abs(v - unit).max()) > tol:
            return None
        tgt = face_plus if unit[ax] > 0 else face_minus
        if tgt[ax] >= 0:
            return None
        tgt[ax] = f
    if (face_minus < 0).any() or (face_plus < 0).any():
        return None
    # coordinate along axis d = chain distance from the -d boundary
    coords = np.zeros((ne, dim), dtype=np.int64)
    for d in range(dim):
        nbr = neighbor[:, face_minus[d]]
        has = nbr >= 0
        nbr_s = np.where(has, nbr, 0)
        c = np.zeros(ne, dtype=np.int64)
        for _ in range(ne + 1):
            new = np.where(has, c[nbr_s] + 1, 0)
            if np.array_equal(new, c):
                break
            c = new
        else:
            return None  # cyclic chain
        coords[:, d] = c
    dims = coords.max(axis=0) + 1
    if int(np.prod(dims)) != ne:
        return None
    strides = np.ones(dim, dtype=np.int64)
    for d in range(dim - 2, -1, -1):
        strides[d] = strides[d + 1] * dims[d + 1]
    lin = coords @ strides
    if len(np.unique(lin)) != ne:
        return None
    elem_at = np.empty(ne, dtype=np.int64)
    elem_at[lin] = np.arange(ne)
    for d in range(dim):
        for sign, faces in ((1, face_plus), (-1, face_minus)):
            c2 = coords.copy()
            c2[:, d] += sign
            inside = (c2[:, d] >= 0) & (c2[:, d] < dims[d])
            lin2 = np.clip(c2 @ strides, 0, ne - 1)
            expect = np.where(inside, elem_at[lin2], -1)
            if not np.array_equal(neighbor[:, faces[d]], expect):
                return None
    return LatticeInfo(
        dims=tuple(int(x) for x in dims),
        coords=coords,
        face_minus=face_minus,
        face_plus=face_plus,
    )


def greedy_orders(neighbor: np.ndarray, normals: np.ndarray,
                  directions: np.ndarray) -> list:
    """The reference's greedy sweep order per direction (the element order
    of ``validation.oracle``): repeated passes over elements in index
    order; an element is ready when every interior-face neighbour with
    outward_normal . dir < 0 is already processed; processing within a pass
    makes later elements ready in the same pass; a pass with no progress
    raises. The native kernel where it builds, as in pbte_tpu, else the
    numpy form."""
    from pbte_tpu_torch import native as _native

    try:
        out = _native.greedy_orders(neighbor, normals, directions)
        return [out[k] for k in range(directions.shape[0])]
    except ValueError:
        raise SweepCycleError("angular sweep ordering stalled (native kernel)")
    except RuntimeError as e:
        _native.log_fallback("greedy_orders", e)
    return _greedy_orders_numpy(neighbor, normals, directions)


def _greedy_orders_numpy(neighbor, normals, directions):
    """``greedy_orders``' numpy form: all directions' passes in lockstep,
    each element tested for every unfinished direction at once (the same
    orders as the native kernel)."""
    K = directions.shape[0]
    ne, nf = neighbor.shape
    dim = normals.shape[-1]
    # upwind[e, f, k]: face f of e receives from its neighbour for dir k
    dots = np.stack([normals @ directions[k, :dim] for k in range(K)], -1)
    upwind = (dots < 0.0) & (neighbor >= 0)[..., None]
    nbr_safe = np.where(neighbor >= 0, neighbor, 0)
    processed = np.zeros((ne, K), dtype=bool)
    orders = np.zeros((K, ne), dtype=np.int32)
    count = np.zeros(K, dtype=np.int64)
    active = count < ne
    while active.any():
        progressed = np.zeros(K, dtype=bool)
        for e in range(ne):
            ready = active & ~processed[e]
            if not ready.any():
                continue
            ready &= np.all(~upwind[e] | processed[nbr_safe[e]], axis=0)
            if ready.any():
                ks = np.flatnonzero(ready)
                orders[ks, count[ks]] = e
                count[ks] += 1
                processed[e, ks] = True
                progressed[ks] = True
        if (active & ~progressed).any():
            raise SweepCycleError(
                "angular sweep ordering stalled; check mesh connectivity"
            )
        active = count < ne
    return [orders[k] for k in range(K)]


def write_sweep_orders(quad, topo, path: str) -> None:
    """The reference's golden-format sweep order dump (``sweep_*.txt``)."""
    import os

    # periodic pairs are lagged couplings, not sweep dependencies: masked
    # exactly as the solver masks them (ElementOps.sweep_neighbor)
    nbr = np.where(topo.elem_face_periodic, -1, topo.elem_neighbor)
    orders = greedy_orders(nbr, topo.normals, quad.directions)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("Sweep order per direction\n")
        f.write(f"dimension: {topo.mesh.dim}\n")
        f.write(f"elements: {topo.mesh.num_elements}\n")
        f.write(f"directions: {quad.num_directions}\n\n")
        for k, order in enumerate(orders):
            f.write(
                f"dir {k} theta={quad.polar[k]:g} phi={quad.azimuth[k]:g} "
                f"w={quad.weights[k]:g} order:"
            )
            for e in order:
                f.write(f" {e}")
            f.write("\n")
