"""Host tables of the shift-structured lattice ring (numpy).

This package's own copies of ``_lattice_ring_tables``
(``pbte_tpu/solver/source_iteration.py``) and ``mirror_direction_map``
(``pbte_tpu/validation/oracle.py``), the per-level hull windows of the
lattice slab (``ring_windows``), and the slab layout, active faces and
inflow tables that the lattice ring and the general one-hot ring share.
"""

from __future__ import annotations

import numpy as np


def lattice_ring_tables(lat, plan, dirs_np, major_axis=None):
    """Per-group lattice slab tables for the shift-structured ring sweep.

    With wavefront level l = sum of sweep-transformed integer coordinates
    (i'_d = coord_d on positive sweep axes, n_d - 1 - coord_d on negative)
    and slab slot w = i'_p1 * n_p2 + i'_p2 over the plane axes (all axes but
    the largest, or all but ``major_axis`` where it is given: the slab
    solver partitions along a non-periodic axis), the upwind neighbor along
    every axis sits in the previous level's slab at a static offset: 0 for
    the major axis, n_p2 and 1 for the plane axes.

    Returns (tables (G, L, W), axis_faces (G, dim), shifts (dim,)) or None:
    tables[g, l, w] = element id (or -1 padding); axis_faces[g, j] = the
    inflow face slot of axis j for group g; shifts[j] = slab offset of axis
    j's upwind neighbor within the previous level's slab.
    """
    dim = len(lat.dims)
    dims = np.asarray(lat.dims, dtype=np.int64)
    G = plan.num_groups
    ne = lat.coords.shape[0]
    L = int(dims.sum()) - dim + 1
    if L != plan.max_levels:
        return None
    a0 = int(np.argmax(dims)) if major_axis is None else int(major_axis)
    plane = [d for d in range(dim) if d != a0]
    shifts = np.zeros(dim, dtype=np.int64)
    if dim == 3:
        W = int(dims[plane[0]] * dims[plane[1]])
        shifts[plane[0]] = int(dims[plane[1]])
        shifts[plane[1]] = 1
    elif dim == 2:
        W = int(dims[plane[0]])
        shifts[plane[0]] = 1
    else:
        return None
    tables = np.full((G, L, W), -1, dtype=np.int32)
    axis_faces = np.zeros((G, dim), dtype=np.int64)
    for g in range(G):
        rep = dirs_np[plan.dirs_of_group[g][0]]
        if np.abs(rep[:dim]).min() < 1e-14:
            return None  # axis-grazing direction: sign pattern ill-defined
        sgn = np.where(rep[:dim] > 0, 1, -1)
        ip = np.where(sgn[None, :] > 0, lat.coords,
                      dims[None, :] - 1 - lat.coords)
        lev = ip.sum(axis=1)
        # the lattice leveling must be the canonical longest-path leveling
        if not np.array_equal(lev, plan.level_of_elem[g]):
            return None
        if dim == 3:
            w = ip[:, plane[0]] * dims[plane[1]] + ip[:, plane[1]]
        else:
            w = ip[:, plane[0]]
        tables[g, lev, w] = np.arange(ne, dtype=np.int32)
        axis_faces[g] = np.where(sgn > 0, lat.face_minus, lat.face_plus)
    return tables, axis_faces, shifts


def ring_windows(tables):
    """Per-level hull windows of the lattice slab: ``(L, 2)`` int32 rows
    ``[lo_l, hi_l)``, the first valid slot of level l and one past the last,
    over the union of the groups (``lo = hi = 0`` for a level without an
    element). The diagonal wavefront fills a narrow part of the plane near
    the sweep's entry and exit corners, so a sweep that runs each level on
    its window alone skips slots that are padding in every group.

    The hull is pbte_tpu's (``win_lo``/``win_hi`` in its constructor, there
    with an inclusive end). Its fitting of the hulls into a few segments of
    128-lane windows (``_fit_ring_window``, ``_pick_ring_windows``,
    ``PBTE_RING_MAX_SEGS``) serves the TPU's lane tiling and compile time
    and has no counterpart here: the windows stay per level, and the kernel
    rounds them out to its own tiles."""
    vm = (np.asarray(tables) >= 0).any(axis=0)  # (L, W)
    W = vm.shape[1]
    lo = np.argmax(vm, axis=1)
    hi = W - np.argmax(vm[:, ::-1], axis=1)
    none = ~vm.any(axis=1)
    lo[none] = hi[none] = 0
    return np.stack([lo, hi], axis=1).astype(np.int32)


def window_slots(win, tile=1):
    """Slots a sweep over the windows ``win`` touches when every window is
    rounded out to whole ``tile``-slot tiles."""
    win = np.asarray(win, dtype=np.int64)
    return int((-(-win[:, 1] // tile) * tile - win[:, 0] // tile * tile).sum())


def mirror_direction_map(quad, dim: int, axes=None,
                         tol: float = 1e-9) -> np.ndarray:
    """mirror_of[axis, k] = index of the quadrature direction equal to
    direction k with component ``axis`` negated (specular reflection off an
    axis-aligned face); -1 rows for axes not requested. Raises if the
    quadrature is not mirror-symmetric about a requested axis, or if a
    matched direction's weight differs."""
    dirs = quad.directions[:, :dim]
    w = quad.weights
    K = len(dirs)
    scale = max(float(np.abs(dirs).max()), 1e-300)
    out = np.full((dim, K), -1, dtype=np.int64)
    for ax in (range(dim) if axes is None
               else sorted(set(int(a) for a in axes))):
        m = dirs.copy()
        m[:, ax] = -m[:, ax]
        d2 = np.abs(m[:, None, :] - dirs[None, :, :]).max(axis=-1)
        j = np.argmin(d2, axis=1)
        if (d2[np.arange(K), j] > tol * scale).any():
            raise ValueError(
                f"angular quadrature is not mirror-symmetric about axis "
                f"{ax}; specular BCs need a symmetric direction set"
            )
        if (np.abs(w[j] - w) > tol * max(float(w.max()), 1e-300)).any():
            raise ValueError(
                f"mirrored directions about axis {ax} carry different "
                "quadrature weights"
            )
        out[ax] = j
    return out


def slab_positions(tables, sweep_nbr):
    """The padded (L, W) slab layout of a ring per group.

    ``tables`` (G, L, W) the element at each (level, slot) or -1 (the
    lattice's ``lattice_ring_tables``, or a general mesh's
    ``plan.levels``); ``sweep_nbr`` (ne, nf) the sweep's neighbour table.
    Returns ``perm`` (G, L W) the element at each slab position or -1,
    ``pos_valid``, ``perm_safe`` (-1 as 0), ``pos_of_elem`` (G, ne) and
    ``nbr_pos`` (G, nf, L W) the slab position of each face's neighbour or
    -1 (boundary, padding)."""
    G, L, W = tables.shape
    ne, nf = sweep_nbr.shape
    ne_pad = L * W
    perm = tables.reshape(G, ne_pad).astype(np.int64)
    pos_valid = perm >= 0
    perm_safe = np.where(pos_valid, perm, 0)
    pos_of_elem = np.zeros((G, ne), dtype=np.int64)
    for g in range(G):
        pos_of_elem[g, perm_safe[g][pos_valid[g]]] = np.flatnonzero(
            pos_valid[g]
        )
    nbr_g = sweep_nbr[perm_safe]  # (G, ne_pad, nf)
    nbr_pos = np.where(
        (nbr_g >= 0) & pos_valid[..., None],
        np.take_along_axis(
            pos_of_elem, np.clip(nbr_g, 0, None).reshape(G, -1), axis=1
        ).reshape(G, ne_pad, nf),
        -1,
    )
    nbr_pos = np.swapaxes(nbr_pos, 1, 2)  # (G, nf, ne_pad)
    return perm, pos_valid, perm_safe, pos_of_elem, nbr_pos


def slab_layout(tables, sweep_nbr, act_f, shifts):
    """``slab_positions`` of the lattice ring, checked against its static
    shifts: ``act_f`` (G, dim) and ``shifts`` (dim,) the inflow face and
    slab offset of each axis. Raises where a valid interior upwind read
    does not hit the previous level's slab at exactly its axis's static
    shift."""
    W = tables.shape[2]
    perm, pos_valid, perm_safe, pos_of_elem, nbr_pos = slab_positions(
        tables, sweep_nbr)
    for g in range(tables.shape[0]):
        for j, f in enumerate(act_f[g]):
            psel = np.flatnonzero(pos_valid[g] & (nbr_pos[g, f] >= 0))
            d = psel - nbr_pos[g, f, psel]
            if psel.size and not np.all(d == W + int(shifts[j])):
                raise RuntimeError(
                    f"lattice shift mismatch g={g} axis={j}: offsets "
                    f"{np.unique(d)} != {W + int(shifts[j])}"
                )
    return perm, pos_valid, perm_safe, pos_of_elem, nbr_pos


def active_faces(ops, perm_safe, dirs_slots, dir_valid):
    """The faces of each group that are ever inflow (pbte_tpu's general
    ring, ``source_iteration.py:1198-1219``): a face is active in group g
    when s . n < 0 for some valid slot direction s at some slab position
    (padded positions read element 0, as pbte_tpu's probe does). Returns
    ``act_f`` (G, nf_act), each group's active faces padded with a repeat
    of its first, and ``act_valid`` (G, nf_act), False on the padding."""
    G = perm_safe.shape[0]
    probe = np.einsum("gefd,gkd->gkfe", ops.normals[perm_safe], dirs_slots)
    probe = np.minimum(probe, 0.0) * dir_valid[:, :, None, None]
    active = [np.flatnonzero((probe[g] < 0).any(axis=(0, 2)))
              for g in range(G)]
    nf_act = max(max((len(a) for a in active), default=1), 1)
    act_f = np.zeros((G, nf_act), dtype=np.int64)
    act_valid = np.zeros((G, nf_act), dtype=bool)
    for g, a in enumerate(active):
        a = a if len(a) else np.array([0])
        act_f[g, :len(a)] = a
        act_valid[g, :len(a)] = True
    return act_f, act_valid


def group_permuted(a, perm_safe, pos_valid, np_dtype):
    """a (ne, ...) -> (G, ..., L W) in slab order, zero at padded slots."""
    G, ne_pad = perm_safe.shape
    t = a[perm_safe].astype(np_dtype, copy=False)
    t = np.where(
        pos_valid.reshape(G, ne_pad, *([1] * (t.ndim - 2))),
        t, np.zeros((), dtype=np_dtype),
    )
    return np.moveaxis(t, 1, -1)


def inflow_tables(ops, dirs_slots, perm_safe, nbr_pos, act_f, bc_T_g,
                  face_int_g):
    """Inflow coefficients and the constant wall source on the slab.

    ``dirs_slots`` (G, Km, dim) the direction of each slot; ``perm_safe``
    and ``nbr_pos`` from ``slab_layout``; ``act_f`` (G, nf_act) the inflow
    face of each axis; ``bc_T_g`` (G, nf, L W) and ``face_int_g`` (G, nf,
    D, L W) the wall temperatures and face integrals in slab order
    (``group_permuted``). Returns ``fdot`` (G, Km, nf, L W) = s . n,
    ``cin_bnd`` (G, Km, nf, L W) its inflow part on boundary faces and
    padding, ``cin_act`` (G, nf_act, Km, L W) on the axes' interior faces,
    and ``bsrc`` (G, Km, D, L W) = sum_f cin_bnd T_f int_F phi."""
    G = perm_safe.shape[0]
    fdot = np.einsum("gefd,gkd->gkfe", ops.normals[perm_safe], dirs_slots)
    cin = np.minimum(fdot, 0.0)
    isb = nbr_pos < 0  # (G, nf, ne_pad): boundary or padding
    cin_bnd = np.where(isb[:, None], cin, 0.0)
    cin_int = np.where(isb[:, None], 0.0, cin)
    cin_act = cin_int[np.arange(G)[:, None], :, act_f]
    bsrc = np.einsum("gkfE,gfE,gfiE->gkiE", cin_bnd, bc_T_g, face_int_g,
                     optimize=True)
    return fdot, cin_bnd, cin_act, bsrc
