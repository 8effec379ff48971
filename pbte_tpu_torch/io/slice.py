"""Sampled temperature and heat-flux slices of DG fields.

This package's own copy of ``pbte_tpu/io/slice.py``: point location is a
batched inverse map and inside test on bounding-box candidates, the first
matching element in index order wins (the reference's loop order, which
matters for points on interior faces, where the DG field is
discontinuous). Writers: the golden 2D slice (``T_slice.txt``), the 3D
plane and line slices and the 2D T-and-Q slice of the legacy code. Fields
are numpy arrays.
"""

from __future__ import annotations

import numpy as np

from pbte_tpu_torch.fem import assembly as fem_assembly
from pbte_tpu_torch.fem import reference as fem_ref
from pbte_tpu_torch.mesh import core as mesh_core


def locate_points(mesh: mesh_core.MeshData, pts: np.ndarray, tol: float = 1e-10):
    """Find containing element per point (first match in element order).

    Returns (elem (n,), ref_coords (n, dim)); elem = -1 when not found.

    The (iterative, for hexes/quads) inverse map only runs on bounding-box
    candidates: the all-pairs version cost ne*npts Newton solves (100+ s for
    a 100x100 plane on a 512-hex mesh); the prefilter leaves ~a few
    candidates per point. Element order is still ascending, so the
    first-match semantics (= the reference's loop order, which matters on
    interior faces where the DG field is discontinuous) are preserved."""
    ne = mesh.num_elements
    n = len(pts)
    dim = mesh.dim
    ev = mesh.elem_verts
    vmask = ev >= 0  # mixed meshes right-pad with -1
    Xv = mesh.vertices[np.where(vmask, ev, 0)]  # (ne, nv, dim)
    lo = np.where(vmask[..., None], Xv, np.inf).min(axis=1)  # (ne, dim)
    hi = np.where(vmask[..., None], Xv, -np.inf).max(axis=1)
    # slack generously covers the ref-coord tolerance mapped to physical space
    slack = (hi - lo) * 1e-6 + tol * np.maximum((hi - lo).max(), 1.0)

    def geom_of(e):
        if mesh.geom == mesh_core.GEOM_MIXED:
            return mesh_core.MFEM_GEOM_CODES[int(mesh.elem_geom[e])]
        return mesh.geom

    elem = np.full(n, -1, dtype=np.int64)
    ref = np.zeros((n, dim))
    remaining = np.arange(n)
    for e in range(ne):
        if remaining.size == 0:
            break
        p = pts[remaining]
        cand = np.all(
            (p >= lo[e] - slack[e]) & (p <= hi[e] + slack[e]), axis=1
        )
        if not cand.any():
            continue
        idx = remaining[cand]
        g = geom_of(e)
        nv = mesh_core.GEOM_NV[g]
        r = fem_assembly.inverse_map(g, Xv[e, :nv][None], pts[idx][None])[0]
        if g in (mesh_core.GEOM_TRIANGLE, mesh_core.GEOM_TET):
            inside = np.all(r >= -tol, axis=-1) & (r.sum(-1) <= 1.0 + tol)
        elif g == mesh_core.GEOM_PRISM:
            inside = (
                np.all(r >= -tol, axis=-1)
                & (r[..., 0] + r[..., 1] <= 1.0 + tol)
                & (r[..., 2] <= 1.0 + tol)
            )
        elif g == mesh_core.GEOM_PYRAMID:
            inside = (
                np.all(r >= -tol, axis=-1)
                & (r[..., 0] <= 1.0 - r[..., 2] + tol)
                & (r[..., 1] <= 1.0 - r[..., 2] + tol)
                & (r[..., 2] <= 1.0 + tol)
            )
        else:
            inside = np.all((r >= -tol) & (r <= 1.0 + tol), axis=-1)
        hit = idx[inside]
        elem[hit] = e
        ref[hit] = r[inside]
        keep = np.ones(n, dtype=bool)
        keep[hit] = False
        remaining = remaining[keep[remaining]]
    return elem, ref


def sample_field(mesh: mesh_core.MeshData, order: int, coeffs: np.ndarray,
                 pts: np.ndarray, tol: float = 1e-10):
    """Evaluate a DG field (coeffs (ne, D)) at points; NaN where not found."""
    elem, ref = locate_points(mesh, pts, tol)
    esafe = np.where(elem >= 0, elem, 0)
    if mesh.geom == mesh_core.GEOM_MIXED:
        vals = np.zeros(len(pts))
        egeom = mesh.elem_geom
        for code in np.unique(egeom):
            g = mesh_core.MFEM_GEOM_CODES[int(code)]
            b = fem_ref.basis(g, order)
            mask = (elem >= 0) & (egeom[esafe] == code)
            if not mask.any():
                continue
            shape = b.eval(ref[mask])  # (nm, Dg)
            vals[mask] = np.einsum(
                "ni,ni->n", coeffs[elem[mask]][:, : b.ndof], shape
            )
    else:
        b = fem_ref.basis(mesh.geom, order)
        shape = b.eval(ref)  # (n, D)
        vals = np.einsum("ni,ni->n", coeffs[esafe], shape)
    return np.where(elem >= 0, vals, np.nan)


def write_2d_slice(mesh, order, Tc, path, nx=100, ny=100, clamp_tol=1e-12):
    """Golden-format 2D temperature slice
    (ref: src/MacroscopicQuantities.cpp:273-345)."""
    import os

    if mesh.dim != 2:
        raise ValueError("write_2d_slice supports 2D meshes only")
    mn = mesh.vertices.min(axis=0)
    mx = mesh.vertices.max(axis=0)
    xs = mn[0] + np.arange(nx) / (nx - 1) * (mx[0] - mn[0])
    ys = mn[1] + np.arange(ny) / (ny - 1) * (mx[1] - mn[1])
    # clamp slightly inside the domain (matching the reference's edge handling)
    xc = xs.copy()
    yc = ys.copy()
    xc[0] = mn[0] + clamp_tol
    xc[-1] = mx[0] - clamp_tol
    yc[0] = mn[1] + clamp_tol
    yc[-1] = mx[1] - clamp_tol
    X, Y = np.meshgrid(xc, yc, indexing="xy")
    pts = np.stack([X.reshape(-1), Y.reshape(-1)], axis=-1)
    T = sample_field(mesh, order, np.asarray(Tc), pts)

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"# nx {nx} ny {ny}\n")
        f.write("x y T\n")
        idx = 0
        for j in range(ny):
            for i in range(nx):
                f.write(f"{xs[i]:.16f} {ys[j]:.16f} {T[idx]:.16f}\n")
                idx += 1
    return T.reshape(ny, nx)


def sample_3d_plane(mesh, order, Tc, z, nx=100, ny=100, clamp_tol=1e-12,
                    Qc=None):
    """3D analog: sample a z=const plane (legacy output_3D_2Dslice_T_Q,
    ref: reference/PhononModel/NonGraySMRT.cpp:377-524).

    Returns T (ny, nx); with Qc (dim, ne, D) also returns Q (dim, ny, nx)."""
    if mesh.dim != 3:
        raise ValueError("sample_3d_plane requires a 3D mesh")
    mn = mesh.vertices.min(axis=0)
    mx = mesh.vertices.max(axis=0)
    xs = np.linspace(mn[0] + clamp_tol, mx[0] - clamp_tol, nx)
    ys = np.linspace(mn[1] + clamp_tol, mx[1] - clamp_tol, ny)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    pts = np.stack([X.reshape(-1), Y.reshape(-1), np.full(X.size, z)], axis=-1)
    T = sample_field(mesh, order, np.asarray(Tc), pts).reshape(ny, nx)
    if Qc is None:
        return T
    Qc = np.asarray(Qc)
    Q = np.stack(
        [sample_field(mesh, order, Qc[d], pts).reshape(ny, nx)
         for d in range(Qc.shape[0])]
    )
    return T, Q


def write_3d_line_slice(mesh, order, Tc, Qc, axis, crd1, crd2, path, n=100,
                        clamp_tol=1e-12):
    """Sampled T and Q along an axis-aligned line through a 3D domain
    (legacy NonGraySMRT::output_3D_1Dslice_T_Q,
    ref: reference/PhononModel/NonGraySMRT.cpp:257-375): n points spread over
    the domain extent of `axis` (0/1/2), the other two coordinates fixed at
    (crd1, crd2) filling the remaining axes in index order; endpoints clamped
    slightly inside the domain. Writes 'x y z T Qx Qy Qz' rows at fixed
    16-digit precision and returns (pts (n,3), T (n,), Q (3,n))."""
    import os

    if mesh.dim != 3:
        raise ValueError("write_3d_line_slice requires a 3D mesh")
    if axis not in (0, 1, 2):
        raise ValueError(f"invalid line axis {axis} (expected 0, 1 or 2)")
    mn = mesh.vertices.min(axis=0)
    mx = mesh.vertices.max(axis=0)
    ts = np.linspace(mn[axis] + clamp_tol, mx[axis] - clamp_tol, n)
    others = [d for d in range(3) if d != axis]
    pts = np.empty((n, 3))
    pts[:, axis] = ts
    pts[:, others[0]] = crd1
    pts[:, others[1]] = crd2
    T = sample_field(mesh, order, np.asarray(Tc), pts)
    Qc = np.asarray(Qc)
    Q = np.stack([sample_field(mesh, order, Qc[d], pts) for d in range(3)])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("x y z T Qx Qy Qz\n")
        for i in range(n):
            f.write(
                f"{pts[i, 0]:.16f} {pts[i, 1]:.16f} {pts[i, 2]:.16f} "
                f"{T[i]:.16f} {Q[0, i]:.16f} {Q[1, i]:.16f} {Q[2, i]:.16f}\n"
            )
    return pts, T, Q


def write_3d_slice(mesh, order, Tc, Qc, z, path, nx=100, ny=100):
    """Golden-style text output of a z-plane: x y T Qx Qy Qz per row
    (legacy NonGraySMRT::output_3D_2Dslice_T_Q format family)."""
    import os

    T, Q = sample_3d_plane(mesh, order, Tc, z, nx, ny, Qc=Qc)
    mn = mesh.vertices.min(axis=0)
    mx = mesh.vertices.max(axis=0)
    xs = np.linspace(mn[0], mx[0], nx)
    ys = np.linspace(mn[1], mx[1], ny)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"# nx {nx} ny {ny} z {z:.16g}\n")
        f.write("x y T Qx Qy Qz\n")
        for j in range(ny):
            for i in range(nx):
                f.write(
                    f"{xs[i]:.16f} {ys[j]:.16f} {T[j, i]:.16f} "
                    f"{Q[0, j, i]:.8e} {Q[1, j, i]:.8e} {Q[2, j, i]:.8e}\n"
                )
    return T, Q


def write_2d_slice_tq(mesh, order, Tc, Qc, path, nx=50, ny=50,
                      clamp_tol=1e-12):
    """2D-mesh T and heat-flux slice (legacy NonGraySMRT::output_2D_slice_T_Q,
    ref: reference/PhononModel/NonGraySMRT.cpp:137-253: 50x50 sampling of T
    and Q over the domain bounding box). Writes 'x y T Qx Qy' rows; returns
    (T (ny, nx), Q (2, ny, nx))."""
    import os

    if mesh.dim != 2:
        raise ValueError("write_2d_slice_tq supports 2D meshes only")
    mn = mesh.vertices.min(axis=0)
    mx = mesh.vertices.max(axis=0)
    xs = np.linspace(mn[0] + clamp_tol, mx[0] - clamp_tol, nx)
    ys = np.linspace(mn[1] + clamp_tol, mx[1] - clamp_tol, ny)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    pts = np.stack([X.reshape(-1), Y.reshape(-1)], axis=-1)
    T = sample_field(mesh, order, np.asarray(Tc), pts).reshape(ny, nx)
    Qc = np.asarray(Qc)
    Q = np.stack(
        [sample_field(mesh, order, Qc[d], pts).reshape(ny, nx)
         for d in range(2)]
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"# nx {nx} ny {ny}\n")
        f.write("x y T Qx Qy\n")
        for j in range(ny):
            for i in range(nx):
                f.write(
                    f"{xs[i]:.16f} {ys[j]:.16f} {T[j, i]:.16f} "
                    f"{Q[0, j, i]:.16f} {Q[1, j, i]:.16f}\n"
                )
    return T, Q
