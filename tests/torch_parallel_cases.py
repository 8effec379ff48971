"""Rank-side cases of the port's sharded solvers, for the parallel CPU
tests (``tests/test_torch_slab.py``, ``tests/test_torch_parallel.py``).

Imports torch and pbte_tpu_torch only: each function here runs in a
spawned rank (``pbte_tpu_torch.parallel.launch.run_ranks``) that builds its
problem from the port's own host layers, runs the port's solver on its
shard and returns numpy arrays (gathered, so every rank returns the global
fields; the tests read rank 0's).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pbte_tpu_torch import mesh as pmesh
from pbte_tpu_torch.angular import quadrature as ang
from pbte_tpu_torch.fem import assembly
from pbte_tpu_torch.material import nongray_smrt as mat


def build_problem(spec):
    """(topo, ops, quad, tables) of a problem spec: ``("hex", nx, ny, nz,
    order, polar, azimuth, nspec, periodic_axes[, edge])`` (edge: the
    cube's length in metres, a micron by default), ``("quad", nx, ny,
    order, azimuth, nspec[, edge])``, ``("tri", nx, ny, order, azimuth,
    nspec, face_mode[, edge])`` or ``("tet", n, order, polar, azimuth,
    nspec)``; meshes in microns. Also, with no topology (None):
    ``("tetbox", nx, ny, nz, order, polar, azimuth, nspec)``
    (``problem.tet_box``), ``("graded", n, order, polar, azimuth, nspec)``
    (``problem.graded_cube``) and ``("square", refine, azimuth, nspec[,
    azimuth_scheme])``, the default config's unit square refined
    ``refine`` times (consistent faces, p = 1)."""
    from pbte_tpu_torch import problem

    kind = spec[0]
    face_mode = "consistent"
    if kind == "tetbox":
        return (None,) + problem.tet_box(*spec[1:])
    if kind == "graded":
        return (None,) + problem.graded_cube(*spec[1:])
    if kind == "square":
        _, refine, az, nspec, *scheme = spec
        m = pmesh.uniform_refine(pmesh.load_mesh(
            str(problem.REPO_ROOT / "config" / "mesh" / "unit-square-iso.mesh")
        ).scaled(1e-6), refine)
        ops = assembly.assemble(pmesh.connect(m), order=1,
                                face_mode="consistent")
        quad = ang.build(ang.AngularOptions(
            dimension=2, azimuth_points=az,
            azimuth_scheme=scheme[0] if scheme else "gauss"))
        return (None, ops, quad,
                mat.build_tables(mat.SILICON, num_spectral=nspec))
    if kind == "hex":
        _, nx, ny, nz, order, polar, az, nspec, per, *edge = spec
        m = pmesh.make_cartesian_3d(nx, ny, nz, "hex").scaled(
            edge[0] if edge else 1e-6)
        if per:
            m = pmesh.make_periodic(m, list(per))
        dimension = 3
    elif kind == "tet":
        _, n, order, polar, az, nspec = spec
        m = pmesh.make_cartesian_3d(n, n, n, "tet").scaled(1e-6)
        dimension = 3
    elif kind == "quad":
        _, nx, ny, order, az, nspec, *edge = spec
        m = pmesh.make_cartesian_2d(nx, ny, "quad").scaled(
            edge[0] if edge else 1e-6)
        dimension, polar = 2, None
    else:
        _, nx, ny, order, az, nspec, face_mode, *edge = spec
        m = pmesh.make_cartesian_2d(nx, ny, pmesh.GEOM_TRIANGLE).scaled(
            edge[0] if edge else 1e-6)
        dimension, polar = 2, None
    topo = pmesh.connect(m)
    ops = assembly.assemble(topo, order=order, face_mode=face_mode)
    opts = (ang.AngularOptions(dimension=3, polar_points=polar,
                               azimuth_points=az)
            if dimension == 3 else
            ang.AngularOptions(dimension=2, azimuth_points=az))
    return (topo, ops, ang.build(opts),
            mat.build_tables(mat.SILICON, num_spectral=nspec))


def _grid(shape):
    from pbte_tpu_torch.parallel.comm import Grid

    return Grid(**shape)


def run_cases(rank, world, shape, cases, workdir=None):
    """Every case of ``cases`` (name -> dict) on one grid of ``shape``;
    returns name -> results dict."""
    torch.set_flush_denormal(True)
    grid = _grid(shape)
    out = {}
    for name, case in cases.items():
        fn = globals()[case["fn"]]
        t0 = time.perf_counter()
        out[name] = fn(grid, case, workdir)
        out[name]["seconds"] = time.perf_counter() - t0
    return out


def run_grid_cases(rank, world, cases, workdir=None):
    """Every case of ``cases`` on the grid its ``"grid"`` names (axis ->
    ranks, over all ``world`` ranks; each grid made once, in the order
    the cases name them, on every rank); returns name -> results dict."""
    torch.set_flush_denormal(True)
    grids, out = {}, {}
    for name, case in cases.items():
        key = tuple(case["grid"].items())
        if key not in grids:
            grids[key] = _grid(case["grid"])
        t0 = time.perf_counter()
        out[name] = globals()[case["fn"]](grids[key], case, workdir)
        out[name]["seconds"] = time.perf_counter() - t0
    return out


def _f64(case):
    return torch.float64 if case.get("dtype", "f64") == "f64" else \
        torch.float32


def slab_iterates(grid, case, workdir):
    """SlabLatticeSolver: ``iters`` plain steps (or a solve to ``tol``)."""
    from pbte_tpu_torch.parallel.slab import SlabLatticeSolver

    topo, ops, quad, tables = build_problem(case["problem"])
    s = SlabLatticeSolver(ops, quad, tables, case["bcs"], grid,
                          dtype=_f64(case), device="cpu",
                          **case.get("kw", {}))
    r = s.solve(tol=case.get("tol", 0), max_iter=case["iters"],
                verbose=False, check_every=case.get("check_every", 1),
                accelerate=case.get("accelerate"))
    res = dict(Tc=r.Tc_global(), residual=r.residual,
               iterations=r.iterations, a0=s.a0, P=s.P,
               shifts=s.shift_vals, part=s.element_partition,
               windowed=s.win is not None)
    if case.get("state"):
        u, Tc, Tv = s.gather_state(r.u, r.Tc, r.Tv)
        res.update(u=u, Tc_sh=Tc, Tv_sh=Tv)
    if case.get("views"):
        res["u_dirs"] = r.u_dirs()
        res["Qv"] = s.heat_flux(r.u)[1]
    return res


def spatial_iterates(grid, case, workdir):
    """SpatialShardedSolver: ``iters`` plain steps (or a solve to
    ``tol``), with its views where asked."""
    from pbte_tpu_torch.parallel.spatial import SpatialShardedSolver

    topo, ops, quad, tables = build_problem(case["problem"])
    s = SpatialShardedSolver(ops, quad, tables, case["bcs"], grid,
                             dtype=_f64(case), topo=topo, device="cpu",
                             **case.get("kw", {}))
    r = s.solve(tol=case.get("tol", 0), max_iter=case["iters"],
                verbose=False, check_every=case.get("check_every", 1),
                accelerate=case.get("accelerate"))
    res = dict(Tc=r.Tc_global(), residual=r.residual,
               iterations=r.iterations, part=s.element_partition,
               classes=s._spatial_cls is not None)
    if case.get("views"):
        res["u_dirs"] = r.u_dirs()
        res["Qc"] = s.heat_flux(r.u)[0]
        res["pieces"] = s.paraview_pieces(r.Tc, r.u)
        if workdir is not None:
            res["pvd"] = s.write_paraview(r.Tc, r.u, name="dd",
                                          root=str(workdir), cycle=3)
    return res


def dir_sharded(grid, case, workdir):
    """SourceIterationSolver with ``dir_sharding``: ``iters`` plain steps
    (or a solve to ``tol``)."""
    from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

    import os

    topo, ops, quad, tables = build_problem(case["problem"])
    env = case.get("env", {})
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        s = SourceIterationSolver(ops, quad, tables, case["bcs"],
                                  dtype=_f64(case), device="cpu",
                                  dir_sharding=grid, **case.get("kw", {}))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    r = s.solve(tol=case.get("tol", 0), max_iter=case["iters"],
                verbose=False, check_every=case.get("check_every", 1),
                accelerate=case.get("accelerate"))
    u0 = r.u[0] if isinstance(r.u, tuple) else r.u
    path = ("supercell" if s._super is not None else "scan"
            if s.sweep_mode == "scan" else "general" if s._general
            else "multi" if s._multi is not None else "k1")
    res = dict(Tc=r.Tc.numpy(), Tv=r.Tv.numpy(), residual=r.residual,
               iterations=r.iterations, BS=s.BS, Km=s.Km,
               shard=tuple(u0.shape), state_dtype=str(u0.dtype),
               mode=s.sweep_mode, path=path, k1=path == "k1",
               windowed=s.win is not None, policy=s.cache_policy)
    if case.get("views"):
        res["u_dirs"] = r.u_dirs()
        res["Qc"] = s.heat_flux(r.u)[0].numpy()
    if case.get("convert"):
        from pbte_tpu_torch import convert

        u, _, _ = convert.sharded_state_to_numpy(s, r.u, r.Tc, r.Tv)
        res["u_full"] = u
        back, _, _ = convert.sharded_state_from_numpy(s, u, r.Tc.numpy(),
                                                      r.Tv.numpy())
        pairs = zip(back, r.u) if isinstance(back, tuple) else [(back, r.u)]
        res["convert_roundtrip"] = all(torch.equal(a, b) for a, b in pairs)
    if case.get("ckpt"):
        from pbte_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint

        res["ckpt"] = str(workdir / f"dir_{case.get('ckpt_name', 'ring')}.npz")
        save_checkpoint(res["ckpt"], s, r.u, r.Tc, r.Tv, r.iterations,
                        r.residual)
        (u, _, _), _, _ = load_checkpoint(res["ckpt"], s)
        pairs = zip(u, r.u) if isinstance(u, tuple) else [(u, r.u)]
        res["reloaded"] = all(a.dtype == b.dtype and torch.equal(a, b)
                              for a, b in pairs)
    return res


def slab_checkpoint(grid, case, workdir):
    """SlabLatticeSolver checkpoints: 6 steps straight; 3, a checkpoint of
    this package, its load and 3 more; and 3 more from pbte_tpu's
    checkpoint at ``case["jax_ckpt"]`` (written at iteration 3)."""
    from pbte_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from pbte_tpu_torch.parallel.slab import SlabLatticeSolver

    topo, ops, quad, tables = build_problem(case["problem"])
    s = SlabLatticeSolver(ops, quad, tables, case["bcs"], grid,
                          dtype=torch.float64, device="cpu")
    full = s.solve(tol=0, max_iter=6, verbose=False)
    half = s.solve(tol=0, max_iter=3, verbose=False)
    ck = str(workdir / "port_slab.npz")
    save_checkpoint(ck, s, half.u, half.Tc, half.Tv, 3, half.residual)
    state, it, _ = load_checkpoint(ck, s)
    resumed = s.solve(tol=0, max_iter=3, verbose=False, state=state)
    jstate, jit, _ = load_checkpoint(case["jax_ckpt"], s)
    from_jax = s.solve(tol=0, max_iter=3, verbose=False, state=jstate)
    return dict(full=full.Tc_global(), resumed=resumed.Tc_global(),
                from_jax=from_jax.Tc_global(), it=it, jit=jit, path=ck)


def from_state(grid, case, workdir):
    """The slab or spatial solver stepped ``iters`` times from pbte_tpu's
    global state in ``case["state"]`` (an npz of u, Tc, Tv) through
    ``convert``; returns the gathered global state in pbte_tpu's layout."""
    from pbte_tpu_torch import convert
    from pbte_tpu_torch.parallel.slab import SlabLatticeSolver
    from pbte_tpu_torch.parallel.spatial import SpatialShardedSolver

    topo, ops, quad, tables = build_problem(case["problem"])
    if case["solver"] == "slab":
        s = SlabLatticeSolver(ops, quad, tables, case["bcs"], grid,
                              dtype=torch.float64, device="cpu",
                              **case.get("kw", {}))
    else:
        s = SpatialShardedSolver(ops, quad, tables, case["bcs"], grid,
                                 dtype=torch.float64, topo=topo,
                                 device="cpu", **case.get("kw", {}))
    z = np.load(case["state"])
    state = convert.sharded_state_from_numpy(s, z["u"], z["Tc"], z["Tv"])
    back = convert.sharded_state_to_numpy(s, *state)
    r = s.solve(tol=0, max_iter=case["iters"], verbose=False, state=state)
    u, Tc, Tv = convert.sharded_state_to_numpy(s, r.u, r.Tc, r.Tv)
    return dict(u=u, Tc_sh=Tc, Tv_sh=Tv, roundtrip=all(
        np.array_equal(a, b) for a, b in zip(back, (z["u"], z["Tc"],
                                                   z["Tv"]))))
