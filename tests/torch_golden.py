"""Golden Tc of pbte_tpu's lattice-ring paths, for the CUDA port.

``build()`` runs pbte_tpu's SourceIterationSolver with ``use_pallas="on"``
(the Pallas kernel under the Pallas interpreter on the CPU, f32, exact
operands) on a hex 8^3, p=2, 8-direction, nspec=2 problem with the flagship
walls, 5 outer steps from the zero state.

``build_closures()`` runs its XLA ring (``sweep_mode="ring"``, f32 with the
bf16 operand staging off, ``PBTE_RING_BF16=0``) on a hex 8^3, p=1,
8-direction, nspec=2 problem with all three lagged closures: x faces
periodic, z faces isothermal, one y face diffuse and the other specular;
5 outer steps from the zero state.

``build_accel()`` runs its float64 XLA ring (``sweep_mode="ring"``) on a
hex 8^3, p=1, 8-direction, nspec=2 problem with the flagship walls through
the BiCGStab outer solve, ``solve(accelerate="bicgstab", tol=0,
max_iter=18)``, and keeps Tc, Tv, the Tv residual and the step count
(a cap of 18 step applications: from ~19 on, at a plateau of the
recurrence, the rounding of the summation order grows ~1e3-fold every two
steps, to 1e-7 of Tc at a cap of 24, measured between pbte_tpu and the port
on the CPU).

``build_scan()`` runs its scan path (``sweep_mode="scan"``, f32, the
class-batched ``full`` factor cache) on a 3^3 6-tet cube at p=2 with
consistent faces, 8 directions and nspec=2: attribute 6 hot, 1, 3 and 5
cold, the y faces (2 and 4) diffuse; 5 outer steps from the zero state.

``build_super()`` runs its supercell ring (``supercell="on"``, the XLA
two-matmul body, f32 with the bf16 operand staging off) on a 3x2x2 6-tet
box at p=2 with consistent faces, 8 directions and nspec=2, the flagship
walls; 5 outer steps from the zero state.

``build_p3()`` runs its f32 XLA lattice ring (``sweep_mode="ring"``, bf16
operand staging off) on a hex 17x17x4 lattice at p=3 (D = 64, a slab of
W = 68 slots) of millimetre edge, 8 directions and nspec=2, the flagship
walls; 5 outer steps from the zero state. On a GPU the port sweeps it with
K1's cluster kernel. (At a micron edge the f32 state v = M^T u of this
lattice reaches the f32 subnormals, which XLA's CPU backend flushes: there
pbte_tpu's f32 lands 1.6e-5 of max from its float64 answer, and the
card, which keeps them, 4.4e-5 from that golden.)

``build_graded()`` runs the same ring on a graded hex 8^3 at p=2 (x spacing
alternating 1 : 2, two geometry classes: its multi-class branch with
per-element couplings), 8 directions, nspec=2, the flagship walls; 5 outer
steps from the zero state.

All seven build their problems from pbte_tpu's own host layers
(``jax_unit_cube``, ``jax_graded_cube``, ``jax_tet_cube``, ``jax_tet_box``),
the same problems ``pbte_tpu_torch.problem.unit_cube``, ``graded_cube``,
``tet_cube`` and ``tet_box`` build from the port's copy of them.

``python tests/torch_golden.py [file name ...]`` writes them (or the
named ones) to ``tests/data/``;
tests/test_torch_solver.py and tests/test_torch_accel.py regenerate them
and check them against the committed files, and chip_smoke.py holds
pbte_tpu_torch's CUDA kernel path on a GPU to them.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

DATA = pathlib.Path(__file__).resolve().parent / "data"
PATH = DATA / "torch_port_golden.npz"
PARAMS = dict(nx=8, ny=8, nz=8, order=2, polar=2, azimuth=4, nspec=2)
STEPS = 5
# the flagship's isothermal walls (pbte_tpu_torch.problem.WALL_BCS)
WALL_BCS = {1: -0.5, 2: -0.5, 3: -0.5, 4: -0.5, 5: -0.5, 6: 0.5}

PATH_CLOSURES = DATA / "torch_port_golden_closures.npz"
CLOSURE_PARAMS = dict(nx=8, ny=8, nz=8, order=1, polar=2, azimuth=4, nspec=2)
CLOSURE_PERIODIC = (0,)
CLOSURE_BCS = {1: -0.5, 6: 0.5}
CLOSURE_DIFFUSE = (2,)
CLOSURE_SPECULAR = (4,)


PATH_SCAN = DATA / "torch_port_golden_scan.npz"
SCAN_PARAMS = dict(n=3, order=2, polar=2, azimuth=4, nspec=2)
SCAN_BCS = {1: -0.5, 3: -0.5, 5: -0.5, 6: 0.5}
SCAN_DIFFUSE = (2, 4)

PATH_SUPER = DATA / "torch_port_golden_super.npz"
SUPER_PARAMS = dict(nx=3, ny=2, nz=2, order=2, polar=2, azimuth=4, nspec=2)

PATH_P3 = DATA / "torch_port_golden_p3.npz"
P3_PARAMS = dict(nx=17, ny=17, nz=4, order=3, polar=2, azimuth=4, nspec=2)
P3_LENGTH = 1.0e-3  # metres: the lattice's edge
PATH_GRADED = DATA / "torch_port_golden_graded.npz"
GRADED_PARAMS = dict(n=8, order=2, polar=2, azimuth=4, nspec=2)

PATH_ACCEL = DATA / "torch_port_golden_accel.npz"
ACCEL_PARAMS = dict(nx=8, ny=8, nz=8, order=1, polar=2, azimuth=4, nspec=2)
ACCEL_MAX_ITER = 18


def jax_unit_cube(nx, ny, nz, order, polar, azimuth, nspec, periodic=(),
                  length=1.0e-6):
    """(ops, quad, tables) of pbte_tpu_torch.problem.unit_cube, built from
    pbte_tpu's mesh, assembly, quadrature and material modules."""
    from pbte_tpu import mesh as pmesh
    from pbte_tpu.angular import quadrature as ang
    from pbte_tpu.fem import assembly
    from pbte_tpu.material import nongray_smrt as mat

    m = pmesh.make_cartesian_3d(nx, ny, nz, "hex").scaled(length)
    if len(periodic):
        m = pmesh.make_periodic(m, [int(a) for a in periodic])
    ops = assembly.assemble(pmesh.connect(m), order=order,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(
        dimension=3, polar_points=polar, azimuth_points=azimuth))
    tables = mat.build_tables(mat.SILICON, num_spectral=nspec)
    return ops, quad, tables


def jax_graded_cube(n, order, polar, azimuth, nspec):
    """(ops, quad, tables) of pbte_tpu_torch.problem.graded_cube from
    pbte_tpu's host layers: the n^3 hex unit cube with its x spacing
    alternating 1 : 2, in microns, consistent faces, silicon."""
    import dataclasses

    from pbte_tpu import mesh as pmesh
    from pbte_tpu.angular import quadrature as ang
    from pbte_tpu.fem import assembly
    from pbte_tpu.material import nongray_smrt as mat

    md = pmesh.make_cartesian_3d(n, n, n, "hex")
    xs = np.concatenate([[0.0], np.cumsum(np.tile([1.0, 2.0], n)[:n])])
    v = md.vertices.copy()
    v[:, 0] = xs[np.rint(v[:, 0] * n).astype(int)] / xs[-1]
    md = dataclasses.replace(md, vertices=v).scaled(1.0e-6)
    ops = assembly.assemble(pmesh.connect(md), order=order,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(
        dimension=3, polar_points=polar, azimuth_points=azimuth))
    tables = mat.build_tables(mat.SILICON, num_spectral=nspec)
    return ops, quad, tables


def jax_unit_square(nx, ny, order, azimuth, nspec, length=1.0e-6):
    """(ops, quad, tables) of pbte_tpu_torch.problem.unit_square from
    pbte_tpu's host layers."""
    from pbte_tpu import mesh as pmesh
    from pbte_tpu.angular import quadrature as ang
    from pbte_tpu.fem import assembly
    from pbte_tpu.material import nongray_smrt as mat

    m = pmesh.make_cartesian_2d(nx, ny, "quad").scaled(length)
    ops = assembly.assemble(pmesh.connect(m), order=order,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=azimuth))
    tables = mat.build_tables(mat.SILICON, num_spectral=nspec)
    return ops, quad, tables


def jax_tet_cube(n, order, polar, azimuth, nspec):
    """(ops, quad, tables) of pbte_tpu_torch.problem.tet_cube from
    pbte_tpu's host layers: the n^3 6-tet unit cube in microns, consistent
    faces, silicon."""
    return jax_tet_box(n, n, n, order, polar, azimuth, nspec)


def jax_tet_box(nx, ny, nz, order, polar, azimuth, nspec):
    """(ops, quad, tables) of pbte_tpu_torch.problem.tet_box from
    pbte_tpu's host layers: the nx x ny x nz 6-tet box in microns,
    consistent faces, silicon."""
    from pbte_tpu import mesh as pmesh
    from pbte_tpu.angular import quadrature as ang
    from pbte_tpu.fem import assembly
    from pbte_tpu.material import nongray_smrt as mat

    m = pmesh.make_cartesian_3d(nx, ny, nz, "tet").scaled(1.0e-6)
    ops = assembly.assemble(pmesh.connect(m), order=order,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(
        dimension=3, polar_points=polar, azimuth_points=azimuth))
    tables = mat.build_tables(mat.SILICON, num_spectral=nspec)
    return ops, quad, tables


def scan_solver_args(d, tet_cube) -> tuple:
    """(problem, bc_temps, solver keywords) of the scan golden's fields,
    the problem built by ``tet_cube`` (jax_tet_cube or the port's)."""
    prob = tet_cube(**{k: int(d[k]) for k in SCAN_PARAMS})
    bcs = dict(zip(np.asarray(d["bc_attrs"]).tolist(),
                   np.asarray(d["bc_temps"]).tolist()))
    return prob, bcs, dict(diffuse_bcs=np.asarray(d["diffuse"]).tolist(),
                           sweep_mode="scan", cache_policy="full")


def _steps(s):
    u, Tc, Tv = s.initial_state()
    tcs, res = [], []
    for _ in range(STEPS):
        u, Tc, Tv, r = s.step(u, Tc, Tv)
        tcs.append(np.asarray(Tc))
        res.append(float(r))
    return np.stack(tcs), np.array(res)


def build() -> dict:
    import jax.numpy as jnp

    from pbte_tpu.solver.source_iteration import SourceIterationSolver

    s = SourceIterationSolver(*jax_unit_cube(**PARAMS), WALL_BCS,
                              dtype=jnp.float32, use_pallas="on")
    if not (s._use_pallas_ring and s._pallas_interpret):
        raise RuntimeError("the golden must come from the Pallas kernel path")
    tcs, res = _steps(s)
    attrs = sorted(WALL_BCS)
    return dict(
        **{k: np.int64(v) for k, v in PARAMS.items()},
        steps=np.int64(STEPS),
        bc_attrs=np.array(attrs, dtype=np.int64),
        bc_temps=np.array([WALL_BCS[a] for a in attrs]),
        Tc=tcs,  # (steps, ne, D) f32, Tc after each step
        residual=res,
    )


def closure_solver_args(d, unit_cube) -> tuple:
    """(problem, bc_temps, solver keywords) of a closure golden's fields,
    the problem built by ``unit_cube`` (jax_unit_cube for pbte_tpu, the
    port's own for pbte_tpu_torch)."""
    params = {k: int(d[k]) for k in CLOSURE_PARAMS}
    prob = unit_cube(**params, periodic=tuple(int(a) for a in d["periodic"]))
    bcs = dict(zip(np.asarray(d["bc_attrs"]).tolist(),
                   np.asarray(d["bc_temps"]).tolist()))
    kw = dict(diffuse_bcs=np.asarray(d["diffuse"]).tolist(),
              specular_bcs=np.asarray(d["specular"]).tolist())
    return prob, bcs, kw


def build_closures() -> dict:
    import jax.numpy as jnp

    from pbte_tpu.solver.source_iteration import SourceIterationSolver

    attrs = sorted(CLOSURE_BCS)
    fields = dict(
        **{k: np.int64(v) for k, v in CLOSURE_PARAMS.items()},
        steps=np.int64(STEPS),
        periodic=np.array(CLOSURE_PERIODIC, dtype=np.int64),
        bc_attrs=np.array(attrs, dtype=np.int64),
        bc_temps=np.array([CLOSURE_BCS[a] for a in attrs]),
        diffuse=np.array(CLOSURE_DIFFUSE, dtype=np.int64),
        specular=np.array(CLOSURE_SPECULAR, dtype=np.int64),
    )
    prob, bcs, kw = closure_solver_args(fields, jax_unit_cube)
    old = os.environ.get("PBTE_RING_BF16")
    os.environ["PBTE_RING_BF16"] = "0"
    try:
        s = SourceIterationSolver(*prob, bcs, dtype=jnp.float32,
                                  sweep_mode="ring", use_pallas="off", **kw)
    finally:
        if old is None:
            del os.environ["PBTE_RING_BF16"]
        else:
            os.environ["PBTE_RING_BF16"] = old
    if not (s.sweep_mode == "ring" and s._ring_lattice and s.has_periodic
            and s._dif_on and s._spc_on and not s._ring_stage_bf16):
        raise RuntimeError("the closure golden must come from the f32 XLA "
                           "lattice ring with all three closures")
    tcs, res = _steps(s)
    return dict(fields, Tc=tcs, residual=res)


def build_scan() -> dict:
    import jax.numpy as jnp

    from pbte_tpu.solver.source_iteration import SourceIterationSolver

    attrs = sorted(SCAN_BCS)
    fields = dict(
        **{k: np.int64(v) for k, v in SCAN_PARAMS.items()},
        steps=np.int64(STEPS),
        bc_attrs=np.array(attrs, dtype=np.int64),
        bc_temps=np.array([SCAN_BCS[a] for a in attrs]),
        diffuse=np.array(SCAN_DIFFUSE, dtype=np.int64),
    )
    prob, bcs, kw = scan_solver_args(fields, jax_tet_cube)
    s = SourceIterationSolver(*prob, bcs, dtype=jnp.float32, **kw)
    if not (s.sweep_mode == "scan" and s.cache_policy == "full"
            and s.ncls > 0 and s._dif_on):
        raise RuntimeError("the scan golden must come from the f32 scan "
                           "path with the class factor cache")
    tcs, res = _steps(s)
    return dict(fields, Tc=tcs, residual=res)


def build_super() -> dict:
    import jax.numpy as jnp

    from pbte_tpu.solver.source_iteration import SourceIterationSolver

    old = os.environ.get("PBTE_RING_BF16")
    os.environ["PBTE_RING_BF16"] = "0"
    try:
        s = SourceIterationSolver(*jax_tet_box(**SUPER_PARAMS), WALL_BCS,
                                  dtype=jnp.float32, supercell="on")
    finally:
        if old is None:
            del os.environ["PBTE_RING_BF16"]
        else:
            os.environ["PBTE_RING_BF16"] = old
    if not (s._super is not None and s.sweep_mode == "ring"
            and not s._ring_stage_bf16 and not s._ring_state_bf16
            and not s._ring_windowed):
        raise RuntimeError("the supercell golden must come from the f32 "
                           "supercell ring with exact operands")
    tcs, res = _steps(s)
    attrs = sorted(WALL_BCS)
    return dict(
        **{k: np.int64(v) for k, v in SUPER_PARAMS.items()},
        steps=np.int64(STEPS),
        bc_attrs=np.array(attrs, dtype=np.int64),
        bc_temps=np.array([WALL_BCS[a] for a in attrs]),
        Tc=tcs,  # (steps, ncell, D') f32, the super blocks after each step
        residual=res,
    )


def _xla_ring_f32(prob):
    """pbte_tpu's f32 XLA lattice ring on ``prob`` with the flagship walls,
    bf16 operand staging off (exact f32 operands, as on the CPU)."""
    import jax.numpy as jnp

    from pbte_tpu.solver.source_iteration import SourceIterationSolver

    old = os.environ.get("PBTE_RING_BF16")
    os.environ["PBTE_RING_BF16"] = "0"
    try:
        s = SourceIterationSolver(*prob, WALL_BCS, dtype=jnp.float32,
                                  sweep_mode="ring", use_pallas="off")
    finally:
        if old is None:
            del os.environ["PBTE_RING_BF16"]
        else:
            os.environ["PBTE_RING_BF16"] = old
    if not (s.sweep_mode == "ring" and s._ring_lattice
            and not s._ring_stage_bf16 and not s._use_pallas_ring):
        raise RuntimeError("the golden must come from the f32 XLA lattice "
                           "ring with exact operands")
    return s


def _ring_golden(params, s) -> dict:
    tcs, res = _steps(s)
    attrs = sorted(WALL_BCS)
    return dict(
        **{k: np.int64(v) if isinstance(v, int) else np.float64(v)
           for k, v in params.items()},
        steps=np.int64(STEPS),
        bc_attrs=np.array(attrs, dtype=np.int64),
        bc_temps=np.array([WALL_BCS[a] for a in attrs]),
        Tc=tcs,  # (steps, ne, D) f32, Tc after each step
        residual=res,
    )


def build_p3() -> dict:
    params = dict(P3_PARAMS, length=P3_LENGTH)
    s = _xla_ring_f32(jax_unit_cube(**params))
    if not (s.ncls_ring == 1 and s._ring_ccpl and s.D == 64):
        raise RuntimeError("the p=3 golden must come from the single-class "
                           "ring at D = 64")
    return _ring_golden(params, s)


def build_graded() -> dict:
    s = _xla_ring_f32(jax_graded_cube(**GRADED_PARAMS))
    if not (s.ncls_ring == 2 and not s._ring_ccpl):
        raise RuntimeError("the graded golden must come from the "
                           "multi-class ring with per-element couplings")
    return _ring_golden(GRADED_PARAMS, s)


def build_accel() -> dict:
    import jax.numpy as jnp

    from pbte_tpu.solver.source_iteration import SourceIterationSolver

    s = SourceIterationSolver(*jax_unit_cube(**ACCEL_PARAMS), WALL_BCS,
                              dtype=jnp.float64, sweep_mode="ring")
    if not (s.sweep_mode == "ring" and s._ring_lattice
            and not s._use_pallas_ring):
        raise RuntimeError("the accelerated golden must come from the "
                           "float64 XLA lattice ring")
    r = s.solve(tol=0, max_iter=ACCEL_MAX_ITER, verbose=False,
                accelerate="bicgstab")
    attrs = sorted(WALL_BCS)
    return dict(
        **{k: np.int64(v) for k, v in ACCEL_PARAMS.items()},
        max_iter=np.int64(ACCEL_MAX_ITER),
        bc_attrs=np.array(attrs, dtype=np.int64),
        bc_temps=np.array([WALL_BCS[a] for a in attrs]),
        Tc=np.asarray(r.Tc),  # (ne, D) f64
        Tv=np.asarray(r.Tv),  # (ne,) f64
        residual=np.float64(r.residual),
        iterations=np.int64(r.iterations),
    )


GOLDENS = {PATH: build, PATH_CLOSURES: build_closures}
# the accelerated golden (tests/test_torch_accel.py checks it is current)
ACCEL_GOLDENS = {PATH_ACCEL: build_accel}
# the scan golden (tests/test_torch_scan.py checks it is current)
SCAN_GOLDENS = {PATH_SCAN: build_scan}
# the supercell golden (tests/test_torch_supercell.py checks it is current)
SUPER_GOLDENS = {PATH_SUPER: build_super}
# the p = 3 and the graded lattice goldens (tests/test_torch_lattice_multi.py
# checks they are current)
LATTICE_GOLDENS = {PATH_P3: build_p3, PATH_GRADED: build_graded}


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import jax

    # the test environment's settings (tests/conftest.py)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    DATA.mkdir(parents=True, exist_ok=True)
    only = set(sys.argv[1:])  # file names to regenerate (default: all)
    for path, fn in {**GOLDENS, **ACCEL_GOLDENS, **SCAN_GOLDENS,
                     **SUPER_GOLDENS, **LATTICE_GOLDENS}.items():
        if only and path.name not in only:
            continue
        np.savez_compressed(path, **fn())
        print(f"wrote {path}")
