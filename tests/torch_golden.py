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

All three build their problems from pbte_tpu's own host layers
(``jax_unit_cube``), the same unit cube ``pbte_tpu_torch.problem.unit_cube``
builds from the port's copy of them.

``python tests/torch_golden.py`` writes them to ``tests/data/``;
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


PATH_ACCEL = DATA / "torch_port_golden_accel.npz"
ACCEL_PARAMS = dict(nx=8, ny=8, nz=8, order=1, polar=2, azimuth=4, nspec=2)
ACCEL_MAX_ITER = 18


def jax_unit_cube(nx, ny, nz, order, polar, azimuth, nspec, periodic=()):
    """(ops, quad, tables) of pbte_tpu_torch.problem.unit_cube, built from
    pbte_tpu's mesh, assembly, quadrature and material modules."""
    from pbte_tpu import mesh as pmesh
    from pbte_tpu.angular import quadrature as ang
    from pbte_tpu.fem import assembly
    from pbte_tpu.material import nongray_smrt as mat

    m = pmesh.make_cartesian_3d(nx, ny, nz, "hex").scaled(1.0e-6)
    if len(periodic):
        m = pmesh.make_periodic(m, [int(a) for a in periodic])
    ops = assembly.assemble(pmesh.connect(m), order=order,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(
        dimension=3, polar_points=polar, azimuth_points=azimuth))
    tables = mat.build_tables(mat.SILICON, num_spectral=nspec)
    return ops, quad, tables


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


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import jax

    # the test environment's settings (tests/conftest.py)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    DATA.mkdir(parents=True, exist_ok=True)
    for path, fn in {**GOLDENS, **ACCEL_GOLDENS}.items():
        np.savez_compressed(path, **fn())
        print(f"wrote {path}")
