"""Benchmark of pbte_tpu_torch: sweep throughput on the flagship 3D problem.

The port's counterpart of ``bench.py``. The last line of its standard output
is ONE JSON object with ``bench.py``'s keys: {"metric", "value", "unit",
"vs_baseline", "cpp_baseline_dof_per_s", "shape", "rows", ...}.

Metric: element-ordinate DOF/s = steps K BS ne D / seconds on a unit-cube hex
mesh, by default the flagship: hex 16^3 (ne=4096), p=2 (D=27), 4x16 = 64
directions, 2x20 = 40 silicon bands, float32, consistent DG faces, isothermal
walls (``pbte_tpu_torch.problem``). Timing: 2 warm-up steps, then
``PBTE_BENCH_STEPS`` (default 30) steps, the window closed by
``torch.cuda.synchronize()``. The kernels' build and each row's set-up (the
host assembly of the problem and the solver's constructor) are reported
apart, in seconds.

Rows (each rebuilds the solver under its environment):

- ``f32``: the primary row, the solver's defaults (hull windows on); it is
  also ``value``. An error in it ends the run.
- ``bf16_state``: ``PBTE_RING_STATE_BF16=1``.
- ``diffuse_walls``: ``problem.DIFFUSE_WALLS`` (x faces isothermal, the other
  four diffuse: the lagged closure sources).
- ``p3_f32``: order 3, 4x4 = 16 directions, as ``bench.py``'s row. The CUDA
  kernel is built for D in {8, 27}, so on the GPU this row records the error
  it raises (ROADMAP.md queue 2, K1 item 5).
- ``f64_state``: ``dtype=torch.float64`` (the float64 kernel on the GPU),
  timed as the others, with its ``k1_share_of_bound``.
- ``f64_bicgstab``: the float64 problem solved with
  ``solve(accelerate="bicgstab", tol=1e-8)`` from the zero state (at most
  ``ACCEL_MAX_ITER`` step applications, the residual read every
  ``ACCEL_CHECK_EVERY`` of them): ``step_applications``, ``wall_s``
  (ending in a synchronise), ``ms_per_step_application``, the final
  ``linear_relres`` and ``tv_residual``, and the peak memory. The time per
  step application includes the Krylov vector updates.

An extra row that fails records ``{"error": ...}``; ``PBTE_BENCH_ROWS=0``
skips the extra rows.

``k1_share_of_bound``: per Km bucket of the primary row, the lattice ring
kernel's CUDA-event time in a step, its bound
(``ops.lattice_ring.sweep_bound_ms``: the larger of its bytes over 3.35 TB/s
and its flop over the H100's tensor-core peak for the state type) and the
share of the bound it reaches. It stands where ``bench.py`` reports a
fraction of a TPU's matmul peak; on the CPU it is null (no device metric
comes from a CPU run).

``vs_baseline`` and ``cpp_baseline_dof_per_s`` are null: ``bench.py`` times
pbte_tpu's C++ mirror solver, which this package has no copy of yet.

Usage (from the root of a checkout; the GPU unless asked otherwise, and no
fall-back: without a GPU the default raises)::

    python3 bench_torch.py [--device cuda|cpu]

Environment overrides: PBTE_BENCH_NX, PBTE_BENCH_ORDER, PBTE_BENCH_POLAR,
PBTE_BENCH_AZIMUTH, PBTE_BENCH_NSPEC, PBTE_BENCH_STEPS, PBTE_BENCH_ROWS.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pbte_tpu_torch import problem  # noqa: E402
from pbte_tpu_torch.ops import lattice_ring as lr  # noqa: E402
from pbte_tpu_torch.solver.source_iteration import (  # noqa: E402
    SourceIterationSolver,
    checked_device,
)

WARMUP_STEPS = 2
K1_TIMED_STEPS = 5
ACCEL_TOL = 1e-8
ACCEL_MAX_ITER = 1500
# residual reads every 10 BiCGStab iterations, as chip_smoke.py: the
# stagnation guard then waits 120 step applications, past the plateaus of
# the flagship's f64 relres near 1e-3 (a run reading every iteration
# stopped on one at 1.06e-3, measured on an H100)
ACCEL_CHECK_EVERY = 20
BASELINE_NOTE = (
    "bench.py measures its baseline with pbte_tpu's C++ mirror solver "
    "(pbte_tpu/native/); pbte_tpu_torch has no copy of it yet and imports "
    "nothing of pbte_tpu, so no baseline is measured"
)


def log(msg):
    print(f"[bench_torch] {msg}", file=sys.stderr, flush=True)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def k1_share_of_bound(solver, state):
    """Per bucket: the sweep kernel's mean CUDA-event ms over a few steps
    from ``state``, its bound and the share of it."""
    inner = solver.ring_sweep
    events, bounds = [], []

    def timed(v, *args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = inner(v, *args, **kw)
        e1.record()
        events.append((e0, e1))
        # the host windows: no read of the device inside the timed steps
        bounds.append(lr.sweep_bound_ms(v, len(kw["shifts"]), kw["dsrc"],
                                        kw["xsrc"], solver.win))
        return out

    solver.ring_sweep = timed
    try:
        for _ in range(K1_TIMED_STEPS):
            state = solver.step(*state)[:3]
        torch.cuda.synchronize()
    finally:
        solver.ring_sweep = inner
    nb = len(solver.consts["buckets"])
    out = []
    for bi in range(nb):
        ms = [e0.elapsed_time(e1) for e0, e1 in events[bi::nb]]
        kernel_ms = sum(ms) / len(ms)
        bound_ms, bound_by = bounds[bi]
        out.append(dict(bucket=bi, kernel_ms=kernel_ms, bound_ms=bound_ms,
                        bound_by=bound_by,
                        share_of_bound=bound_ms / kernel_ms))
    return out


def build(device, size, env=None, solver_kw=None):
    """(solver, set-up seconds) of the problem built under ``env``."""
    env = env or {}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        solver = SourceIterationSolver(
            *problem.unit_cube(**size), device=device,
            **(solver_kw or dict(bc_temps=problem.WALL_BCS)))
        sync(device)
        setup_s = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return solver, setup_s


def release(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_row(name, device, steps, size, env=None, solver_kw=None, shares=False):
    """Build the solver under ``env`` and time ``steps`` steps; returns the
    row and the solver's shape."""
    solver, setup_s = build(device, size, env, solver_kw)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    u, Tc, Tv = solver.initial_state()
    for _ in range(WARMUP_STEPS):
        u, Tc, Tv, r = solver.step(u, Tc, Tv)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        u, Tc, Tv, r = solver.step(u, Tc, Tv)
    sync(device)
    dt = time.perf_counter() - t0
    res = float(r)
    if not (torch.isfinite(Tc).all() and res == res):
        raise RuntimeError(f"row {name}: Tc or the residual is not finite")
    shape = dict(ne=solver.ne, D=solver.D, K=solver.K, BS=solver.BS)
    row = dict(
        dof_per_s=steps * solver.K * solver.BS * solver.ne * solver.D / dt,
        ms_per_step=dt / steps * 1e3, setup_s=round(setup_s, 2),
        windows=solver.win is not None, state=str(solver.state_dtype),
        residual=res,
    )
    if device.type == "cuda":
        row["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
        if shares:
            row["k1_share_of_bound"] = k1_share_of_bound(solver, (u, Tc, Tv))
    log(f"row {name}: {row['ms_per_step']:.3f} ms/step -> "
        f"{row['dof_per_s']:.4g} DOF/s (set-up {setup_s:.1f} s, residual "
        f"{res:.3e})")
    del solver, u, Tc, Tv
    release(device)
    return row, shape


def run_bicgstab_row(device, size):
    """The float64 problem solved by BiCGStab to ACCEL_TOL from the zero
    state; returns the row."""
    solver, setup_s = build(device, size, solver_kw=dict(
        bc_temps=problem.WALL_BCS, dtype=torch.float64))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    relres = []
    sync(device)
    t0 = time.perf_counter()
    r = solver.solve(tol=ACCEL_TOL, max_iter=ACCEL_MAX_ITER, verbose=False,
                     check_every=ACCEL_CHECK_EVERY, accelerate="bicgstab",
                     callback=lambda nmv, res: relres.append(res))
    sync(device)
    wall = time.perf_counter() - t0
    if not (torch.isfinite(r.Tc).all() and r.residual == r.residual):
        raise RuntimeError("row f64_bicgstab: Tc or the residual is not "
                           "finite")
    row = dict(step_applications=r.iterations, wall_s=wall,
               ms_per_step_application=wall / r.iterations * 1e3,
               linear_relres=relres[-1] if relres else None,
               tv_residual=r.residual, tol=ACCEL_TOL,
               setup_s=round(setup_s, 2), state=str(solver.state_dtype))
    if device.type == "cuda":
        row["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    log(f"row f64_bicgstab: {r.iterations} step applications in "
        f"{wall:.2f} s ({row['ms_per_step_application']:.3f} ms each), "
        f"linear relres {row['linear_relres']}, Tv residual "
        f"{r.residual:.3e}")
    del solver, r
    release(device)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    a = ap.parse_args(argv)
    device = checked_device(a.device)

    nx = int(os.environ.get("PBTE_BENCH_NX", 16))
    size = dict(
        nx=nx, ny=nx, nz=nx,
        order=int(os.environ.get("PBTE_BENCH_ORDER", 2)),
        polar=int(os.environ.get("PBTE_BENCH_POLAR", 4)),
        azimuth=int(os.environ.get("PBTE_BENCH_AZIMUTH", 16)),
        nspec=int(os.environ.get("PBTE_BENCH_NSPEC", 20)),
    )
    steps = int(os.environ.get("PBTE_BENCH_STEPS", 30))

    build_s = 0.0
    if device.type == "cuda":
        from pbte_tpu_torch.bench_dma import card_name_power
        from pbte_tpu_torch.ops import _build

        device_name = card_name_power()
        t0 = time.perf_counter()
        _build.load("lattice_ring")
        build_s = time.perf_counter() - t0
    else:
        torch.set_num_threads(1)
        device_name = "cpu"
    log(f"device {device_name}; hex {nx}^3 {size}; {steps} timed steps after "
        f"{WARMUP_STEPS}; kernel build {build_s:.1f} s")

    rows = {}
    # the primary row: an error here ends the run
    rows["f32"], shape = run_row("f32", device, steps, size, shares=True)

    if os.environ.get("PBTE_BENCH_ROWS", "1") != "0":
        f64 = dict(bc_temps=problem.WALL_BCS, dtype=torch.float64)
        extra = [
            ("bf16_state", size, {"PBTE_RING_STATE_BF16": "1"}, None, False),
            ("diffuse_walls", size, {}, problem.DIFFUSE_WALLS, False),
            # bench.py's production-order row: p=3, 4x4 = 16 directions
            ("p3_f32", dict(size, order=3, polar=4, azimuth=4), {}, None,
             False),
            ("f64_state", size, {}, f64, True),
        ]
        for name, row_size, env, solver_kw, shares in extra:
            try:
                rows[name], _ = run_row(name, device, steps, row_size, env,
                                        solver_kw, shares=shares)
            except Exception as e:  # an extra row never breaks the primary
                rows[name] = {"error": f"{type(e).__name__}: {e}"[:300]}
                log(f"row {name} FAILED: {e}")
                release(device)
        try:
            rows["f64_bicgstab"] = run_bicgstab_row(device, size)
        except Exception as e:
            rows["f64_bicgstab"] = {"error": f"{type(e).__name__}: {e}"[:300]}
            log(f"row f64_bicgstab FAILED: {e}")
            release(device)

    primary = rows["f32"]
    shares = primary.pop("k1_share_of_bound", None)
    print(json.dumps({
        "metric": "element_ordinate_dof_per_s",
        "value": primary["dof_per_s"],
        "unit": "dof/s",
        "vs_baseline": None,
        "cpp_baseline_dof_per_s": None,
        "baseline_note": BASELINE_NOTE,
        "k1_share_of_bound": shares,
        "shape": shape,
        "rows": rows,
        "device": device_name,
        "steps": steps,
        "kernel_build_s": round(build_s, 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
