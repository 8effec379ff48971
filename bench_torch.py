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
- ``p3_f32``: order 3, 4x4 = 16 directions, as ``bench.py``'s row (D = 64:
  K1's tiled kernel on the GPU).
- ``wide_f32``: the flagship's order, angles and bands on a hex lattice 1.5
  times as wide per axis (24^3 by default, ne = 13,824, a slab of W = 576
  slots: K1's tiled kernel), with its ``k1_share_of_bound``.
- ``p3_wide_f64``, only with ``--p3-wide``: hex 28^3 (7/4 of the run's
  lattice per axis) at order 3 (D = 64), 2 x 8 = 16 directions, 2 x 4
  bands, float64 state: W = 784 slots, a level past the 16 CTAs of the
  earlier cluster kernel, which raised there; with its
  ``k1_share_of_bound``. Its host set-up is long and large, so it runs in
  a child process of its own (``--row p3_wide_f64``): the row records
  ``setup_s``, the host's peak resident memory (``host_peak_rss_gb``) and
  ``stages``, the child's host memory at each stage it reaches
  (``start``, ``assembled``, ``constructed``, ``initial state``, ``first
  step``, ``warm-up``, ``timed``, ``shares``, ``done``): the seconds
  since it started, the resident (``VmRSS``) and peak resident
  (``VmHWM``) memory of ``/proc/self/status``, ``ru_maxrss``, and on the
  GPU the device's ``max_memory_allocated``; each stage is also logged
  as it is reached. The parent stops the child where its host memory
  passes ``P3_WIDE_HOST_LIMIT_GB`` (before the host's own limit would end
  the whole run) or it runs past ``P3_WIDE_TIMEOUT_S``, and the row then
  records the last stage the child reached and its host memory. Its
  order, angles and bands take the PBTE_BENCH_* overrides where they are
  set.
- ``graded_f32``: the flagship on ``problem.graded_cube`` (x spacing
  alternating 1 : 2, two geometry classes): the multi-class torch ring.
- ``f64_state``: ``dtype=torch.float64`` (the float64 kernel on the GPU),
  timed as the others, with its ``k1_share_of_bound``.
- ``f64_bicgstab``: the float64 problem solved with
  ``solve(accelerate="bicgstab", tol=1e-8)`` from the zero state (at most
  ``ACCEL_MAX_ITER`` step applications, the residual read every
  ``ACCEL_CHECK_EVERY`` of them): ``step_applications``, ``wall_s``
  (ending in a synchronise), ``ms_per_step_application``, the final
  ``linear_relres`` and ``tv_residual``, and the peak memory. The time per
  step application includes the Krylov vector updates.
- ``tet_scan``: the reference's legacy production tet shape through the
  scan path (``problem.tet_cube(**problem.LEGACY_TET)`` with
  ``problem.LEGACY_TET_SOLVER``: the 5^3 6-tet cuboid, p=3, 16x24 = 384
  directions, 2x20 bands, f32, the class-batched full factor cache), timed
  as the others. Its order, polar and azimuth points and bands take the
  PBTE_BENCH_* overrides where they are set.
- ``tet_super``: the same shape with the solver's defaults, which merge the
  6-tet split into a 5^3 lattice of super elements (D' = 6 D) and take the
  supercell ring; timed as the others, then solved from the zero state to
  a Tv residual of ``CONVERGE_TOL`` (1e-7) with the residual read every
  ``CONVERGE_CHECK_EVERY`` (20) steps, as pbte_tpu's
  ``scripts/converge_tet.py`` measures it: ``converge_steps``,
  ``converge_wall_s`` (ending in a synchronise) and ``converge_residual``.
- ``general_ring``: the repository's default config on the general ring
  (pbte_tpu's one-hot ring, off the box lattice), f32:
  ``problem.config_problem(7)``, the unit-square-iso triangles refined 7
  times (32,768 elements), p = 1, 24 in-plane directions, 2 x 20 bands,
  with consistent faces (the config's mfem-parity faces make the refined
  iteration diverge in both packages, ROADMAP.md section 3; the step's
  shapes and work are the same). ``PBTE_BENCH_GENERAL_REFINE`` sets the
  refinement, ``PBTE_BENCH_NSPEC`` the bands where it is set. The ring
  (``sweep_mode="ring"``, which ``auto`` resolves to at this size) timed
  as the others, then the same problem on the scan (``scan_ms_per_step``,
  ``scan_dof_per_s``, its peak memory) and the C++ mirror's baseline on
  an 8-direction subset (``cpp_baseline_dof_per_s``, ``vs_baseline``).

An extra row that fails records ``{"error": ...}``; ``PBTE_BENCH_ROWS=0``
skips the extra rows.

``k1_share_of_bound``: per Km bucket of the primary row, the lattice ring
kernel's CUDA-event time in a step, its bound
(``ops.lattice_ring.sweep_bound_ms``: the larger of its bytes over 3.35 TB/s
and its flop over the H100's tensor-core peak for the state type) and the
share of the bound it reaches. It stands where ``bench.py`` reports a
fraction of a TPU's matmul peak; on the CPU it is null (no device metric
comes from a CPU run).

``vs_baseline`` and ``cpp_baseline_dof_per_s``: as ``bench.py`` measures
them (``bench.py:113-157``), the C++ mirror of the reference's solver
(``pbte_tpu_torch.native``, built with g++ at first use; a failed build
fails the run) solves the same problem on an 8-direction subset (polar 1 x
azimuth 8) for ``PBTE_BENCH_CPP_ITERS`` iterations (default 1) with the
on-the-fly LU: its DOF/s counts those 8 directions (the C++ sweep does no
work across directions, so its rate a direction is that of the full set),
and ``vs_baseline`` is the primary row's DOF/s over it. ``cpp_threads`` is
its OpenMP thread count (the cores the process may run on unless
OMP_NUM_THREADS says otherwise).

Usage (from the root of a checkout; the GPU unless asked otherwise, and no
fall-back: without a GPU the default raises)::

    python3 bench_torch.py [--device cuda|cpu] [--p3-wide]

Environment overrides: PBTE_BENCH_NX, PBTE_BENCH_ORDER, PBTE_BENCH_POLAR,
PBTE_BENCH_AZIMUTH, PBTE_BENCH_NSPEC, PBTE_BENCH_STEPS, PBTE_BENCH_ROWS,
PBTE_BENCH_CPP_ITERS, PBTE_BENCH_GENERAL_REFINE.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import resource
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pbte_tpu_torch import problem, tracing  # noqa: E402
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
# the tet_super row's solve to convergence (scripts/converge_tet.py's
# PBTE_TETC_TOL, PBTE_TETC_MAXIT and residual cadence)
CONVERGE_TOL = 1e-7
CONVERGE_MAX_ITER = 3000
CONVERGE_CHECK_EVERY = 20
# the p3_wide_f64 row: hex 28^3 p=3, 2 x 8 directions, 2 x 4 bands (order,
# polar, azimuth, nspec; PBTE_BENCH_* overrides them), and its child's time
P3_WIDE = dict(order=3, polar=2, azimuth=8, nspec=4)
P3_WIDE_TIMEOUT_S = 2400
# the child's host memory the parent allows, below the 96 GiB of host
# memory an H100 node of one card may give the whole run, where the
# parent and the card's driver hold the rest
P3_WIDE_HOST_LIMIT_GB = 72.0
# the general_ring row: the default config refined this many times
GENERAL_REFINE = 7
# the C++ baseline's direction subset (bench.py's: polar 1 x azimuth 8 in
# 3D, 8 azimuths in 2D)
CPP_AZIMUTH = 8


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


def takes_k1(solver):
    """Whether ``solver`` sweeps on K1 (the single-class lattice ring)."""
    return (solver._sweep is None and solver._multi is None
            and not solver._general)


def build(device, size, env=None, solver_kw=None, make=None):
    """(solver, set-up seconds) of the problem ``make(**size)`` (the unit
    cube by default) built under ``env``."""
    env = env or {}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        solver = SourceIterationSolver(
            *(make or problem.unit_cube)(**size), device=device,
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


def host_peak_rss_gb():
    """This process's peak resident host memory (GB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def stage_logger(label, device=None):
    """``(stage, stages)``: ``stage(name, **info)`` appends to ``stages``
    and logs the seconds since the logger was made, this process's
    resident and peak resident host memory (``VmRSS``, ``VmHWM``), its
    ``ru_maxrss`` and, on a GPU, the device's ``max_memory_allocated``
    (GB), with ``info``."""
    t0 = time.perf_counter()
    stages = []

    def stage(name, **info):
        rec = dict(stage=name, s=round(time.perf_counter() - t0, 1),
                   rss_gb=status_gb("self", "VmRSS"),
                   hwm_gb=status_gb("self", "VmHWM"),
                   maxrss_gb=host_peak_rss_gb())
        if device is not None and device.type == "cuda":
            rec["device_peak_gb"] = torch.cuda.max_memory_allocated(
                device) / 1e9
        rec.update(info)
        stages.append(rec)
        log(f"{label} stage {name} at {rec['s']:.1f} s, host "
            f"{rec['rss_gb']:.2f} GB, peak {rec['hwm_gb']:.2f} GB "
            f"(ru_maxrss {rec['maxrss_gb']:.2f} GB)"
            + "".join(f", {k} {v}" for k, v in rec.items()
                      if k not in ("stage", "s", "rss_gb", "hwm_gb",
                                   "maxrss_gb")))

    return stage, stages


def p3_wide_size(nx):
    """The p3_wide_f64 row's lattice: 7/4 of the run's per axis (28^3 by
    default), P3_WIDE's order, angles and bands unless PBTE_BENCH_* set
    them."""
    n = -(-7 * nx // 4)
    return dict(nx=n, ny=n, nz=n, **{
        k: int(os.environ.get(f"PBTE_BENCH_{k.upper()}", v))
        for k, v in P3_WIDE.items()})


def p3_wide_child(device, steps, size):
    """The p3_wide_f64 row in this (child) process: each stage it reaches is
    logged and recorded (``stage_logger``); returns the row."""
    stage, stages = stage_logger("p3_wide_f64", device)

    def assemble(**kw):
        out = problem.unit_cube(**kw)
        stage("assembled")
        return out

    stage("start")
    row, shape = run_row("p3_wide_f64", device, steps, size,
                         solver_kw=dict(bc_temps=problem.WALL_BCS,
                                        dtype=torch.float64),
                         shares=device.type == "cuda", make=assemble,
                         stage=stage)
    stage("done")
    row.update(shape=dict(shape, W=size["ny"] * size["nz"],
                          nx=size["nx"], order=size["order"]),
               host_peak_rss_gb=host_peak_rss_gb(), stages=stages)
    return row


def status_gb(pid, key):
    """The ``key`` line (``VmRSS``, ``VmHWM``) of process ``pid``'s status
    (or ``"self"``'s), in GB; 0 once the process is gone."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith(key + ":"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    return 0.0


def p3_wide_row(device, steps, size, cmd=None):
    """Run the p3_wide_f64 row in a child process (``cmd``, by default this
    script's ``--row p3_wide_f64``) and return its row; stop the child
    past P3_WIDE_HOST_LIMIT_GB of host memory or P3_WIDE_TIMEOUT_S, and
    then return where it failed: why, its exit code, the last stage it
    logged, its host memory and the tail of its errors."""
    cmd = cmd or [sys.executable, os.path.abspath(__file__), "--device",
                  device.type, "--row", "p3_wide_f64"]
    with tempfile.TemporaryFile("w+") as out, \
            tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen(cmd, stdout=out, stderr=err, text=True)
        t0, peak, stopped = time.perf_counter(), 0.0, None
        while proc.poll() is None:
            rss = status_gb(proc.pid, "VmRSS")
            peak = max(peak, rss)
            if rss > P3_WIDE_HOST_LIMIT_GB:
                stopped = (f"host memory {rss:.1f} GB past the "
                           f"{P3_WIDE_HOST_LIMIT_GB} GB allowed")
            elif time.perf_counter() - t0 > P3_WIDE_TIMEOUT_S:
                stopped = f"past {P3_WIDE_TIMEOUT_S} s"
            if stopped:
                proc.kill()
                break
            time.sleep(0.2)
        rc = proc.wait()
        out.seek(0)
        err.seek(0)
        lines, errs = out.read().strip().splitlines(), err.read()
    sys.stderr.write(errs)
    if rc == 0 and lines:
        return json.loads(lines[-1])
    stages = [x for x in errs.splitlines() if "p3_wide_f64 stage" in x]
    return {"error": stopped or f"child exit {rc}", "exit": rc,
            "size": size, "last_stage": stages[-1] if stages else None,
            "host_peak_gb": peak,
            "seconds": time.perf_counter() - t0,
            "stderr_tail": errs[-600:]}


def release(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_row(name, device, steps, size, env=None, solver_kw=None, shares=False,
            make=None, converge=False, stage=None):
    """Build the solver under ``env`` and time ``steps`` steps (and with
    ``converge`` solve from the zero state to ``CONVERGE_TOL``); returns
    the row and the solver's shape. On the GPU the row counts the K1
    launches of its timed steps by variant (``k1_launches``). ``stage``
    (``stage_logger``'s) is called as each stage ends: ``constructed``,
    ``initial state``, ``first step``, ``warm-up``, ``timed`` and, with
    ``shares``, ``shares``."""
    stage = stage or (lambda name, **info: None)
    solver, setup_s = build(device, size, env, solver_kw, make)
    stage("constructed", sweep_mode=solver.sweep_mode, k1=takes_k1(solver))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    u, Tc, Tv = solver.initial_state()
    sync(device)
    stage("initial state")
    for i in range(WARMUP_STEPS):
        u, Tc, Tv, r = solver.step(u, Tc, Tv)
        if i == 0:
            sync(device)
            stage("first step")
    sync(device)
    stage("warm-up")
    tracing.reset()
    t0 = time.perf_counter()
    for _ in range(steps):
        u, Tc, Tv, r = solver.step(u, Tc, Tv)
    sync(device)
    dt = time.perf_counter() - t0
    stage("timed")
    counts = tracing.report()["counts"]
    launches = {v: sum(c for k, c in counts.items()
                       if k.startswith(f"k1.launches.{v}."))
                for v in ("persistent", "tiled")}
    res = float(r)
    if not (torch.isfinite(Tc).all() and res == res):
        raise RuntimeError(f"row {name}: Tc or the residual is not finite")
    shape = dict(ne=solver.ne, D=solver.D, K=solver.K, BS=solver.BS)
    row = dict(
        dof_per_s=steps * solver.K * solver.BS * solver.ne * solver.D / dt,
        ms_per_step=dt / steps * 1e3, setup_s=round(setup_s, 2),
        windows=solver.win is not None, state=str(solver.state_dtype),
        residual=res, sweep_mode=solver.sweep_mode,
        supercell=solver._super is not None,
    )
    if device.type == "cuda":
        row["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
        row["k1_launches"] = launches
        if shares:
            row["k1_share_of_bound"] = k1_share_of_bound(solver, (u, Tc, Tv))
            stage("shares")
    if converge:
        del u, Tc, Tv
        sync(device)
        t0 = time.perf_counter()
        r = solver.solve(tol=CONVERGE_TOL, max_iter=CONVERGE_MAX_ITER,
                         check_every=CONVERGE_CHECK_EVERY, verbose=False)
        sync(device)
        row.update(converge_steps=r.iterations,
                   converge_wall_s=time.perf_counter() - t0,
                   converge_residual=r.residual, converge_tol=CONVERGE_TOL)
        log(f"row {name}: {r.iterations} steps to a Tv residual of "
            f"{r.residual:.3e} in {row['converge_wall_s']:.2f} s")
        u = Tc = Tv = r = None
    log(f"row {name}: {row['ms_per_step']:.3f} ms/step -> "
        f"{row['dof_per_s']:.4g} DOF/s (set-up {setup_s:.1f} s, residual "
        f"{res:.3e})")
    del solver, u, Tc, Tv
    release(device)
    return row, shape


def cpp_baseline(ops, quad, tables, bcs, iters, label):
    """The C++ mirror's DOF/s on ``ops`` with ``quad``'s directions (a
    subset of the row's), ``iters`` iterations with the on-the-fly LU:
    (DOF/s, seconds, OpenMP threads). Raises where it cannot be built."""
    from pbte_tpu_torch import native

    t0 = time.perf_counter()
    *_, secs = native.cpp_source_iteration(ops, quad, tables, bcs, iters,
                                           use_full_lu=False)
    cpp_dt = float(secs.sum())
    dofs = (iters * quad.num_directions * tables.num_branches
            * tables.num_spectral * ops.num_elements * ops.ndof / cpp_dt)
    # OpenMP's default: the cores this process may run on
    threads = (int(os.environ.get("OMP_NUM_THREADS", 0))
               or len(os.sched_getaffinity(0)))
    log(f"C++ baseline {label} ({quad.num_directions}-direction subset, "
        f"{threads} threads): {iters} iteration(s) in {cpp_dt:.2f} s "
        f"(+{time.perf_counter() - t0 - cpp_dt:.1f} s set-up) -> "
        f"{dofs:.4g} DOF/s")
    return dofs, cpp_dt, threads


def flagship_baseline(size, iters):
    """bench.py's baseline of the primary row: its hex lattice, order and
    bands on the 8-direction subset."""
    from pbte_tpu_torch.angular import quadrature as ang

    ops, _, tables = problem.unit_cube(**size)
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=1,
                                        azimuth_points=CPP_AZIMUTH))
    return cpp_baseline(ops, quad, tables, problem.WALL_BCS, iters,
                        "flagship")


def run_general_row(device, steps, refine, nspec, iters):
    """The general_ring row: the default config refined ``refine`` times
    on the general ring, then on the scan, then the C++ baseline."""
    def make(**_):
        return problem.config_problem(refine, face_mode="consistent",
                                      nspec=nspec)[0]

    bcs = problem.config_problem(0)[1]
    row, shape = run_row("general_ring", device, steps, {}, make=make,
                         solver_kw=dict(bc_temps=bcs, sweep_mode="ring"))
    scan, _ = run_row("general_ring scan", device, steps, {}, make=make,
                      solver_kw=dict(bc_temps=bcs, sweep_mode="scan"))
    row.update(shape=dict(shape, refine=refine),
               scan_ms_per_step=scan["ms_per_step"],
               scan_dof_per_s=scan["dof_per_s"],
               scan_setup_s=scan["setup_s"],
               scan_residual=scan["residual"],
               ring_over_scan=row["ms_per_step"] / scan["ms_per_step"])
    if "max_memory_allocated" in scan:
        row["scan_max_memory_allocated"] = scan["max_memory_allocated"]
    ops, _, tables = make()
    from pbte_tpu_torch.angular import quadrature as ang

    sub = ang.build(ang.AngularOptions(dimension=2,
                                       azimuth_points=CPP_AZIMUTH))
    cpp, cpp_s, threads = cpp_baseline(ops, sub, tables, bcs, iters,
                                       "general_ring")
    row.update(cpp_baseline_dof_per_s=cpp, cpp_seconds=cpp_s,
               cpp_threads=threads, vs_baseline=row["dof_per_s"] / cpp)
    log(f"row general_ring: ring {row['ms_per_step']:.3f} ms/step, scan "
        f"{scan['ms_per_step']:.3f} ms/step, {row['vs_baseline']:.4g}x the "
        f"C++ baseline")
    return row


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
    ap.add_argument("--row", choices=["p3_wide_f64"], default=None,
                    help="run this one row in this process and print it "
                         "(the main run starts it as a child process)")
    ap.add_argument("--p3-wide", action="store_true",
                    help="also run the p3_wide_f64 row (minutes of host "
                         "set-up and tens of GB of host memory)")
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
    if a.row is not None:
        if device.type == "cpu":
            torch.set_num_threads(1)
        print(json.dumps(p3_wide_child(device, steps, p3_wide_size(nx))))
        return 0

    build_s = 0.0
    if device.type == "cuda":
        from pbte_tpu_torch.bench_dma import card_name_power
        from pbte_tpu_torch.ops import _build

        device_name = card_name_power()
        t0 = time.perf_counter()
        _build.load_all(["lattice_ring", "lattice_ring_tiled"])
        build_s = time.perf_counter() - t0
    else:
        torch.set_num_threads(1)
        device_name = "cpu"
    log(f"device {device_name}; hex {nx}^3 {size}; {steps} timed steps after "
        f"{WARMUP_STEPS}; kernel build {build_s:.1f} s")

    rows = {}
    # the primary row: an error here ends the run
    rows["f32"], shape = run_row("f32", device, steps, size, shares=True)
    # its measured baseline (a failed build ends the run too)
    cpp_iters = int(os.environ.get("PBTE_BENCH_CPP_ITERS", 1))
    cpp_dofs, cpp_s, cpp_threads = flagship_baseline(size, cpp_iters)
    vs_baseline = rows["f32"]["dof_per_s"] / cpp_dofs
    log(f"the primary row is {vs_baseline:.4g}x the C++ baseline")

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
        # a wider lattice (K1's tiled kernel) and a graded one (the
        # multi-class torch ring), the flagship's order, angles and bands
        wide = -(-3 * nx // 2)
        graded = dict(n=nx, **{k: size[k] for k in ("order", "polar",
                                                    "azimuth", "nspec")})
        for name, row_size, make, shares in (
                ("wide_f32", dict(size, nx=wide, ny=wide, nz=wide), None,
                 True),
                ("graded_f32", graded, problem.graded_cube, False)):
            try:
                rows[name], row_shape = run_row(name, device, steps,
                                                row_size, make=make,
                                                shares=shares)
                rows[name]["shape"] = row_shape
            except Exception as e:
                rows[name] = {"error": f"{type(e).__name__}: {e}"[:300]}
                log(f"row {name} FAILED: {e}")
                release(device)
        # past the earlier 16-CTA ceiling, in a child process (see the module
        # docstring)
        if a.p3_wide:
            rows["p3_wide_f64"] = p3_wide_row(device, steps,
                                              p3_wide_size(nx))
            if "error" in rows["p3_wide_f64"]:
                log(f"row p3_wide_f64 FAILED: {rows['p3_wide_f64']}")
        try:
            rows["f64_bicgstab"] = run_bicgstab_row(device, size)
        except Exception as e:
            rows["f64_bicgstab"] = {"error": f"{type(e).__name__}: {e}"[:300]}
            log(f"row f64_bicgstab FAILED: {e}")
            release(device)
        # the legacy production tet shape on the scan path (pbte_tpu's
        # sweep_mode="scan") and on the supercell ring
        tet = dict(problem.LEGACY_TET, **{
            k: int(os.environ[f"PBTE_BENCH_{k.upper()}"])
            for k in ("order", "polar", "azimuth", "nspec")
            if f"PBTE_BENCH_{k.upper()}" in os.environ})
        try:
            rows["tet_scan"], tet_shape = run_row(
                "tet_scan", device, steps, tet, solver_kw=dict(
                    bc_temps=problem.WALL_BCS, **problem.LEGACY_TET_SOLVER),
                make=problem.tet_cube)
            rows["tet_scan"]["shape"] = dict(tet_shape, n=tet["n"],
                                             order=tet["order"])
        except Exception as e:
            rows["tet_scan"] = {"error": f"{type(e).__name__}: {e}"[:300]}
            log(f"row tet_scan FAILED: {e}")
            release(device)
        # the same shape on the supercell ring (the solver's defaults)
        try:
            rows["tet_super"], tet_shape = run_row(
                "tet_super", device, steps, tet,
                solver_kw=dict(bc_temps=problem.WALL_BCS),
                make=problem.tet_cube, converge=True)
            rows["tet_super"]["shape"] = dict(tet_shape, n=tet["n"],
                                              order=tet["order"])
        except Exception as e:
            rows["tet_super"] = {"error": f"{type(e).__name__}: {e}"[:300]}
            log(f"row tet_super FAILED: {e}")
            release(device)
        # the default config off the box lattice: the general ring, its
        # scan and its C++ baseline
        nspec_env = os.environ.get("PBTE_BENCH_NSPEC")
        try:
            rows["general_ring"] = run_general_row(
                device, steps, int(os.environ.get(
                    "PBTE_BENCH_GENERAL_REFINE", GENERAL_REFINE)),
                None if nspec_env is None else int(nspec_env), cpp_iters)
        except Exception as e:
            rows["general_ring"] = {"error": f"{type(e).__name__}: {e}"[:300]}
            log(f"row general_ring FAILED: {e}")
            release(device)

    primary = rows["f32"]
    shares = primary.pop("k1_share_of_bound", None)
    print(json.dumps({
        "metric": "element_ordinate_dof_per_s",
        "value": primary["dof_per_s"],
        "unit": "dof/s",
        "vs_baseline": vs_baseline,
        "cpp_baseline_dof_per_s": cpp_dofs,
        "cpp_baseline": dict(iters=cpp_iters, seconds=cpp_s,
                             threads=cpp_threads,
                             directions=CPP_AZIMUTH),
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
