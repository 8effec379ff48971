"""Mode ``solve``: ``SourceIterationSolver.solve(accelerate=...)`` from the
zero state, one solve after another.

Set-up builds the solver and runs one short solve of
``warmup_applications`` step applications (every kernel and vector update
a solve uses). The window starts solves back to back, each ending in a
synchronise; a new one starts only while the time left holds one more at
the last one's pace (the first always runs). Each solve's Tc and last
linear relres are kept. The traced segment is one solve capped at the
cell's ``trace_applications``. The check holds every solve of the window
to the plain reference's fixed point.

Numbers of the traffic file: ``accelerate``, ``tol``, ``max_iter``,
``check_every``, ``warmup_applications``; of the cell's file:
``trace_applications`` and the limits.
"""

from __future__ import annotations

import time

from pbte_bench import harness, port, trace
from pbte_bench.reference import check as reference


def _solve(run, max_iter):
    """One solve from zero: (SolveResult, last linear relres read)."""
    t = run.traffic
    reads = []
    res = run.solver.solve(accelerate=t["accelerate"], tol=t["tol"],
                           max_iter=max_iter, check_every=t["check_every"],
                           verbose=False,
                           callback=lambda it, r: reads.append(r))
    return res, (reads[-1] if reads else float("inf"))


def setup(run):
    t0 = time.perf_counter()
    run.solver = port.build_solver(run)
    _solve(run, 3)  # b = F(0) and the two trailing steps
    run.sync()
    run.spans["setup.init_s"] = (time.perf_counter() - t0
                                 - run.spans["setup.assembly_s"])
    _solve(run, run.traffic["warmup_applications"])
    run.sync()
    run.spans["setup_s"] = time.perf_counter() - run.t_start


def window(run):
    t = run.traffic
    solves = []
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        res, relres = _solve(run, t["max_iter"])
        run.sync()
        now = time.perf_counter()
        solves.append(dict(seconds=now - ts, applications=res.iterations,
                           relres=relres,
                           Tc=run.solver.Tc_fine(res.Tc).double().cpu()))
        del res
        if run.seconds - (now - t0) < solves[-1]["seconds"]:
            break
    elapsed = time.perf_counter() - t0
    harness.log("solves (applications, s): " + ", ".join(
        f"({s['applications']}, {s['seconds']:.4f})" for s in solves))
    failed = sum(not s["relres"] < t["tol"] for s in solves)
    run.results.update(window_s=elapsed, solves=solves,
                       attempted=len(solves), failed=failed)


def traced(run):
    n = run.cell_file["trace_applications"]
    (result, _), run.trace = trace.profile(lambda: _solve(run, n), run.sync)
    run.results["traced_applications"] = result.iterations


def release(run):
    run.solver = None


def check(run):
    plain = reference.plain_step(run.config, run.walls, run.device)
    gap = max(reference.fixed_point_gap(plain, s["Tc"])
              for s in run.results["solves"])
    run.checks["fixed_point_gap"] = (gap, run.cell_file["limits"][
        "fixed_point_gap"])
    run.checks["unconverged_solves"] = (run.results["failed"], 0)
