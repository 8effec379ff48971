"""Mode ``steps``: ``SourceIterationSolver.step`` back to back.

Set-up builds the solver and drives it from its zero state through one
step and one chunk more. The window enqueues ``chunk_steps`` steps at a
time, each chunk ending in a synchronise, and closes at the end of the
first chunk that passes ``--seconds``. The traced segment is
``trace_chunks`` chunks more under the profiler.

After that the same solver, through the window's own call, gives the
readings the check judges: the window's last state counted for values
that are not finite; one step more from that state (its physical
coefficients by the program's ``u_by_direction``, Tc and Tv in, Tc and Tv
out), which the reference follows from the same state; and, from
``initial_state()`` again, ``check_steps`` steps, which the reference
follows from its own zero state.

Numbers of the traffic file: ``chunk_steps``, ``check_steps``; of the
cell's file: ``trace_chunks`` and the limits.
"""

from __future__ import annotations

import time

import torch

from pbte_bench import port, trace
from pbte_bench.reference import check as reference


def _step_chunk(run, n):
    """n steps from run.state, the host's enqueue seconds summed."""
    step, state = run.solver.step, run.state
    enq = 0.0
    for _ in range(n):
        t = time.perf_counter()
        state = step(*state[:3])
        enq += time.perf_counter() - t
    run.state = state
    return enq


def _nonfinite(state):
    """Values of (u slabs, Tc, Tv, residual) that are not finite."""
    u, *rest = state
    parts = list(u) if isinstance(u, (tuple, list)) else [u]
    return sum(int((~torch.isfinite(x)).sum()) for x in parts + rest)


def setup(run):
    t0 = time.perf_counter()
    run.solver = port.build_solver(run)
    run.state = run.solver.initial_state()
    _step_chunk(run, 1)
    run.sync()
    run.spans["setup.init_s"] = (time.perf_counter() - t0
                                 - run.spans["setup.assembly_s"])
    _step_chunk(run, run.traffic["chunk_steps"])
    run.sync()
    run.spans["setup_s"] = time.perf_counter() - run.t_start


def window(run):
    chunk = run.traffic["chunk_steps"]
    steps, enq = 0, 0.0
    t0 = time.perf_counter()
    while True:
        enq += _step_chunk(run, chunk)
        steps += chunk
        run.sync()
        elapsed = time.perf_counter() - t0
        if elapsed >= run.seconds:
            break
    nonfinite = _nonfinite(run.state)
    run.results.update(window_s=elapsed, steps=steps, enqueue_s=enq,
                       attempted=steps, failed=int(nonfinite > 0),
                       nonfinite=nonfinite)


def traced(run):
    n = run.cell_file["trace_chunks"] * run.traffic["chunk_steps"]
    _, run.trace = trace.profile(lambda: _step_chunk(run, n), run.sync)
    run.results["traced_steps"] = n


def release(run):
    """The program's readings for the check, then the program dropped."""
    s = run.solver
    u, Tc, Tv, _ = run.state
    before = (s.u_by_direction(u), s.Tc_fine(Tc).double().cpu(),
              Tv.double().cpu())
    _, Tc, Tv, _ = s.step(u, Tc, Tv)
    run.follow = before + (s.Tc_fine(Tc).double().cpu(), Tv.double().cpu())
    run.state = s.initial_state()
    run.readings = []
    for _ in range(run.traffic["check_steps"]):
        _step_chunk(run, 1)
        _, Tc, Tv, res = run.state
        run.readings.append((s.Tc_fine(Tc).double().cpu(), Tv.double().cpu(),
                             float(res)))
    run.solver = run.state = None


def check(run):
    plain = reference.plain_step(run.config, run.walls, run.device)
    gaps = reference.steps_gaps(plain, run.readings)
    gaps.update(reference.follow_gaps(plain, run.follow))
    gaps["nonfinite_state"] = run.results["nonfinite"]
    for name, value in gaps.items():
        run.checks[name] = (value, run.cell_file["limits"][name])
