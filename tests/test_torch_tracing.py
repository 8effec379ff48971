"""The port's registry of spans and counters (pbte_tpu_torch.tracing) on
the CPU, at tiny sizes: off without the profiler (no record, no
``record_function``), set-up stages and counters always, and under
``torch.profiler`` the spans of a step and of a BiCGStab solve in the
Chrome trace and in the registry's tree."""

import functools
import json

import pytest
import torch

from pbte_tpu_torch import tracing
from pbte_tpu_torch.problem import WALL_BCS, tet_box, unit_cube
from pbte_tpu_torch.solver import accel
from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver
from test_torch_accel import (PLATEAU_SEEDS, _affine_map, _torch_step,
                              _torch_zero)

SMALL = dict(order=1, polar=2, azimuth=4, nspec=1)
# (problem, solver keywords) of each step the registry instruments: the
# lattice ring's single class (K1's path, its plain version on the CPU),
# the general ring, the supercell ring and the scan
CASES = {
    "lattice": (lambda: unit_cube(8, 8, 8, **SMALL), {}),
    "general": (lambda: unit_cube(8, 8, 8, **SMALL),
                dict(sweep_mode="ring", use_lattice=False)),
    "supercell": (lambda: tet_box(2, 2, 2, **SMALL), dict(supercell="on")),
    "scan": (lambda: unit_cube(3, 3, 3, **SMALL), dict(sweep_mode="scan")),
}
STEP_PARTS = ("pbte.step.sources", "pbte.step.sweep", "pbte.step.macroscopic")


@functools.lru_cache(maxsize=None)
def _problem(case):
    return CASES[case][0]()


def _solver(case, **kw):
    return SourceIterationSolver(*_problem(case), WALL_BCS, device="cpu",
                                 **CASES[case][1], **kw)


def _steps(solver, n):
    state = solver.initial_state()
    for _ in range(n):
        state = solver.step(*state[:3])
    return state


@pytest.fixture(autouse=True)
def _fresh_registry():
    tracing.reset()
    yield
    tracing.reset()


def test_span_off_is_one_shared_no_op():
    """Without the profiler every span is the same no-op context."""
    assert not torch._C._autograd._profiler_enabled()
    assert tracing.span("a") is tracing.span("b")
    with tracing.span("pbte.step"):
        pass
    assert tracing.report()["spans"] == {}


@pytest.mark.parametrize("case", list(CASES))
def test_no_span_record_without_profiler(case, monkeypatch):
    """Steps and a BiCGStab solve with the profiler off keep no span and
    never enter ``record_function``; the set-up stages and the counters
    are kept all the same."""
    s = _solver(case)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _steps(s, 3)
    res = s.solve(accelerate="bicgstab", tol=0.0, max_iter=12,
                  verbose=False)
    rep = tracing.report()
    assert rep["spans"] == {}
    assert rep["stages"]["pbte.setup.solver"]["calls"] == 1
    assert rep["counts"]["bicgstab.step_applications"] == res.iterations


def test_setup_stages_and_counters_without_profiler():
    """The host layers, the constructor and the supercell factor keep their
    host seconds; a solve counts its step applications; reset clears
    every one."""
    prob = tet_box(2, 2, 2, **SMALL)
    SourceIterationSolver(*prob, WALL_BCS, device="cpu", supercell="on")
    rep = tracing.report()
    for stage in ("connect", "assemble", "face_trace", "angles", "tables",
                  "solver", "supercell_factor"):
        got = rep["stages"][f"pbte.setup.{stage}"]
        assert got["calls"] >= 1 and got["host_s"] > 0, stage
    # assemble holds its face traces
    assert (rep["stages"]["pbte.setup.face_trace"]["host_s"]
            <= rep["stages"]["pbte.setup.assemble"]["host_s"])
    tracing.count("x.y", 2)
    tracing.count("x.y")
    assert tracing.report()["counts"]["x.y"] == 3
    tracing.reset()
    assert tracing.report() == dict(spans={}, stages={}, counts={})


def _profiled(fn, tmp_path):
    """fn() under the CPU profiler: (its result, the Chrome trace's
    complete events)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    return out, events


def _inside(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


@pytest.mark.parametrize("case", list(CASES))
def test_step_spans_under_profiler(case, tmp_path):
    """Under the profiler each step is a ``pbte.step`` annotation holding
    its sources, its sweeps and its closure, each around the step's aten
    ops; the registry has the same tree, one ``pbte.step`` call a step,
    and self times within the totals."""
    s = _solver(case)
    _steps(s, 1)  # the first step's one-time work
    n = 3
    _, events = _profiled(lambda: _steps(s, n), tmp_path)
    ann = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            ann.setdefault(e["name"], []).append(e)
    steps = ann["pbte.step"]
    assert len(steps) == n
    for name in STEP_PARTS:
        for e in ann[name]:
            assert any(_inside(e, st) for st in steps), name
            assert any(o.get("cat") == "cpu_op" and _inside(o, e)
                       for o in events), name
    spans = tracing.report()["spans"]
    assert spans["pbte.step"]["calls"] == n
    assert spans["pbte.step"]["parents"] == []
    for name in STEP_PARTS:
        assert spans[name]["parents"] == ["pbte.step"], name
        assert spans[name]["calls"] == len(ann[name]), name
    assert spans["pbte.step.sources"]["calls"] == n
    assert spans["pbte.step.macroscopic"]["calls"] == n
    assert spans["pbte.step.sweep"]["calls"] % n == 0
    for name, e in spans.items():
        assert 0 <= e["self_device_s"] <= e["device_s"] + 1e-12, name
        assert e["device_s"] > 0, name
    parts = sum(spans[name]["device_s"] for name in STEP_PARTS)
    assert parts <= spans["pbte.step"]["device_s"] + 1e-12


def test_spans_leave_the_step_unchanged():
    """The same steps with and without the profiler give the same bits."""
    s = _solver("lattice")
    want = _steps(s, 2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = _steps(s, 2)
    assert all(torch.equal(a, b) for a, b in zip(want[0], got[0]))
    assert all(torch.equal(a, b) for a, b in zip(want[1:], got[1:]))


def test_bicgstab_spans_under_profiler(tmp_path):
    """A BiCGStab solve: ``pbte.solve`` the root, every step application a
    ``pbte.step`` in it, the inner products inside the vector updates, the
    residual reads in the solve; the counter of step applications equals
    the solve's count."""
    s = _solver("lattice")
    res, events = _profiled(
        lambda: s.solve(accelerate="bicgstab", tol=0.0, max_iter=14,
                        check_every=2, verbose=False), tmp_path)
    spans = tracing.report()["spans"]
    assert spans["pbte.solve"]["calls"] == 1
    assert spans["pbte.solve"]["parents"] == []
    assert spans["pbte.step"]["calls"] == res.iterations
    assert spans["pbte.step"]["parents"] == ["pbte.solve"]
    assert spans["pbte.bicgstab.update"]["parents"] == ["pbte.solve"]
    assert spans["pbte.bicgstab.dot"]["parents"] == ["pbte.bicgstab.update"]
    assert spans["pbte.bicgstab.residual_read"]["parents"] == ["pbte.solve"]
    assert (spans["pbte.bicgstab.update"]["self_device_s"]
            <= spans["pbte.bicgstab.update"]["device_s"])
    assert (tracing.report()["counts"]["bicgstab.step_applications"]
            == res.iterations)
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"pbte.solve", "pbte.step", "pbte.step.sweep",
            "pbte.bicgstab.update", "pbte.bicgstab.dot"} <= names


def test_plain_solve_spans_under_profiler(tmp_path):
    """The plain loop: ``pbte.solve`` round its steps, a residual read at
    each check."""
    s = _solver("scan")
    res, _ = _profiled(lambda: s.solve(tol=0.0, max_iter=4, check_every=2,
                                       verbose=False), tmp_path)
    spans = tracing.report()["spans"]
    assert spans["pbte.solve"]["calls"] == 1
    assert spans["pbte.step"]["calls"] == res.iterations == 4
    assert spans["pbte.step"]["parents"] == ["pbte.solve"]
    assert spans["pbte.solve.residual_read"]["calls"] == 2


@pytest.mark.parametrize("seed", PLATEAU_SEEDS)
def test_restart_counter_counts_restart_lines(seed, capsys):
    """The plateau case of test_bicgstab_restarts_a_plateau: the restart
    counters add up to the solve's ``bicgstab restart`` lines."""
    fmap = _affine_map(seed=seed, rho=0.99, nonnormal=1.0)
    r = accel.bicgstab_outer(_torch_step(fmap), _torch_zero(), None, 1e-10,
                             1500, check_every=2)
    out = capsys.readouterr().out
    counts = tracing.report()["counts"]
    assert out.count("bicgstab restart (plateau)") >= 1
    assert counts["bicgstab.restarts.plateau"] == out.count(
        "bicgstab restart (plateau)")
    assert counts.get("bicgstab.restarts.breakdown", 0) == out.count(
        "bicgstab restart (breakdown)")
    assert counts["bicgstab.step_applications"] == r[4]
