"""A whole run of each cell at small sizes on the CPU (``run_cell``, the
harness's look for a card skipped): the result line, the control, and the
timed path broken underneath, each of which has to read not correct."""

import functools
import json
import os
import subprocess
import sys

import pytest
import torch

from pbte_bench import harness
from pbte_bench.tests.small import small_config

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]
SEED = 2**31 + 12345


def _run(cell, control=False, fault=None, trace=False):
    w = harness.find_cell(harness.load_benchmark(), cell)
    return harness.run_cell(cell, SEED, 0.2, trace, "cpu", control=control,
                            config=small_config(w["config"]), fault=fault)


def _buckets(solver):
    """The per-bucket consts of the sweep the solver took."""
    sweep = solver._sweep if solver._sweep is not None else solver
    return sweep.consts["buckets"]


def unchanged(solver):
    """A step that returns its state unchanged."""
    solver.step = lambda u, Tc, Tv: (u, Tc, Tv, torch.zeros((), dtype=Tc.dtype))


def half_batch(solver):
    """Half of the bands left out of the macroscopic sum, the rest counted
    twice (the mean taken over the rest)."""
    for cb in _buckets(solver):
        mw = cb["macro_w"]
        half = mw.shape[-1] // 2
        mw[..., half:] = 0
        mw[..., :half] *= 2


def altered(solver):
    """One element's temperature altered where the step produces it."""
    inner = solver.step

    def step(u, Tc, Tv):
        u, Tc, Tv, res = inner(u, Tc, Tv)
        Tc = Tc.clone()
        Tc[0] += 0.05 * Tc.abs().max()
        return u, Tc, Tv, res

    solver.step = step


# step calls before a late fault appears, by mode: past the set-up (a
# step and a chunk of 16; solves of 3 and 24 applications) and inside the
# window's first chunk or solve
LATE = {"steps": 20, "solve": 40}


def late(fault):
    """``fault`` from the step call after the first ``LATE`` of the mode."""
    def plant(solver, mode):
        inner, calls = solver.step, [0]
        fault(solver)
        broken = solver.step

        def step(*state):
            calls[0] += 1
            return (inner if calls[0] <= LATE[mode] else broken)(*state)

        solver.step = step

    plant.__name__ = f"late_{fault.__name__}"
    return plant


def not_finite(solver):
    """A step whose temperatures come out not finite."""
    inner = solver.step

    def step(u, Tc, Tv):
        u, Tc, Tv, res = inner(u, Tc, Tv)
        return u, Tc * float("nan"), Tv, res

    solver.step = step


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    line = _run(cell, trace=True)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert line["device"]["platform"] == "cpu"
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device metric from a CPU run
    for name in line["metrics"]:
        assert "roofline" not in name and "idle" not in name
        assert "device_ms" not in name


@pytest.mark.parametrize("cell", CELLS)
def test_end_to_end_metrics(cell):
    line = _run(cell)
    e2e = harness.cell_metrics(harness.load_benchmark(),
                               harness.find_cell(harness.load_benchmark(),
                                                 cell), False)
    # peak memory is a device reading: absent on the CPU
    want = {m["name"] for m in e2e} - {"peak_mem_gib"}
    assert set(line["metrics"]) == want
    assert all(v["value"] > 0 for v in line["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    assert not _run(cell, control=True)["correct"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [unchanged, half_batch, altered,
                                   late(unchanged), late(altered),
                                   late(not_finite)],
                         ids=lambda f: f.__name__)
def test_broken_timed_path_is_not_correct(cell, fault):
    if fault.__name__.startswith("late_"):
        w = harness.find_cell(harness.load_benchmark(), cell)
        mode = harness.load_json("traffic", w["traffic"])["mode"]
        fault = functools.partial(fault, mode=mode)
    assert not _run(cell, fault=fault)["correct"]


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    proc = subprocess.run(
        [sys.executable, str(harness.ROOT / "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.REPO, timeout=120)
    assert proc.returncode != 0
    assert not proc.stdout.strip()


@pytest.mark.card
def test_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA device")
    proc = subprocess.run(
        [sys.executable, str(harness.ROOT / "run.py"), "--workload",
         "legacy_tet.steps.f32", "--seed", "3", "--seconds", "2",
         "--trace", "1"],
        capture_output=True, text=True, cwd=harness.REPO, timeout=600,
        env=dict(os.environ))
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["busy_s"] > 0
