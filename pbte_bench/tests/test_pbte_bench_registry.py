"""The per-layer metrics that read the program's own registry
(``registry.py``, ``pbte_tpu_torch.tracing``), on each cell at small sizes
on the CPU: a number in a traced run (a device metric only on the card,
so its arithmetic is checked on the traced run's registry with the device
taken for the card's), and nothing with ``--trace 0`` or an empty
registry."""

import math

import pytest
import torch

from pbte_bench import harness
from pbte_bench.tests.small import small_config
from pbte_tpu_torch import tracing

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 777
READERS = ("sweep.span_roofline.steps", "step.closure_device_ms",
           "bicgstab.update_device_ms", "bicgstab.dot_device_ms",
           "bicgstab.restarts_per_kapp", "setup.solver_s",
           "setup.face_trace_s")
# device readings: the card's alone
DEVICE = ("roofline", "device_ms")


def _readers(cell):
    w = harness.find_cell(BENCH, cell)
    return [m["name"] for m in harness.cell_metrics(BENCH, w, True)
            if m["name"] in READERS]


def _run(cell, trace, monkeypatch):
    """One small run of ``cell`` from an empty registry: (its result line,
    its ``Run``)."""
    seen = {}
    inner = harness.result_line

    def keep(bench, run):
        seen["run"] = run
        return inner(bench, run)

    monkeypatch.setattr(harness, "result_line", keep)
    tracing.reset()
    w = harness.find_cell(BENCH, cell)
    line = harness.run_cell(cell, SEED, 0.2, trace, "cpu",
                            config=small_config(w["config"]))
    return line, seen["run"]


def test_seven_readers_of_the_registry():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in READERS:
        assert entries[name]["source"] in ("program_span",
                                           "program_counter"), name
        path = harness.ROOT / "metrics" / f"{name}.py"
        assert "registry" in path.read_text(), name
    for cell in CELLS:
        assert _readers(cell), cell


@pytest.mark.parametrize("cell", CELLS)
def test_readers_read_a_traced_run(cell, monkeypatch):
    line, run = _run(cell, True, monkeypatch)
    assert line["correct"], line["checks"]
    for name in _readers(cell):
        device = any(d in name for d in DEVICE)
        got = harness.read_metric(name, run)
        if device:  # no device reading from a CPU run
            assert got is None and name not in line["metrics"], name
            run.device = torch.device("cuda")
            got = harness.read_metric(name, run)
            run.device = torch.device("cpu")
        else:
            assert line["metrics"][name]["value"] == got, name
        assert got is not None and math.isfinite(got) and got >= 0, name
    spans = tracing.report()["spans"]
    n = run.results.get("traced_steps", run.results.get(
        "traced_applications"))
    assert spans["pbte.step"]["calls"] == n


@pytest.mark.parametrize("cell", CELLS)
def test_readers_read_nothing_untraced_or_empty(cell, monkeypatch):
    _, run = _run(cell, False, monkeypatch)
    for name in _readers(cell):
        assert harness.read_metric(name, run) is None, name
    _, run = _run(cell, True, monkeypatch)
    tracing.reset()
    run.device = torch.device("cuda")
    for name in _readers(cell):
        assert harness.read_metric(name, run) is None, name
