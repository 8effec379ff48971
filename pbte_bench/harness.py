"""The benchmark's driver: one cell, one seed, one run.

Everything is found by name. ``BENCHMARK.json`` at the root of the
checkout names the cell's configuration and traffic and the metrics; the
harness reads

- ``configs/<config>.json``: the problem (mesh, order, angles, material,
  walls, which sweep's work count applies);
- ``traffic/<traffic>.json``: the mode (``modes/<mode>.py``), the state
  type, its control, how the walls are drawn from the seed and the mode's
  own numbers;
- ``workloads/<cell>.json``: the cell's limits of ``correct`` and its
  trace length;
- ``metrics/<metric>.py``: one reader per metric, ``read(run)`` returning
  a number or None (nothing to read: the metric is left out);
- ``costs/<sweep>.py``: the work a sweep of the problem must do, and
  ``peaks.json`` the card's peaks.

A mode module has ``setup(run)``, ``window(run)``, ``traced(run)``,
``release(run)`` and ``check(run)``; they fill the ``Run`` that the
readers read. ``run_cell`` drives them in that order on any device (the
tests run it on the CPU at small sizes); ``run.py`` refuses a run without
the card.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# top-level module names that may not be loaded in a run (compared whole:
# the port, pbte_tpu_torch, begins with pbte_tpu)
FORBIDDEN = ("jax", "jaxlib", "flax", "pbte_tpu")


def log(msg):
    print(f"[pbte_bench] {msg}", file=sys.stderr, flush=True)


def load_json(kind, name):
    """``<ROOT>/<kind>/<name>.json``."""
    with open(ROOT / kind / f"{name}.json") as f:
        return json.load(f)


def load_benchmark(repo=REPO):
    with open(Path(repo) / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench, cell, trace):
    """The metric entries a run of ``cell`` reports: the end-to-end ones
    with ``trace`` 0, the per-layer ones with 1; an entry with a
    ``workloads`` list only in the cells it names."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def _load_file_module(kind, name):
    path = ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"pbte_bench.{kind}._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metric(name, run):
    """The reader ``metrics/<name>.py`` applied to ``run``."""
    value = _load_file_module("metrics", name).read(run)
    return None if value is None else float(value)


def load_mode(name):
    return importlib.import_module(f"pbte_bench.modes.{name}")


def load_cost(name):
    return importlib.import_module(f"pbte_bench.costs.{name}")


def draw_walls(config, traffic, seed):
    """Wall temperatures of this seed (boundary attribute -> deviation):
    each wall its base value plus a uniform draw in [-spread, spread]."""
    rng = np.random.default_rng(int(seed))
    spread = traffic["walls"]["spread"]
    return {int(a): float(t) + float(rng.uniform(-spread, spread))
            for a, t in sorted(config["walls"].items(),
                               key=lambda kv: int(kv[0]))}


class Run:
    """What one run knows: its cell, inputs and readings. Modes write
    ``spans`` (host seconds by name), ``results`` (the mode's own
    readings), ``trace`` (``trace.Trace`` of the traced
    segment) and ``checks`` (name -> (value, limit))."""

    def __init__(self, cell, config, traffic, cell_file, seed, seconds,
                 trace, device, control=False, fault=None):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.cell_file = cell_file
        self.seed, self.seconds, self.trace_on = int(seed), float(seconds), trace
        self.device = torch.device(device)
        self.control = control
        self.fault = fault  # tests: fault(solver) breaks the timed path
        self.walls = draw_walls(config, traffic, seed)
        self.spans, self.results, self.checks = {}, {}, {}
        self.trace = None
        self.t_start = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def bound_s(self):
        """The least seconds one sweep of the problem could take on the
        card: the larger of its bytes over the memory rate and its flop
        over the peak of the run's state type (``costs/<sweep>.py``,
        ``peaks.json``)."""
        nbytes, flop = load_cost(self.config["sweep"]["cost"]).work(
            self.config, self.results["state"])
        peaks = load_json(".", "peaks")
        return max(nbytes / peaks["bytes_per_s"],
                   flop / peaks["flop_per_s"][self.results["state"]])


def run_cell(name, seed, seconds, trace, device="cuda", *, control=False,
             bench=None, config=None, fault=None, t_start=None):
    """Run one cell once; returns the result line (a dict). ``config``
    replaces the cell's configuration file (the tests' small sizes)."""
    bench = bench or load_benchmark()
    cell = find_cell(bench, name)
    config = config or load_json("configs", cell["config"])
    traffic = load_json("traffic", cell["traffic"])
    cell_file = load_json("workloads", name)
    run = Run(cell, config, traffic, cell_file, seed, seconds, trace, device,
              control=control, fault=fault)
    run.t_start = time.perf_counter() if t_start is None else t_start
    mode = load_mode(traffic["mode"])
    cuda = run.device.type == "cuda"
    log(f"imports {time.perf_counter() - run.t_start:.3f} s")
    mode.setup(run)
    log(f"set-up {run.spans['setup_s']:.3f} s")
    if cuda:  # the process's peak so far, then the window's alone
        setup_peak = torch.cuda.max_memory_allocated(run.device)
        torch.cuda.reset_peak_memory_stats(run.device)
    mode.window(run)
    log(f"window {run.results['window_s']:.3f} s")
    if cuda:
        peak = torch.cuda.max_memory_allocated(run.device)
        run.results["window_peak_bytes"] = peak
        run.results["memory_peak_bytes"] = max(setup_peak, peak)
    if trace:
        t0 = time.perf_counter()
        mode.traced(run)
        log(f"traced segment {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    mode.release(run)
    log(f"program readings {time.perf_counter() - t0:.3f} s")
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mode.check(run)
    log(f"reference check {time.perf_counter() - t0:.3f} s")
    return result_line(bench, run)


def result_line(bench, run):
    metrics = {}
    for m in cell_metrics(bench, run.cell, run.trace_on):
        v = read_metric(m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = {k: {"value": float(v), "limit": float(lim)}
              for k, (v, lim) in run.checks.items()}
    correct = bool(checks) and all(
        np.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    dev = run.device
    device = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": 1,
        "memory_peak_bytes": int(run.results.get("memory_peak_bytes", 0)),
    }
    line = {"correct": correct,
            "attempted": int(run.results["attempted"]),
            "failed": int(run.results["failed"]),
            "metrics": metrics, "device": device}
    if run.trace_on and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = checks  # last: each compared number and its limit
    return line


def forbidden_modules():
    """Loaded top-level modules among ``FORBIDDEN``, compared whole."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))

