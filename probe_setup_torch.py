"""Host memory of the p3_wide_f64 row's set-up, by stage, at several sizes.

``bench_torch.py --p3-wide`` runs hex 28^3 p=3 in float64 (its
``p3_wide_f64`` row); this script measures where that row's host memory
goes, at hex n^3 for each n given, every size in a child process of its
own, which the parent stops past ``bench_torch.P3_WIDE_HOST_LIMIT_GB`` of
host memory or ``bench_torch.P3_WIDE_TIMEOUT_S`` (as the row's parent
does). The order, angles and bands are the row's (``bench_torch.P3_WIDE``,
PBTE_BENCH_* overrides as there). Two modes:

- ``--rows N ...``: the p3_wide_f64 row itself at each hex N^3
  (``bench_torch.p3_wide_child``: assembly, the solver's constructor,
  the initial state, the warm-up and ``PBTE_BENCH_STEPS`` timed steps, on
  the GPU K1's share of bound), with the host memory at each of its
  stages;
- ``--constructor N ...``: the assembly and the solver's constructor
  alone, with the host memory after each host function the constructor
  calls (the functions are wrapped from outside the package: the solver
  has no switch for this) and the geometry classes each
  ``element_classes`` call returns.

Each stage records the seconds since the child started, the resident
(``VmRSS``) and peak resident (``VmHWM``) memory of ``/proc/self/status``
and ``ru_maxrss``, in GB (``bench_torch.stage_logger``); ``VmHWM`` only
grows, so the stage whose peak rises past the others' is where the
memory goes. Prints one JSON object, ``{"mode", "device", "sizes":
{n: row or stages}}``, as its last line, and with ``--out`` writes it
there too.

Usage (from the root of a checkout)::

    python3 probe_setup_torch.py --device cpu --constructor 12 16 20
    python3 probe_setup_torch.py --rows 20 24 28 --out chiprun_out/p3w.json
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import bench_torch  # noqa: E402
from pbte_tpu_torch import problem  # noqa: E402
from pbte_tpu_torch.solver import source_iteration as si  # noqa: E402

# the host functions the solver's constructor calls, by the module (or the
# solver's own namespace) it calls them through
CONSTRUCTOR_CALLS = (
    (si.assembly, ("element_classes", "canonical_face_perm", "permute_faces",
                   "class_coupling")),
    (si.planner, ("build_plan", "detect_lattice")),
    (si.lattice_multi, ("class_factors", "coupling_classes",
                        "bucket_tables")),
    (si.macroscopic, ("slot_weights",)),
    (si.scan, ("ScanSweep",)),
    (si.super_ring, ("SuperRingSweep",)),
    (si, ("lattice_ring_tables", "ring_windows", "slab_layout",
          "slab_positions", "inflow_tables", "_periodic_tables",
          "_reflective_tables", "closure_scatter")),
)


def size_of(n):
    """The p3_wide_f64 row's problem at hex n^3."""
    return dict(bench_torch.p3_wide_size(16), nx=n, ny=n, nz=n)


def log_constructor_calls(stage):
    """Wrap each of CONSTRUCTOR_CALLS so that it calls ``stage`` as it
    returns (with the class count of ``element_classes``)."""
    def wrap(name, fn):
        @functools.wraps(fn)
        def logged(*args, **kw):
            out = fn(*args, **kw)
            info = {}
            if name == "element_classes":
                info["classes"] = int(out.max()) + 1
            stage(f"constructor: {name}", **info)
            return out
        return logged

    for mod, names in CONSTRUCTOR_CALLS:
        for name in names:
            setattr(mod, name, wrap(name, getattr(mod, name)))


def constructor_child(device, n):
    """Assemble hex n^3 and build the row's solver, logging the host memory
    after each host function the constructor calls; returns the stages."""
    stage, stages = bench_torch.stage_logger("p3_wide_f64", device)
    log_constructor_calls(stage)
    stage("start")
    ops, quad, tables = problem.unit_cube(**size_of(n))
    stage("assembled", ne=ops.num_elements)
    solver = si.SourceIterationSolver(ops, quad, tables, problem.WALL_BCS,
                                      dtype=torch.float64, device=device)
    bench_torch.sync(device)
    stage("constructed", sweep_mode=solver.sweep_mode,
          k1=bench_torch.takes_k1(solver))
    return dict(size=size_of(n), stages=stages)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--rows", type=int, nargs="+", metavar="N",
                      help="the p3_wide_f64 row at each hex N^3")
    mode.add_argument("--constructor", type=int, nargs="+", metavar="N",
                      help="the assembly and the constructor at each hex "
                           "N^3")
    ap.add_argument("--child", type=int, default=None,
                    help="run one size in this process (the parent starts "
                         "each size as a child)")
    ap.add_argument("--out", default=None, help="also write the JSON here "
                    "(after each size)")
    ap.add_argument("--timeout", type=float,
                    default=bench_torch.P3_WIDE_TIMEOUT_S,
                    help="stop a child past this many seconds (default "
                         "bench_torch.P3_WIDE_TIMEOUT_S)")
    a = ap.parse_args(argv)
    device = si.checked_device(a.device)
    name = "rows" if a.rows else "constructor"
    steps = int(os.environ.get("PBTE_BENCH_STEPS", 30))
    if a.child is not None:
        if device.type == "cpu":
            torch.set_num_threads(1)
        if a.rows:
            # the row's own stages, with the constructor's calls between
            # "assembled" and "constructed"
            logger = bench_torch.stage_logger

            def stage_logger(label, dev=None):
                stage, stages = logger(label, dev)
                log_constructor_calls(stage)
                return stage, stages

            bench_torch.stage_logger = stage_logger
            out = bench_torch.p3_wide_child(device, steps, size_of(a.child))
        else:
            out = constructor_child(device, a.child)
        print(json.dumps(out))
        return 0

    bench_torch.P3_WIDE_TIMEOUT_S = a.timeout
    result = dict(mode=name, device=(torch.cuda.get_device_name(0)
                                     if device.type == "cuda" else "cpu"),
                  sizes={})
    for n in a.rows or a.constructor:
        cmd = [sys.executable, os.path.abspath(__file__), "--device",
               device.type, f"--{name}", str(n), "--child", str(n)]
        result["sizes"][n] = bench_torch.p3_wide_row(device, steps,
                                                     size_of(n), cmd=cmd)
        if a.out:
            os.makedirs(os.path.dirname(os.path.abspath(a.out)),
                        exist_ok=True)
            with open(a.out, "w") as f:
                json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
