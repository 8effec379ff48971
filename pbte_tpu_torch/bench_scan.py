"""The scan path's factor caches at the legacy production tet shape, on the
GPU: set-up seconds, ms per outer step and peak memory of each.

``problem.tet_cube(**LEGACY_TET)`` with ``WALL_BCS`` and
``sweep_mode="scan"`` runs under each ``cache_policy``: ``full`` (the
class-batched cache), ``on-the-fly`` (``torch.linalg.inv`` over each
level's (D, D) blocks) and ``eigen`` (which the conditioning guard turns
into the class cache at p = 3), and once more as ``full`` with the class
streams forced (``scan.CLASS_OPS_BUDGET`` set to 0: the memory fallback
that this shape does not reach by itself). Each row: ``WARMUP`` steps from
the zero state, then ``--steps`` timed ones ending in
``torch.cuda.synchronize()``.

Usage (on a machine with a CUDA GPU)::

    python -m pbte_tpu_torch.bench_scan [--steps 5] [--out F]

It prints one JSON object, with the card's name and power limit under
``device``, to stdout, or writes it to ``--out``; it exits 1 without a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import warnings

import torch

from pbte_tpu_torch import problem
from pbte_tpu_torch.bench_dma import card_name_power
from pbte_tpu_torch.solver import scan
from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

WARMUP = 2
# (row name, cache_policy, CLASS_OPS_BUDGET or None for the module's own)
ROWS = (("full", "full", None), ("on-the-fly", "on-the-fly", None),
        ("eigen", "eigen", None), ("full_class_streams", "full", 0))


def run_row(prob, policy, budget, steps):
    """One row: build the solver, step it, read its time and memory."""
    saved = scan.CLASS_OPS_BUDGET
    if budget is not None:
        scan.CLASS_OPS_BUDGET = budget
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            s = SourceIterationSolver(*prob, problem.WALL_BCS, device="cuda",
                                      sweep_mode="scan", cache_policy=policy)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
    finally:
        scan.CLASS_OPS_BUDGET = saved
    torch.cuda.reset_peak_memory_stats()
    st = s.initial_state()
    for _ in range(WARMUP):
        st = s.step(*st)[:3]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        st = s.step(*st)[:3]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sv = s._scan
    row = dict(
        resolved=s.cache_policy, ncls=sv.ncls,
        class_streams=sv._scan_cls_ops, hoisted_rhs=sv._hoist_rhs,
        sequential_groups=sv._seq_groups, setup_s=setup_s,
        ms_per_step=wall / steps * 1e3,
        dof_per_s=steps * s.K * s.BS * s.ne * s.D / wall,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        tc_finite=bool(torch.isfinite(st[1]).all()),
        warnings=[str(w.message) for w in caught])
    del s, st
    torch.cuda.empty_cache()
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_scan: no CUDA device", file=sys.stderr)
        return 1
    prob = problem.tet_cube(**problem.LEGACY_TET)
    out = dict(device=card_name_power(), shape=problem.LEGACY_TET,
               steps=args.steps, warmup=WARMUP, rows={})
    for name, policy, budget in ROWS:
        out["rows"][name] = run_row(prob, policy, budget, args.steps)
        print(f"[bench_scan] {name}: {json.dumps(out['rows'][name])}",
              file=sys.stderr, flush=True)
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
