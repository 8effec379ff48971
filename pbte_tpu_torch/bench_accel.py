"""The float64 flagship's BiCGStab solve, repeated, on the GPU: where its
relative residual plateaus, and where the stagnation guard stops it.

``problem.unit_cube(**FLAGSHIP)`` with ``WALL_BCS`` and float64 state is
solved ``--free`` times with the guard off (``accel.STALL_READS`` set out of
reach), the residual read every BiCGStab iteration, to ``TOL``. Runs differ
only in the order of K1's ``ms`` atomics, which the recurrence carries on.
Each trajectory is then read at the cadences of ``CADENCES`` (matvecs
between reads), and pbte_tpu's guard replayed on it (6 reads and 60
matvecs without a 10% gain stop the solve): ``stop_fixed`` is the matvec
where it would stop, null where the solve reaches ``TOL`` first. Then
``--guarded`` more solves run with the port's guard (``accel.stall_action``,
which restarts the recurrence on a plateau), counting its restarts, at
the residual cadence of ``chip_smoke.py`` (``--check-every 20``) and with
the module's ``STALL_MATVECS`` unless ``--stall-matvecs`` sets a shorter
span (which makes restarts common, to see the solve go on after them).

Usage (on a machine with a CUDA GPU)::

    python -m pbte_tpu_torch.bench_accel [--free 5] [--guarded 3]
        [--check-every 20] [--stall-matvecs N] [--out F]

It prints one JSON object, with the card's name and power limit under
``device``, to stdout, or writes it to ``--out``; it exits 1 without a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from pbte_tpu_torch import problem
from pbte_tpu_torch.bench_dma import card_name_power
from pbte_tpu_torch.solver import accel
from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

TOL = 1e-8  # chip_smoke.py's ACCEL_TOL
MAX_ITER = 1500
CADENCES = (2, 20)  # matvecs between reads: every iteration; chip_smoke.py's


def replay(reads, every):
    """The matvec count at which pbte_tpu's guard stops a solve whose
    (nmv, relres) reads are ``reads``, read every ``every`` matvecs; None if
    it reaches TOL first."""
    best, stale, last_gain = float("inf"), 0, 1
    for nmv, res in reads:
        if (nmv - 1) % every:
            continue
        if res < TOL:
            return None
        if res < 0.9 * best:
            best, stale, last_gain = res, 0, nmv
        else:
            stale += 1
            if stale >= 6 and nmv - last_gain >= 60:
                return nmv
    return None


def plateaus(reads, least=40):
    """(first matvec, matvecs) of each span of at least ``least`` matvecs
    in which the residual gains no 10% on its best."""
    out, best, since = [], float("inf"), 1
    for nmv, res in reads:
        if res < 0.9 * best:
            if nmv - since >= least:
                out.append((since, nmv - since))
            best, since = res, nmv
    return out


def solve(s, check_every):
    reads = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = s.solve(tol=TOL, max_iter=MAX_ITER, verbose=False,
                check_every=check_every, accelerate="bicgstab",
                callback=lambda nmv, res: reads.append((nmv, res)))
    torch.cuda.synchronize()
    return r, reads, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--free", type=int, default=5)
    ap.add_argument("--guarded", type=int, default=3)
    ap.add_argument("--check-every", type=int, default=20)
    ap.add_argument("--stall-matvecs", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_accel: no CUDA device", file=sys.stderr)
        return 1
    s = SourceIterationSolver(*problem.unit_cube(**problem.FLAGSHIP),
                              problem.WALL_BCS, device="cuda",
                              dtype=torch.float64)
    out = dict(device=card_name_power(), shape=problem.FLAGSHIP, tol=TOL,
               max_iter=MAX_ITER, check_every=args.check_every,
               stall_matvecs=args.stall_matvecs or accel.STALL_MATVECS,
               free=[], guarded=[])
    saved = accel.STALL_READS
    accel.STALL_READS = 1 << 30
    try:
        for i in range(args.free):
            r, reads, wall = solve(s, check_every=2)
            row = dict(
                step_applications=r.iterations, wall_s=wall,
                last_relres=reads[-1][1], plateaus=plateaus(reads),
                stop_fixed={e: replay(reads, e) for e in CADENCES},
                reads=[(n, float(f"{x:.4e}")) for n, x in reads])
            out["free"].append(row)
            print(f"[bench_accel] free {i}: " + json.dumps(
                {k: v for k, v in row.items() if k != "reads"}),
                file=sys.stderr, flush=True)
    finally:
        accel.STALL_READS = saved
    actions = []

    def counted(*a):
        actions.append(action(*a))
        return actions[-1]

    action, accel.stall_action = accel.stall_action, counted
    saved = accel.STALL_MATVECS
    accel.STALL_MATVECS = out["stall_matvecs"]
    try:
        for i in range(args.guarded):
            actions.clear()
            r, reads, wall = solve(s, check_every=args.check_every)
            row = dict(step_applications=r.iterations, wall_s=wall,
                       last_relres=reads[-1][1],
                       reached_tol=reads[-1][1] <= TOL,
                       plateau_restarts=actions.count("plateau"))
            out["guarded"].append(row)
            print(f"[bench_accel] guarded {i}: {json.dumps(row)}",
                  file=sys.stderr, flush=True)
    finally:
        accel.stall_action = action
        accel.STALL_MATVECS = saved
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
