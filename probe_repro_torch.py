"""Run to run, on one input, on the GPU: how often K1's ys and ms, the f64
flagship's BiCGStab solve and a few steps of the flagship differ, for the
pbte_tpu_torch of any checkout (``chip_smoke.py``'s phase 16 (a), (b) and
(c), repeated more times).

Usage (on a machine with a CUDA GPU, from the root of a checkout)::

    python3 probe_repro_torch.py [--root DIR] [--launches 10] [--solves 3]
        [--out F]

``--root`` names the checkout whose package runs (default: this one), for
example an earlier commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists. Cases:

- K1 at the flagship's two Km-bucket shapes with its hull windows, in f32,
  bf16 and f64 state (``chip_smoke.k1_case_inputs``: the solver's operators,
  seeded random state), each launched ``--launches`` times: the launches
  whose ys and whose ms differ in any bit from the first's;
- the f64 flagship's ``solve(accelerate="bicgstab", tol=1e-8)`` from the
  zero state ``--solves`` times (``chip_smoke.solve_bicgstab``): each
  solve's step applications, whether its relres at every read and its Tc
  equal the first solve's;
- the f32 flagship with isothermal walls and with diffuse walls
  (``problem.DIFFUSE_WALLS``), ``chip_smoke.REPRO_STEPS`` steps from the
  zero state twice and once under torch's deterministic-algorithms audit
  (``chip_smoke.repro_record``).

Prints one JSON object (the card's name and power limit under ``card``) or
writes it to ``--out``; exits 1 without a GPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

# this checkout's chip_smoke.py (it imports no pbte_tpu_torch at import time,
# so the package comes from --root)
import chip_smoke as smoke

CASES = [(bi, state, False, False, True) for bi in (0, 1)
         for state in ("f32", "bf16", "f64")]


def k1_cases(lr, spec, launches):
    """K1's repeated launches at CASES on ``spec``."""
    inside, inside_t = smoke.window_masks(spec)
    rng = np.random.default_rng(0)
    gen = smoke.card_generator(rng)
    rows = []
    for case in CASES:
        args, kw, _, win_k = smoke.k1_case_inputs(lr, spec, case, rng, gen,
                                                  inside, inside_t)
        first = lr.lattice_ring_sweep(*args, **kw, win=win_k)
        torch.cuda.synchronize()
        rep = smoke.k1_repeats(lr, args, kw, win_k, first, launches)
        rows.append(dict(case=smoke.case_tag(case), **rep))
        print("[probe_repro] " + json.dumps(rows[-1]), file=sys.stderr,
              flush=True)
        del args, kw, first
        torch.cuda.empty_cache()
    return rows


def bicgstab_solves(s64, solves):
    """The f64 flagship's BiCGStab solve ``solves`` times from the zero
    state, each against the first."""
    rows, first = [], None
    for _ in range(solves):
        acc, relres, wall = smoke.solve_bicgstab(s64)
        if first is None:
            first = (relres, acc.Tc)
        rows.append(dict(step_applications=acc.iterations, wall_s=wall,
                         last_relres=relres[-1],
                         relres_equal=relres == first[0],
                         tc_equal=bool(torch.equal(acc.Tc, first[1]))))
        print("[probe_repro] bicgstab " + json.dumps(rows[-1]),
              file=sys.stderr, flush=True)
        del acc
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--launches", type=int, default=10, dest="n_launches")
    ap.add_argument("--solves", type=int, default=3)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[probe_repro] no CUDA device: this probe runs on a GPU only",
              file=sys.stderr)
        return 1
    if a.root is not None:
        sys.path.insert(0, str(pathlib.Path(a.root).resolve()))
    import pbte_tpu_torch
    from pbte_tpu_torch import problem
    from pbte_tpu_torch.bench_dma import card_name_power
    from pbte_tpu_torch.bench_k1 import k1_spec
    from pbte_tpu_torch.ops import lattice_ring as lr
    from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

    t0 = time.perf_counter()
    prob = problem.unit_cube(**problem.FLAGSHIP)
    out = dict(package=str(pathlib.Path(pbte_tpu_torch.__file__).parent),
               card=card_name_power(), launches=a.n_launches, solves=a.solves)
    s = SourceIterationSolver(*prob, problem.WALL_BCS, device="cuda")
    out["k1"] = k1_cases(lr, k1_spec(s), a.n_launches)
    out["steps"] = [smoke.repro_record(s, "flagship f32")]
    del s
    film = SourceIterationSolver(*prob, device="cuda",
                                 **problem.DIFFUSE_WALLS)
    out["steps"].append(smoke.repro_record(film, "diffuse-wall flagship"))
    del film
    torch.cuda.empty_cache()
    s64 = SourceIterationSolver(*prob, problem.WALL_BCS, device="cuda",
                                dtype=torch.float64)
    out["bicgstab"] = bicgstab_solves(s64, a.solves)
    del s64
    out["seconds"] = time.perf_counter() - t0
    text = json.dumps(out, indent=1)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
