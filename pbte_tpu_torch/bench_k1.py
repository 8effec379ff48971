"""Paired timing of lattice-ring kernel (K1) designs on the GPU.

Every design is a build of a K1 source with the C entry point of
``csrc/lattice_ring.cu``: the committed source as it stands (``current``,
always first), and each ``--design NAME=[PATH][:DEFINE,...]``, a source
file (default: the committed one) built with ``-D`` defines, for example
an earlier design taken from git, or a measurement variant of the
committed source (``PBTE_K1_NO_MS``, ``PBTE_K1_NO_YS``,
``PBTE_K1_NO_PRODUCT``: see the source). All are built at once.

At the flagship's two Km-bucket shapes, with the solver's operators and
seeded random state (f32 state; bf16 state; bucket 1 with a Dirichlet
source), every design is held to the current one (max |diff| over max) and
timed in turns: ``--rounds`` rounds, each a CUDA-event window of
``--reps`` launches per design, one untimed launch ahead of each window,
the order reversed every other round. A row reports each design's median
ms, its ratio to the current design per round (median, min, max), the
bound (``ops.lattice_ring.sweep_bound_ms``) and the share of the bound.

Usage (on a machine with a CUDA GPU, from the root of a checkout)::

    python -m pbte_tpu_torch.bench_k1 [--design pr1=build/pr1.cu] \\
        [--reps 5] [--rounds 5] [--out F]

It prints the JSON to stdout (or writes ``--out``); it exits 1 without a
GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from pbte_tpu_torch.bench_dma import card_name_power
from pbte_tpu_torch.ops import _build
from pbte_tpu_torch.ops import lattice_ring as lr

# (bucket, state, Dirichlet source)
CASES = ((0, "f32", False), (0, "bf16", False), (1, "f32", True),
         (1, "bf16", False))


def parse_design(arg):
    """NAME=[PATH][:DEF,...] -> (name, path or None, defines)."""
    name, _, spec = arg.partition("=")
    path, _, defs = spec.partition(":")
    return name, (path or None), tuple(d for d in defs.split(",") if d)


def case_inputs(solver, bi, state, dirichlet, rng):
    """The sweep's arguments at one bucket shape: the solver's operators,
    seeded random v, ttc (and dsrc)."""
    c = solver.consts
    cb = c["buckets"][bi]
    L, D, W, BS = solver.L, solver.D, solver.W, solver.BS
    Gb, Km = cb["macro_w"].shape[:2]

    def rnd(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).cuda()

    v = rnd(L, Gb, Km, BS, D, W)
    cast = state == "bf16"
    if cast:
        v = v.to(torch.bfloat16)
    args = (v, rnd(L, Gb, D, W), cb["bsrc0"], cb["cin"], cb["bcat"],
            cb["macro_w"], c["wvec"])
    kw = dict(shifts=solver.shifts, dsrc=rnd(L, Gb, Km, D, W)
              if dirichlet else None, xsrc=None, cast_bf16=cast)
    return args, kw


def launcher(lib, args, kw):
    def run():
        return lr._launch(*args, kw["shifts"], kw["dsrc"], kw["xsrc"],
                          kw["cast_bf16"], lib=lib)
    return run


def time_designs(runs, reps, rounds):
    """Per design: the window ms of every round (mean over reps launches)."""
    names = list(runs)
    out = {n: [] for n in names}
    for r in range(rounds):
        order = names if r % 2 == 0 else names[::-1]
        for n in order:
            runs[n]()  # untimed: the host's launch cost stays out
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                runs[n]()
            e1.record()
            torch.cuda.synchronize()
            out[n].append(e0.elapsed_time(e1) / reps)
    return out


def run(designs, reps, rounds):
    from pbte_tpu_torch.problem import FLAGSHIP, WALL_BCS, unit_cube
    from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

    names = ["current"] + [d[0] for d in designs]
    committed = _build.CSRC_DIR / "lattice_ring.cu"
    sources = {"current": (committed, ())} | {
        name: (path or committed, defines) for name, path, defines in designs}
    t0 = time.perf_counter()
    built = _build.load_all(names, sources)
    build_s = time.perf_counter() - t0
    libs = {n: lr._lib(n) for n in names}
    solver = SourceIterationSolver(*unit_cube(**FLAGSHIP), WALL_BCS,
                                   device="cuda")
    rng = np.random.default_rng(0)
    rows = []
    for bi, state, dirichlet in CASES:
        args, kw = case_inputs(solver, bi, state, dirichlet, rng)
        runs = {n: launcher(libs[n], args, kw) for n in names}
        ref = runs["current"]()
        torch.cuda.synchronize()
        errs = {}
        for n in names[1:]:
            got = runs[n]()
            torch.cuda.synchronize()
            errs[n] = [((a.float() - b.float()).abs().max()
                        / b.float().abs().max()).item()
                       for a, b in zip(got, ref)]
            del got
        del ref
        ms = time_designs(runs, reps, rounds)
        bound, by = lr.sweep_bound_ms(args[0], len(kw["shifts"]), kw["dsrc"])
        cur = ms["current"]
        row = dict(bucket=bi, shape=list(args[0].shape), state=state,
                   dirichlet=dirichlet, bound_ms=bound, bound_by=by,
                   designs={})
        for n in names:
            ratio = [a / b for a, b in zip(ms[n], cur)]
            med = statistics.median(ms[n])
            row["designs"][n] = dict(
                ms=med, share_of_bound=bound / med,
                vs_current=dict(median=statistics.median(ratio),
                                min=min(ratio), max=max(ratio)),
                rel_err_ys_ms=errs.get(n))
        rows.append(row)
        print("[bench_k1] " + json.dumps(row), file=sys.stderr, flush=True)
        del args, kw, runs
        torch.cuda.empty_cache()
    return dict(
        device=torch.cuda.get_device_name(0), card=card_name_power(),
        build_s=build_s, reps=reps, rounds=rounds,
        ptxas={n: b.log for n, b in built.items()},
        designs={n: dict(source=str(src), defines=list(defs))
                 for n, (src, defs) in sources.items()},
        rows=rows,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--design", action="append", default=[],
                    help="NAME=[PATH][:DEFINE,...]")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[bench_k1] no CUDA device: this probe runs on a GPU only",
              file=sys.stderr)
        return 1
    res = run([parse_design(d) for d in a.design], a.reps, a.rounds)
    text = json.dumps(res, indent=1)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
