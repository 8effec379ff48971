"""Paired timing of lattice-ring kernel (K1) designs on the GPU.

Every design is a build of a K1 source: the committed source as it stands
(``current``, always first), and each ``--design NAME=[PATH][:DEFINE,...]``,
a source file (default: the committed one) built with ``-D`` defines, for
example a scratch design, or a measurement variant of the committed source
(``PBTE_K1_NO_MS``, ``PBTE_K1_NO_YS``, ``PBTE_K1_NO_PRODUCT``: see the
source). All are built at once. Two flags go among the defines: ``@full``
launches the design without windows and holds and compares it to
``full_slab`` (a variant that is right on the full slab only), and
``@nowin`` (which implies ``@full``) says that the source has the C entry
point from before the window argument, so an earlier commit's kernel is
timed in turns with today's full slab::

    git show <commit>:pbte_tpu_torch/csrc/lattice_ring.cu > build/k1_old.cu
    python -m pbte_tpu_torch.bench_k1 --design old=build/k1_old.cu:@nowin

At the flagship's two Km-bucket shapes, with the solver's operators and
seeded random state zeroed outside the solver's hull windows (f32 state;
bf16 state; bucket 1 with a Dirichlet source; f64 state with a Dirichlet
source in both buckets, the operators of a float64 solver), every design
that has an entry point for the case's state is launched
with the windows, held to the current one (max |diff| over max) and timed
in turns with it and with ``full_slab``, the current build launched
without windows on the same inputs: ``--rounds`` rounds, each a CUDA-event
window of ``--reps`` launches per design, one untimed launch ahead of each
window, the order reversed every other round. A row reports each design's
median ms, its ratio to the current design per round (median, min, max),
its ratio to ``full_slab`` the same way, its bound
(``ops.lattice_ring.sweep_bound_ms``: in-window slots for the windowed
launches, every slot for a full-slab launch) and the share of it.

Usage (on a machine with a CUDA GPU, from the root of a checkout)::

    python -m pbte_tpu_torch.bench_k1 [--design no_ms=:PBTE_K1_NO_MS] \\
        [--state f64] [--reps 5] [--rounds 5] [--out F]

``--state`` (repeatable) keeps the cases of those state types. The f64
cases time the float64 kernel against an earlier one, e.g. the one-role
FP64 FMA kernel of commit fdfeb19::

    git show fdfeb19:pbte_tpu_torch/csrc/lattice_ring.cu > build/k1_fma.cu
    python -m pbte_tpu_torch.bench_k1 --design fma=build/k1_fma.cu \\
        --state f64

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
         (1, "bf16", False), (0, "f64", True), (1, "f64", True))
STATES = ("f32", "bf16", "f64")


def parse_design(arg):
    """NAME=[PATH][:DEF,...] -> (name, path or None, defines, flags): the
    entries that start with ``@`` are flags, without the ``@``."""
    name, _, spec = arg.partition("=")
    path, _, defs = spec.partition(":")
    defs = [d for d in defs.split(",") if d]
    flags = {d[1:] for d in defs if d.startswith("@")}
    unknown = flags - {"full", "nowin"}
    if unknown:
        raise ValueError(f"design {name}: unknown flags {sorted(unknown)}")
    if "nowin" in flags:
        flags.add("full")
    return (name, (path or None),
            tuple(d for d in defs if not d.startswith("@")),
            frozenset(flags))


def case_inputs(solver, bi, state, dirichlet, rng):
    """The sweep's arguments at one bucket shape: the solver's operators
    (a float64 solver's for f64 state), seeded random v, ttc (and dsrc) in
    the state's precision, zero outside the solver's windows."""
    c = solver.consts
    cb = c["buckets"][bi]
    L, D, W, BS = solver.L, solver.D, solver.W, solver.BS
    Gb, Km = cb["macro_w"].shape[:2]
    inside = np.zeros((L, W), dtype=np.float32)
    for l, (lo, hi) in enumerate(solver.win):
        inside[l, lo:hi] = 1.0
    inside = torch.from_numpy(inside).cuda()

    np_dt = np.float64 if state == "f64" else np.float32

    def rnd(*shape):
        t = torch.from_numpy(rng.standard_normal(shape, dtype=np_dt)).cuda()
        return t * inside.view((L,) + (1,) * (len(shape) - 2) + (W,))

    v = rnd(L, Gb, Km, BS, D, W)
    cast = state == "bf16"
    if cast:
        v = v.to(torch.bfloat16)
    args = (v, rnd(L, Gb, D, W), cb["bsrc0"], cb["cin"], cb["bcat"],
            cb["macro_w"], c["wvec"])
    kw = dict(shifts=solver.shifts, dsrc=rnd(L, Gb, Km, D, W)
              if dirichlet else None, xsrc=None, cast_bf16=cast)
    return args, kw


def launcher(lib, args, kw, win):
    def run():
        return lr._launch(*args, kw["shifts"], kw["dsrc"], kw["xsrc"],
                          kw["cast_bf16"], lib=lib, win=win)
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


def cases_of(states):
    """The CASES of the given state types (all of them for None)."""
    unknown = set(states or ()) - set(STATES)
    if unknown:
        raise ValueError(f"unknown states {sorted(unknown)}, want {STATES}")
    return [c for c in CASES if not states or c[1] in states]


def run(designs, reps, rounds, states=None):
    from pbte_tpu_torch.problem import FLAGSHIP, WALL_BCS, unit_cube
    from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

    builds = ["current"] + [d[0] for d in designs]
    flags = {"current": frozenset()} | {d[0]: d[3] for d in designs}
    committed = _build.CSRC_DIR / "lattice_ring.cu"
    sources = {"current": (committed, ())} | {
        name: (path or committed, defines)
        for name, path, defines, _ in designs}
    t0 = time.perf_counter()
    built = _build.load_all(builds, sources)
    build_s = time.perf_counter() - t0
    libs = {n: lr._lib(n, takes_win="nowin" not in flags[n]) for n in builds}
    full = {n for n in builds if "full" in flags[n]} | {"full_slab"}
    cases = cases_of(states)
    problem = unit_cube(**FLAGSHIP)
    solvers = {}

    def solver_of(state):
        dt = torch.float64 if state == "f64" else torch.float32
        if dt not in solvers:
            s = SourceIterationSolver(*problem, WALL_BCS, device="cuda",
                                      dtype=dt)
            if s.win is None:
                raise RuntimeError("the flagship solver took no hull windows")
            solvers[dt] = s
        return solvers[dt]

    rng = np.random.default_rng(0)
    rows = []
    for bi, state, dirichlet in cases:
        solver = solver_of(state)
        args, kw = case_inputs(solver, bi, state, dirichlet, rng)
        # a design from before the float64 kernel sits out the f64 cases
        case_builds = [n for n in builds if state != "f64"
                       or hasattr(libs[n], "pbte_lattice_ring_sweep_f64")]
        runs = {n: launcher(libs[n], args, kw,
                            None if n in full else solver.win_dev)
                for n in case_builds}
        runs["full_slab"] = launcher(libs["current"], args, kw, None)
        # every design against the committed build launched the same way
        # (the inputs respect the windows' contract, so the two references
        # differ in the order of the ms atomics alone)
        errs = {}
        dt = torch.float64 if state == "f64" else torch.float32
        held_to = {
            "current": [n for n in case_builds[1:] if n not in full]
            + ["full_slab"],
            "full_slab": [n for n in case_builds if n in full],
        }
        for ref_name, group in held_to.items():
            ref = runs[ref_name]()
            torch.cuda.synchronize()
            for n in group:
                got = runs[n]()
                torch.cuda.synchronize()
                errs[n] = [((a.to(dt) - b.to(dt)).abs().max()
                            / b.to(dt).abs().max()).item()
                           for a, b in zip(got, ref)]
                del got
            del ref
        ms = time_designs(runs, reps, rounds)
        nf = len(kw["shifts"])
        bound, by = lr.sweep_bound_ms(args[0], nf, kw["dsrc"],
                                      win=solver.win)
        full_bound, _ = lr.sweep_bound_ms(args[0], nf, kw["dsrc"])
        cur, fs = ms["current"], ms["full_slab"]
        row = dict(bucket=bi, shape=list(args[0].shape), state=state,
                   dirichlet=dirichlet, bound_ms=bound, bound_by=by,
                   full_slab_bound_ms=full_bound, designs={})
        for n in runs:
            med = statistics.median(ms[n])
            row["designs"][n] = dict(
                ms=med, windows=n not in full,
                share_of_bound=(full_bound if n in full else bound) / med,
                rel_err_ys_ms=errs.get(n))
            for key, base in (("vs_current", cur), ("vs_full_slab", fs)):
                ratio = [a / b for a, b in zip(ms[n], base)]
                row["designs"][n][key] = dict(
                    median=statistics.median(ratio), min=min(ratio),
                    max=max(ratio))
        rows.append(row)
        print("[bench_k1] " + json.dumps(row), file=sys.stderr, flush=True)
        del args, kw, runs
        torch.cuda.empty_cache()
    return dict(
        device=torch.cuda.get_device_name(0), card=card_name_power(),
        build_s=build_s, reps=reps, rounds=rounds,
        ptxas={n: b.log for n, b in built.items()},
        designs={n: dict(source=str(src), defines=list(defs),
                         flags=sorted(flags[n]))
                 for n, (src, defs) in sources.items()},
        rows=rows,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--design", action="append", default=[],
                    help="NAME=[PATH][:DEFINE,...]")
    ap.add_argument("--state", action="append", default=[],
                    choices=STATES, help="keep the cases of this state type")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[bench_k1] no CUDA device: this probe runs on a GPU only",
              file=sys.stderr)
        return 1
    res = run([parse_design(d) for d in a.design], a.reps, a.rounds,
              a.state)
    text = json.dumps(res, indent=1)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
