"""Paired timing of lattice-ring kernel (K1) designs on the GPU.

Every design is a build of a K1 source: the committed source as it stands
(``current``, always first), and each ``--design NAME=[PATH][:DEFINE,...]``,
a source file (default: the committed one) built with ``-D`` defines, for
example a scratch design, or a measurement variant of the committed source
(``PBTE_K1_NO_MS``, ``PBTE_K1_NO_YS``, ``PBTE_K1_NO_PRODUCT``: see the
source; ``PBTE_K1_NO_MS`` drops the band sum of ms, so its time against
``current`` is what the band chain costs). A design from before the band
chain (no ``pbte_lattice_ring_scratch_numel`` in its library) is launched
as it was: ms zeroed first, the one-CTA entry points without the scratch.
All are built at once. Two flags go among the defines: ``@full``
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
with the windows, held to the current one and to the plain version
(``rel_err_ys_ms``, ``rel_err_vs_plain``: max |diff| over max) and timed
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

``--shape quad`` times the one-CTA kernel at D = 9 (quad 64^2 p=2, its
first Km bucket, in each state type). ``--shape p3`` and ``--shape wide``
time the tiled kernel
(``csrc/lattice_ring_tiled.cu``, the committed source and each design's
default) instead, at the shapes that take it: hex 16^3 p=3 (D = 64, the
p3_f32 row's lattice, its Km = 2 bucket: the lattice's own inflow
coefficients and hull windows, a seeded random D = 64 factor and boundary
source; ``p3_spec``) and the wide hex 24^3 p=2's last Km bucket (W = 576,
the solver's operators), each in f32, bf16 and f64 state with the hull
windows. The measurement variants of that source say which side sets its
pace::

    python -m pbte_tpu_torch.bench_k1 --shape p3 \\
        --design no_product=:PBTE_K1_NO_PRODUCT \\
        --design no_ys=:PBTE_K1_NO_YS --design no_ms=:PBTE_K1_NO_MS

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
SHAPES = ("flagship", "p3", "wide", "quad")
# the lattices of the tiled kernel: bench_torch.py's p3_f32 lattice (D =
# 64) and the flagship 1.5 times as wide per axis (W = 576)
P3_LATTICE = dict(nx=16, ny=16, nz=16, order=3, polar=4, azimuth=4, nspec=20)
WIDE = dict(nx=24, ny=24, nz=24, order=2, polar=4, azimuth=16, nspec=20)
# the one-CTA kernel at D = 9 (two faces): chip_smoke.py's quad 64^2 p=2
QUAD = dict(nx=64, ny=64, order=2, azimuth=16, nspec=20)
# the tiled shapes' cases: the last bucket (p3 has one), each state type
TILED_CASES = tuple((-1, state, False) for state in STATES)
# the quad lattice's cases: its first bucket (phase 3's), each state type
QUAD_CASES = tuple((0, state, False) for state in STATES)


def k1_spec(solver):
    """The shape, windows and per-bucket operators a lattice solver hands
    K1: what a kernel-vs-plain case runs on."""
    c = solver.consts
    return dict(L=solver.L, D=solver.D, W=solver.W, BS=solver.BS,
                shifts=solver.shifts, win=solver.win, win_dev=solver.win_dev,
                wvec=c["wvec"],
                buckets=[{k: cb[k] for k in ("bsrc0", "cin", "bcat",
                                             "macro_w")}
                         for cb in c["buckets"]])


def p3_spec(dims=P3_LATTICE, seed=3):
    """K1's operands on a p=3 lattice (D = 64), by default hex 16^3 with
    the p3_f32 row's 16 directions and 2 x 20 bands: the lattice, its
    inflow coefficients and hull windows from the solver at p=1 (they do
    not depend on the order; the p=3 assembly of 4,096 elements takes
    about a minute of host time), the D = 64 factor and boundary source
    seeded random (the factor scaled by 1/J, so the recurrence contracts
    like the physical one; the source zero outside the windows)."""
    from pbte_tpu_torch import problem
    from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

    s = SourceIterationSolver(
        *problem.unit_cube(**dict(dims, order=1)), problem.WALL_BCS,
        device="cuda")
    spec = k1_spec(s)
    del s
    D, L, W = 64, spec["L"], spec["W"]
    J = (1 + len(spec["shifts"])) * D
    rng = np.random.default_rng(seed)
    inside = np.zeros((L, W), dtype=np.float32)
    for l, (lo, hi) in enumerate(spec["win"]):
        inside[l, lo:hi] = 1.0
    for cb in spec["buckets"]:
        Gb, Km = cb["macro_w"].shape[:2]
        cb["bcat"] = torch.from_numpy(rng.standard_normal(
            (Gb, Km, spec["BS"], D, J), dtype=np.float32) / J).cuda()
        cb["bsrc0"] = torch.from_numpy(rng.standard_normal(
            (L, Gb, Km, D, W), dtype=np.float32)
            * inside[:, None, None, None, :]).cuda()
    spec["D"] = D
    return spec


def synthetic_spec(D, W, shifts, L, Gb, Km, BS, seed):
    """K1 operands at a shape no lattice gives (``k1_spec``'s layout, one
    bucket): seeded random factor (scaled by 1/J, so the recurrence
    contracts), boundary source and band weights; per-level windows that
    grow and shrink as their centre crosses the slab (so they cross tile
    boundaries; the middle level is empty); inflow coefficients that keep
    the windows' contract (zero outside the level's window, left of the
    slab, and where the upwind slot lies outside the previous level's
    window), and the boundary source zero outside the windows."""
    rng = np.random.default_rng(seed)
    nf = len(shifts)
    J = (1 + nf) * D
    win = np.zeros((L, 2), dtype=np.int32)
    for l in range(L):
        centre = W * (l + 1) // (L + 1)
        half = int(W / 4 * (0.25 + np.sin(np.pi * l / max(L - 1, 1)))) + 5
        win[l] = (max(centre - half, 0), min(centre + half, W))
    win[L // 2, 1] = win[L // 2, 0]
    inside = np.zeros((L, W), dtype=bool)
    for l, (lo, hi) in enumerate(win):
        inside[l, lo:hi] = True
    ok = np.zeros((L, nf, W), dtype=bool)
    w = np.arange(W)
    for l in range(1, L):
        for f, sf in enumerate(shifts):
            up = np.zeros(W, dtype=bool)
            up[sf:] = inside[l - 1, :W - sf]
            ok[l, f] = inside[l] & (w >= sf) & up
    cin = -np.abs(rng.standard_normal((L, Gb, Km, nf, W))) * ok[:, None, None]
    bsrc = rng.standard_normal((L, Gb, Km, D, W)) * inside[:, None, None, None]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()

    return dict(
        L=L, D=D, W=W, BS=BS, shifts=tuple(int(s) for s in shifts), win=win,
        win_dev=lr.windows_on_device(win, L, W, "cuda"),
        wvec=dev(rng.standard_normal((4, BS))),
        buckets=[dict(bsrc0=dev(bsrc), cin=dev(cin),
                      bcat=dev(rng.standard_normal((Gb, Km, BS, D, J)) / J),
                      macro_w=dev(np.abs(rng.standard_normal((Gb, Km, BS)))))])


def shape_spec(shape):
    """``k1_spec`` of a shape other than the flagship: "p3" (``p3_spec``),
    "wide" or "quad" (the lattice's solver, its operators as they are)."""
    if shape == "p3":
        return p3_spec()
    from pbte_tpu_torch import problem
    from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

    prob, bcs = ((problem.unit_square(**QUAD), problem.SQUARE_BCS)
                 if shape == "quad" else
                 (problem.unit_cube(**WIDE), problem.WALL_BCS))
    s = SourceIterationSolver(*prob, bcs, device="cuda")
    spec = k1_spec(s)
    del s
    return spec


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


def case_inputs(spec, bi, state, dirichlet, rng):
    """The sweep's arguments at one bucket shape: the operators of ``spec``
    (``k1_spec``; float64 state: a float64 solver's, or the spec's in
    float64), seeded random v, ttc (and dsrc) in the state's precision,
    zero outside the spec's windows."""
    cb = spec["buckets"][bi]
    L, D, W, BS = spec["L"], spec["D"], spec["W"], spec["BS"]
    Gb, Km = cb["macro_w"].shape[:2]
    inside = np.zeros((L, W), dtype=np.float32)
    for l, (lo, hi) in enumerate(spec["win"]):
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
    ops = [cb["bsrc0"], cb["cin"], cb["bcat"], cb["macro_w"], spec["wvec"]]
    if state == "f64":  # a float32 spec's operators, in float64
        ops = [t.double() for t in ops]
    args = (v, rnd(L, Gb, D, W), *ops)
    kw = dict(shifts=spec["shifts"], dsrc=rnd(L, Gb, Km, D, W)
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


def cases_of(states, shape="flagship"):
    """The cases of the given state types (all of them for None) at
    ``shape``: CASES at the flagship, QUAD_CASES at the quad lattice,
    TILED_CASES at a tiled shape."""
    unknown = set(states or ()) - set(STATES)
    if unknown:
        raise ValueError(f"unknown states {sorted(unknown)}, want {STATES}")
    if shape not in SHAPES:
        raise ValueError(f"unknown shape {shape}, want one of {SHAPES}")
    cases = {"flagship": CASES, "quad": QUAD_CASES}.get(shape, TILED_CASES)
    return [c for c in cases if not states or c[1] in states]


def run(designs, reps, rounds, states=None, shape="flagship"):
    from pbte_tpu_torch.problem import FLAGSHIP, WALL_BCS, unit_cube
    from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

    cases = cases_of(states, shape)
    builds = ["current"] + [d[0] for d in designs]
    flags = {"current": frozenset()} | {d[0]: d[3] for d in designs}
    committed = _build.CSRC_DIR / ("lattice_ring.cu"
                                   if shape in ("flagship", "quad")
                                   else "lattice_ring_tiled.cu")
    sources = {"current": (committed, ())} | {
        name: (path or committed, defines)
        for name, path, defines, _ in designs}
    t0 = time.perf_counter()
    built = _build.load_all(builds, sources)
    build_s = time.perf_counter() - t0
    libs = {n: lr._lib(n, takes_win="nowin" not in flags[n]) for n in builds}
    full = {n for n in builds if "full" in flags[n]} | {"full_slab"}
    specs = {}

    def spec_of(state):
        """The flagship's spec from a solver of the state's precision, or
        the tiled shape's spec (its operators in float64 for f64)."""
        if shape != "flagship":
            if None not in specs:
                specs[None] = shape_spec(shape)
            return specs[None]
        dt = torch.float64 if state == "f64" else torch.float32
        if dt not in specs:
            s = SourceIterationSolver(*unit_cube(**FLAGSHIP), WALL_BCS,
                                      device="cuda", dtype=dt)
            if s.win is None:
                raise RuntimeError("the flagship solver took no hull windows")
            specs[dt] = k1_spec(s)
            del s
        return specs[dt]

    rng = np.random.default_rng(0)
    rows = []
    for bi, state, dirichlet in cases:
        spec = spec_of(state)
        bi %= len(spec["buckets"])
        args, kw = case_inputs(spec, bi, state, dirichlet, rng)
        # a one-CTA design from before the float64 kernel sits out the f64
        # cases (every tiled design has them)
        case_builds = [n for n in builds if state != "f64"
                       or shape not in ("flagship", "quad")
                       or hasattr(libs[n], "pbte_lattice_ring_sweep_f64")]
        runs = {n: launcher(libs[n], args, kw,
                            None if n in full else spec["win_dev"])
                for n in case_builds}
        runs["full_slab"] = launcher(libs["current"], args, kw, None)
        # every design against the committed build launched the same way
        # (the inputs respect the windows' contract, so the committed build
        # windowed and on the full slab agree bit for bit; a design from
        # before the band chain sums ms in another order)
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
        # and against the plain version on the same inputs (the windows'
        # contract: the full-slab result is the windowed one)
        plain = lr.lattice_ring_sweep_ref(*args, **kw, win=spec["win"])
        plain_errs = {}
        for n, fn in runs.items():
            got = fn()
            torch.cuda.synchronize()
            plain_errs[n] = [((a.to(dt) - b.to(dt)).abs().max()
                              / b.to(dt).abs().max()).item()
                             for a, b in zip(got, plain)]
            del got
        del plain
        ms = time_designs(runs, reps, rounds)
        nf = len(kw["shifts"])
        bound, by = lr.sweep_bound_ms(args[0], nf, kw["dsrc"],
                                      win=spec["win"])
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
                rel_err_ys_ms=errs.get(n),
                rel_err_vs_plain=plain_errs[n])
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
        shape=shape,
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
    ap.add_argument("--shape", default="flagship", choices=SHAPES,
                    help="the flagship's buckets or quad 64^2 p=2 "
                         "(csrc/lattice_ring.cu) or a tiled shape "
                         "(csrc/lattice_ring_tiled.cu)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[bench_k1] no CUDA device: this probe runs on a GPU only",
              file=sys.stderr)
        return 1
    res = run([parse_design(d) for d in a.design], a.reps, a.rounds,
              a.state, a.shape)
    text = json.dumps(res, indent=1)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
