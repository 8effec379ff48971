"""GPU smoke run of pbte_tpu_torch: build the CUDA kernels, hold each to its
plain PyTorch version at the shapes its path gives it, run the flagship
source iteration (isothermal walls, then diffuse walls) and the copy probe
through them, and check the results against the pbte_tpu goldens.

Usage (from the root of a checkout, on a machine with one CUDA GPU):

    python3 chip_smoke.py

Phases (a failing phase raises and the script exits non-zero):

1. versions, the device and its power limit (no GPU: exit 1);
2. nvcc builds of pbte_tpu_torch/csrc/lattice_ring.cu (K1) and
   csrc/dma_copy.cu (K2, K3), concurrently, with the ptxas register /
   shared-memory reports of every kernel;
3. K1 vs plain version at the flagship's two Km-bucket shapes, with the
   solver's real operators and seeded random state, for f32 state, bf16
   state, a Dirichlet source and a random sparse lagged closure source:
   errors, CUDA-event times, and each launch's bound (the larger of its
   bytes over 3.35 TB/s and its flop over the tensor-core peak of its
   state type) with the share of it the kernel reaches. Then the same with
   the flagship's hull windows (the solver's default), the random inputs
   zeroed outside the windows as the windows' contract asks: the windowed
   kernel is held to the windowed plain version at the same tolerances and
   to the full-slab kernel on the same inputs (ys bit for bit, ms to 1e-6
   of max: its atomics add in another order), timed in turns with it, and
   both bounds are printed (full slab; in-window slots only);
4. the copy probe (python -m pbte_tpu_torch.bench_dma): every K2 and K3
   configuration held bit-exact (torch.equal) to its input at small and
   ragged totals (one vector, a block less 16 bytes, a block plus 16 bytes,
   fewer blocks than CTAs, many blocks and a ragged end), then at 512 MB
   f32 to its input and to the plain copy, then the probe's sweep (each row
   timed in turns with the plain copy) with the launch counts read around
   it; GB/s, the kernel/plain rate ratios, and K1's bucket-0 bytes/s as a
   share of the best copy rate;
5. the flagship (hex 16^3, p=2, 64 directions x 40 bands, f32), with hull
   windows as the solver takes them by default: setup, 2 warm-up + 30 timed
   steps, ms/step, element-ordinate DOF/s, peak memory, residuals, kernel
   launches; then 3 steps through the kernel and through the plain version
   from one state; then a second solver built with PBTE_RING_WINDOWS=0 and
   10 timed steps of each in turns (windows, full slab, full slab,
   windows), the two held bit-equal in Tc after the same steps;
6. the same flagship as a film: x faces isothermal, the other four diffuse
   (the lagged closure through K1's xsrc), measured as phase 5;
7. the golden Tc of pbte_tpu's Pallas path (tests/data/torch_port_golden.npz)
   and of its XLA ring with periodic, diffuse and specular walls
   (tests/data/torch_port_golden_closures.npz) against the port on the GPU.

The line before the last is the card's name and power limit, the one before
it {"kernels": [...]}, the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import time

import numpy as np
import torch

WARMUP_STEPS = 2
TIMED_STEPS = 30
TIMED_LAUNCHES = 10
AB_STEPS = 10  # timed steps per turn of the windows on/off comparison
# windowed vs full-slab kernel on the same inputs: ys is bit-equal; ms sums
# the same band terms by atomics in another order
WIN_MS_RTOL = 1e-6
DMA_TOTAL_MB = 512
DMA_REPS = 20
XSRC_ROWS = 1024  # closure rows of the random K1 closure source
# kernel vs plain on the same card: f32 sums in another order (FMA chains
# in the kernel, cuBLAS in the plain version; ms also by atomics in run-to-
# run order), so errors are stated relative to the largest value
F32_RTOL = 1e-5
# bf16 state: the ring and the state are rounded to bf16 every level, so a
# sum that lands on the other side of a rounding boundary moves one ulp and
# the recurrence carries it on
BF16_ULPS = 2
BF16_MS_RTOL = 1e-3
GOLDEN_RTOL = 2e-5


def log(*a):
    print(*a, flush=True)


def rel_err(got, ref):
    """max|got - ref| / max|ref|, and max|got - ref|."""
    d = (got.float() - ref.float()).abs().max().item()
    return d / max(ref.float().abs().max().item(), 1e-30), d


def bf16_ulp_of_max(ref):
    m = ref.float().abs().max().item()
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def time_turns(fns, n):
    """Mean CUDA-event ms of each of fns, launched in turns after one
    warm-up each."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    tot = [0.0] * len(fns)
    for _ in range(n):
        for i, fn in enumerate(fns):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            tot[i] += e0.elapsed_time(e1)
    return [t / n for t in tot]


# (bucket, state, Dirichlet source, closure source, hull windows); the first
# windowed case is what the flagship's step launches (bucket 0, f32)
K1_CASES = (
    [(0, "f32", False, False, False), (0, "bf16", False, False, False),
     (1, "f32", True, False, False), (1, "bf16", False, False, False),
     (0, "f32", False, True, False), (1, "f32", False, True, False),
     (0, "f32", False, False, True)]
    + [(bi, state, dirichlet, not dirichlet, True)
       for bi in (0, 1) for state in ("f32", "bf16")
       for dirichlet in (True, False)]
)


def phase_kernel_vs_plain(solver, lr):
    """Kernel vs plain at the flagship bucket shapes, full slab and with the
    solver's hull windows; returns the result rows."""
    rng = np.random.default_rng(0)
    c = solver.consts
    L, D, W, BS = solver.L, solver.D, solver.W, solver.BS
    nf = len(solver.shifts)
    if solver.win is None:
        raise RuntimeError("the flagship solver took no hull windows")
    inside = np.zeros((L, W), dtype=bool)
    for l, (lo, hi) in enumerate(solver.win):
        inside[l, lo:hi] = True
    inside_t = torch.from_numpy(inside).cuda()
    rows = []
    for bi, state, dirichlet, closure, windowed in K1_CASES:
        cb = c["buckets"][bi]
        Gb, Km = cb["macro_w"].shape[:2]
        # host windows for the plain version and the bounds, the solver's
        # uploaded tensor for the kernel
        win, win_k = (solver.win, solver.win_dev) if windowed else (None, None)

        def rnd(*shape):
            """Seeded normal values of a slab-shaped operand (L first, W
            last), zero outside the windows in a windowed case."""
            t = torch.from_numpy(
                rng.standard_normal(shape, dtype=np.float32)).cuda()
            if windowed and shape[0] == L:
                t *= inside_t.view((L,) + (1,) * (len(shape) - 2) + (W,))
            return t

        v = rnd(L, Gb, Km, BS, D, W)
        ttc = rnd(L, Gb, D, W)
        dsrc = rnd(L, Gb, Km, D, W) if dirichlet else None
        xsrc = None
        if closure:  # 40% of the slots read one of XSRC_ROWS random rows
            xmap = np.where(rng.random((L, Gb, W)) < 0.4,
                            rng.integers(0, XSRC_ROWS, (L, Gb, W)), -1)
            if windowed:  # the contract: no closure row outside a window
                xmap = np.where(inside[:, None, :], xmap, -1)
            xsrc = lr.ClosureSource(
                torch.from_numpy(xmap.astype(np.int32)).cuda(),
                rnd(Gb, XSRC_ROWS, Km, BS, D))
        cast = state == "bf16"
        if cast:
            v = v.to(torch.bfloat16)
        args = (v, ttc, cb["bsrc0"], cb["cin"], cb["bcat"], cb["macro_w"],
                c["wvec"])
        kw = dict(shifts=solver.shifts, dsrc=dsrc, xsrc=xsrc, cast_bf16=cast)
        tag = (f"bucket {bi} {state}{' dirichlet' if dirichlet else ''}"
               f"{' closure' if closure else ''}"
               f"{' windows' if windowed else ''}")
        ys, ms = lr.lattice_ring_sweep(*args, **kw, win=win_k)
        torch.cuda.synchronize()
        ys_r, ms_r = lr.lattice_ring_sweep_ref(*args, **kw, win=win)
        torch.cuda.synchronize()
        if not (torch.isfinite(ys.float()).all() and torch.isfinite(ms).all()):
            raise RuntimeError(f"{tag}: non-finite kernel output")
        ys_rel, ys_abs = rel_err(ys, ys_r)
        ms_rel, ms_abs = rel_err(ms, ms_r)
        if cast:
            ys_ulps = ys_abs / bf16_ulp_of_max(ys_r)
            ok = ys_ulps <= BF16_ULPS and ms_rel <= BF16_MS_RTOL
            tol = f"ys <= {BF16_ULPS} bf16 ulps of max, ms rel <= {BF16_MS_RTOL}"
        else:
            ys_ulps = None
            ok = ys_rel <= F32_RTOL and ms_rel <= F32_RTOL
            tol = f"ys, ms rel <= {F32_RTOL}"
        del ys_r, ms_r
        row = dict(bucket=bi, shape=list(v.shape), state=state,
                   dirichlet=dirichlet, xsrc=closure, windows=windowed,
                   ys_rel=ys_rel, ys_abs=ys_abs, ys_ulps_of_max=ys_ulps,
                   ms_rel=ms_rel, ms_abs=ms_abs, tolerance=tol)
        if windowed:
            # the windowed kernel against the full-slab kernel
            outside = ~inside_t
            if (ys.abs().amax(dim=(1, 2, 3, 4))[outside].max() != 0
                    or ms.abs().amax(dim=(0, 1, 3))[outside].max() != 0):
                raise RuntimeError(f"{tag}: ys or ms is not zero outside "
                                   f"the windows")
            ys_f, ms_f = lr.lattice_ring_sweep(*args, **kw)
            torch.cuda.synchronize()
            ys_equal = torch.equal(ys, ys_f)
            ms_full_rel, _ = rel_err(ms, ms_f)
            del ys_f, ms_f
            row.update(ys_equals_full_slab=ys_equal,
                       ms_vs_full_slab_rel=ms_full_rel,
                       full_slab_tolerance=f"ys bit-equal, ms rel <= "
                                           f"{WIN_MS_RTOL}")
            ok = ok and ys_equal and ms_full_rel <= WIN_MS_RTOL
        del ys, ms
        fns = [lambda: lr.lattice_ring_sweep(*args, **kw, win=win_k),
               lambda: lr.lattice_ring_sweep_ref(*args, **kw, win=win)]
        if windowed:
            fns.append(lambda: lr.lattice_ring_sweep(*args, **kw))
        k_ms, p_ms, *full_ms = time_turns(fns, TIMED_LAUNCHES)
        nbytes, flop = lr.sweep_cost(v, nf, dsrc, xsrc, win)
        bound_ms, bound_by = lr.sweep_bound_ms(v, nf, dsrc, xsrc, win)
        full_bound_ms, full_bound_by = lr.sweep_bound_ms(v, nf, dsrc, xsrc)
        win_bound_ms, _ = lr.sweep_bound_ms(v, nf, dsrc, xsrc, solver.win)
        row.update(kernel_ms=k_ms, plain_ms=p_ms, bytes=nbytes, flop=flop,
                   bound_ms=bound_ms, bound_by=bound_by,
                   share_of_bound=bound_ms / k_ms,
                   full_slab_bound_ms=full_bound_ms,
                   full_slab_bound_by=full_bound_by,
                   windows_bound_ms=win_bound_ms, ok=ok)
        line = (f"[smoke] K1 {tag}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
                f"ms, bound {bound_ms:.4f} ms ({bound_by}: "
                f"{nbytes / 1e9:.3f} GB, {flop / 1e9:.1f} Gflop), "
                f"{bound_ms / k_ms:.3f} of the bound (bounds: full slab "
                f"{full_bound_ms:.4f} ms, windows {win_bound_ms:.4f} ms)")
        if windowed:
            row.update(full_slab_kernel_ms=full_ms[0],
                       full_slab_share_of_bound=full_bound_ms / full_ms[0])
            line += (f"; full-slab kernel on the same inputs "
                     f"{full_ms[0]:.4f} ms (windows / full "
                     f"{k_ms / full_ms[0]:.3f}), "
                     f"{full_bound_ms / full_ms[0]:.3f} of its bound")
        log("[smoke] kernel vs plain " + json.dumps(row))
        log(line)
        if not ok:
            raise RuntimeError(f"kernel disagrees: {row}")
        if max(row["share_of_bound"],
               row.get("full_slab_share_of_bound", 0.0)) > 1.0:
            raise RuntimeError(f"{tag}: faster than its bound: {row}")
        rows.append(row)
        del v, ttc, dsrc, xsrc, args, kw, fns
        torch.cuda.empty_cache()
    return rows


def check_k1_smem(solver, lr):
    """The wrapper's shared-memory check (lr.kernel_smem_bytes) against the
    kernel's own carve-up, at the flagship's shapes in both modes."""
    lib = lr._lib()
    W, D, nf = solver.W, solver.D, len(solver.shifts)
    for cast in (0, 1):
        got = lib.pbte_lattice_ring_smem_bytes(cast, D, W, nf, solver.L)
        want = lr.kernel_smem_bytes(D, W, nf, bool(cast), solver.L)
        if got != want:
            raise RuntimeError(f"K1 shared memory: the kernel takes {got} B, "
                               f"the wrapper checks {want} B (cast={cast})")
    log(f"[smoke] K1 shared memory per CTA at D={D} W={W}: f32 "
        f"{lr.kernel_smem_bytes(D, W, nf, False, solver.L)} B, bf16 "
        f"{lr.kernel_smem_bytes(D, W, nf, True, solver.L)} B")


def edge_totals(block):
    """Small and ragged totals in bytes for a kernel of `block`-byte tiles or
    stages: one 16-byte vector, below one block, one block plus 16 bytes,
    fewer blocks than the card has CTAs, and many blocks with a ragged end."""
    return (16, block - 16, block + 16, 7 * block + 48,
            1000 * block + 4096 + 16)


def phase_dma_edges(dma, bench_dma):
    """Every K2 and K3 configuration bit-exact at the edge totals."""
    cfgs = bench_dma.configs()
    blocks = [info.get("tile_bytes", info.get("stage_bytes"))
              for _, _, info in cfgs]
    gen = torch.Generator(device="cuda").manual_seed(2)
    big = torch.randn(max(max(edge_totals(b)) for b in blocks) // 4,
                      generator=gen, device="cuda")
    n = 0
    for (name, fn, _), block in zip(cfgs, blocks):
        for total in edge_totals(block):
            x = big[:total // 4]
            y = fn(x)
            torch.cuda.synchronize()
            if not torch.equal(y, x):
                raise RuntimeError(f"{name}: the copy of {total} B differs "
                                   f"from its input")
            n += 1
    log(f"[smoke] dma {len(cfgs)} kernel configurations bit-exact at the "
        f"small and ragged totals: {n} copies")


def phase_dma(dma, bench_dma):
    """K2 and K3 at the edge totals and against the plain copy at 512 MB,
    then the probe's sweep (its main path) with the launch counts read
    around it."""
    phase_dma_edges(dma, bench_dma)
    rows = bench_dma.total_rows_for(DMA_TOTAL_MB)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((rows, dma.LANE), generator=gen, device="cuda")
    ref = dma.copy_ref(x)
    errs = {"auto": 0.0, "manual": 0.0}
    for name, fn, info in bench_dma.configs():
        y = fn(x)
        torch.cuda.synchronize()
        if not (torch.equal(y, x) and torch.equal(y, ref)):
            raise RuntimeError(f"{name}: the copy differs from its input")
        key = "auto" if info["kernel"] == "K2" else "manual"
        errs[key] = max(errs[key], (y - ref).abs().max().item())
        del y
    log(f"[smoke] dma {len(bench_dma.configs())} kernel configurations "
        f"bit-exact at {x.numel() * 4} B: max |y - plain| {errs}")
    del x, ref
    torch.cuda.empty_cache()

    dma.auto_copy.launches = dma.manual_copy.launches = 0
    res = bench_dma.run(DMA_TOTAL_MB, DMA_REPS)
    launches = {"auto": dma.auto_copy.launches,
                "manual": dma.manual_copy.launches}
    log("[smoke] dma probe " + json.dumps(res))
    for name, gbs in res["gbs"].items():
        line = (f"[smoke] dma {name:15s} {res['ms'][name]:8.4f} ms "
                f"{gbs:8.1f} GB/s")
        if name in res["rate_vs_plain"]:
            r = res["rate_vs_plain"][name]
            line += (f"  plain {res['plain_ms'][name]:.4f} ms, rate x"
                     f"{r['median']:.4f} of plain [{r['min']:.4f}, "
                     f"{r['max']:.4f}]")
        log(line)
    if min(launches.values()) < 1:
        raise RuntimeError(f"the probe launched a copy kernel no time: "
                           f"{launches}")
    return res, launches, errs


def phase_flagship(solver, lr, setup_s, name):
    """Time a flagship step through the kernel; returns (launches, row)."""
    torch.cuda.reset_peak_memory_stats()
    u, Tc, Tv = solver.initial_state()
    lr.lattice_ring_sweep.launches = 0
    res = []
    for _ in range(WARMUP_STEPS):
        u, Tc, Tv, r = solver.step(u, Tc, Tv)
        res.append(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        u, Tc, Tv, r = solver.step(u, Tc, Tv)
        res.append(r)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lr.lattice_ring_sweep.launches
    res = [float(x) for x in res]
    want = len(solver.consts["buckets"]) * (WARMUP_STEPS + TIMED_STEPS)
    ne, D, K, BS = solver.ne, solver.D, solver.K, solver.BS
    row = dict(
        ne=ne, D=D, K=K, BS=BS, G=solver.G, L=solver.L, W=solver.W,
        buckets=[[int(len(g)), km] for g, km in solver._ring_buckets],
        setup_s=setup_s, ms_per_step=wall / TIMED_STEPS * 1e3,
        dof_per_s=TIMED_STEPS * K * BS * ne * D / wall,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches=launches, residuals=res,
    )
    log(f"[smoke] {name} " + json.dumps(row))
    if launches != want:
        raise RuntimeError(f"{name}: {launches} kernel launches, want {want}")
    if Tc.shape != (ne, D) or not torch.isfinite(Tc).all():
        raise RuntimeError(f"{name}: Tc is not finite of shape (ne, D)")
    if not (np.all(np.isfinite(res)) and res[-1] < res[0]):
        raise RuntimeError(f"{name}: residuals not finite and falling: {res}")

    # 3 steps from one state, through the kernel and through the plain
    # version, on the card
    outs = []
    for sweep in (lr.lattice_ring_sweep, lr.lattice_ring_sweep_ref):
        solver.ring_sweep = sweep
        s = (u, Tc, Tv)
        for _ in range(3):
            s = solver.step(*s)[:3]
        outs.append(s[1])
        del s
    solver.ring_sweep = lr.lattice_ring_sweep
    torch.cuda.synchronize()
    tc_rel, tc_abs = rel_err(outs[0], outs[1])
    log(f"[smoke] {name} 3 steps kernel vs plain: Tc rel {tc_rel:.3e} "
        f"(abs {tc_abs:.3e}), tolerance {F32_RTOL}")
    if not tc_rel <= F32_RTOL:
        raise RuntimeError(f"{name} Tc: kernel disagrees with plain version")
    row["tc_kernel_vs_plain_rel"] = tc_rel
    return launches, row


def timed_steps(solver, steps):
    """(ms per step, Tc) of `steps` steps after the warm-up steps, from the
    initial state."""
    u, Tc, Tv = solver.initial_state()
    for _ in range(WARMUP_STEPS):
        u, Tc, Tv, _ = solver.step(u, Tc, Tv)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        u, Tc, Tv, _ = solver.step(u, Tc, Tv)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3, Tc


def phase_windows_ab(solver, build_full, name, row):
    """The step with hull windows (solver) and with PBTE_RING_WINDOWS=0 (a
    second solver from build_full), AB_STEPS timed steps each in turns:
    windows, full slab, full slab, windows. The same steps give the same
    Tc up to the order of the ms atomics, carried through the steps."""
    os.environ["PBTE_RING_WINDOWS"] = "0"
    try:
        full, _ = build_full()
    finally:
        del os.environ["PBTE_RING_WINDOWS"]
    if solver.win is None or full.win is not None:
        raise RuntimeError(f"{name}: windows on/off not as asked")
    ms = {"windows": [], "full_slab": []}
    tcs = {}
    for key in ("windows", "full_slab", "full_slab", "windows"):
        t, tcs[key] = timed_steps(solver if key == "windows" else full,
                                  AB_STEPS)
        ms[key].append(t)
    tc_rel, _ = rel_err(tcs["windows"], tcs["full_slab"])
    row["windows_ab_ms_per_step"] = ms
    row["windows_vs_full_slab_tc_rel"] = tc_rel
    log(f"[smoke] {name} windows on/off, {AB_STEPS} steps each in turns: "
        f"windows {ms['windows'][0]:.3f} / {ms['windows'][1]:.3f} ms/step, "
        f"full slab (PBTE_RING_WINDOWS=0) {ms['full_slab'][0]:.3f} / "
        f"{ms['full_slab'][1]:.3f} ms/step; Tc windows vs full slab rel "
        f"{tc_rel:.3e}, tolerance {F32_RTOL}")
    if not tc_rel <= F32_RTOL:
        raise RuntimeError(f"{name}: windows change Tc")


PARAM_KEYS = ("nx", "ny", "nz", "order", "polar", "azimuth", "nspec")


def phase_golden(SourceIterationSolver, unit_cube, file):
    """The port on the GPU against a pbte_tpu golden Tc (isothermal walls,
    or periodic, diffuse and specular closures when the file names them)."""
    golden = pathlib.Path(__file__).resolve().parent / "tests" / "data"
    with np.load(golden / file) as d:
        params = {k: int(d[k]) for k in PARAM_KEYS}
        bcs = dict(zip(d["bc_attrs"].tolist(), d["bc_temps"].tolist()))
        ref = torch.from_numpy(d["Tc"][-1]).cuda()
        steps = int(d["steps"])
        periodic = tuple(d["periodic"].tolist()) if "periodic" in d else ()
        kw = {f"{k}_bcs": d[k].tolist() for k in ("diffuse", "specular")
              if k in d}
    s = SourceIterationSolver(*unit_cube(**params, periodic=periodic), bcs,
                              device="cuda", **kw)
    r = s.solve(tol=0, max_iter=steps, verbose=False)
    rel, ab = rel_err(r.Tc, ref)
    log(f"[smoke] golden {file} {params} periodic={periodic} {kw} {steps} "
        f"steps: Tc rel {rel:.3e} (abs {ab:.3e}), tolerance {GOLDEN_RTOL}")
    if not rel <= GOLDEN_RTOL:
        raise RuntimeError(f"GPU Tc disagrees with the pbte_tpu golden {file}")
    return rel


def build_flagship(SourceIterationSolver, problem, name, **kw):
    t0 = time.perf_counter()
    solver = SourceIterationSolver(*problem, device="cuda", **kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"[smoke] {name} setup {setup_s:.1f} s: G={solver.G} L={solver.L} "
        f"W={solver.W} shifts={solver.shifts} buckets="
        f"{[(list(map(int, g)), k) for g, k in solver._ring_buckets]} "
        f"windows={'off' if solver.win is None else 'on'}")
    return solver, setup_s


def main() -> int:
    if not torch.cuda.is_available():
        log("[smoke] no CUDA device: this check runs on a GPU only")
        return 1
    from pbte_tpu_torch import bench_dma
    from pbte_tpu_torch.ops import _build
    from pbte_tpu_torch.ops import dma_copy as dma
    from pbte_tpu_torch.ops import lattice_ring as lr
    from pbte_tpu_torch.problem import (DIFFUSE_WALLS, FLAGSHIP, WALL_BCS,
                                        unit_cube)
    from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

    kind = torch.cuda.get_device_name(0)
    log(f"[smoke] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()}")
    card = bench_dma.card_name_power()
    log(f"[smoke] nvidia-smi: {card}")

    t0 = time.perf_counter()
    built = _build.load_all(["lattice_ring", "dma_copy"])
    log(f"[smoke] built {[b.path.name for b in built.values()]} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc "
        f"{ {k: round(b.seconds, 1) for k, b in built.items()} } s)")
    for b in built.values():
        log(b.log.strip())

    problem = unit_cube(**FLAGSHIP)
    solver, setup_s = build_flagship(SourceIterationSolver, problem,
                                     "flagship", bc_temps=WALL_BCS)
    check_k1_smem(solver, lr)
    rows = phase_kernel_vs_plain(solver, lr)
    dma_res, dma_launches, dma_errs = phase_dma(dma, bench_dma)
    best = dma_res["best"]
    all_b = rows[0]["bytes"]
    k1_gbs = all_b / (rows[0]["kernel_ms"] * 1e-3) / 1e9
    log(f"[smoke] K1 bucket 0 f32: {all_b} B in all in "
        f"{rows[0]['kernel_ms']:.3f} ms = {k1_gbs:.1f} GB/s, "
        f"{k1_gbs / best['gbs']:.3f} of the best copy rate "
        f"({best['name']}, {best['gbs']:.1f} GB/s), "
        f"{rows[0]['share_of_bound']:.3f} of the {rows[0]['bound_ms']:.3f} ms "
        f"bound, on {card}")

    launches, flag = phase_flagship(solver, lr, setup_s, "flagship")
    phase_windows_ab(
        solver, lambda: build_flagship(SourceIterationSolver, problem,
                                       "flagship, full slab",
                                       bc_temps=WALL_BCS),
        "flagship", flag)
    del solver
    torch.cuda.empty_cache()

    def build_film(name="diffuse-wall flagship"):
        return build_flagship(SourceIterationSolver, problem, name,
                              **DIFFUSE_WALLS)

    film, film_setup_s = build_film()
    film_launches, film_row = phase_flagship(film, lr, film_setup_s,
                                             "diffuse-wall flagship")
    phase_windows_ab(
        film, lambda: build_film("diffuse-wall flagship, full slab"),
        "diffuse-wall flagship", film_row)
    del film
    torch.cuda.empty_cache()

    golden_rel = phase_golden(SourceIterationSolver, unit_cube,
                              "torch_port_golden.npz")
    closure_rel = phase_golden(SourceIterationSolver, unit_cube,
                               "torch_port_golden_closures.npz")

    jax_mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib"))
    if jax_mods:
        raise RuntimeError(f"the port imported JAX: {jax_mods[:5]}")

    # the launch the flagship's step makes: bucket 0, f32, hull windows
    main_row = next(r for r in rows if r["windows"] and r["bucket"] == 0
                    and r["state"] == "f32" and not r["dirichlet"]
                    and not r["xsrc"])
    log(f"[smoke] summary: flagship {flag['ms_per_step']:.3f} ms/step, "
        f"{flag['dof_per_s']:.4g} DOF/s; diffuse-wall flagship "
        f"{film_row['ms_per_step']:.3f} ms/step, "
        f"{film_row['dof_per_s']:.4g} DOF/s; best copy {best['name']} "
        f"{best['gbs']:.1f} GB/s; golden rel {golden_rel:.3e}, closure "
        f"golden rel {closure_rel:.3e}; on {card}")

    def best_row(prefix):
        """The fastest row of a kernel: its paired median ms and the plain
        copy's median ms of the same rounds."""
        name = min((n for n in dma_res["ms"] if n.startswith(prefix)),
                   key=dma_res["ms"].get)
        return dma_res["ms"][name], dma_res["plain_ms"][name]

    auto_ms, auto_plain_ms = best_row("auto/")
    manual_ms, manual_plain_ms = best_row("manual/")
    # a copy moves each input byte once in and once out: 2 x the array
    copy_bound_ms = dma_res["bytes_per_call"] / lr.H100_BYTES_PER_S * 1e3

    log(json.dumps({"kernels": [
        {
            "name": "lattice_ring_sweep",
            "route": "cuda",
            "source": "pbte_tpu_torch/csrc/lattice_ring.cu",
            "replaces": "pbte_tpu/ops/lattice_ring.py:234",
            "launches": launches + film_launches,
            "max_abs_err": max(max(r["ys_abs"], r["ms_abs"])
                               for r in rows if r["state"] == "f32"),
            "ms": main_row["kernel_ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": None,
        },
        {
            "name": "dma_auto_copy",
            "route": "cuda",
            "source": "pbte_tpu_torch/csrc/dma_copy.cu",
            "replaces": "scripts/bench_pallas_dma.py:76",
            "launches": dma_launches["auto"],
            "max_abs_err": dma_errs["auto"],
            "ms": auto_ms,
            "plain_ms": auto_plain_ms,
            "bound_ms": copy_bound_ms,
            "bound_by": "bytes",
            "library_ms": auto_plain_ms,
        },
        {
            "name": "dma_manual_copy",
            "route": "cuda",
            "source": "pbte_tpu_torch/csrc/dma_copy.cu",
            "replaces": "scripts/bench_pallas_dma.py:140",
            "launches": dma_launches["manual"],
            "max_abs_err": dma_errs["manual"],
            "ms": manual_ms,
            "plain_ms": manual_plain_ms,
            "bound_ms": copy_bound_ms,
            "bound_by": "bytes",
            "library_ms": manual_plain_ms,
        },
    ]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
