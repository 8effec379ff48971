"""GPU smoke run of pbte_tpu_torch: build the CUDA kernels, hold each to its
plain PyTorch version at the shapes its path gives it, run the flagship
source iteration (isothermal walls, diffuse walls, bf16 state, and in
float64 through the BiCGStab-accelerated solve) and the copy probe through
them, and check the results against the pbte_tpu goldens.

Usage (from the root of a checkout, on a machine with one CUDA GPU):

    python3 chip_smoke.py

Phases (a failing phase raises and the script exits non-zero):

1. versions, the device and its power limit (no GPU: exit 1);
2. nvcc builds of pbte_tpu_torch/csrc/lattice_ring.cu (K1) and
   csrc/dma_copy.cu (K2, K3), concurrently, with the ptxas register /
   shared-memory reports of every kernel;
3. K1 vs plain version at the flagship's two Km-bucket shapes, with the
   solver's real operators and seeded random state, for f32 state, bf16
   state, f64 state (the float64 kernel, with the operators in float64), a
   Dirichlet source and a random sparse lagged closure source:
   errors, CUDA-event times, and each launch's bound (the larger of its
   bytes over 3.35 TB/s and its flop over the tensor-core peak of its
   state type) with the share of it the kernel reaches. Then the same with
   the flagship's hull windows (the solver's default), the random inputs
   zeroed outside the windows as the windows' contract asks: the windowed
   kernel is held to the windowed plain version at the same tolerances and
   to the full-slab kernel on the same inputs (ys bit for bit, ms to 1e-6
   of max: its atomics add in another order), timed in turns with it, and
   both bounds are printed (full slab; in-window slots only); the
   wrapper's shared-memory sizes against the library's, in all three types;
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
   from one state;
6. the same flagship as a film: x faces isothermal, the other four diffuse
   (the lagged closure through K1's xsrc), measured as phase 5; then the
   flagship with bf16 state (PBTE_RING_STATE_BF16=1), the same way;
7. the golden Tc of pbte_tpu's Pallas path (tests/data/torch_port_golden.npz)
   and of its XLA ring with periodic, diffuse and specular walls
   (tests/data/torch_port_golden_closures.npz) against the port on the GPU,
   and the float64 BiCGStab golden of its XLA ring
   (tests/data/torch_port_golden_accel.npz) against the port's float64
   kernel path;
8. the f64 flagship (the f32 solvers freed first, so the peak is its own):
   set-up, 2 + 30 timed steps and 3 steps kernel vs plain as phase 5; then
   solve(accelerate="bicgstab", tol=1e-8) with its K1 launches (2 per step
   application: nothing fell back to the plain version), wall time, linear
   relres, Tv residual and peak memory; the plain f64 solve to the same Tv
   residual, its steps, seconds and Tc against the accelerated one; and
   refined_solve with the f32 flagship solver as the base and the f64
   solver's step as the defect step: the defect before and after one round,
   the correction steps, and the bound ||d(x_ref)|| / (1 - rho) with rho
   the plain solve's rate over its last steps.

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
# f64 state, kernel vs plain: both sum in float64 in another order (and ms
# by atomics in run-to-run order)
F64_RTOL = 1e-12
# the f64 BiCGStab golden: pbte_tpu's XLA ring and the kernel sum in another
# order, and the recurrence carries that on (1e-14 between pbte_tpu and the
# port on the CPU at this cap)
ACCEL_GOLDEN_RTOL = 1e-9
ACCEL_TOL = 1e-8  # linear relative residual of the f64 flagship solve
ACCEL_MAX_ITER = 1500
# the residual is read every 10 BiCGStab iterations: the stagnation guard
# then stops only after 120 step applications without a 10% gain. At the
# flagship the f64 relres plateaus near 1e-3 for 30-60 of them, and where a
# run crosses such a plateau depends on the order of the ms atomics: a run
# reading every iteration (check_every=2) stopped there at 1.06e-3
# (measured on an H100), two others went on to 1e-8
ACCEL_CHECK_EVERY = 20
# the plain f64 solve to the accelerated solve's Tv residual: it contracts
# by ~0.9925 a step at the flagship, so ~2100 steps (1500 reached 6.2e-8 of
# the 7.6e-10 asked for, measured on an H100)
PLAIN_MAX_ITER = 3000
ACCEL_PEAK_LIMIT = 75e9  # bytes of device memory the f64 solve may reach
# the accelerated and the plain f64 solve to the same Tv residual
ACCEL_TC_RTOL = 1e-5
REFINE_GAIN = 100.0  # least fall of the f64 defect in one refinement round


def log(*a):
    print(*a, flush=True)


def rel_err(got, ref):
    """max|got - ref| / max|ref|, and max|got - ref| (in float64 where
    either is float64)."""
    dt = (torch.float64 if torch.float64 in (got.dtype, ref.dtype)
          else torch.float32)
    d = (got.to(dt) - ref.to(dt)).abs().max().item()
    return d / max(ref.to(dt).abs().max().item(), 1e-300), d


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
       for bi in (0, 1) for state in ("f32", "bf16", "f64")
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
        f64 = state == "f64"
        np_dt = np.float64 if f64 else np.float32

        def rnd(*shape):
            """Seeded normal values of a slab-shaped operand (L first, W
            last), zero outside the windows in a windowed case."""
            t = torch.from_numpy(
                rng.standard_normal(shape, dtype=np_dt)).cuda()
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
        ops = [cb["bsrc0"], cb["cin"], cb["bcat"], cb["macro_w"], c["wvec"]]
        if f64:  # the float64 kernel takes float64 operators
            ops = [t.double() for t in ops]
        args = (v, ttc, *ops)
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
        elif f64:
            ys_ulps = None
            ok = ys_rel <= F64_RTOL and ms_rel <= F64_RTOL
            tol = f"ys, ms rel <= {F64_RTOL}"
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
    kernels' own carve-ups, at the flagship's shapes in all three types."""
    lib = lr._lib()
    W, D, nf, L = solver.W, solver.D, len(solver.shifts), solver.L
    got = {torch.float32: lib.pbte_lattice_ring_smem_bytes(0, D, W, nf, L),
           torch.bfloat16: lib.pbte_lattice_ring_smem_bytes(1, D, W, nf, L),
           torch.float64: lib.pbte_lattice_ring_smem_bytes_f64(D, W, nf, L)}
    for state, n in got.items():
        want = lr.kernel_smem_bytes(D, W, nf, state, L)
        if n != want:
            raise RuntimeError(f"K1 shared memory: the kernel takes {n} B, "
                               f"the wrapper checks {want} B ({state})")
    log(f"[smoke] K1 shared memory per CTA at D={D} W={W}: "
        + ", ".join(f"{str(k).split('.')[-1]} {v} B" for k, v in got.items()))


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


STATE_KEYS = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float64: "f64"}


def phase_flagship(solver, lr, setup_s, name):
    """Time a flagship step through the kernel; returns (launches of the
    solver's state type, row)."""
    key = STATE_KEYS[solver.state_dtype]
    torch.cuda.reset_peak_memory_stats()
    u, Tc, Tv = solver.initial_state()
    lr.reset_launches()
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
    launches = lr.lattice_ring_sweep.launches_by_state[key]
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
    if launches != want or lr.lattice_ring_sweep.launches != want:
        raise RuntimeError(f"{name}: {lr.lattice_ring_sweep.launches_by_state}"
                           f" kernel launches, want {want} {key}")
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
    # bf16 state: a sum next to a bf16 rounding boundary rounds the other
    # way on one side and the steps carry it on
    tol = {"f32": F32_RTOL, "bf16": BF16_MS_RTOL, "f64": F64_RTOL}[key]
    log(f"[smoke] {name} 3 steps kernel vs plain: Tc rel {tc_rel:.3e} "
        f"(abs {tc_abs:.3e}), tolerance {tol}")
    if not tc_rel <= tol:
        raise RuntimeError(f"{name} Tc: kernel disagrees with plain version")
    row["tc_kernel_vs_plain_rel"] = tc_rel
    return launches, row


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


def phase_accel_golden(SourceIterationSolver, unit_cube, lr):
    """The port's float64 BiCGStab solve through the f64 kernel against
    pbte_tpu's float64 XLA ring (tests/data/torch_port_golden_accel.npz):
    Tc and Tv, the step count and the Tv residual."""
    golden = pathlib.Path(__file__).resolve().parent / "tests" / "data"
    with np.load(golden / "torch_port_golden_accel.npz") as d:
        params = {k: int(d[k]) for k in PARAM_KEYS}
        bcs = dict(zip(d["bc_attrs"].tolist(), d["bc_temps"].tolist()))
        ref = {k: torch.from_numpy(d[k]).cuda() for k in ("Tc", "Tv")}
        steps, max_iter = int(d["iterations"]), int(d["max_iter"])
        ref_res = float(d["residual"])
    s = SourceIterationSolver(*unit_cube(**params), bcs, device="cuda",
                              dtype=torch.float64)
    lr.reset_launches()
    r = s.solve(tol=0, max_iter=max_iter, verbose=False,
                accelerate="bicgstab")
    n_f64 = lr.lattice_ring_sweep.launches_by_state["f64"]
    tc_rel, tc_abs = rel_err(r.Tc, ref["Tc"])
    tv_rel, _ = rel_err(r.Tv, ref["Tv"])
    res_rel = abs(r.residual - ref_res) / ref_res
    log(f"[smoke] golden torch_port_golden_accel.npz {params} f64 bicgstab "
        f"max_iter={max_iter}: {r.iterations} step applications (golden "
        f"{steps}), {n_f64} f64 kernel launches, Tc rel {tc_rel:.3e} (abs "
        f"{tc_abs:.3e}), Tv rel {tv_rel:.3e}, Tv residual rel "
        f"{res_rel:.3e}, tolerance {ACCEL_GOLDEN_RTOL}")
    if not (r.iterations == steps
            and n_f64 == len(s.consts["buckets"]) * steps
            and max(tc_rel, tv_rel, res_rel) <= ACCEL_GOLDEN_RTOL):
        raise RuntimeError("the GPU's f64 BiCGStab solve disagrees with the "
                           "pbte_tpu golden")
    return tc_rel


def tree_norm(tree):
    """sqrt of the sum of squares over the leaves of a state tree."""
    from pbte_tpu_torch.solver.accel import tree_dot

    return float(torch.sqrt(tree_dot(tree, tree)))


def phase_f64_flagship(SourceIterationSolver, problem, lr, walls):
    """The f64 flagship: timed steps, the accelerated solve, the plain solve
    to the same Tv residual, and refined_solve on an f32 base. Returns
    (f64 kernel launches of the phase, row)."""
    from pbte_tpu_torch.solver import accel

    s64, setup_s = build_flagship(SourceIterationSolver, problem,
                                  "f64 flagship", dtype=torch.float64,
                                  **walls)
    launches, row = phase_flagship(s64, lr, setup_s, "f64 flagship")
    torch.cuda.empty_cache()

    # the accelerated solve
    torch.cuda.reset_peak_memory_stats()
    lr.reset_launches()
    relres = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = s64.solve(tol=ACCEL_TOL, max_iter=ACCEL_MAX_ITER, verbose=False,
                    check_every=ACCEL_CHECK_EVERY, accelerate="bicgstab",
                    callback=lambda nmv, res: relres.append(res))
    torch.cuda.synchronize()
    acc_s = time.perf_counter() - t0
    acc_peak = torch.cuda.max_memory_allocated()
    acc_launches = lr.lattice_ring_sweep.launches_by_state["f64"]
    launches += acc_launches
    nb = len(s64.consts["buckets"])
    row.update(bicgstab=dict(
        step_applications=acc.iterations, wall_s=acc_s,
        ms_per_step_application=acc_s / acc.iterations * 1e3,
        linear_relres=relres[-1], tv_residual=acc.residual,
        max_memory_allocated=acc_peak, k1_launches=acc_launches))
    log(f"[smoke] f64 flagship bicgstab: {acc.iterations} step applications "
        f"in {acc_s:.2f} s ({acc_s / acc.iterations * 1e3:.2f} ms each), "
        f"linear relres {relres[-1]:.3e}, Tv residual {acc.residual:.3e}, "
        f"peak {acc_peak / 1e9:.2f} GB, K1 f64 launches {acc_launches} "
        f"(want {nb} x {acc.iterations}); relres every read: "
        f"{[float(f'{x:.3e}') for x in relres]}")
    if acc_launches != nb * acc.iterations or lr.lattice_ring_sweep.launches \
            != acc_launches:
        raise RuntimeError("the accelerated solve did not run every step "
                           "through the f64 kernel")
    if not (relres[-1] <= ACCEL_TOL and acc_peak < ACCEL_PEAK_LIMIT
            and torch.isfinite(acc.Tc).all()):
        raise RuntimeError(f"the accelerated f64 solve: {row['bicgstab']}")
    Tc_acc = acc.Tc
    del acc
    torch.cuda.empty_cache()

    # the plain solve to the same Tv residual
    lr.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    tv_res = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = s64.solve(tol=row["bicgstab"]["tv_residual"],
                      max_iter=PLAIN_MAX_ITER, verbose=False,
                      callback=lambda it, res: tv_res.append(res))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    launches += lr.lattice_ring_sweep.launches_by_state["f64"]
    tc_rel, _ = rel_err(Tc_acc, plain.Tc)
    # the plain iteration's rate over its last 100 steps (the slowest mode)
    n = min(100, len(tv_res) - 1)
    rho = (tv_res[-1] / tv_res[-1 - n]) ** (1.0 / n)
    row.update(plain=dict(
        steps=plain.iterations, wall_s=plain_s, tv_residual=plain.residual,
        max_memory_allocated=torch.cuda.max_memory_allocated(), rate=rho,
        tc_vs_bicgstab_rel=tc_rel))
    ratio = plain.iterations / row["bicgstab"]["step_applications"]
    log(f"[smoke] f64 flagship plain solve to Tv residual "
        f"{row['bicgstab']['tv_residual']:.3e}: {plain.iterations} steps in "
        f"{plain_s:.2f} s (residual {plain.residual:.3e}), {ratio:.2f}x the "
        f"accelerated step applications, {plain_s / acc_s:.2f}x its wall "
        f"time; rate over the last {n} steps {rho:.5f}; Tc accelerated vs "
        f"plain rel {tc_rel:.3e}, tolerance {ACCEL_TC_RTOL}")
    if not (ratio >= 3 and tc_rel <= ACCEL_TC_RTOL
            and plain.residual < row["bicgstab"]["tv_residual"]):
        raise RuntimeError(f"accelerated vs plain f64: {row['plain']}")
    del plain
    torch.cuda.empty_cache()

    # iterative refinement of an f32 solve with the f64 defect step
    s32, _ = build_flagship(SourceIterationSolver, problem, "f32 base",
                            **walls)
    lr.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = accel.refined_solve(s32, s64.step, tol=1e-7, max_iter=3000,
                              inner_tol=1e-4, inner_max_iter=2000,
                              verbose=False, check_every=10)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    launches += lr.lattice_ring_sweep.launches_by_state["f64"]
    x_ref = (out["u_refined"], out["Tc_refined"])
    Tv0 = torch.zeros((s64.ne,), dtype=torch.float64, device=s64.device)
    u_p, Tc_p, _, _ = s64.step(*x_ref, Tv0)
    launches += nb
    d_after = tree_norm(tuple(a.sub_(b) for a, b in zip(u_p, x_ref[0]))
                        + (Tc_p - x_ref[1],))
    del u_p, Tc_p
    gain = out["defect_norm"] / d_after
    base_rel, _ = rel_err(out["base_result"].Tc, Tc_acc)
    ref_rel, _ = rel_err(out["Tc_refined"], Tc_acc)
    row.update(refined=dict(
        base_steps=out["base_result"].iterations, wall_s=ref_s,
        defect_before=out["defect_norm"], defect_after=d_after, gain=gain,
        correction_steps=out["correction_steps"],
        correction_relres=out["correction_relres"],
        certified_bound=d_after / (1.0 - rho),
        tc_base_vs_bicgstab_rel=base_rel,
        tc_refined_vs_bicgstab_rel=ref_rel,
        max_memory_allocated=torch.cuda.max_memory_allocated()))
    log(f"[smoke] f64 refined_solve (f32 base): "
        f"{out['base_result'].iterations} base steps, defect "
        f"{out['defect_norm']:.3e} -> {d_after:.3e} ({gain:.1f}x) after "
        f"{out['correction_steps']} correction steps (relres "
        f"{out['correction_relres']:.2e}), bound ||d||/(1-rho) "
        f"{d_after / (1.0 - rho):.3e}; Tc vs the accelerated f64 solve: "
        f"base {base_rel:.3e}, refined {ref_rel:.3e}; {ref_s:.2f} s")
    if not gain >= REFINE_GAIN:
        raise RuntimeError(f"refined_solve: the defect fell {gain:.1f}x, "
                           f"want >= {REFINE_GAIN}")
    del out, x_ref, s32, s64
    torch.cuda.empty_cache()
    log(f"[smoke] f64 flagship " + json.dumps(row))
    return launches, row


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
    del solver
    torch.cuda.empty_cache()

    film, film_setup_s = build_flagship(SourceIterationSolver, problem,
                                        "diffuse-wall flagship",
                                        **DIFFUSE_WALLS)
    film_launches, film_row = phase_flagship(film, lr, film_setup_s,
                                             "diffuse-wall flagship")
    del film
    torch.cuda.empty_cache()

    os.environ["PBTE_RING_STATE_BF16"] = "1"
    try:
        bf16, bf16_setup_s = build_flagship(
            SourceIterationSolver, problem, "bf16-state flagship",
            bc_temps=WALL_BCS)
    finally:
        del os.environ["PBTE_RING_STATE_BF16"]
    bf16_launches, bf16_row = phase_flagship(bf16, lr, bf16_setup_s,
                                             "bf16-state flagship")
    del bf16
    torch.cuda.empty_cache()

    golden_rel = phase_golden(SourceIterationSolver, unit_cube,
                              "torch_port_golden.npz")
    closure_rel = phase_golden(SourceIterationSolver, unit_cube,
                               "torch_port_golden_closures.npz")
    accel_rel = phase_accel_golden(SourceIterationSolver, unit_cube, lr)

    f64_launches, f64_row = phase_f64_flagship(
        SourceIterationSolver, problem, lr, dict(bc_temps=WALL_BCS))

    jax_mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib"))
    if jax_mods:
        raise RuntimeError(f"the port imported JAX: {jax_mods[:5]}")

    # the launch the flagship's step makes: bucket 0, hull windows (f32 with
    # no source; bf16 and f64 with the Dirichlet source, the case measured
    # with windows in those types)
    def main_row(state):
        return next(r for r in rows if r["windows"] and r["bucket"] == 0
                    and r["state"] == state and not r["xsrc"]
                    and r["dirichlet"] == (state != "f32"))

    acc = f64_row["bicgstab"]
    log(f"[smoke] summary: flagship {flag['ms_per_step']:.3f} ms/step, "
        f"{flag['dof_per_s']:.4g} DOF/s; diffuse-wall flagship "
        f"{film_row['ms_per_step']:.3f} ms/step, "
        f"{film_row['dof_per_s']:.4g} DOF/s; bf16 state "
        f"{bf16_row['ms_per_step']:.3f} ms/step; f64 "
        f"{f64_row['ms_per_step']:.3f} ms/step, bicgstab "
        f"{acc['step_applications']} step applications in "
        f"{acc['wall_s']:.2f} s against {f64_row['plain']['steps']} plain "
        f"steps in {f64_row['plain']['wall_s']:.2f} s, peak "
        f"{acc['max_memory_allocated'] / 1e9:.2f} GB; refined defect "
        f"{f64_row['refined']['gain']:.1f}x; best copy {best['name']} "
        f"{best['gbs']:.1f} GB/s; golden rel {golden_rel:.3e}, closure "
        f"golden rel {closure_rel:.3e}, f64 bicgstab golden rel "
        f"{accel_rel:.3e}; on {card}")

    def k1_entry(name, state, n):
        r = main_row(state)
        return {
            "name": name,
            "route": "cuda",
            "source": "pbte_tpu_torch/csrc/lattice_ring.cu",
            "replaces": "pbte_tpu/ops/lattice_ring.py:234",
            "launches": n,
            "max_abs_err": max(max(x["ys_abs"], x["ms_abs"])
                               for x in rows if x["state"] == state),
            "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
        }

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
        k1_entry("lattice_ring_sweep", "f32", launches + film_launches),
        k1_entry("lattice_ring_sweep_bf16", "bf16", bf16_launches),
        k1_entry("lattice_ring_sweep_f64", "f64", f64_launches),
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
