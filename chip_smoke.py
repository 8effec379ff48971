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
   state type) with the share of it the kernel reaches;
4. the copy probe (python -m pbte_tpu_torch.bench_dma): every K2 and K3
   configuration held bit-exact (torch.equal) to its input at small and
   ragged totals (one vector, a block less 16 bytes, a block plus 16 bytes,
   fewer blocks than CTAs, many blocks and a ragged end), then at 512 MB
   f32 to its input and to the plain copy, then the probe's sweep (each row
   timed in turns with the plain copy) with the launch counts read around
   it; GB/s, the kernel/plain rate ratios, and K1's bucket-0 bytes/s as a
   share of the best copy rate;
5. the flagship (hex 16^3, p=2, 64 directions x 40 bands, f32): setup, 2
   warm-up + 30 timed steps, ms/step, element-ordinate DOF/s, peak memory,
   residuals, kernel launches; then 3 steps through the kernel and through
   the plain version from one state;
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
import pathlib
import sys
import time

import numpy as np
import torch

WARMUP_STEPS = 2
TIMED_STEPS = 30
TIMED_LAUNCHES = 10
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


def time_pair(fn_a, fn_b, n):
    """Mean CUDA-event ms of fn_a and fn_b, launched in turns after one
    warm-up each."""
    fn_a()
    fn_b()
    torch.cuda.synchronize()
    tot = [0.0, 0.0]
    for _ in range(n):
        for i, fn in enumerate((fn_a, fn_b)):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            tot[i] += e0.elapsed_time(e1)
    return tot[0] / n, tot[1] / n


def phase_kernel_vs_plain(solver, lr):
    """Kernel vs plain at the flagship bucket shapes; returns the result
    rows (bucket 0 f32 first)."""
    rng = np.random.default_rng(0)
    c = solver.consts
    L, D, W, BS = solver.L, solver.D, solver.W, solver.BS
    rows = []
    cases = [(0, "f32", False, False), (0, "bf16", False, False),
             (1, "f32", True, False), (1, "bf16", False, False),
             (0, "f32", False, True), (1, "f32", False, True)]
    for bi, state, dirichlet, closure in cases:
        cb = c["buckets"][bi]
        Gb, Km = cb["macro_w"].shape[:2]

        def rnd(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape, dtype=np.float32)).cuda()

        v = rnd(L, Gb, Km, BS, D, W)
        ttc = rnd(L, Gb, D, W)
        dsrc = rnd(L, Gb, Km, D, W) if dirichlet else None
        xsrc = None
        if closure:  # 40% of the slots read one of XSRC_ROWS random rows
            xmap = np.where(rng.random((L, Gb, W)) < 0.4,
                            rng.integers(0, XSRC_ROWS, (L, Gb, W)), -1)
            xsrc = lr.ClosureSource(
                torch.from_numpy(xmap.astype(np.int32)).cuda(),
                rnd(Gb, XSRC_ROWS, Km, BS, D))
        cast = state == "bf16"
        if cast:
            v = v.to(torch.bfloat16)
        args = (v, ttc, cb["bsrc0"], cb["cin"], cb["bcat"], cb["macro_w"],
                c["wvec"])
        kw = dict(shifts=solver.shifts, dsrc=dsrc, xsrc=xsrc, cast_bf16=cast)
        ys, ms = lr.lattice_ring_sweep(*args, **kw)
        torch.cuda.synchronize()
        ys_r, ms_r = lr.lattice_ring_sweep_ref(*args, **kw)
        torch.cuda.synchronize()
        if not (torch.isfinite(ys.float()).all() and torch.isfinite(ms).all()):
            raise RuntimeError(f"bucket {bi} {state}: non-finite kernel output")
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
        del ys, ms, ys_r, ms_r
        k_ms, p_ms = time_pair(
            lambda: lr.lattice_ring_sweep(*args, **kw),
            lambda: lr.lattice_ring_sweep_ref(*args, **kw),
            TIMED_LAUNCHES,
        )
        nf = len(solver.shifts)
        nbytes, flop = lr.sweep_cost(v, nf, dsrc, xsrc)
        bound_ms, bound_by = lr.sweep_bound_ms(v, nf, dsrc, xsrc)
        row = dict(bucket=bi, shape=list(v.shape), state=state,
                   dirichlet=dirichlet, xsrc=closure, ys_rel=ys_rel,
                   ys_abs=ys_abs,
                   ys_ulps_of_max=ys_ulps, ms_rel=ms_rel, ms_abs=ms_abs,
                   tolerance=tol, kernel_ms=k_ms, plain_ms=p_ms,
                   bytes=nbytes, flop=flop, bound_ms=bound_ms,
                   bound_by=bound_by, share_of_bound=bound_ms / k_ms, ok=ok)
        log("[smoke] kernel vs plain " + json.dumps(row))
        log(f"[smoke] K1 bucket {bi} {state}"
            f"{' dirichlet' if dirichlet else ''}"
            f"{' closure' if closure else ''}: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
            f"{nbytes / 1e9:.3f} GB, {flop / 1e9:.1f} Gflop), "
            f"{bound_ms / k_ms:.3f} of the bound")
        if not ok:
            raise RuntimeError(f"kernel disagrees with the plain version: {row}")
        rows.append(row)
        del v, ttc, dsrc, xsrc, args
        torch.cuda.empty_cache()
    return rows


def check_k1_smem(solver, lr):
    """The wrapper's shared-memory check (lr.kernel_smem_bytes) against the
    kernel's own carve-up, at the flagship's shapes in both modes."""
    lib = lr._lib()
    W, D, nf = solver.W, solver.D, len(solver.shifts)
    for cast in (0, 1):
        got = lib.pbte_lattice_ring_smem_bytes(cast, D, W, nf)
        want = lr.kernel_smem_bytes(D, W, nf, bool(cast))
        if got != want:
            raise RuntimeError(f"K1 shared memory: the kernel takes {got} B, "
                               f"the wrapper checks {want} B (cast={cast})")
    log(f"[smoke] K1 shared memory per CTA at D={D} W={W}: f32 "
        f"{lr.kernel_smem_bytes(D, W, nf, False)} B, bf16 "
        f"{lr.kernel_smem_bytes(D, W, nf, True)} B")


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
        f"{[(list(map(int, g)), k) for g, k in solver._ring_buckets]}")
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
    film, film_setup_s = build_flagship(
        SourceIterationSolver, problem, "diffuse-wall flagship",
        **DIFFUSE_WALLS)
    film_launches, film_row = phase_flagship(film, lr, film_setup_s,
                                             "diffuse-wall flagship")
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

    main_row = rows[0]
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
