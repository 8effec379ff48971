"""GPU smoke run of pbte_tpu_torch: build the CUDA kernel, hold it to its
plain PyTorch version at the flagship's shapes, run the flagship source
iteration through it, and check the result against the pbte_tpu golden.

Usage (from the root of a checkout, on a machine with one CUDA GPU):

    python3 chip_smoke.py

Phases (a failing phase raises and the script exits non-zero):

1. versions, the device and its power limit (no GPU: exit 1);
2. nvcc build of pbte_tpu_torch/csrc/lattice_ring.cu, with the ptxas
   register / shared-memory report;
3. kernel vs plain version at the flagship's two Km-bucket shapes, with the
   solver's real operators and seeded random state, for f32 state, bf16
   state and a Dirichlet source: errors and CUDA-event times;
4. the flagship (hex 16^3, p=2, 64 directions x 40 bands, f32): setup, 2
   warm-up + 30 timed steps, ms/step, element-ordinate DOF/s, peak memory,
   residuals, kernel launches; then 3 steps through the kernel and through
   the plain version from one state;
5. the golden Tc of pbte_tpu's Pallas path (tests/data/torch_port_golden.npz)
   against the port on the GPU.

The line before the last is {"kernels": [...]}, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

WARMUP_STEPS = 2
TIMED_STEPS = 30
TIMED_LAUNCHES = 10
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


def nvidia_smi_name_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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
    cases = [(0, "f32", False), (0, "bf16", False), (1, "f32", True),
             (1, "bf16", False)]
    for bi, state, dirichlet in cases:
        cb = c["buckets"][bi]
        Gb, Km = cb["macro_w"].shape[:2]

        def rnd(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape, dtype=np.float32)).cuda()

        v = rnd(L, Gb, Km, BS, D, W)
        ttc = rnd(L, Gb, D, W)
        dsrc = rnd(L, Gb, Km, D, W) if dirichlet else None
        cast = state == "bf16"
        if cast:
            v = v.to(torch.bfloat16)
        args = (v, ttc, cb["bsrc0"], cb["cin"], cb["bcat"], cb["macro_w"],
                c["wvec"])
        kw = dict(shifts=solver.shifts, dsrc=dsrc, cast_bf16=cast)
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
        row = dict(bucket=bi, shape=list(v.shape), state=state,
                   dirichlet=dirichlet, ys_rel=ys_rel, ys_abs=ys_abs,
                   ys_ulps_of_max=ys_ulps, ms_rel=ms_rel, ms_abs=ms_abs,
                   tolerance=tol, kernel_ms=k_ms, plain_ms=p_ms, ok=ok)
        log("[smoke] kernel vs plain " + json.dumps(row))
        if not ok:
            raise RuntimeError(f"kernel disagrees with the plain version: {row}")
        rows.append(row)
        del v, ttc, dsrc, args
        torch.cuda.empty_cache()
    return rows


def phase_flagship(solver, lr, setup_s):
    """Time the flagship step through the kernel; returns (launches, row)."""
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
    log("[smoke] flagship " + json.dumps(row))
    if launches != want:
        raise RuntimeError(f"{launches} kernel launches, want {want}")
    if Tc.shape != (ne, D) or not torch.isfinite(Tc).all():
        raise RuntimeError("flagship Tc is not finite of shape (ne, D)")
    if not (np.all(np.isfinite(res)) and res[-1] < res[0]):
        raise RuntimeError(f"residuals not finite and falling: {res}")

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
    log(f"[smoke] flagship 3 steps kernel vs plain: Tc rel {tc_rel:.3e} "
        f"(abs {tc_abs:.3e}), tolerance {F32_RTOL}")
    if not tc_rel <= F32_RTOL:
        raise RuntimeError("flagship Tc: kernel disagrees with plain version")
    row["tc_kernel_vs_plain_rel"] = tc_rel
    return launches, row


def phase_golden(SourceIterationSolver, unit_cube):
    """The port on the GPU against pbte_tpu's Pallas-path golden Tc."""
    golden = pathlib.Path(__file__).resolve().parent / "tests" / "data"
    with np.load(golden / "torch_port_golden.npz") as d:
        params = {k: int(d[k]) for k in
                  ("nx", "ny", "nz", "order", "polar", "azimuth", "nspec")}
        bcs = dict(zip(d["bc_attrs"].tolist(), d["bc_temps"].tolist()))
        ref = torch.from_numpy(d["Tc"][-1]).cuda()
        steps = int(d["steps"])
    s = SourceIterationSolver(*unit_cube(**params), bcs, device="cuda")
    r = s.solve(tol=0, max_iter=steps, verbose=False)
    rel, ab = rel_err(r.Tc, ref)
    log(f"[smoke] golden {params} {steps} steps: Tc rel {rel:.3e} "
        f"(abs {ab:.3e}), tolerance {GOLDEN_RTOL}")
    if not rel <= GOLDEN_RTOL:
        raise RuntimeError("GPU Tc disagrees with the pbte_tpu golden")
    return rel


def main() -> int:
    if not torch.cuda.is_available():
        log("[smoke] no CUDA device: this check runs on a GPU only")
        return 1
    from pbte_tpu_torch.ops import _build
    from pbte_tpu_torch.ops import lattice_ring as lr
    from pbte_tpu_torch.problem import FLAGSHIP, WALL_BCS, unit_cube
    from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

    kind = torch.cuda.get_device_name(0)
    log(f"[smoke] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()}")
    card = nvidia_smi_name_power()
    log(f"[smoke] nvidia-smi: {card}")

    t0 = time.perf_counter()
    built = _build.load("lattice_ring")
    log(f"[smoke] built {built.path.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {built.seconds:.1f} s)")
    log(built.log.strip())

    t0 = time.perf_counter()
    solver = SourceIterationSolver(*unit_cube(**FLAGSHIP), WALL_BCS,
                                   device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"[smoke] flagship setup {setup_s:.1f} s: G={solver.G} L={solver.L} "
        f"W={solver.W} shifts={solver.shifts} buckets="
        f"{[(list(map(int, g)), k) for g, k in solver._ring_buckets]}")

    rows = phase_kernel_vs_plain(solver, lr)
    launches, flag = phase_flagship(solver, lr, setup_s)
    golden_rel = phase_golden(SourceIterationSolver, unit_cube)

    jax_mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib"))
    if jax_mods:
        raise RuntimeError(f"the port imported JAX: {jax_mods[:5]}")

    main_row = rows[0]
    log(f"[smoke] summary: {flag['ms_per_step']:.3f} ms/step, "
        f"{flag['dof_per_s']:.4g} DOF/s, golden rel {golden_rel:.3e}, "
        f"on {card}")
    log(json.dumps({"kernels": [{
        "name": "lattice_ring_sweep",
        "route": "cuda",
        "source": "pbte_tpu_torch/csrc/lattice_ring.cu",
        "replaces": "pbte_tpu/ops/lattice_ring.py:234",
        "launches": launches,
        "max_abs_err": max(main_row["ys_abs"], main_row["ms_abs"]),
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
