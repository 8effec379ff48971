"""pbte_tpu_torch's SourceIterationSolver against pbte_tpu's, on the
lattice-ring path: constructor, one step through the consts bridge, the
whole slice, the committed golden, the gate, and the no-JAX import."""

import functools
import inspect
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_golden
from pbte_tpu import mesh as pmesh
from pbte_tpu.fem import assembly
from pbte_tpu.solver.source_iteration import SourceIterationSolver as JaxSolver
from pbte_tpu_torch.convert import consts_from_numpy, state_from_numpy
from pbte_tpu_torch.ops import lattice_ring as tlr
from pbte_tpu_torch.problem import SQUARE_BCS, WALL_BCS, unit_cube, \
    unit_square
from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

REPO = pathlib.Path(__file__).resolve().parents[1]
DIRICHLET = dict(dirichlet_bcs={6: 0.25})
DIRICHLET_WALLS = {a: -0.5 for a in range(1, 6)}
# (nx, ny, nz, order, azimuth): the 9x8x8 lattice makes x the major axis
# (a shift-axis mix-up shows there); azimuth 8 splits the octants into two
# Km buckets (3 and 1 slots)
CASES = {
    "9x8x8_p1": (9, 8, 8, 1, 4),
    "8x8x8_p2": (8, 8, 8, 2, 4),
    "8x8x8_p1_two_buckets": (8, 8, 8, 1, 8),
    "8x8x8_p1": (8, 8, 8, 1, 4),
}


@pytest.fixture(autouse=True)
def _cpu_float_env():
    """One thread, and f32 subnormals flushed to zero as XLA's CPU backend
    flushes them. The mass-transformed state v = M^T u of a micron-scale
    mesh sits near the f32 subnormal range (~1e-32 at p=2), so with
    gradual underflow the port lands closer to the float64 answer than
    pbte_tpu does (measured at 8^3 p=2: 1.2e-7 vs 1.6e-6 in Tc of scale
    0.42) and the two f32 results differ by more than rounding order;
    with the same float environment they agree to 2e-7."""
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _problem(case, build=unit_cube):
    """The case's problem from the port's host layers, or from pbte_tpu's
    with build=torch_golden.jax_unit_cube."""
    nx, ny, nz, order, az = CASES[case]
    return build(nx, ny, nz, order=order, polar=2, azimuth=az, nspec=2)


def _pair(case, dirichlet=False, dtype=np.float32, pallas="on"):
    """pbte_tpu's solver on pbte_tpu's problem, the port's on its own."""
    bcs, kw = (DIRICHLET_WALLS, DIRICHLET) if dirichlet else (WALL_BCS, {})
    f32 = dtype == np.float32
    js = JaxSolver(*_problem(case, torch_golden.jax_unit_cube), bcs,
                   dtype=jnp.float32 if f32 else jnp.float64,
                   use_pallas=pallas, **kw)
    ts = SourceIterationSolver(
        *_problem(case), bcs, dtype=torch.float32 if f32 else torch.float64,
        device="cpu", **kw)
    if pallas == "on":
        assert js._use_pallas_ring and js._pallas_interpret
    return js, ts


def _np(t):
    return t.detach().double().numpy()


def _assert_tc(got, want, dirichlet):
    """Tc tolerances of tests/test_pallas_ring.py: elementwise for the
    isothermal walls (:57-58), norm-wise for the Dirichlet wall (:86-88),
    whose Tc spans two decades more."""
    want = np.asarray(want, dtype=np.float64)
    if dirichlet:
        got = np.asarray(got, dtype=np.float64)
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=5e-7)


@pytest.mark.parametrize("case,dirichlet", [
    ("9x8x8_p1", False), ("8x8x8_p2", False),
    ("8x8x8_p1_two_buckets", False), ("9x8x8_p1", True),
])
def test_constructor_parity(case, dirichlet):
    """Every const of the kernel path, built without JAX, matches the JAX
    solver's (both are float64 host math cast to float32)."""
    js, ts = _pair(case, dirichlet)
    assert (ts.G, ts.L, ts.W, ts.Km, ts.shifts) == (
        js.G, js.L, js.W, js.Km, js._ring_shift_vals)
    assert [(list(g), k) for g, k in ts._ring_buckets] == [
        (list(g), k) for g, k in js._ring_buckets]
    want = consts_from_numpy(jax.tree.map(np.asarray, js.consts),
                             device="cpu")
    got = ts.consts
    assert got.keys() == want.keys()
    for key in got:
        if key == "buckets":
            continue
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), rtol=1e-6,
                                   atol=1e-6 * float(want[key].abs().max()),
                                   err_msg=key)
    assert len(got["buckets"]) == len(want["buckets"])
    for gb, wb in zip(got["buckets"], want["buckets"]):
        assert gb.keys() == wb.keys()
        assert ("dsrc0" in gb) == dirichlet
        for key in gb:
            np.testing.assert_allclose(_np(gb[key]), _np(wb[key]), rtol=1e-6,
                                       atol=1e-6 * float(wb[key].abs().max()),
                                       err_msg=key)


@pytest.mark.parametrize("case,dirichlet", [
    ("9x8x8_p1", False), ("8x8x8_p2", False),
    ("8x8x8_p1_two_buckets", False), ("8x8x8_p1", True),
])
def test_step_parity_through_bridge(case, dirichlet):
    """The JAX Pallas-interpret step and the port's step, fed the same
    operators (consts_from_numpy) and the same state each step, over 4
    steps; tolerances as tests/test_pallas_ring.py."""
    js, ts = _pair(case, dirichlet)
    ts.consts = consts_from_numpy(jax.tree.map(np.asarray, js.consts),
                                  device="cpu")
    u, Tc, Tv = js.initial_state()
    for _ in range(4):
        ut, Tct, Tvt = state_from_numpy(u, Tc, Tv, device="cpu")
        u, Tc, Tv, r = js.step(u, Tc, Tv)
        ut, Tct, Tvt, rt = ts.step(ut, Tct, Tvt)
        _assert_tc(Tct.numpy(), Tc, dirichlet)
        np.testing.assert_allclose(float(rt), float(r), rtol=1e-3)
    if not dirichlet:
        np.testing.assert_allclose(ts.u_by_direction(ut),
                                   js.u_by_direction(u), rtol=2e-5, atol=5e-7)


def test_bf16_state_step_through_bridge(monkeypatch):
    """bf16 state: pbte_tpu's kernel path (bf16 state forced on the
    interpreter, as tests/test_pallas_ring.py does) and the port with
    PBTE_RING_STATE_BF16=1 round the same f32 sums to bf16; Tc agrees to
    1e-5 of its scale over 4 steps from the same state (measured 6.2e-7:
    a sum that lands next to a bf16 rounding boundary can round the other
    way on one side, one bf16 ulp of one state entry)."""
    monkeypatch.setenv("PBTE_RING_STATE_BF16", "1")
    js, ts = _pair("9x8x8_p1")
    js._pallas_state_bf16 = True
    assert ts.state_bf16 and ts.state_dtype == torch.bfloat16
    ts.consts = consts_from_numpy(jax.tree.map(np.asarray, js.consts),
                                  device="cpu")
    u, Tc, Tv = js.initial_state()
    assert u[0].dtype == jnp.bfloat16
    for _ in range(4):
        ut, Tct, Tvt = state_from_numpy(u, Tc, Tv, device="cpu")
        assert ut[0].dtype == torch.bfloat16
        u, Tc, Tv, r = js.step(u, Tc, Tv)
        ut, Tct, Tvt, rt = ts.step(ut, Tct, Tvt)
        assert ut[0].dtype == torch.bfloat16 and Tct.dtype == torch.float32
        scale = float(np.abs(np.asarray(Tc)).max())
        np.testing.assert_allclose(Tct.numpy(), np.asarray(Tc), rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("bf16", [False, True])
def test_step_hands_the_kernel_what_it_takes(monkeypatch, bf16):
    """Every sweep call of the step passes the CUDA kernel's argument checks
    (dtypes, contiguity, D, W, faces) at both state dtypes, with the
    Dirichlet source on."""
    if bf16:
        monkeypatch.setenv("PBTE_RING_STATE_BF16", "1")
    ts = SourceIterationSolver(*_problem("8x8x8_p2"), DIRICHLET_WALLS,
                               device="cpu", **DIRICHLET)
    calls = []

    def checked(v, ttc, bsrc, cin, bcat, macro_w, wvec, *, shifts, dsrc,
                xsrc, cast_bf16, win):
        assert xsrc is None  # no lagged closures on this problem
        tensors = dict(v=v, ttc=ttc, bsrc=bsrc, cin=cin, bcat=bcat,
                       macro_w=macro_w, wvec=wvec, dsrc=dsrc)
        assert win is ts.win and win is not None  # windows are on
        tensors["win"] = torch.from_numpy(win)
        tlr._kernel_args_ok(v, tensors, cast_bf16, shifts)
        calls.append(cast_bf16)
        return tlr.lattice_ring_sweep_ref(
            v, ttc, bsrc, cin, bcat, macro_w, wvec, shifts=shifts, dsrc=dsrc,
            cast_bf16=cast_bf16, win=win)

    ts.ring_sweep = checked
    ts.solve(tol=0, max_iter=2, verbose=False)
    assert calls == [bf16] * (2 * len(ts.consts["buckets"]))


@pytest.mark.parametrize("case", ["9x8x8_p1", "8x8x8_p2"])
def test_whole_slice_f32(case):
    """The port's own solver (its own constructor, its own state) against
    the JAX Pallas-interpret solver, 4 steps of solve()."""
    js, ts = _pair(case)
    rj = js.solve(tol=0, max_iter=4, verbose=False)
    rt = ts.solve(tol=0, max_iter=4, verbose=False)
    assert rt.iterations == 4
    np.testing.assert_allclose(rt.Tc.numpy(), np.asarray(rj.Tc), rtol=2e-5,
                               atol=5e-7)
    np.testing.assert_allclose(rt.residual, rj.residual, rtol=1e-3)


@pytest.mark.parametrize("case,dirichlet", [
    ("9x8x8_p1", False), ("8x8x8_p1_two_buckets", True),
])
def test_whole_slice_f64_vs_xla_ring(case, dirichlet):
    """The algorithm in float64: the port's plain version against the JAX
    XLA ring (use_pallas='off'), 4 steps, through Tc and u_by_direction."""
    js, ts = _pair(case, dirichlet, dtype=np.float64, pallas="off")
    assert js.sweep_mode == "ring" and js._ring_lattice
    rj = js.solve(tol=0, max_iter=4, verbose=False)
    rt = ts.solve(tol=0, max_iter=4, verbose=False)
    assert rt.Tc.dtype == torch.float64
    np.testing.assert_allclose(rt.Tc.numpy(), np.asarray(rj.Tc), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(rj.Tc)).max())
    uj = js.u_by_direction(rj.u)
    np.testing.assert_allclose(ts.u_by_direction(rt.u), uj, rtol=1e-10,
                               atol=1e-10 * np.abs(uj).max())


@pytest.mark.parametrize("case", ["9x8x8_p1", "8x8x8_p1_two_buckets"])
def test_views_match_xla_ring(case):
    """heat_flux (Qc, Qv), SolveResult.u_dirs and Tc_fine against pbte_tpu's
    in float64, after 3 steps of the XLA ring and of the port."""
    js, ts = _pair(case, dtype=np.float64, pallas="off")
    rj = js.solve(tol=0, max_iter=3, verbose=False)
    rt = ts.solve(tol=0, max_iter=3, verbose=False)
    Qc_j, Qv_j = (np.asarray(q) for q in js.heat_flux(rj.u))
    Qc, Qv = ts.heat_flux(rt.u)
    assert Qc.shape == (3, ts.ne, ts.D) and Qv.shape == (3, ts.ne)
    for got, want in ((Qc, Qc_j), (Qv, Qv_j)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())
    uj = rj.u_dirs()
    np.testing.assert_allclose(rt.u_dirs(), uj, rtol=1e-10,
                               atol=1e-10 * np.abs(uj).max())
    assert ts.Tc_fine(rt.Tc) is rt.Tc
    np.testing.assert_allclose(ts.Tc_fine(rt.Tc).numpy(),
                               js.Tc_fine(rj.Tc), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(rj.Tc)).max())


def test_golden_file_is_current():
    """Regenerating the committed goldens from pbte_tpu reproduces them:
    the Pallas-path golden and the XLA-ring closure golden."""
    for path, build in torch_golden.GOLDENS.items():
        fresh = build()
        with np.load(path) as d:
            assert sorted(d.files) == sorted(fresh), path.name
            for key in d.files:
                np.testing.assert_allclose(fresh[key], d[key], rtol=1e-6,
                                           err_msg=f"{path.name}: {key}")


def test_port_matches_golden_on_cpu():
    """The port's own solver on the CPU against the committed golden, the
    check chip_smoke.py repeats on a GPU through the CUDA kernel."""
    with np.load(torch_golden.PATH) as d:
        params = {k: int(d[k]) for k in torch_golden.PARAMS}
        bcs = dict(zip(d["bc_attrs"].tolist(), d["bc_temps"].tolist()))
        Tc_ref = d["Tc"][-1]
        steps = int(d["steps"])
    ts = SourceIterationSolver(*unit_cube(**params), bcs, device="cpu")
    r = ts.solve(tol=0, max_iter=steps, verbose=False)
    np.testing.assert_allclose(r.Tc.numpy(), Tc_ref, rtol=2e-5, atol=5e-7)


def _solve_states(case, steps=3, windows=True, bf16=False, dirichlet=False,
                  dtype=torch.float32):
    """(solver, result) of `steps` steps with hull windows on (the default)
    or off (the constructor's gate closed: WINDOW_MAX_SHARE = 0)."""
    from pbte_tpu_torch.solver import source_iteration as tsi

    bcs, kw = (DIRICHLET_WALLS, DIRICHLET) if dirichlet else (WALL_BCS, {})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PBTE_RING_STATE_BF16", "1" if bf16 else "0")
        if not windows:
            mp.setattr(tsi, "WINDOW_MAX_SHARE", 0.0)
        ts = SourceIterationSolver(*_problem(case), bcs, dtype=dtype,
                                   device="cpu", **kw)
    assert (ts.win is not None) == windows and ts.state_bf16 == bf16
    return ts, ts.solve(tol=0, max_iter=steps, verbose=False)


def assert_same_bits(ra, rb):
    assert torch.equal(ra.Tc, rb.Tc) and torch.equal(ra.Tv, rb.Tv)
    assert len(ra.u) == len(rb.u)
    for a, b in zip(ra.u, rb.u):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ra.residual == rb.residual


@pytest.mark.parametrize("case,dirichlet,bf16,dtype", [
    ("9x8x8_p1", False, False, torch.float32),
    ("8x8x8_p2", False, False, torch.float32),
    ("8x8x8_p1_two_buckets", True, False, torch.float32),
    ("8x8x8_p1_two_buckets", False, True, torch.float32),
    ("9x8x8_p1", True, False, torch.float64),
])
def test_windows_change_no_bit(case, dirichlet, bf16, dtype):
    """Hull windows on and off (the gate closed) give the same u, Tc, Tv and
    residual bit for bit (isothermal and Dirichlet walls, one and two
    buckets, f32, bf16 and f64 state): slots outside the windows are
    exact-zero fixed points."""
    ts, r_w = _solve_states(case, windows=True, bf16=bf16,
                            dirichlet=dirichlet, dtype=dtype)
    _, r_f = _solve_states(case, windows=False, bf16=bf16,
                           dirichlet=dirichlet, dtype=dtype)
    assert_same_bits(r_w, r_f)
    assert float(r_w.Tc.abs().max()) > 0
    for ub in r_w.u:  # exact zeros outside the windows
        for l, (lo, hi) in enumerate(ts.win):
            assert not ub[l, ..., :lo].any() and not ub[l, ..., hi:].any()


def test_windowed_step_matches_jax_step_ring_win():
    """The port's windowed step against pbte_tpu's hull-windowed XLA ring
    (_step_ring_win) in float64: the set-up of tests/test_ring.py's
    test_ring_windowed_matches_full_slab (hex 16^3 p=1, 2x4 directions,
    nspec=2, a Dirichlet face, 3 steps; pbte_tpu's 128-lane windows only
    engage on a 256-slot plane), Tc and the state at rtol 1e-12 with atol
    1e-12 of the field's max, as there."""
    size = dict(nx=16, ny=16, nz=16, order=1, polar=2, azimuth=4, nspec=2)
    js = JaxSolver(*torch_golden.jax_unit_cube(**size), DIRICHLET_WALLS,
                   dtype=jnp.float64, sweep_mode="ring", **DIRICHLET)
    assert js._ring_windowed and js.has_dirichlet
    ts = SourceIterationSolver(*unit_cube(**size), DIRICHLET_WALLS,
                               dtype=torch.float64, device="cpu", **DIRICHLET)
    assert ts.win is not None and (ts.L, ts.W) == (46, 256)
    assert int((ts.win[:, 1] - ts.win[:, 0]).sum()) == 7246
    rj = js.solve(tol=0, max_iter=3, verbose=False)
    rt = ts.solve(tol=0, max_iter=3, verbose=False)
    Tj = np.asarray(rj.Tc)
    np.testing.assert_allclose(rt.Tc.numpy(), Tj, rtol=1e-12,
                               atol=1e-12 * np.abs(Tj).max())
    uj = js._ring_u_standard(rj.u)
    np.testing.assert_allclose(ts._ring_u_standard(rt.u), uj, rtol=1e-12,
                               atol=1e-12 * np.abs(uj).max())


def test_window_gate(monkeypatch):
    """Windows are taken when, rounded out to the kernel's 16-slot tiles,
    they keep under 95% of the slab (pbte_tpu's gate, WINDOW_MAX_SHARE), and
    never with the gate closed. A 32x4x4 lattice has a 16-slot plane, one
    tile per level: nothing to save. The PBTE_RING_WINDOWS switch is gone:
    it changes nothing."""
    from pbte_tpu_torch.solver import source_iteration as tsi
    from pbte_tpu_torch.solver.lattice_tables import window_slots

    monkeypatch.setenv("PBTE_RING_WINDOWS", "0")
    ts = SourceIterationSolver(*_problem("8x8x8_p1"), WALL_BCS, device="cpu")
    slots = window_slots(ts.win, tsi.WINDOW_TILE)
    assert slots == 1024 and slots < 0.95 * ts.L * ts.W
    assert ts.win_dev is None  # the uploaded copy is for a GPU's kernel
    thin = SourceIterationSolver(
        *unit_cube(32, 4, 4, order=1, polar=2, azimuth=4, nspec=2), WALL_BCS,
        device="cpu")
    assert thin.W == 16 and thin.win is None
    r = thin.solve(tol=0, max_iter=2, verbose=False)
    assert torch.isfinite(r.Tc).all()
    monkeypatch.setattr(tsi, "WINDOW_MAX_SHARE", 0.0)
    off = SourceIterationSolver(*_problem("8x8x8_p1"), WALL_BCS, device="cpu")
    assert off.win is None


@pytest.mark.parametrize("flag", [True, False])
def test_solver_leaves_tf32_flags_alone(flag):
    """Building a solver, stepping it and taking its views leaves both
    process-wide TF32 flags as the caller set them; inside the solver's
    products they are off."""
    from pbte_tpu_torch.solver.source_iteration import exact_f32_products

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = flag
        torch.backends.cudnn.allow_tf32 = flag
        ts = SourceIterationSolver(*_problem("8x8x8_p1"), WALL_BCS,
                                   device="cpu")
        seen = []
        inner = ts.ring_sweep

        def spy(*a, **kw):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
            return inner(*a, **kw)

        ts.ring_sweep = spy
        r = ts.solve(tol=0, max_iter=1, verbose=False)
        ts.heat_flux(r.u)
        assert seen == [(False, False)] * len(ts.consts["buckets"])
        assert torch.backends.cuda.matmul.allow_tf32 is flag
        assert torch.backends.cudnn.allow_tf32 is flag
        with pytest.raises(RuntimeError, match="inside"):
            with exact_f32_products():
                raise RuntimeError("inside")
        assert torch.backends.cuda.matmul.allow_tf32 is flag
        assert torch.backends.cudnn.allow_tf32 is flag
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _f64_pair(bcs=WALL_BCS, case="8x8x8_p1", **kw):
    """pbte_tpu's XLA ring and the port's plain version in float64, each on
    its own package's problem, with the same constructor options."""
    js = JaxSolver(*_problem(case, torch_golden.jax_unit_cube), bcs,
                   dtype=jnp.float64, sweep_mode="ring", use_pallas="off",
                   **kw)
    ts = SourceIterationSolver(*_problem(case), bcs, dtype=torch.float64,
                               device="cpu", **kw)
    assert js.sweep_mode == "ring" and js._ring_lattice
    return js, ts


def _assert_f64_state(js, ts, uj, Tcj, ut, Tct, tol=1e-12):
    """Tc and the ring state (through both packages' _ring_u_standard) at
    rtol `tol` with atol `tol` of the field's max."""
    Tcj = np.asarray(Tcj)
    np.testing.assert_allclose(Tct.numpy(), Tcj, rtol=tol,
                               atol=tol * np.abs(Tcj).max())
    uj = js._ring_u_standard(uj)
    np.testing.assert_allclose(ts._ring_u_standard(ut), uj, rtol=tol,
                               atol=tol * np.abs(uj).max())


@pytest.mark.parametrize("extrapolate", [False, True])
def test_polish_matches_jax(extrapolate):
    """solve(polish_iters=3[, polish_extrapolate=True]) after 6 iterations
    against pbte_tpu's solve with the same options, in float64 on the CPU:
    Tc, the state, Tv, the residual and the iteration count (11 with the
    Aitken jump's two extra steps, 9 without)."""
    js, ts = _f64_pair()
    opts = dict(tol=0, max_iter=6, verbose=False, polish_iters=3,
                polish_extrapolate=extrapolate)
    rj, rt = js.solve(**opts), ts.solve(**opts)
    assert rt.iterations == rj.iterations == (11 if extrapolate else 9)
    _assert_f64_state(js, ts, rj.u, rj.Tc, rt.u, rt.Tc)
    Tvj = np.asarray(rj.Tv)
    np.testing.assert_allclose(rt.Tv.numpy(), Tvj, rtol=1e-12,
                               atol=1e-12 * np.abs(Tvj).max())
    np.testing.assert_allclose(rt.residual, rj.residual, rtol=1e-9)
    if extrapolate:  # the jump moved the state off the plain iterate
        plain = ts.solve(tol=0, max_iter=11, verbose=False)
        assert not torch.equal(plain.Tc, rt.Tc)


def test_cycle_hook_matches_jax():
    """cycle_hook under both packages' solve: called at the same
    iterations, with the same live Tc, state and Tv each time."""
    js, ts = _f64_pair()
    seen_j, seen_t = [], []
    opts = dict(tol=0, max_iter=5, verbose=False, cycle_every=2)
    js.solve(cycle_hook=lambda it, u, Tc, Tv: seen_j.append(
        (it, u, np.asarray(Tc), np.asarray(Tv))), **opts)
    ts.solve(cycle_hook=lambda it, u, Tc, Tv: seen_t.append(
        (it, u, Tc.clone(), Tv.clone())), **opts)
    assert [s[0] for s in seen_t] == [s[0] for s in seen_j] == [2, 4]
    for (_, uj, Tcj, Tvj), (_, ut, Tct, Tvt) in zip(seen_j, seen_t):
        _assert_f64_state(js, ts, uj, Tcj, ut, Tct)
        np.testing.assert_allclose(Tvt.numpy(), Tvj, rtol=1e-12,
                                   atol=1e-12 * np.abs(Tvj).max())
    seen_j.clear(), seen_t.clear()
    for s, seen in ((js, seen_j), (ts, seen_t)):  # cycle_every = 0: never
        s.solve(tol=0, max_iter=2, verbose=False,
                cycle_hook=lambda *a, seen=seen: seen.append(a))
    assert seen_j == [] and seen_t == []


def test_require_bcs_false_matches_jax():
    """A boundary attribute left without a condition: both packages raise
    by default and, with require_bcs=False, step to the same Tc and state
    (float64, 3 steps)."""
    bcs = {a: t for a, t in WALL_BCS.items() if a != 2}
    with pytest.raises(ValueError, match="without isothermal BC"):
        JaxSolver(*_problem("8x8x8_p1", torch_golden.jax_unit_cube), bcs,
                  dtype=jnp.float64, sweep_mode="ring", use_pallas="off")
    js, ts = _f64_pair(bcs, require_bcs=False)
    rj = js.solve(tol=0, max_iter=3, verbose=False)
    rt = ts.solve(tol=0, max_iter=3, verbose=False)
    _assert_f64_state(js, ts, rj.u, rj.Tc, rt.u, rt.Tc)
    np.testing.assert_allclose(rt.residual, rj.residual, rtol=1e-9)


def test_polish_equals_extra_steps_f64():
    """solve(polish_iters=N) in float64, where every step is exact, equals
    N more plain iterations (tests/test_ring.py's case for pbte_tpu)."""
    ts = SourceIterationSolver(*_problem("8x8x8_p1"), WALL_BCS,
                               dtype=torch.float64, device="cpu")
    r1 = ts.solve(tol=0, max_iter=9, verbose=False)
    r2 = ts.solve(tol=0, max_iter=6, verbose=False, polish_iters=3)
    assert r2.iterations == 9
    assert_same_bits(r1, r2)


def test_polish_is_exact_f32_steps_after_bf16_state(monkeypatch):
    """After a bf16-state solve, polish casts the slabs to float32 and
    steps them without operand rounding: the same bits as a float32-state
    solver stepping that state."""
    monkeypatch.setenv("PBTE_RING_STATE_BF16", "1")
    tb = SourceIterationSolver(*_problem("8x8x8_p1"), WALL_BCS, device="cpu")
    monkeypatch.delenv("PBTE_RING_STATE_BF16")
    tf = SourceIterationSolver(*_problem("8x8x8_p1"), WALL_BCS, device="cpu")
    assert tb.state_bf16 and not tf.state_bf16
    rb = tb.solve(tol=0, max_iter=3, verbose=False)
    assert rb.u[0].dtype == torch.bfloat16
    state = (tuple(x.float() for x in rb.u), rb.Tc, rb.Tv)
    want = tf.solve(tol=0, max_iter=2, state=state, verbose=False)
    got = tb.solve(tol=0, max_iter=3, verbose=False, polish_iters=2)
    assert got.iterations == 5 and got.u[0].dtype == torch.float32
    assert_same_bits(got, want)
    assert not torch.equal(got.Tc, rb.Tc)


def test_polish_extrapolation():
    """The Aitken jump after the polish tail: x2 + d2 r / (1 - r) with r
    from the Tc differences of two more steps (pbte_tpu's formula), and it
    lands much closer to the fixed point than the same number of plain
    steps (tests/test_ring.py's case for pbte_tpu, on an 8^3 lattice of
    0.3 um, which converges to 1e-13 within 300 steps)."""
    from pbte_tpu_torch import mesh as tmesh
    from pbte_tpu_torch.fem import assembly as tasm

    _, quad, tables = _problem("8x8x8_p1")
    m = tmesh.make_cartesian_3d(8, 8, 8, "hex").scaled(3.0e-7)
    ts = SourceIterationSolver(tasm.assemble(tmesh.connect(m), order=1,
                                             face_mode="consistent"), quad,
                               tables, WALL_BCS, dtype=torch.float64,
                               device="cpu")
    base = ts.solve(tol=0, max_iter=48, verbose=False)
    s1 = ts.step(base.u, base.Tc, base.Tv)
    s2 = ts.step(*s1[:3])
    d1, d2 = s1[1] - base.Tc, s2[1] - s1[1]
    ratio = float((d2 * d1).sum() / (d1 * d1).sum())
    assert 0.5 < ratio < 0.99995
    fac = ratio / (1.0 - ratio)
    extr = ts.solve(tol=0, max_iter=30, verbose=False, polish_iters=18,
                    polish_extrapolate=True)
    assert extr.iterations == 50
    torch.testing.assert_close(extr.Tc, s2[1] + fac * d2, rtol=1e-12,
                               atol=1e-14)
    torch.testing.assert_close(
        extr.u[0], s2[0][0] + fac * (s2[0][0] - s1[0][0]), rtol=1e-12,
        atol=1e-12 * float(s2[0][0].abs().max()))
    assert torch.equal(extr.Tv, s2[2])
    ref = ts.solve(tol=1e-13, max_iter=400, verbose=False)
    assert ref.residual < 1e-13
    plain = ts.solve(tol=0, max_iter=50, verbose=False)
    e_plain = float((plain.Tc - ref.Tc).abs().max())
    e_extr = float((extr.Tc - ref.Tc).abs().max())
    assert e_extr < 0.1 * e_plain


def test_cycle_hook_cadence():
    """cycle_hook sees the live state every cycle_every iterations, and not
    at all with cycle_every = 0."""
    ts = SourceIterationSolver(*_problem("8x8x8_p1"), WALL_BCS, device="cpu")
    seen = []

    def hook(it, u, Tc, Tv):
        assert len(u) == len(ts.consts["buckets"])
        assert Tc.shape == (ts.ne, ts.D) and Tv.shape == (ts.ne,)
        seen.append((it, Tc.clone()))

    r = ts.solve(tol=0, max_iter=7, verbose=False, cycle_hook=hook,
                 cycle_every=3)
    assert [it for it, _ in seen] == [3, 6]
    assert not torch.equal(seen[0][1], seen[1][1])
    assert not torch.equal(seen[1][1], r.Tc)
    seen.clear()
    ts.solve(tol=0, max_iter=3, verbose=False, cycle_hook=hook)
    assert seen == []


def test_checkpoint_options_name_their_item(tmp_path):
    """The checkpoint options (ROADMAP.md queue 1, item 9) are taken now: a
    solve writes its state at the cadence, and the file resumes to the
    same iterate (tests/test_torch_checkpoint.py holds the rest)."""
    from pbte_tpu_torch.io.checkpoint import load_checkpoint

    ts = SourceIterationSolver(*_problem("8x8x8_p1"), WALL_BCS, device="cpu")
    path = str(tmp_path / "x.npz")
    ts.solve(tol=0, max_iter=2, verbose=False, checkpoint_path=path,
             checkpoint_every=2)
    state, it, _ = load_checkpoint(path, ts)
    assert it == 2
    ref = ts.solve(tol=0, max_iter=3, verbose=False)
    assert_same_bits(ts.solve(tol=0, max_iter=1, verbose=False, state=state),
                     ref)


def test_require_bcs_false():
    """A boundary attribute without a condition raises unless
    require_bcs=False, which takes it as a wall at deviation 0: the same
    bits as giving it 0."""
    bcs = {a: t for a, t in WALL_BCS.items() if a != 2}
    with pytest.raises(ValueError, match=r"without isothermal BC: \[2\]"):
        SourceIterationSolver(*_problem("8x8x8_p1"), bcs, device="cpu")
    loose = SourceIterationSolver(*_problem("8x8x8_p1"), bcs, device="cpu",
                                  require_bcs=False)
    zero = SourceIterationSolver(*_problem("8x8x8_p1"), dict(bcs) | {2: 0.0},
                                 device="cpu")
    assert_same_bits(loose.solve(tol=0, max_iter=2, verbose=False),
                     zero.solve(tol=0, max_iter=2, verbose=False))


def _gate_raises(prob, bcs, **kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SourceIterationSolver(*prob, bcs, device="cpu", **kw)


def _gate_scans(prob, bcs, **kw):
    """Off the lattice ring, the problem takes the scan path, as pbte_tpu's
    solver does (tests/test_torch_scan.py holds the resolution of both
    packages side by side)."""
    ts = SourceIterationSolver(*prob, bcs, device="cpu", **kw)
    assert ts.sweep_mode == "scan"


def test_gate_periodic():
    """Periodic wraps on the single-class lattice are taken (lagged through
    the sweep's xsrc); a periodic mesh below 512 elements has several
    geometry classes and takes the scan path."""
    def periodic_ops(n):
        m = pmesh.make_periodic(
            pmesh.make_cartesian_3d(n, n, n, "hex").scaled(1e-6), [0])
        return assembly.assemble(pmesh.connect(m), order=1,
                                 face_mode="consistent")

    _, quad, tables = _problem("9x8x8_p1")
    bcs = {1: -0.5, 2: -0.5, 4: -0.5, 6: 0.5}  # x faces wrap (no attr)
    ts = SourceIterationSolver(periodic_ops(8), quad, tables, bcs,
                               device="cpu")
    assert ts.has_periodic and "per_cpl" in ts.consts["buckets"][0]
    _gate_scans((periodic_ops(7), quad, tables), bcs)


@pytest.mark.parametrize("kind", ["diffuse_bcs", "specular_bcs"])
def test_gate_reflective(kind):
    """Reflective walls on the lattice are taken and need no temperature;
    below 512 elements (several classes) they take the scan path."""
    bcs = {5: -0.5, 3: 0.5}
    ts = SourceIterationSolver(*_problem("9x8x8_p1"), bcs, device="cpu",
                               **{kind: [1, 2, 4, 6]})
    on = ts._dif_on if kind == "diffuse_bcs" else ts._spc_on
    assert on and "refl_pl" in ts.consts["buckets"][0]
    _gate_scans(unit_cube(7, 7, 7, order=1, polar=2, azimuth=4, nspec=2),
                bcs, **{kind: [1, 2, 4, 6]})
    with pytest.raises(ValueError, match="without isothermal BC"):
        SourceIterationSolver(*_problem("9x8x8_p1"), bcs, device="cpu",
                              **{kind: [1, 2]})


def test_gate_tet_mesh():
    """A 4^3 6-tet mesh (384 elements, faces not canonicalised) is scanned;
    at 5^3 and above the split merges into supercells, as in pbte_tpu, and
    takes the supercell ring (G = 8 octants of the 5^3 macro lattice)."""
    _, quad, tables = _problem("9x8x8_p1")
    for n in (4, 5):
        m = pmesh.make_cartesian_3d(n, n, n, "tet").scaled(1e-6)
        ops = assembly.assemble(pmesh.connect(m), order=1,
                                face_mode="consistent")
        if n == 4:
            _gate_scans((ops, quad, tables), WALL_BCS)
        else:
            ts = SourceIterationSolver(ops, quad, tables, WALL_BCS,
                                       device="cpu")
            assert ts._super is not None and ts.sweep_mode == "ring"
            assert (ts.G, ts.ne, ts.D, ts.ne_tv) == (8, 125, 24, 750)


def test_gate_axis_grazing_directions():
    """A one-polar-point 3D rule lies in the xy plane: no octant leveling,
    so the lattice ring refuses it and the mesh is scanned."""
    _gate_scans(unit_cube(8, 8, 8, order=1, polar=1, azimuth=4, nspec=2),
                WALL_BCS)


def test_gate_small_mesh_keeps_face_order():
    """Below 512 elements faces are not canonicalised (as in pbte_tpu), so
    a hex mesh has several classes and is not on the kernel path: it is
    scanned."""
    _gate_scans(unit_cube(7, 7, 7, order=1, polar=2, azimuth=4, nspec=2),
                WALL_BCS)


def test_gate_f64_on_gpu_device(monkeypatch):
    """float64 is taken on a GPU too (the float64 kernel): with no GPU
    visible it raises only for the missing device, and the flagship's two
    float64 bucket shapes pass the kernel's argument checks and fit its
    shared memory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        SourceIterationSolver(*_problem("9x8x8_p1"), WALL_BCS,
                              dtype=torch.float64, device="cuda")
    for km in (10, 6):
        v = torch.zeros((46, 4, km, 40, 27, 256), dtype=torch.float64,
                        device="meta")
        tlr._kernel_args_ok(v, dict(v=v), False, (0, 16, 1))
    assert tlr.kernel_smem_bytes(27, 256, 3, torch.float64, 46) == 209808


def test_f64_step_hands_the_kernel_what_it_takes():
    """Every sweep call of a float64 step passes the float64 kernel's
    argument checks (float64 operands, int32 windows and closure map), with
    the Dirichlet source on and with diffuse walls."""
    for bcs, kw in ((DIRICHLET_WALLS, DIRICHLET),
                    ({5: -0.5, 3: 0.5}, dict(diffuse_bcs=[1, 2, 4, 6]))):
        ts = SourceIterationSolver(*_problem("9x8x8_p1"), bcs,
                                   dtype=torch.float64, device="cpu", **kw)
        calls = []

        def checked(v, ttc, bsrc, cin, bcat, macro_w, wvec, *, shifts, dsrc,
                    xsrc, cast_bf16, win):
            tensors = dict(v=v, ttc=ttc, bsrc=bsrc, cin=cin, bcat=bcat,
                           macro_w=macro_w, wvec=wvec,
                           win=tlr.windows_on_device(win, v.shape[0],
                                                     v.shape[-1], "cpu"))
            if dsrc is not None:
                tensors["dsrc"] = dsrc
            if xsrc is not None:
                tensors.update(xmap=xsrc.xmap, xval=xsrc.xval)
            assert v.dtype == torch.float64 and not cast_bf16
            tlr._kernel_args_ok(v, tensors, cast_bf16, shifts)
            calls.append((dsrc is not None, xsrc is not None))
            return tlr.lattice_ring_sweep_ref(
                v, ttc, bsrc, cin, bcat, macro_w, wvec, shifts=shifts,
                dsrc=dsrc, xsrc=xsrc, cast_bf16=cast_bf16, win=win)

        ts.ring_sweep = checked
        ts.solve(tol=0, max_iter=2, verbose=False)
        want = ("dirichlet_bcs" in kw, "diffuse_bcs" in kw)
        assert calls == [want] * (2 * len(ts.consts["buckets"]))


@pytest.mark.parametrize("entry", ["solver", "consts", "state"])
def test_entry_points_default_to_the_gpu(monkeypatch, entry):
    """SourceIterationSolver, consts_from_numpy and state_from_numpy run on
    the GPU unless asked for the CPU: with no GPU visible, the default
    raises before anything is allocated, and never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = {"solver": SourceIterationSolver.__init__,
          "consts": consts_from_numpy, "state": state_from_numpy}[entry]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        if entry == "solver":
            SourceIterationSolver(*_problem("9x8x8_p1"), WALL_BCS)
        elif entry == "consts":
            consts_from_numpy({})
        else:
            state_from_numpy([np.zeros((1, 1, 1, 1, 8, 4))], np.zeros(1),
                             np.zeros(1))


def test_no_jax_import():
    """The port builds and steps a hex 8^3 problem, and solves it in float64
    with solve(accelerate="bicgstab") (solver/accel.py), steps a 6-tet cube
    on the general ring (solver/one_hot_ring.py) and runs the C++ baseline
    (pbte_tpu_torch.native) on it, solves on one rank with the slab and the
    spatial solvers (parallel/) and the dir-sharded supercell ring, and
    runs the partition validation, in a
    process where importing JAX, or anything of pbte_tpu, fails; every
    module of the port, chip_smoke.py, bench_torch.py and
    probe_setup_torch.py import there too."""
    code = textwrap.dedent("""
        import importlib
        import pkgutil
        import sys

        class _RefuseJax:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "pbte_tpu"):
                    raise ImportError(f"{name} refused")
                return None

        sys.meta_path.insert(0, _RefuseJax())
        import torch
        torch.set_num_threads(1)
        import pbte_tpu_torch
        mods = [m.name for m in pkgutil.walk_packages(
            pbte_tpu_torch.__path__, "pbte_tpu_torch.")]
        for name in mods + ["chip_smoke", "bench_torch",
                            "probe_setup_torch"]:
            importlib.import_module(name)
        assert len(mods) > 15, mods
        from pbte_tpu_torch.problem import WALL_BCS, unit_cube
        from pbte_tpu_torch.solver.source_iteration import (
            SourceIterationSolver,
        )
        s = SourceIterationSolver(
            *unit_cube(8, 8, 8, order=1, polar=2, azimuth=4, nspec=2),
            WALL_BCS, device="cpu")
        u, Tc, Tv = s.initial_state()
        for _ in range(2):
            u, Tc, Tv, r = s.step(u, Tc, Tv)
        assert torch.isfinite(Tc).all() and bool(torch.isfinite(r))
        from pbte_tpu_torch.solver import accel
        assert callable(accel.bicgstab_outer)
        s64 = SourceIterationSolver(
            *unit_cube(8, 8, 8, order=1, polar=2, azimuth=4, nspec=2),
            WALL_BCS, dtype=torch.float64, device="cpu")
        r = s64.solve(tol=0, max_iter=6, verbose=False, accelerate="bicgstab")
        assert r.iterations == 5 and torch.isfinite(r.Tc).all()
        import numpy as np
        from pbte_tpu_torch import native
        from pbte_tpu_torch.problem import tet_cube
        tp = tet_cube(4, order=1, polar=2, azimuth=4, nspec=1)
        g = SourceIterationSolver(*tp, WALL_BCS, device="cpu",
                                  sweep_mode="ring", supercell="off")
        assert g._general
        u, Tc, Tv = g.initial_state()
        u, Tc, Tv, r = g.step(u, Tc, Tv)
        assert torch.isfinite(Tc).all() and bool(torch.isfinite(r))
        assert np.isfinite(native.cpp_source_iteration(*tp, WALL_BCS, 1)[1]).all()
        from pbte_tpu_torch import mesh as pmesh
        from pbte_tpu_torch.parallel.comm import Grid
        from pbte_tpu_torch.parallel.slab import SlabLatticeSolver
        from pbte_tpu_torch.parallel.spatial import SpatialShardedSolver
        from pbte_tpu_torch.validation.__main__ import main as validate_main
        grid = Grid(dir=1, space=1)
        sl = SlabLatticeSolver(
            *unit_cube(8, 8, 8, order=1, polar=2, azimuth=4, nspec=2),
            WALL_BCS, grid, device="cpu")
        assert np.isfinite(sl.solve(tol=0, max_iter=2,
                                    verbose=False).Tc_global()).all()
        topo = pmesh.connect(pmesh.make_cartesian_3d(3, 3, 3, "tet")
                             .scaled(1e-6))
        sp = SpatialShardedSolver(*tet_cube(3, order=1, polar=2, azimuth=4,
                                            nspec=1),
                                  WALL_BCS, grid, topo=topo, device="cpu",
                                  partition_method="multilevel")
        assert np.isfinite(sp.solve(tol=0, max_iter=2,
                                    verbose=False).Tc_global()).all()
        assert validate_main(["2", "--mesh", "unit-cube-tet"]) == 0
        from pbte_tpu_torch.problem import tet_box
        sc = SourceIterationSolver(
            *tet_box(2, 2, 2, order=1, polar=2, azimuth=4, nspec=1),
            WALL_BCS, device="cpu", supercell="on",
            dir_sharding=Grid(dir=1, band=1))
        assert sc._super is not None
        assert np.isfinite(sc.solve(tol=0, max_iter=2,
                                    verbose=False).Tc.numpy()).all()
        assert not any(m.split(".")[0] in ("jax", "jaxlib", "pbte_tpu")
                       for m in sys.modules)
        print("no-jax ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no-jax ok" in proc.stdout


# ---- the lattices K1 takes since its cluster kernel ------------------------

# name: (builder of both packages' problem, walls); small angle and band
# counts: 8 directions (2D: 8 azimuths), 2 bands
NEW_SHAPES = {
    "quad_24x22_p2": (lambda pkg, length: (
        torch_golden.jax_unit_square if pkg == "jax" else unit_square)(
        24, 22, order=2, azimuth=8, nspec=2, length=length), SQUARE_BCS),
    "hex_8x8x8_p3": (lambda pkg, length: (
        torch_golden.jax_unit_cube if pkg == "jax" else unit_cube)(
        8, 8, 8, order=3, polar=2, azimuth=4, nspec=2, length=length),
        WALL_BCS),
    "hex_17x17x17_p1": (lambda pkg, length: (
        torch_golden.jax_unit_cube if pkg == "jax" else unit_cube)(
        17, 17, 17, order=1, polar=2, azimuth=4, nspec=2, length=length),
        WALL_BCS),
}


@functools.lru_cache(maxsize=None)
def _new_shape(name, pkg, length=1.0e-6):
    return NEW_SHAPES[name][0](pkg, length)


def _new_shape_pair(name, f32, length=1.0e-6, jax_f32=None):
    """pbte_tpu's XLA ring (f32 with its bf16 staging off) and the port's
    ring on one of NEW_SHAPES, 3 steps each: (pbte_tpu's Tc, port's Tc)."""
    bcs = NEW_SHAPES[name][1]
    jax_f32 = f32 if jax_f32 is None else jax_f32
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PBTE_RING_BF16", "0")
        js = JaxSolver(*_new_shape(name, "jax", length), bcs,
                       dtype=jnp.float32 if jax_f32 else jnp.float64,
                       use_pallas="off")
    ts = SourceIterationSolver(*_new_shape(name, "torch", length), bcs,
                               dtype=torch.float32 if f32 else torch.float64,
                               device="cpu")
    assert js.sweep_mode == ts.sweep_mode == "ring" and js._ring_lattice
    assert (ts.D, ts.W) == (js.D, js.W) and ts._multi is None
    rj = js.solve(tol=0, max_iter=3, verbose=False)
    rt = ts.solve(tol=0, max_iter=3, verbose=False)
    return np.asarray(rj.Tc, dtype=np.float64), rt.Tc.double().numpy()


@pytest.mark.parametrize("check", ["f64", "f32_mm", "f32_vs_f64"])
@pytest.mark.parametrize("name", list(NEW_SHAPES))
def test_ring_parity_at_new_shapes(name, check):
    """The port's plain ring against pbte_tpu's XLA ring on a 2D quad
    lattice at p=2 (D=9, two faces), a hex lattice at p=3 (D=64) and one of
    W = 289 > 256 slots (the shapes K1's new instantiations and cluster
    kernel take on the card), 3 steps:

    - ``f64``: Tc to roundoff, 1e-12 of max;
    - ``f32_mm``: both in float32 at rtol=2e-5, atol=5e-7 of max, on the
      same lattices of millimetre edge. At a micron edge the f32 state
      v = M^T u of these lattices peaks at 3e-32 to 5e-32, and with f32
      subnormals flushed (XLA's CPU backend; the fixture here, for
      pbte_tpu's sake) each package lands 8e-6 to 1.6e-5 of max from the
      float64 answer, so the two differ by more than their rounding order
      (measured: the port 2.5e-7 to 3.6e-7 with subnormals kept);
    - ``f32_vs_f64``: at a micron edge, the port's float32 with subnormals
      kept (as on the card) against pbte_tpu's float64 at rtol=2e-5,
      atol=5e-7 of max."""
    if check == "f64":
        want, got = _new_shape_pair(name, f32=False)
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
        return
    if check == "f32_mm":
        want, got = _new_shape_pair(name, f32=True, length=1.0e-3)
    else:
        torch.set_flush_denormal(False)
        want, got = _new_shape_pair(name, f32=True, jax_f32=False)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=2e-5,
                               atol=5e-7)


@pytest.mark.parametrize("value", [None, "default", "high", "highest",
                                   "selective"])
def test_matmul_precision_changes_nothing(value):
    """Every matmul_precision tier of pbte_tpu runs the same exact float32
    path here (K1 and TF32-free products): the same Tc, bit for bit, as the
    default."""
    prob = _problem("8x8x8_p1")
    ref = SourceIterationSolver(*prob, WALL_BCS, device="cpu").solve(
        tol=0, max_iter=2, verbose=False)
    ts = SourceIterationSolver(*prob, WALL_BCS, device="cpu",
                               matmul_precision=value)
    assert ts.matmul_precision == value and ts.sweep_mode == "ring"
    r = ts.solve(tol=0, max_iter=2, verbose=False)
    assert torch.equal(r.Tc, ref.Tc) and r.residual == ref.residual


@pytest.mark.parametrize("value", [None, "default", "high", "highest"])
def test_polish_precision_changes_nothing(value, monkeypatch):
    """So does solve's polish_precision on the exact steps after a
    bfloat16-state solve."""
    monkeypatch.setenv("PBTE_RING_STATE_BF16", "1")
    ts = SourceIterationSolver(*_problem("8x8x8_p1"), WALL_BCS, device="cpu")
    ref = ts.solve(tol=0, max_iter=2, verbose=False, polish_iters=2)
    r = ts.solve(tol=0, max_iter=2, verbose=False, polish_iters=2,
                 polish_precision=value)
    assert torch.equal(r.Tc, ref.Tc) and r.residual == ref.residual


def test_unknown_precision_raises():
    """An unknown tier raises, as pbte_tpu's does."""
    prob = _problem("8x8x8_p1")
    with pytest.raises(ValueError, match="matmul_precision"):
        SourceIterationSolver(*prob, WALL_BCS, device="cpu",
                              matmul_precision="bf16x9")
    ts = SourceIterationSolver(*prob, WALL_BCS, device="cpu")
    with pytest.raises(ValueError, match="polish_precision"):
        ts.solve(tol=0, max_iter=1, verbose=False, polish_iters=1,
                 polish_precision="selective")
