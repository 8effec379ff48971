"""The lattice ring's lagged closures in pbte_tpu_torch: periodic wraps and
diffuse and specular walls, added to K1's rhs through its ``xsrc`` operand.

The port's float64 plain path is held against pbte_tpu's XLA ring
(``sweep_mode="ring"``, the form that runs these closures on the same
single-class lattice) and against the sequential numpy oracle; one f32 step
goes through the consts bridge; the K1 plain version's ``xsrc`` is held to
the rhs addition it stands for; and the port is held to the committed
closure golden. On a GPU, chip_smoke.py repeats the golden check through
the CUDA kernel."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_golden
from pbte_tpu.solver.source_iteration import SourceIterationSolver as JaxSolver
from pbte_tpu.validation.oracle import solve_oracle
from pbte_tpu_torch.convert import consts_from_numpy, state_from_numpy
from pbte_tpu_torch.ops import lattice_ring as tlr
from pbte_tpu_torch.problem import unit_cube
from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

STEPS = 5
# (azimuth, periodic axes, isothermal walls, diffuse, specular). Hex 8^3,
# p=1, nspec=2. Azimuth 4 gives 8 directions (one slot per octant, one Km
# bucket); azimuth 8 gives two buckets (3 and 1 slots), so the diffuse sum
# and the specular mirror cross buckets. Specular walls are y and z faces:
# the Gauss azimuth rule is mirror-symmetric about y, not about x.
CASES = {
    "diffuse": (4, (), {5: -0.5, 3: 0.5}, [1, 2, 4, 6], []),
    "specular": (4, (), {5: -0.5, 3: 0.5}, [], [1, 2, 4, 6]),
    "periodic": (4, (0,), {1: -0.5, 2: -0.5, 4: 0.5, 6: 0.5}, [], []),
    "periodic_diffuse": (4, (0,), {1: -0.5, 6: 0.5}, [2, 4], []),
    "specular_two_buckets": (8, (), {5: -0.5, 3: 0.5}, [], [1, 2, 4, 6]),
    "all_two_buckets": (8, (0,), {1: -0.5, 6: 0.5}, [2], [4]),
}
ORACLE_CASES = ["diffuse", "specular", "periodic", "periodic_diffuse"]


@pytest.fixture(autouse=True)
def _cpu_float_env():
    """One thread, and f32 subnormals flushed as XLA's CPU backend flushes
    them (see tests/test_torch_solver.py)."""
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@functools.lru_cache(maxsize=None)
def _problem(case, build=unit_cube):
    """The case's problem from the port's host layers, or from pbte_tpu's
    with build=torch_golden.jax_unit_cube."""
    az, periodic, bcs, dif, spc = CASES[case]
    prob = build(8, 8, 8, order=1, polar=2, azimuth=az, nspec=2,
                 periodic=periodic)
    return prob, bcs, dict(diffuse_bcs=dif, specular_bcs=spc)


def _jax_solver(case, dtype):
    prob, bcs, kw = _problem(case, torch_golden.jax_unit_cube)
    js = JaxSolver(*prob, bcs, dtype=dtype, sweep_mode="ring",
                   use_pallas="off", **kw)
    assert js.sweep_mode == "ring" and js._ring_lattice and js._ring_ccpl
    assert js.ncls_ring == 1 and js._ring_H == 1
    return js


def _port_solver(case, dtype):
    prob, bcs, kw = _problem(case)
    return SourceIterationSolver(*prob, bcs, dtype=dtype, device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _f64_runs(case):
    """(port Tc, JAX XLA ring Tc) after STEPS steps in float64."""
    rt = _port_solver(case, torch.float64).solve(tol=0, max_iter=STEPS,
                                                 verbose=False)
    rj = _jax_solver(case, jnp.float64).solve(tol=0, max_iter=STEPS,
                                              verbose=False)
    assert rt.iterations == STEPS
    return rt.Tc.numpy(), np.asarray(rj.Tc)


@pytest.mark.parametrize("case", list(CASES))
def test_f64_closures_match_xla_ring(case):
    """The algorithm in float64: the port's plain path against pbte_tpu's
    XLA lattice ring, 5 steps (measured ~7e-16 of max)."""
    got, want = _f64_runs(case)
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("case", ORACLE_CASES)
def test_f64_closures_match_oracle(case):
    """Against the sequential numpy oracle at pbte_tpu's own tolerances for
    these closures on the lattice ring (tests/test_reflective_bcs.py:203)."""
    prob, bcs, kw = _problem(case, torch_golden.jax_unit_cube)
    okw = dict(diffuse=kw["diffuse_bcs"] or None,
               specular=kw["specular_bcs"] or None)
    _, Tco, *_ = solve_oracle(*prob, bcs, tol=0, max_iter=STEPS, **okw)
    got, _ = _f64_runs(case)
    np.testing.assert_allclose(got, Tco, rtol=1e-11, atol=1e-14)


@pytest.mark.parametrize("case", ["diffuse", "specular", "periodic_diffuse",
                                  "all_two_buckets"])
def test_closure_constructor_parity(case, monkeypatch):
    """Every closure table the port builds without JAX matches pbte_tpu's
    XLA ring consts carried across by consts_from_numpy."""
    monkeypatch.setenv("PBTE_RING_BF16", "0")
    js = _jax_solver(case, jnp.float32)
    ts = _port_solver(case, torch.float32)
    want = consts_from_numpy(jax.tree.map(np.asarray, js.consts),
                             device="cpu")
    got = ts.consts
    assert got.keys() == want.keys()
    for key in got:
        if key != "buckets":
            np.testing.assert_allclose(
                got[key].double().numpy(), want[key].double().numpy(),
                rtol=1e-6, atol=1e-6 * float(want[key].abs().max()),
                err_msg=key)
    for gb, wb in zip(got["buckets"], want["buckets"]):
        assert gb.keys() == wb.keys()
        for key in gb:
            np.testing.assert_allclose(
                gb[key].double().numpy(), wb[key].double().numpy(),
                rtol=1e-6, atol=1e-6 * float(wb[key].abs().max()),
                err_msg=key)


@pytest.mark.parametrize("case", list(CASES))
def test_f32_step_through_bridge(case, monkeypatch):
    """pbte_tpu's f32 XLA ring (bf16 operand staging off) and the port,
    stepped from the same consts and the same state (its (D, BS) slabs
    swapped to the port's (BS, D)), 3 steps: Tc at the Pallas tests'
    tolerances (tests/test_pallas_ring.py:57-62)."""
    monkeypatch.setenv("PBTE_RING_BF16", "0")
    js = _jax_solver(case, jnp.float32)
    assert not js._ring_stage_bf16
    ts = _port_solver(case, torch.float32)
    ts.consts = consts_from_numpy(jax.tree.map(np.asarray, js.consts),
                                  device="cpu")
    u, Tc, Tv = js.initial_state()
    for _ in range(3):
        ut, Tct, Tvt = state_from_numpy(u, Tc, Tv, device="cpu",
                                         layout="dbs")
        u, Tc, Tv, r = js.step(u, Tc, Tv)
        ut, Tct, Tvt, rt = ts.step(ut, Tct, Tvt)
        np.testing.assert_allclose(Tct.numpy(), np.asarray(Tc), rtol=2e-5,
                                   atol=5e-7)
        np.testing.assert_allclose(float(rt), float(r), rtol=1e-3)


def test_state_from_numpy_layouts():
    """"dbs" slabs (the XLA ring's (.., D, BS, W)) arrive as the port's
    (.., BS, D, W); "bsd" slabs as they are."""
    rng = np.random.default_rng(0)
    u = rng.standard_normal((3, 2, 4, 5, 6, 7))  # (L, Gb, Km, D, BS, W)
    ut, _, _ = state_from_numpy([u], np.zeros(1), np.zeros(1), device="cpu",
                               layout="dbs")
    assert torch.equal(ut[0], torch.from_numpy(u.transpose(0, 1, 2, 4, 3, 5)))
    ut, _, _ = state_from_numpy([u], np.zeros(1), np.zeros(1), device="cpu")
    assert torch.equal(ut[0], torch.from_numpy(u))
    with pytest.raises(ValueError):
        state_from_numpy([u], np.zeros(1), np.zeros(1), device="cpu",
                         layout="sbd")


def _sweep_inputs(dt, seed, L=6, Gb=2, Km=3, BS=4, D=8, W=16, U=5):
    """Random sweep inputs, a random sparse closure source (40% of the
    slots map to one of U rows) and its dense (L, Gb, Km, BS, D, W) form."""
    rng = np.random.default_rng(seed)
    shifts = (0, 4, 1)
    J = (1 + len(shifts)) * D

    def r(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(dt))

    d = dict(
        v=r(L, Gb, Km, BS, D, W), ttc=r(L, Gb, D, W), bsrc=r(L, Gb, Km, D, W),
        cin=-r(L, Gb, Km, len(shifts), W).abs(), bcat=r(Gb, Km, BS, D, J) / J,
        macro_w=r(Gb, Km, BS).abs(), wvec=r(4, BS),
    )
    xmap = np.where(rng.random((L, Gb, W)) < 0.4,
                    rng.integers(0, U, (L, Gb, W)), -1).astype(np.int32)
    xval = r(Gb, U, Km, BS, D)
    dense = np.zeros((L, Gb, Km, BS, D, W), dtype=dt)
    for l, g, w in zip(*np.nonzero(xmap >= 0)):
        dense[l, g, :, :, :, w] = xval[g, xmap[l, g, w]].numpy()
    xsrc = tlr.ClosureSource(torch.from_numpy(xmap), xval)
    return d, xsrc, torch.from_numpy(dense), shifts


def _sweep(d, shifts, **kw):
    return tlr.lattice_ring_sweep_ref(
        d["v"], d["ttc"], d["bsrc"], d["cin"], d["bcat"], d["macro_w"],
        d["wvec"], shifts=shifts, cast_bf16=False, **kw)


def test_xsrc_is_an_rhs_addition_f64():
    """With every relax weight nonzero, a sweep with the sparse xsrc equals
    the sweep without it from v + dense(xsrc) / relax_w (the same rhs), in
    float64."""
    d, xsrc, dense, shifts = _sweep_inputs(np.float64, seed=7)
    d["wvec"][1] = 0.5 + d["wvec"][1].abs()
    ys, ms = _sweep(d, shifts, xsrc=xsrc)
    folded = dict(d, v=d["v"] + dense / d["wvec"][1][:, None, None])
    ys_f, ms_f = _sweep(folded, shifts)
    torch.testing.assert_close(ys, ys_f, rtol=1e-12, atol=1e-14)
    torch.testing.assert_close(ms, ms_f, rtol=1e-12, atol=1e-14)
    ys_0, _ = _sweep(d, shifts)
    assert not torch.allclose(ys, ys_0)


def test_xsrc_matches_float64_loop():
    """The same sum through an independent float64 loop, with relax_w = 0
    on one band (where xsrc cannot fold into v)."""
    d, xsrc, dense, shifts = _sweep_inputs(np.float64, seed=8)
    d["wvec"][1, 0] = 0.0
    ys, ms = _sweep(d, shifts, xsrc=xsrc)
    v, wv = d["v"].numpy(), d["wvec"].numpy()
    L, Gb, Km, BS, D, W = v.shape
    ys_n = np.zeros_like(v)
    ms_n = np.zeros((Gb, Km, L, D, W))
    for g in range(Gb):
        for k in range(Km):
            for b in range(BS):
                ring = np.zeros((D, W))
                for l in range(L):
                    rhs = (wv[0, b] * d["ttc"][l, g].numpy()
                           + wv[1, b] * v[l, g, k, b]
                           - wv[2, b] * d["bsrc"][l, g, k].numpy()
                           + dense[l, g, k, b].numpy())
                    cols = [rhs]
                    for f, s in enumerate(shifts):
                        nb = np.zeros((D, W))
                        nb[:, s:] = ring[:, : W - s]
                        cols.append(nb * d["cin"][l, g, k, f].numpy())
                    ring = d["bcat"][g, k, b].numpy() @ np.concatenate(cols)
                    ys_n[l, g, k, b] = ring
                    ms_n[g, k, l] += d["macro_w"][g, k, b].item() * ring
    np.testing.assert_allclose(ys.numpy(), ys_n, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(ms.numpy(), ms_n, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("case", ["xmap_shape", "xval_shape", "xval_dims",
                                  "xmap_float"])
def test_xsrc_checks(case):
    d, xsrc, _, shifts = _sweep_inputs(np.float32, seed=9)
    xmap, xval = xsrc
    if case == "xmap_shape":
        xmap = xmap[:, :1]
    elif case == "xval_shape":
        xval = xval[:, :, :1]
    elif case == "xval_dims":
        xval = xval[0]
    else:
        xmap = xmap.float()
    with pytest.raises(ValueError, match="xmap|xval"):
        _sweep(d, shifts, xsrc=tlr.ClosureSource(xmap, xval))


def test_kernel_takes_int32_map_and_f32_rows():
    """The CUDA kernel's argument checks (host code) refuse an int64 map
    and float64 rows before any launch."""
    d, xsrc, _, shifts = _sweep_inputs(np.float32, seed=10)
    v = d["v"]
    tlr._kernel_args_ok(v, dict(v=v, xmap=xsrc.xmap, xval=xsrc.xval), False,
                        shifts)
    for bad in (dict(xmap=xsrc.xmap.long()), dict(xval=xsrc.xval.double())):
        with pytest.raises(ValueError, match="xmap|xval"):
            tlr._kernel_args_ok(v, dict(v=v, **bad), False, shifts)


@pytest.mark.parametrize("bf16", [False, True])
def test_closure_step_hands_the_kernel_what_it_takes(monkeypatch, bf16):
    """Every sweep call of a closure step passes a closure source the CUDA
    kernel takes (int32 map, float32 rows), at both state dtypes."""
    if bf16:
        monkeypatch.setenv("PBTE_RING_STATE_BF16", "1")
    ts = _port_solver("all_two_buckets", torch.float32)
    calls = []

    def checked(v, ttc, bsrc, cin, bcat, macro_w, wvec, *, shifts, dsrc,
                xsrc, cast_bf16, win):
        assert xsrc is not None
        tensors = dict(v=v, ttc=ttc, bsrc=bsrc, cin=cin, bcat=bcat,
                       macro_w=macro_w, wvec=wvec, xmap=xsrc.xmap,
                       xval=xsrc.xval)
        assert win is ts.win and win is not None  # windows are on
        tensors["win"] = torch.from_numpy(win)
        tlr._kernel_args_ok(v, tensors, cast_bf16, shifts)
        calls.append(cast_bf16)
        return tlr.lattice_ring_sweep_ref(
            v, ttc, bsrc, cin, bcat, macro_w, wvec, shifts=shifts, dsrc=dsrc,
            xsrc=xsrc, cast_bf16=cast_bf16, win=win)

    ts.ring_sweep = checked
    r = ts.solve(tol=0, max_iter=2, verbose=False)
    assert calls == [bf16] * (2 * len(ts.consts["buckets"]))
    assert torch.isfinite(r.Tc).all()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_windows_change_no_bit_with_closures(case, bf16, monkeypatch):
    """The closure problems run with the same hull windows as the others
    (pbte_tpu windows only problems without lagged closures, because it
    re-lays its windowed state out; the port keeps the full-slab layout and
    the closures address valid slots, which lie inside the windows): with
    windows on and off (the gate closed) the state, Tc, Tv and the
    residual are equal bit for bit after 3 steps, and every closure target
    and source lies inside its level's window."""
    from pbte_tpu_torch.solver import source_iteration as tsi

    monkeypatch.setenv("PBTE_RING_STATE_BF16", "1" if bf16 else "0")
    ts = _port_solver(case, torch.float32)
    monkeypatch.setattr(tsi, "WINDOW_MAX_SHARE", 0.0)
    tf = _port_solver(case, torch.float32)
    assert ts.win is not None and tf.win is None and ts.state_bf16 == bf16
    for cb in ts.consts["buckets"]:
        lvl, _, slot = torch.nonzero(cb["xmap"] >= 0, as_tuple=True)
        lo, hi = torch.from_numpy(ts.win).long()[lvl].T
        assert len(slot) and ((lo <= slot) & (slot < hi)).all()
        for pl, pw in (("per_sl", "per_sw"), ("refl_pl", "refl_pw")):
            if pl in cb:
                lo, hi = torch.from_numpy(ts.win).long()[cb[pl]].unbind(-1)
                assert ((lo <= cb[pw]) & (cb[pw] < hi)).all()
    rw = ts.solve(tol=0, max_iter=3, verbose=False)
    rf = tf.solve(tol=0, max_iter=3, verbose=False)
    assert torch.equal(rw.Tc, rf.Tc) and torch.equal(rw.Tv, rf.Tv)
    assert rw.residual == rf.residual and float(rw.Tc.abs().max()) > 0
    for a, b in zip(rw.u, rf.u):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_bf16_state_closures_track_f32(monkeypatch):
    """bf16 state rounds the state (the closure sources built from it stay
    float32): after 5 steps Tc stays within 1e-2 of the f32 run's scale
    (bf16 keeps ~3 decimal digits)."""
    ref = _port_solver("all_two_buckets", torch.float32).solve(
        tol=0, max_iter=STEPS, verbose=False)
    monkeypatch.setenv("PBTE_RING_STATE_BF16", "1")
    ts = _port_solver("all_two_buckets", torch.float32)
    assert ts.state_bf16
    r = ts.solve(tol=0, max_iter=STEPS, verbose=False)
    scale = float(ref.Tc.abs().max())
    assert float((r.Tc - ref.Tc).abs().max()) < 1e-2 * scale


def test_port_matches_closure_golden_on_cpu():
    """The port's own solver on the CPU against the committed closure
    golden, the check chip_smoke.py repeats on a GPU through the CUDA
    kernel."""
    with np.load(torch_golden.PATH_CLOSURES) as d:
        prob, bcs, kw = torch_golden.closure_solver_args(d, unit_cube)
        Tc_ref = d["Tc"][-1]
        steps = int(d["steps"])
    ts = SourceIterationSolver(*prob, bcs, device="cpu", **kw)
    assert ts.has_periodic and ts._dif_on and ts._spc_on
    r = ts.solve(tol=0, max_iter=steps, verbose=False)
    np.testing.assert_allclose(r.Tc.numpy(), Tc_ref, rtol=2e-5, atol=5e-7)
