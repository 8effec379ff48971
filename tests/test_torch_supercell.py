"""pbte_tpu_torch's supercell ring against pbte_tpu's.

The 6-tet / 2-triangle splits of Cartesian lattices merge into macro-cell
super elements (``fem/supercell.py``) that the supercell two-matmul ring
sweeps (``solver/super_ring.py``). The same problems, each package's
built from its own host layers, go through pbte_tpu's supercell ring (its
XLA ring, ``supercell="on"``), the port's supercell ring and the port's
scan of the fine mesh on the CPU; the block solve is exact, so the three
agree to roundoff. Tolerances are pbte_tpu's own
(``tests/test_supercell.py``): in float64 the residual history to rtol
1e-12 (triangles) and 1e-11 (tets), Tc, Tv, ``u_by_direction`` and
``heat_flux`` to 1e-13 (triangles) and 1e-12 (tets) of each field's max;
in float32 ``rtol=2e-5, atol=5e-7`` on each field over its max, against
pbte_tpu's float32 ring with exact operands (``PBTE_RING_BF16=0``).

Also: the oracle, the walls that gate the merge off, the memory budget,
bf16 state (``PBTE_RING_STATE_BF16=1``) against pbte_tpu's bf16 ring and
the port's float32 ring, with its polish, checkpoint and ``convert``,
checkpoints within and across the packages, the state carried by
``convert``, the accelerated and polished solves, the gmsh production mesh
and the supercell golden.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_golden
from pbte_tpu import mesh as jmesh
from pbte_tpu.angular import quadrature as jang
from pbte_tpu.fem import assembly as jasm
from pbte_tpu.io import checkpoint as jckpt
from pbte_tpu.material import nongray_smrt as jmat
from pbte_tpu.solver.source_iteration import SourceIterationSolver as JaxSolver
from pbte_tpu_torch import convert
from pbte_tpu_torch import mesh as tmesh
from pbte_tpu_torch.angular import quadrature as tang
from pbte_tpu_torch.fem import assembly as tasm
from pbte_tpu_torch.io import checkpoint as tckpt
from pbte_tpu_torch.material import nongray_smrt as tmat
from pbte_tpu_torch.problem import tet_box
from pbte_tpu_torch.solver import super_ring
from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver
from pbte_tpu_torch.validation import oracle as toracle

PKG = {"jax": (jmesh, jasm, jang, jmat), "torch": (tmesh, tasm, tang, tmat)}
MESH_FILE = os.path.join(os.path.dirname(__file__), "..", "config", "mesh",
                         "cuboid_5x5x5.msh")
WALLS_2D = {1: -0.5, 2: 0.0, 3: 0.5, 4: 0.0}
WALLS_3D = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}
STEPS = 4


@pytest.fixture(autouse=True)
def _cpu_float_env():
    """One thread, and f32 subnormals flushed as XLA's CPU backend flushes
    them (tests/test_torch_solver.py::_cpu_float_env)."""
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _problem(pkg, mesh, order, polar, azimuth, nspec=3):
    """(ops, quad, tables) of one package: ``mesh`` "tri" (4x3 triangles,
    2D angles), "tet<nx>x<ny>x<nz>" (6-tet box) or "cuboid" (the gmsh
    production mesh), in microns with consistent faces."""
    m, asm, ang, mat = PKG[pkg]
    if mesh == "tri":
        md = m.make_cartesian_2d(4, 3, m.GEOM_TRIANGLE)
        opts = dict(dimension=2, polar_points=1, azimuth_points=azimuth)
    else:
        md = (m.load_mesh(MESH_FILE) if mesh == "cuboid" else
              m.make_cartesian_3d(*map(int, mesh[3:].split("x")), m.GEOM_TET))
        opts = dict(dimension=3, polar_points=polar, azimuth_points=azimuth)
    ops = asm.assemble(m.connect(md.scaled(1e-6)), order=order,
                       face_mode="consistent")
    return (ops, ang.build(ang.AngularOptions(**opts)),
            mat.build_tables(mat.SILICON, num_spectral=nspec))


def _np(t):
    return np.asarray(t.detach().double().numpy() if torch.is_tensor(t)
                      else t, dtype=np.float64)


def _run(s, n=STEPS, state=None):
    st = s.initial_state() if state is None else state
    hist = []
    for _ in range(n):
        u, Tc, Tv, r = s.step(*st)
        st = (u, Tc, Tv)
        hist.append(float(r))
    return st, hist


def _close(got, want, rel, name):
    want, got = _np(want), _np(got)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{name}: {err / scale:.3e} of max > {rel}"


def _three(mesh, order, polar, azimuth, **kw):
    """pbte_tpu's supercell ring, the port's and the port's scan, each run
    STEPS steps in float64 from the zero state."""
    jp = _problem("jax", mesh, order, polar, azimuth)
    tp = _problem("torch", mesh, order, polar, azimuth)
    bcs = WALLS_2D if mesh == "tri" else WALLS_3D
    js = JaxSolver(*jp, bcs, dtype=jnp.float64, sweep_mode="ring",
                   supercell="on", **kw)
    ts = SourceIterationSolver(*tp, bcs, dtype=torch.float64, device="cpu",
                               sweep_mode="ring", supercell="on", **kw)
    tscan = SourceIterationSolver(*tp, bcs, dtype=torch.float64,
                                  device="cpu", sweep_mode="scan",
                                  supercell="off", **kw)
    assert js._super is not None and ts._super is not None
    assert ts.sweep_mode == "ring" and tscan.sweep_mode == "scan"
    assert (ts.G, ts.Km, ts.L, ts.W, ts.D) == (js.G, js.Km, js.L, js.W, js.D)
    return [(s,) + _run(s) for s in (js, ts, tscan)]


def _assert_exact(runs, hist_rtol, rel):
    (js, (uj, Tcj, Tvj), hj), (ts, (ut, Tct, Tvt), ht), \
        (tsc, (us, Tcs, Tvs), hs) = runs
    np.testing.assert_allclose(ht, hj, rtol=hist_rtol)
    np.testing.assert_allclose(ht, hs, rtol=hist_rtol)
    _close(Tct, Tcj, rel, "Tc vs pbte_tpu")
    _close(ts.Tc_fine(Tct), js.Tc_fine(Tcj), rel, "Tc_fine vs pbte_tpu")
    _close(ts.Tc_fine(Tct), Tcs, rel, "Tc_fine vs the scan")
    _close(Tvt, Tvj, rel, "Tv vs pbte_tpu")
    _close(Tvt, Tvs, rel, "Tv vs the scan")
    ud = ts.u_by_direction(ut)
    _close(ud, js.u_by_direction(uj), rel, "u_by_direction vs pbte_tpu")
    _close(ud, tsc.u_by_direction(us), rel, "u_by_direction vs the scan")
    for name, a, b, c in zip(("Qc", "Qv"), ts.heat_flux(ut),
                             js.heat_flux(uj), tsc.heat_flux(us)):
        _close(a, b, rel, f"{name} vs pbte_tpu")
        _close(a, c, rel, f"{name} vs the scan")


def test_tri_lattice_iterate_exact():
    runs = _three("tri", 1, 1, 8)
    assert runs[1][0].G == 4  # quadrant sign patterns only
    _assert_exact(runs, 1e-12, 1e-13)


@pytest.mark.parametrize("order", [1, 2])
def test_six_tet_iterate_exact(order):
    runs = _three("tet3x2x2", order, 4, 4)
    ts, tsc = runs[1][0], runs[2][0]
    assert ts.G == 8  # octant groups, not the fine signature groups
    assert ts.D == 6 * tsc.D and ts.ne_tv == tsc.ne
    _assert_exact(runs, 1e-11, 1e-12)


def test_gmsh_production_mesh_at_a_small_angular_set():
    """The reference's production mesh (config/mesh/cuboid_5x5x5.msh, 750
    tets) with the defaults: both packages merge it (ne >= 512) and take
    the supercell ring; the port's equals pbte_tpu's and the port's scan."""
    jp = _problem("jax", "cuboid", 1, 2, 4, nspec=2)
    tp = _problem("torch", "cuboid", 1, 2, 4, nspec=2)
    js = JaxSolver(*jp, WALLS_3D, dtype=jnp.float64)
    ts = SourceIterationSolver(*tp, WALLS_3D, dtype=torch.float64,
                               device="cpu")
    tsc = SourceIterationSolver(*tp, WALLS_3D, dtype=torch.float64,
                                device="cpu", sweep_mode="scan")
    assert js._super is not None and ts._super is not None
    assert (ts.G, ts.D, ts.ne, ts.L, ts.W) == (8, 24, 125, 13, 25)
    (_, Tcj, Tvj), hj = _run(js, 2)
    (_, Tct, Tvt), ht = _run(ts, 2)
    (_, Tcs, _), hs = _run(tsc, 2)
    np.testing.assert_allclose(ht, hj, rtol=1e-11)
    np.testing.assert_allclose(ht, hs, rtol=1e-11)
    _close(Tct, Tcj, 1e-12, "Tc vs pbte_tpu")
    _close(Tvt, Tvj, 1e-12, "Tv vs pbte_tpu")
    _close(ts.Tc_fine(Tct), Tcs, 1e-12, "Tc_fine vs the scan")


@pytest.mark.parametrize("mesh,order", [("tri", 1), ("tet3x2x2", 1),
                                        ("tet3x2x2", 2)])
def test_float32_against_pbte_tpu(mesh, order, monkeypatch):
    """float32 state against pbte_tpu's float32 ring with exact operands,
    at pbte_tpu's f32 tolerance."""
    monkeypatch.setenv("PBTE_RING_BF16", "0")
    jp = _problem("jax", mesh, order, 2, 4)
    tp = _problem("torch", mesh, order, 2, 4)
    bcs = WALLS_2D if mesh == "tri" else WALLS_3D
    js = JaxSolver(*jp, bcs, dtype=jnp.float32, supercell="on")
    ts = SourceIterationSolver(*tp, bcs, device="cpu", supercell="on")
    assert js._super is not None and not js._ring_stage_bf16
    assert ts._super is not None and ts.state_dtype == torch.float32
    (uj, Tcj, Tvj), hj = _run(js, 3)
    (ut, Tct, Tvt), ht = _run(ts, 3)
    np.testing.assert_allclose(ht, hj, rtol=2e-5)
    for name, a, b in (("Tc", Tct, Tcj), ("Tv", Tvt, Tvj),
                       ("u", ts.u_by_direction(ut), js.u_by_direction(uj))):
        want, got = _np(b), _np(a)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, rtol=2e-5,
                                   atol=5e-7, err_msg=name)


def test_six_tet_oracle_convergence():
    """The converged solve through the port's supercell ring equals the
    sequential numpy oracle (the port's validation/oracle.py) on the fine
    mesh."""
    tp = _problem("torch", "tet2x2x2", 1, 2, 4)
    s = SourceIterationSolver(*tp, WALLS_3D, dtype=torch.float64,
                              device="cpu", supercell="on")
    assert s._super is not None
    res = s.solve(tol=1e-10, max_iter=200, verbose=False)
    _u, Tc_o, _tv, _res, _it = toracle.solve_oracle(
        *tp, WALLS_3D, tol=1e-10, max_iter=200)
    _close(s.Tc_fine(res.Tc), Tc_o, 1e-9, "Tc vs the oracle")


@pytest.mark.parametrize("closure", ["dirichlet", "diffuse", "specular",
                                     "periodic"])
def test_forced_ring_unsupported_bcs_fall_back(closure):
    """Dirichlet, diffuse, specular and periodic walls gate the merge off in
    both packages (their closures live on the fine paths): the fine mesh
    is scanned."""
    if closure == "periodic":
        probs = []
        for pkg in ("jax", "torch"):
            m, asm, ang, mat = PKG[pkg]
            md = m.make_periodic(m.make_cartesian_3d(2, 2, 2, m.GEOM_TET),
                                 [0]).scaled(1e-6)
            probs.append((asm.assemble(m.connect(md), order=1,
                                       face_mode="consistent"),
                          ang.build(ang.AngularOptions(
                              dimension=3, polar_points=2, azimuth_points=4)),
                          mat.build_tables(mat.SILICON, num_spectral=3)))
        jp, tp = probs
        bcs, kw = {1: -0.5, 2: -0.5, 4: -0.5, 6: 0.5}, {}
    else:
        jp = _problem("jax", "tet2x2x2", 1, 2, 4)
        tp = _problem("torch", "tet2x2x2", 1, 2, 4)
        bcs = {a: -0.5 for a in range(1, 6)}
        kw = ({"dirichlet_bcs": {6: 0.1}} if closure == "dirichlet" else
              {f"{closure}_bcs": [6]})
    js = JaxSolver(*jp, bcs, dtype=jnp.float64, supercell="on", **kw)
    ts = SourceIterationSolver(*tp, bcs, dtype=torch.float64, device="cpu",
                               supercell="on", **kw)
    assert js._super is None and ts._super is None
    assert ts.sweep_mode == "scan" and ts.ne_tv == ts.ne


def test_budget_resolves_to_the_scan(monkeypatch):
    """Past super_ring.SUPER_BUDGET the merge is not taken and the fine
    mesh is scanned; sweep_mode="ring" takes the merge whatever the
    budget, as pbte_tpu's forced ring does."""
    tp = _problem("torch", "tet2x2x2", 1, 2, 4)
    monkeypatch.setattr(super_ring, "SUPER_BUDGET", 0)
    s = SourceIterationSolver(*tp, WALLS_3D, device="cpu", supercell="on")
    assert s._super is None and s.sweep_mode == "scan"
    s = SourceIterationSolver(*tp, WALLS_3D, device="cpu", supercell="on",
                              sweep_mode="ring")
    assert s._super is not None and s.sweep_mode == "ring"
    assert super_ring.super_ring_bytes(s._super, s.K, s.BS, 4) > 0


BF16_CASES = [("tet3x2x2", 1), ("tet3x2x2", 2), ("tri", 1)]


def _bf16_pair(mesh, order, monkeypatch):
    """pbte_tpu's and the port's float32 supercell rings with bf16 state
    (PBTE_RING_STATE_BF16=1)."""
    monkeypatch.setenv("PBTE_RING_STATE_BF16", "1")
    bcs = WALLS_2D if mesh == "tri" else WALLS_3D
    js = JaxSolver(*_problem("jax", mesh, order, 2, 4), bcs,
                   dtype=jnp.float32, supercell="on")
    ts = SourceIterationSolver(*_problem("torch", mesh, order, 2, 4), bcs,
                               device="cpu", supercell="on")
    assert js._super is not None and js._ring_state_bf16
    assert ts._super is not None and ts.state_bf16
    assert ts.state_dtype == torch.bfloat16
    return js, ts, bcs


@pytest.mark.parametrize("mesh,order", BF16_CASES)
def test_bf16_state_against_pbte_tpu(mesh, order, monkeypatch):
    """bf16 state against pbte_tpu's bf16 supercell ring, each step from
    pbte_tpu's state carried across (``convert``). Both round the coupling
    operand and the couplings to bf16 and accumulate in f32, but at other
    products: the port scales the operand by -vg/sigma before rounding it
    (the subnormal guard of this module's docstring), pbte_tpu rounds the
    unscaled one and applies vg after the product. So the roundings differ,
    and Tc agrees to 1e-3 of max (measured 1.0e-4 to 2.4e-4 per step on
    these three cases)."""
    js, ts, _ = _bf16_pair(mesh, order, monkeypatch)
    u, Tc, Tv = js.initial_state()
    assert u[0].dtype == jnp.bfloat16
    for _ in range(4):
        st = convert.state_from_numpy([np.asarray(b) for b in u],
                                      np.asarray(Tc), np.asarray(Tv),
                                      device="cpu", supercell=True)
        assert st[0][0].dtype == torch.bfloat16
        u, Tc, Tv, _ = js.step(u, Tc, Tv)
        ut, Tct, _, _ = ts.step(*st)
        assert ut[0].dtype == torch.bfloat16 and Tct.dtype == torch.float32
        _close(Tct, Tc, 1e-3, "Tc vs pbte_tpu's bf16 ring")


@pytest.mark.parametrize("mesh,order", BF16_CASES)
def test_bf16_state_against_f32(mesh, order, monkeypatch):
    """3 steps from the zero state with bf16 state against the port's
    float32 ring: Tc to 3e-3 of max (measured 2.9e-4 to 9.3e-4), finite
    and falling residuals."""
    _, ts, bcs = _bf16_pair(mesh, order, monkeypatch)
    (_, Tcb, _), hb = _run(ts, 3)
    monkeypatch.delenv("PBTE_RING_STATE_BF16")
    t32 = SourceIterationSolver(*_problem("torch", mesh, order, 2, 4), bcs,
                                device="cpu", supercell="on")
    assert t32.state_dtype == torch.float32
    (_, Tc32, _), h32 = _run(t32, 3)
    _close(Tcb, Tc32, 3e-3, "bf16 Tc vs f32")
    assert np.all(np.isfinite(hb)) and hb[-1] < hb[0]


def test_bf16_state_refused_in_float64(monkeypatch):
    """PBTE_RING_STATE_BF16=1 rounds float32 state: a float64 solver on the
    supercell ring refuses it, as on the lattice ring."""
    monkeypatch.setenv("PBTE_RING_STATE_BF16", "1")
    tp = _problem("torch", "tet2x2x2", 1, 2, 4)
    with pytest.raises(ValueError, match="float64"):
        SourceIterationSolver(*tp, WALLS_3D, dtype=torch.float64,
                              device="cpu", supercell="on")


def test_bf16_polish_steps_a_float32_copy(monkeypatch):
    """solve(polish_iters=1) after bf16 steps steps a float32 copy of the
    state exactly (the step takes its mode from the state's dtype): the
    same as one float32-state step of the same solver by hand, and as one
    step of a float32 solver."""
    _, ts, bcs = _bf16_pair("tet3x2x2", 1, monkeypatch)
    r = ts.solve(tol=0, max_iter=3, verbose=False, polish_iters=1)
    assert r.u[0].dtype == torch.float32 and r.iterations == 4
    (u, Tc, Tv), _ = _run(ts, 3)
    assert u[0].dtype == torch.bfloat16
    u32 = tuple(b.float() for b in u)
    up, Tcp, _, _ = ts.step(u32, Tc, Tv)
    assert all(torch.equal(a, b) for a, b in zip(r.u, up))
    assert torch.equal(r.Tc, Tcp)
    monkeypatch.delenv("PBTE_RING_STATE_BF16")
    t32 = SourceIterationSolver(*_problem("torch", "tet3x2x2", 1, 2, 4), bcs,
                                device="cpu", supercell="on")
    _, Tc32, _, _ = t32.step(u32, Tc, Tv)
    assert torch.equal(Tc32, Tcp)


def test_bf16_checkpoint_and_convert_roundtrip(monkeypatch, tmp_path):
    """A bf16 supercell state saves (as float32, exact) and loads back in
    bf16 bit for bit; the resumed run equals the uninterrupted one bit for
    bit; convert carries it to pbte_tpu's layout and back."""
    _, ts, _ = _bf16_pair("tet3x2x2", 1, monkeypatch)
    full = ts.solve(tol=0, max_iter=5, verbose=False)
    half = ts.solve(tol=0, max_iter=3, verbose=False)
    ck = str(tmp_path / "super_bf16.npz")
    tckpt.save_checkpoint(ck, ts, half.u, half.Tc, half.Tv, 3, half.residual)
    (u, Tc, Tv), it, _ = tckpt.load_checkpoint(ck, ts)
    assert it == 3
    assert all(a.dtype == torch.bfloat16 and torch.equal(a, b)
               for a, b in zip(u, half.u))
    resumed = ts.solve(tol=0, max_iter=2, verbose=False, state=(u, Tc, Tv))
    assert torch.equal(resumed.Tc, full.Tc)
    back = convert.super_state_to_numpy(half.u)
    assert back[0].dtype == np.float32
    st = convert.state_from_numpy(back, half.Tc.numpy(), half.Tv.numpy(),
                                  device="cpu", supercell=True,
                                  state_dtype=torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(st[0], half.u))


def test_supercell_off_keeps_the_fine_mesh():
    tp = _problem("torch", "cuboid", 1, 2, 4, nspec=2)
    s = SourceIterationSolver(*tp, WALLS_3D, device="cpu", supercell="off")
    assert s._super is None and s.sweep_mode == "scan"
    with pytest.raises(ValueError, match="supercell"):
        SourceIterationSolver(*tp, WALLS_3D, device="cpu", supercell="yes")


def _ckpt_problem(pkg):
    return _problem(pkg, "tet3x2x2", 1, 2, 4)


def test_supercell_checkpoint_roundtrip(tmp_path):
    """The port's supercell state saves and loads; the resumed run equals
    the uninterrupted one, and Tv is per fine element."""
    s = SourceIterationSolver(*_ckpt_problem("torch"), WALLS_3D,
                              dtype=torch.float64, device="cpu",
                              supercell="on")
    assert s._super is not None
    full = s.solve(tol=0, max_iter=6, verbose=False)
    half = s.solve(tol=0, max_iter=3, verbose=False)
    ck = str(tmp_path / "super.npz")
    tckpt.save_checkpoint(ck, s, half.u, half.Tc, half.Tv, 3, half.residual)
    state, it, _ = tckpt.load_checkpoint(ck, s)
    assert it == 3
    resumed = s.solve(tol=0, max_iter=3, verbose=False, state=state)
    np.testing.assert_allclose(_np(resumed.Tc), _np(full.Tc), rtol=1e-12,
                               atol=1e-18)
    assert tuple(full.Tv.shape) == (s.ne_tv,)


@pytest.mark.parametrize("writer", ["pbte_tpu", "port"])
def test_supercell_checkpoint_across_packages(writer, tmp_path):
    """A supercell checkpoint of one package resumes in the other to the
    uninterrupted run's Tc at 1e-12 of max (pbte_tpu's field layout and
    fingerprint in both)."""
    js = JaxSolver(*_ckpt_problem("jax"), WALLS_3D, dtype=jnp.float64,
                   supercell="on")
    ts = SourceIterationSolver(*_ckpt_problem("torch"), WALLS_3D,
                               dtype=torch.float64, device="cpu",
                               supercell="on")
    ck = str(tmp_path / "super.npz")
    src, dst, save, load = ((js, ts, jckpt.save_checkpoint,
                             tckpt.load_checkpoint)
                            if writer == "pbte_tpu" else
                            (ts, js, tckpt.save_checkpoint,
                             jckpt.load_checkpoint))
    full = src.solve(tol=0, max_iter=6, verbose=False)
    half = src.solve(tol=0, max_iter=3, verbose=False)
    save(ck, src, half.u, half.Tc, half.Tv, 3, half.residual)
    state, it, _ = load(ck, dst)
    assert it == 3
    resumed = dst.solve(tol=0, max_iter=3, verbose=False, state=state)
    _close(resumed.Tc, full.Tc, 1e-12, "resumed Tc")


def test_convert_carries_the_state_both_ways():
    """pbte_tpu's supercell state through state_from_numpy steps in the
    port to pbte_tpu's next iterate; super_state_to_numpy gives pbte_tpu's
    layout back."""
    js = JaxSolver(*_ckpt_problem("jax"), WALLS_3D, dtype=jnp.float64,
                   supercell="on")
    ts = SourceIterationSolver(*_ckpt_problem("torch"), WALLS_3D,
                               dtype=torch.float64, device="cpu",
                               supercell="on")
    (uj, Tcj, Tvj), _ = _run(js, 2)
    st = convert.state_from_numpy([np.asarray(b) for b in uj],
                                  np.asarray(Tcj), np.asarray(Tvj),
                                  device="cpu", supercell=True)
    back = convert.super_state_to_numpy(st[0])
    for a, b in zip(back, uj):
        np.testing.assert_array_equal(a, np.asarray(b))
    _, Tcj2, Tvj2, rj = js.step(uj, Tcj, Tvj)
    _, Tct2, Tvt2, rt = ts.step(*st)
    _close(Tct2, Tcj2, 1e-12, "Tc")
    _close(Tvt2, Tvj2, 1e-12, "Tv")
    assert abs(float(rt) - float(rj)) <= 1e-12 * abs(float(rj))
    with pytest.raises(ValueError, match="supercell"):
        convert.consts_from_numpy({"super_scat": np.zeros(1)}, device="cpu")


def test_solve_options_run_on_the_ring():
    """solve() with cycle_hook, polish_iters and accelerate="bicgstab" runs
    through the generic code on this path: BiCGStab on the supercell ring
    equals BiCGStab on the scan of the fine mesh."""
    tp = _problem("torch", "tet2x2x2", 1, 2, 4)
    kw = dict(dtype=torch.float64, device="cpu")
    s = SourceIterationSolver(*tp, WALLS_3D, supercell="on", **kw)
    scan = SourceIterationSolver(*tp, WALLS_3D, sweep_mode="scan", **kw)
    assert s._super is not None
    seen = []
    r = s.solve(tol=0, max_iter=4, verbose=False, cycle_every=2,
                cycle_hook=lambda it, u, Tc, Tv: seen.append(
                    (it, tuple(Tv.shape))), polish_iters=2,
                polish_extrapolate=True)
    assert seen == [(2, (s.ne_tv,)), (4, (s.ne_tv,))]
    assert r.iterations == 8 and np.isfinite(r.residual)
    ra = s.solve(tol=0, max_iter=8, verbose=False, accelerate="bicgstab")
    rs = scan.solve(tol=0, max_iter=8, verbose=False, accelerate="bicgstab")
    assert ra.iterations == rs.iterations
    _close(s.Tc_fine(ra.Tc), rs.Tc, 1e-10, "BiCGStab Tc vs the scan")


def test_supercell_golden_file_is_current():
    """tests/data/torch_port_golden_super.npz is what pbte_tpu gives now."""
    for path, build in torch_golden.SUPER_GOLDENS.items():
        fresh = build()
        with np.load(path) as d:
            assert sorted(d.files) == sorted(fresh)
            for k, v in fresh.items():
                np.testing.assert_array_equal(d[k], v, err_msg=k)


def test_port_matches_the_supercell_golden():
    """The port's float32 supercell ring on the CPU against the golden, at
    chip_smoke.py's tolerance (2e-5 of max)."""
    with np.load(torch_golden.PATH_SUPER) as d:
        params = {k: int(d[k]) for k in torch_golden.SUPER_PARAMS}
        bcs = dict(zip(d["bc_attrs"].tolist(), d["bc_temps"].tolist()))
        ref, steps = d["Tc"][-1], int(d["steps"])
    s = SourceIterationSolver(*tet_box(**params), bcs, device="cpu",
                              supercell="on")
    r = s.solve(tol=0, max_iter=steps, verbose=False)
    _close(r.Tc, ref, 2e-5, "Tc vs the golden")
