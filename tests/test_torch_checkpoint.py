"""pbte_tpu_torch's checkpoints (io/checkpoint.py) against pbte_tpu's.

Round trips in the port on the scan and the lattice ring (hull windows on,
bfloat16 state); files written by either package loaded by the other for
the same problem (pbte_tpu's scan, its Pallas-layout ring "bsd" and its
XLA ring "dbs"; its hull-windowed XLA-ring files are refused with the
reason); fingerprint mismatches; ``accel_ckpt_saver`` and
``solve(checkpoint_path=...)`` resuming to the same iterate. The port's
forms of pbte_tpu's tests/test_io_extra.py::test_checkpoint_roundtrip and
tests/test_ring.py::test_ring_windowed_checkpoint_roundtrip are here too.
"""

import os
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_golden
from pbte_tpu import mesh as jmesh
from pbte_tpu.angular import quadrature as jang
from pbte_tpu.fem import assembly as jasm
from pbte_tpu.io import checkpoint as jck
from pbte_tpu.material import nongray_smrt as jmat
from pbte_tpu.solver.source_iteration import SourceIterationSolver as JaxSolver
from pbte_tpu_torch import mesh as tmesh
from pbte_tpu_torch.angular import quadrature as tang
from pbte_tpu_torch.fem import assembly as tasm
from pbte_tpu_torch.io import checkpoint as tck
from pbte_tpu_torch.material import nongray_smrt as tmat
from pbte_tpu_torch.problem import WALL_BCS, unit_cube
from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

SQUARE = pathlib.Path(__file__).resolve().parents[1] / "config" / "mesh" \
    / "unit-square-iso.mesh"
SQUARE_BCS = {1: -0.5, 2: 0.5}
PKG = {"jax": (jmesh, jasm, jang, jmat), "torch": (tmesh, tasm, tang, tmat)}


@pytest.fixture(autouse=True)
def _cpu_float_env():
    """One thread, f32 subnormals flushed as XLA's CPU backend flushes
    them (tests/test_torch_solver.py::_cpu_float_env)."""
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _square(pkg, nspec=3):
    """The 2-element demo mesh with 2D angles (pbte_tpu's
    test_checkpoint_roundtrip problem, its default mfem-parity faces)."""
    m, asm, ang, mat = PKG[pkg]
    ops = asm.assemble(m.connect(m.load_mesh(str(SQUARE)).scaled(1e-6)),
                       order=1)
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    return ops, quad, mat.build_tables(mat.SILICON, num_spectral=nspec)


def _tet(pkg):
    """A 2x2x2 6-tet cube at p=2, consistent faces (scan path)."""
    m, asm, ang, mat = PKG[pkg]
    md = m.make_cartesian_3d(2, 2, 2, m.GEOM_TET).scaled(1e-6)
    ops = asm.assemble(m.connect(md), order=2, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    return ops, quad, mat.build_tables(mat.SILICON, num_spectral=2)


def _cube(pkg, n=8):
    return (torch_golden.jax_unit_cube if pkg == "jax" else unit_cube)(
        n, n, n, order=1, polar=2, azimuth=4, nspec=2)


def _np(t):
    return t.detach().double().numpy()


def _close(a, b, f64):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    scale = np.abs(a).max()
    if f64:
        assert np.abs(b - a).max() <= 1e-12 * scale
    else:
        np.testing.assert_allclose(b / scale, a / scale, rtol=2e-5,
                                   atol=5e-7)


# ---- round trips in the port ------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    """pbte_tpu's tests/test_io_extra.py::test_checkpoint_roundtrip on the
    port: 6 steps straight equal 3, a checkpoint, a reload and 3 more; a
    solver with other bands refuses the file."""
    solver = SourceIterationSolver(*_square("torch"), SQUARE_BCS,
                                   dtype=torch.float64, device="cpu")
    assert solver.sweep_mode == "scan"
    r_full = solver.solve(tol=0, max_iter=6, verbose=False)
    r_half = solver.solve(tol=0, max_iter=3, verbose=False)
    ckpt = str(tmp_path / "state.npz")
    tck.save_checkpoint(ckpt, solver, r_half.u, r_half.Tc, r_half.Tv, 3,
                        r_half.residual)
    state, it, res = tck.load_checkpoint(ckpt, solver)
    assert it == 3 and res == r_half.residual
    r_resumed = solver.solve(tol=0, max_iter=3, verbose=False, state=state)
    np.testing.assert_allclose(_np(r_resumed.Tc), _np(r_full.Tc),
                               rtol=1e-12, atol=1e-15)
    other = SourceIterationSolver(*_square("torch", nspec=4), SQUARE_BCS,
                                  dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="checkpoint mismatch"):
        tck.load_checkpoint(ckpt, other)


def test_ring_windowed_checkpoint_roundtrip(tmp_path):
    """pbte_tpu's tests/test_ring.py::test_ring_windowed_checkpoint_roundtrip
    on the port: the lattice ring with hull windows on keeps its full-slab
    state, and a resumed run equals the full run."""
    s = SourceIterationSolver(*_cube("torch", 16), WALL_BCS,
                              dtype=torch.float64, device="cpu")
    assert s.sweep_mode == "ring" and s.win is not None
    full = s.solve(tol=0, max_iter=4, verbose=False)
    half = s.solve(tol=0, max_iter=2, verbose=False)
    ck = str(tmp_path / "win.npz")
    tck.save_checkpoint(ck, s, half.u, half.Tc, half.Tv, 2, half.residual)
    state, it, _ = tck.load_checkpoint(ck, s)
    assert it == 2
    resumed = s.solve(tol=0, max_iter=2, verbose=False, state=state)
    np.testing.assert_allclose(_np(resumed.Tc), _np(full.Tc), rtol=1e-12,
                               atol=1e-15)


def test_bf16_state_roundtrip(tmp_path, monkeypatch):
    """bfloat16 ring state goes through the file as float32 and comes back
    bfloat16, bit for bit."""
    monkeypatch.setenv("PBTE_RING_STATE_BF16", "1")
    s = SourceIterationSolver(*_cube("torch"), WALL_BCS, device="cpu")
    assert s.state_bf16
    r = s.solve(tol=0, max_iter=2, verbose=False)
    ck = str(tmp_path / "bf16")
    tck.save_checkpoint(ck, s, r.u, r.Tc, r.Tv, 2, r.residual)
    with np.load(ck + ".npz") as d:
        assert d["u_0"].dtype == np.float32 and str(d["u_layout"]) == "bsd"
    state, _, _ = tck.load_checkpoint(ck + ".npz", s)
    assert state[0][0].dtype == torch.bfloat16
    for a, b in zip(state[0], r.u):
        assert torch.equal(a, b)


@pytest.mark.parametrize("path", ["scan", "ring"])
def test_solve_checkpoint_resumes_to_the_same_iterate(path, tmp_path):
    """solve(checkpoint_path=, checkpoint_every=) writes the state at the
    cadence; resuming from the file continues the same iterates, on the
    scan and on the ring."""
    prob = _tet("torch") if path == "scan" else _cube("torch")
    s = SourceIterationSolver(*prob, WALL_BCS, dtype=torch.float64,
                              device="cpu")
    assert s.sweep_mode == path
    ck = str(tmp_path / "run.npz")
    s.solve(tol=0, max_iter=5, verbose=False, checkpoint_path=ck,
            checkpoint_every=2)
    state, it, res = tck.load_checkpoint(ck, s)
    assert it == 4 and np.isfinite(res)
    full = s.solve(tol=0, max_iter=7, verbose=False)
    resumed = s.solve(tol=0, max_iter=3, verbose=False, state=state)
    assert torch.equal(resumed.Tc, full.Tc)
    assert torch.equal(resumed.Tv, full.Tv)


@pytest.mark.parametrize("path", ["scan", "ring"])
def test_accel_ckpt_saver(path, tmp_path):
    """accel_ckpt_saver writes the Krylov iterate with the step count and
    zeros for Tv; solve(accelerate="bicgstab", checkpoint_path=...) writes
    it every checkpoint_every BiCGStab iterations, with its linear relative
    residual: the true residual ||F(x) - x|| / ||F(0)|| of the saved x
    (the warm start's first residual) equals it to 1e-6 (the recurrence's
    residual drifts from the true one by rounding only)."""
    from pbte_tpu_torch.solver import accel

    prob = _tet("torch") if path == "scan" else _cube("torch")
    s = SourceIterationSolver(*prob, WALL_BCS, dtype=torch.float64,
                              device="cpu")
    u, Tc, Tv = s.initial_state()
    u, Tc, Tv, _ = s.step(u, Tc, Tv)
    ck = str(tmp_path / "saver.npz")
    tck.accel_ckpt_saver(ck, s, torch.zeros_like(Tv))(u, Tc, 7, 0.25)
    (u2, Tc2, Tv2), it, res = tck.load_checkpoint(ck, s)
    assert (it, res) == (7, 0.25) and not Tv2.any()
    assert torch.equal(Tc2, Tc)
    ck = str(tmp_path / "krylov.npz")
    r = s.solve(tol=0, max_iter=12, verbose=False, accelerate="bicgstab",
                checkpoint_path=ck, checkpoint_every=2)
    state, it, res = tck.load_checkpoint(ck, s)
    assert 0 < it < r.iterations and np.isfinite(res)
    u0, Tc0, Tv0 = s.initial_state()
    b = s.step(u0, Tc0, Tv0)[:2]
    fx = s.step(state[0], state[1], Tv0)[:2]
    r = accel.tree_comb([(1.0, fx), (-1.0, (state[0], state[1]))])
    relres = float(torch.sqrt(accel.tree_dot(r, r) / accel.tree_dot(b, b)))
    assert relres == pytest.approx(res, rel=1e-6)
    warm = s.solve(tol=0, max_iter=6, verbose=False, accelerate="bicgstab",
                   state=state)
    assert torch.isfinite(warm.Tc).all()


def test_fingerprints_refuse_other_problems(tmp_path):
    """Scan and ring files do not load into each other's solvers, nor into
    a solver with another cache policy or mesh."""
    scan = SourceIterationSolver(*_tet("torch"), WALL_BCS,
                                 dtype=torch.float64, device="cpu")
    ring = SourceIterationSolver(*_cube("torch"), WALL_BCS,
                                 dtype=torch.float64, device="cpu")
    files = {}
    for name, s in (("scan", scan), ("ring", ring)):
        r = s.solve(tol=0, max_iter=1, verbose=False)
        files[name] = str(tmp_path / f"{name}.npz")
        tck.save_checkpoint(files[name], s, r.u, r.Tc, r.Tv, 1, r.residual)
    with pytest.raises(ValueError, match="checkpoint"):
        tck.load_checkpoint(files["scan"], ring)
    with pytest.raises(ValueError, match="checkpoint"):
        tck.load_checkpoint(files["ring"], scan)
    eig = SourceIterationSolver(*_tet("torch"), WALL_BCS, dtype=torch.float64,
                                device="cpu", cache_policy="on-the-fly")
    with pytest.raises(ValueError, match="checkpoint mismatch: cache_policy"):
        tck.load_checkpoint(files["scan"], eig)
    other = SourceIterationSolver(*_cube("torch", 9), WALL_BCS,
                                  dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="checkpoint mismatch"):
        tck.load_checkpoint(files["ring"], other)


# ---- across the packages ------------------------------------------------------

def _cross(kind):
    """(pbte_tpu solver, port solver, f64) for the same problem: the scan
    on the tet cube, pbte_tpu's Pallas ring (f32, interpreted) or its XLA
    ring (f64) on the hex 8^3 lattice."""
    if kind == "scan":
        return (JaxSolver(*_tet("jax"), WALL_BCS, dtype=jnp.float64),
                SourceIterationSolver(*_tet("torch"), WALL_BCS,
                                      dtype=torch.float64, device="cpu"),
                True)
    if kind == "pallas":
        js = JaxSolver(*_cube("jax"), WALL_BCS, dtype=jnp.float32,
                       use_pallas="on")
        assert js._use_pallas_ring
        return (js, SourceIterationSolver(*_cube("torch"), WALL_BCS,
                                          device="cpu"), False)
    js = JaxSolver(*_cube("jax"), WALL_BCS, dtype=jnp.float64,
                   sweep_mode="ring", use_pallas="off")
    assert js.sweep_mode == "ring" and not js._ring_windowed
    return (js, SourceIterationSolver(*_cube("torch"), WALL_BCS,
                                      dtype=torch.float64, device="cpu"),
            True)


@pytest.mark.parametrize("kind", ["scan", "pallas", "xla_ring"])
def test_pbte_tpu_checkpoint_loads_in_the_port(kind, tmp_path):
    """A pbte_tpu checkpoint loads into the port (u_layout "bsd" as it is,
    "dbs" transposed), bit for bit, and both packages resume from it to
    the same iterate."""
    js, ts, f64 = _cross(kind)
    rj = js.solve(tol=0, max_iter=2, verbose=False)
    ck = str(tmp_path / "jax.npz")
    jck.save_checkpoint(ck, js, rj.u, rj.Tc, rj.Tv, 2, rj.residual)
    with np.load(ck) as d:
        if kind != "scan":
            assert str(d["u_layout"]) == ("bsd" if kind == "pallas"
                                          else "dbs")
    (u, Tc, Tv), it, res = tck.load_checkpoint(ck, ts)
    assert (it, res) == (2, rj.residual)
    np.testing.assert_array_equal(_np(Tc), np.asarray(rj.Tc))
    if kind == "scan":
        np.testing.assert_array_equal(_np(u), np.asarray(rj.u))
    else:
        want = js._ring_u_standard(rj.u)
        np.testing.assert_array_equal(ts._ring_u_standard(u), want)
    state_j, _, _ = jck.load_checkpoint(ck, js)
    a = js.solve(tol=0, max_iter=2, verbose=False, state=state_j)
    b = ts.solve(tol=0, max_iter=2, verbose=False, state=(u, Tc, Tv))
    _close(a.Tc, _np(b.Tc), f64)


@pytest.mark.parametrize("kind", ["scan", "pallas", "xla_ring"])
def test_port_checkpoint_loads_in_pbte_tpu(kind, tmp_path):
    """The port's checkpoint loads into pbte_tpu (its Pallas ring takes the
    port's "bsd" state as it is, its XLA ring transposes it), and both
    resume from it to the same iterate."""
    js, ts, f64 = _cross(kind)
    rt = ts.solve(tol=0, max_iter=2, verbose=False)
    ck = str(tmp_path / "port.npz")
    tck.save_checkpoint(ck, ts, rt.u, rt.Tc, rt.Tv, 2, rt.residual)
    (u, Tc, Tv), it, _ = jck.load_checkpoint(ck, js)
    assert it == 2
    np.testing.assert_array_equal(np.asarray(Tc), _np(rt.Tc))
    if kind == "scan":
        np.testing.assert_array_equal(np.asarray(u), _np(rt.u))
    else:
        np.testing.assert_array_equal(js._ring_u_standard(u),
                                      ts._ring_u_standard(rt.u))
    a = js.solve(tol=0, max_iter=2, verbose=False, state=(u, Tc, Tv))
    state_t, _, _ = tck.load_checkpoint(ck, ts)
    b = ts.solve(tol=0, max_iter=2, verbose=False, state=state_t)
    _close(a.Tc, _np(b.Tc), f64)


def test_windowed_xla_ring_checkpoint_is_refused(tmp_path):
    """pbte_tpu's hull-windowed XLA-ring file (per-segment state, no slot
    offsets recorded) is refused with the reason, not mis-loaded."""
    js = JaxSolver(*_cube("jax", 16), WALL_BCS, dtype=jnp.float64,
                   sweep_mode="ring")
    assert js._ring_windowed
    rj = js.solve(tol=0, max_iter=1, verbose=False)
    ck = str(tmp_path / "win.npz")
    jck.save_checkpoint(ck, js, rj.u, rj.Tc, rj.Tv, 1, rj.residual)
    ts = SourceIterationSolver(*_cube("torch", 16), WALL_BCS,
                               dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="hull-windowed"):
        tck.load_checkpoint(ck, ts)


def test_fingerprint_fields_are_pbte_tpu_s(tmp_path):
    """The port writes exactly pbte_tpu's fields for the same problem (the
    scan and the Pallas-layout ring)."""
    for kind in ("scan", "pallas"):
        js, ts, _ = _cross(kind)
        rt = ts.solve(tol=0, max_iter=1, verbose=False)
        rj = js.solve(tol=0, max_iter=1, verbose=False)
        a, b = str(tmp_path / f"{kind}_t.npz"), str(tmp_path / f"{kind}_j")
        tck.save_checkpoint(a, ts, rt.u, rt.Tc, rt.Tv, 1, rt.residual)
        jck.save_checkpoint(b, js, rj.u, rj.Tc, rj.Tv, 1, rj.residual)
        with np.load(a) as dt, np.load(b + ".npz") as dj:
            assert sorted(dt.files) == sorted(dj.files)
            for k in dt.files:
                if k.startswith("fp_"):
                    np.testing.assert_array_equal(dt[k], dj[k], err_msg=k)
    assert not os.path.exists(a + ".tmp")
