"""The lattice ring beyond K1's flagship shapes: pbte_tpu_torch's
multi-class ring (``solver/lattice_multi.py``: graded lattices of several
geometry classes, per-element couplings) and the new shapes of its
single-class ring (2D quads, p = 3), against pbte_tpu's XLA ring
(``sweep_mode="ring"``, the form that runs these lattices) and the numpy
oracle, on the CPU:

- float64 to 1e-12 of max;
- float32 at pbte_tpu's tolerance, ``rtol=2e-5, atol=5e-7`` of max
  (``tests/test_pallas_ring.py:57-62``), pbte_tpu with its bf16 operand
  staging off (``PBTE_RING_BF16=0``);
- ports of ``tests/test_ring.py::test_ring_stretched_lattice_multiclass_oracle``
  and ``::test_ring_quad_2d`` and of
  ``tests/test_dirichlet.py::test_dirichlet_matches_oracle_ring``;
- the goldens of pbte_tpu's f32 XLA ring on a hex 17x17x4 at p = 3 (of
  millimetre edge: ``tests/torch_golden.py`` says why) and on a graded hex
  8^3 at p = 2, current and matched by the port; chip_smoke.py holds the
  card to them.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_golden
from pbte_tpu import mesh as jmesh
from pbte_tpu.angular import quadrature as jang
from pbte_tpu.fem import assembly as jasm
from pbte_tpu.material import nongray_smrt as jmat
from pbte_tpu.solver.source_iteration import SourceIterationSolver as JaxSolver
from pbte_tpu_torch import mesh as tmesh
from pbte_tpu_torch import problem
from pbte_tpu_torch.angular import quadrature as tang
from pbte_tpu_torch.fem import assembly as tasm
from pbte_tpu_torch.material import nongray_smrt as tmat
from pbte_tpu_torch.solver import lattice_multi
from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver
from pbte_tpu_torch.validation.oracle import solve_oracle

BCS3 = problem.WALL_BCS
BCS2 = problem.SQUARE_BCS
STEPS = 4
PKG = {"jax": (jmesh, jasm, jang, jmat), "torch": (tmesh, tasm, tang, tmat)}


@pytest.fixture(autouse=True)
def _cpu_float_env():
    """One thread, and f32 subnormals flushed as XLA's CPU backend flushes
    them (tests/test_torch_solver.py says why)."""
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _squared_hex(pkg, n):
    """An n^3 hex lattice graded by x -> x^2 (one geometry class per x
    layer: n classes), tests/test_ring.py's stretched lattice."""
    m, asm, ang, mat = PKG[pkg]
    md = m.make_cartesian_3d(n, n, n, "hex")
    v = md.vertices.copy()
    v[:, 0] = v[:, 0] ** 2
    md = dataclasses.replace(md, vertices=v).scaled(1e-6)
    ops = asm.assemble(m.connect(md), order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    return ops, quad, mat.build_tables(mat.SILICON, num_spectral=2)


def _periodic_graded(pkg, n):
    """The 1 : 2 graded n^3 lattice with its y faces paired (periodic)."""
    m, asm, ang, mat = PKG[pkg]
    md = m.make_cartesian_3d(n, n, n, "hex")
    xs = np.concatenate([[0.0], np.cumsum(np.tile([1.0, 2.0], n)[:n])])
    v = md.vertices.copy()
    v[:, 0] = xs[np.rint(v[:, 0] * n).astype(int)] / xs[-1]
    md = m.make_periodic(dataclasses.replace(md, vertices=v).scaled(1e-6),
                         [1])
    ops = asm.assemble(m.connect(md), order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    return ops, quad, mat.build_tables(mat.SILICON, num_spectral=2)


@functools.lru_cache(maxsize=None)
def _build(name, pkg):
    """The (ops, quad, tables) of a case, from pbte_tpu's host layers
    (pkg "jax") or the port's ("torch")."""
    if name == "graded_8_p1":
        fn = (torch_golden.jax_graded_cube if pkg == "jax"
              else problem.graded_cube)
        return fn(8, order=1, polar=2, azimuth=4, nspec=2)
    if name == "graded_8_p2":
        fn = (torch_golden.jax_graded_cube if pkg == "jax"
              else problem.graded_cube)
        return fn(8, order=2, polar=2, azimuth=4, nspec=2)
    if name == "squared_8":
        return _squared_hex(pkg, 8)
    if name == "periodic_graded_8":
        return _periodic_graded(pkg, 8)
    if name == "quad_24x22_p2":
        fn = (torch_golden.jax_unit_square if pkg == "jax"
              else problem.unit_square)
        return fn(24, 22, order=2, azimuth=8, nspec=2)
    if name == "quad_32x16_p1":
        fn = (torch_golden.jax_unit_square if pkg == "jax"
              else problem.unit_square)
        return fn(32, 16, order=1, azimuth=8, nspec=2)
    raise KeyError(name)


# name: (problem, isothermal walls, solver keywords of both packages)
CASES = {
    "graded_8_p1": ("graded_8_p1", BCS3, {}),
    "graded_8_p2": ("graded_8_p2", BCS3, {}),
    "graded_8_p1_dirichlet": ("graded_8_p1",
                              {a: -0.5 for a in range(1, 6)},
                              dict(dirichlet_bcs={6: 0.25})),
    "graded_8_p1_diffuse": ("graded_8_p1", {5: -0.5, 3: 0.5},
                            dict(diffuse_bcs=[1, 2, 4, 6])),
    "graded_8_p1_specular": ("graded_8_p1", {5: -0.5, 3: 0.5},
                             dict(specular_bcs=[1, 2, 4, 6])),
    "periodic_graded_8": ("periodic_graded_8", {1: -0.5, 3: -0.5, 5: 0.5,
                                                6: 0.5}, {}),
}


def _solve_pair(case, f32=False, steps=STEPS):
    """pbte_tpu's XLA ring and the port's ring on the same case, ``steps``
    steps each: (pbte_tpu solver, its result, port solver, its result)."""
    name, bcs, kw = CASES[case]
    old = os.environ.get("PBTE_RING_BF16")
    os.environ["PBTE_RING_BF16"] = "0"
    try:
        js = JaxSolver(*_build(name, "jax"), bcs,
                       dtype=jnp.float32 if f32 else jnp.float64,
                       use_pallas="off", **kw)
    finally:
        if old is None:
            del os.environ["PBTE_RING_BF16"]
        else:
            os.environ["PBTE_RING_BF16"] = old
    ts = SourceIterationSolver(*_build(name, "torch"), bcs,
                               dtype=torch.float32 if f32 else torch.float64,
                               device="cpu", **kw)
    rj = js.solve(tol=0, max_iter=steps, verbose=False)
    rt = ts.solve(tol=0, max_iter=steps, verbose=False)
    return js, rj, ts, rt


@pytest.mark.parametrize("case", list(CASES))
def test_multi_class_ring_matches_xla_ring_f64(case):
    """Graded lattices resolve to the ring in both packages (two geometry
    classes, per-element couplings) and the port's multi-class torch ring
    gives pbte_tpu's XLA ring in float64 to 1e-12 of max: Tc and the state
    by direction."""
    js, rj, ts, rt = _solve_pair(case)
    assert js.sweep_mode == ts.sweep_mode == "ring"
    assert js._ring_lattice and not js._ring_ccpl and js.ncls_ring == 2
    assert ts._multi is not None and ts.win is None
    Tc = np.asarray(rj.Tc)
    assert np.abs(rt.Tc.numpy() - Tc).max() <= 1e-12 * np.abs(Tc).max()
    uj = js.u_by_direction(rj.u)
    assert np.abs(ts.u_by_direction(rt.u) - uj).max() <= (
        1e-12 * np.abs(uj).max())


@pytest.mark.parametrize("case", ["graded_8_p1", "graded_8_p1_diffuse",
                                  "periodic_graded_8"])
def test_multi_class_ring_matches_xla_ring_f32(case):
    """The same in float32, at pbte_tpu's tolerance of max. At p = 1: the
    f32 state v = M^T u of the graded p = 2 lattice spans 1.6e-31 down to
    the f32 subnormals, which XLA's CPU backend (and this test, as
    pbte_tpu) flushes, and there each package is ~3e-6 of max from the
    float64 answer (pbte_tpu 3.7e-6, the port 2.8e-6; the port 2.8e-7 with
    subnormals kept), so two f32 results differ by more than their
    rounding order; the float64 test holds p = 2."""
    _, rj, _, rt = _solve_pair(case, f32=True)
    Tc = np.asarray(rj.Tc, dtype=np.float64)
    scale = np.abs(Tc).max()
    np.testing.assert_allclose(rt.Tc.numpy() / scale, Tc / scale, rtol=2e-5,
                               atol=5e-7)


def test_ring_stretched_lattice_multiclass_oracle():
    """tests/test_ring.py's stretched lattice (x -> x^2, one class per x
    layer: 8 classes) on the forced ring: the port against pbte_tpu's XLA
    ring at 1e-12 of max and against the oracle at 1e-12 (rtol) and 1e-14
    of max (atol), as the original test."""
    js = JaxSolver(*_build("squared_8", "jax"), BCS3, dtype=jnp.float64,
                   sweep_mode="ring")
    ts = SourceIterationSolver(*_build("squared_8", "torch"), BCS3,
                               dtype=torch.float64, device="cpu",
                               sweep_mode="ring")
    assert js._ring_lattice and js.ncls_ring == 8 and not js._ring_ccpl
    assert ts._multi is not None and ts._multi[0].cls_oh.shape[0] == 8
    rj = js.solve(tol=0, max_iter=4, verbose=False)
    rt = ts.solve(tol=0, max_iter=4, verbose=False)
    Tc = np.asarray(rj.Tc)
    assert np.abs(rt.Tc.numpy() - Tc).max() <= 1e-12 * np.abs(Tc).max()
    ops, quad, tables = _build("squared_8", "torch")
    _, Tco, *_ = solve_oracle(ops, quad, tables, BCS3, tol=0, max_iter=4)
    np.testing.assert_allclose(rt.Tc.numpy(), Tco, rtol=1e-12,
                               atol=1e-14 * np.abs(Tco).max())


@pytest.mark.parametrize("case,bcs,kw", [
    ("quad_24x22_p2", BCS2, {}),
    ("quad_32x16_p1", {1: -0.5, 2: -0.5, 4: -0.5},
     dict(dirichlet_bcs={3: 1.0e-9})),
])
def test_ring_quad_2d(case, bcs, kw):
    """tests/test_ring.py::test_ring_quad_2d (quads, p=2) and
    tests/test_dirichlet.py::test_dirichlet_matches_oracle_ring (quads,
    p=1, a Dirichlet top face) on the forced ring, at 528 and 512 elements:
    pbte_tpu's originals (9x8, 5x4) lie below the 512 elements from which
    faces take canonical order, and there it takes its one-hot ring (the
    port's general ring, tests/test_torch_one_hot_ring.py); from 512 on, 2D quad lattices take the single-class lattice
    ring (two active faces; the plain K1 version on the CPU). Held to
    pbte_tpu's XLA ring at 1e-12 of max and to the oracle as the originals
    (rtol 1e-12 and 1e-11, atol 1e-14)."""
    js = JaxSolver(*_build(case, "jax"), bcs, dtype=jnp.float64,
                   sweep_mode="ring", **kw)
    ts = SourceIterationSolver(*_build(case, "torch"), bcs,
                               dtype=torch.float64, device="cpu",
                               sweep_mode="ring", **kw)
    assert js.sweep_mode == ts.sweep_mode == "ring" and js._ring_lattice
    assert ts._multi is None and len(ts.shifts) == 2
    assert ts.D == (9 if case.endswith("p2") else 4)
    steps = 6 if kw else 4
    rj = js.solve(tol=0, max_iter=steps, verbose=False)
    rt = ts.solve(tol=0, max_iter=steps, verbose=False)
    Tc = np.asarray(rj.Tc)
    assert np.abs(rt.Tc.numpy() - Tc).max() <= 1e-12 * np.abs(Tc).max()
    ops, quad, tables = _build(case, "torch")
    _, Tco, *_ = solve_oracle(ops, quad, tables, bcs, tol=0, max_iter=steps,
                              dirichlet=kw.get("dirichlet_bcs"))
    np.testing.assert_allclose(rt.Tc.numpy(), Tco,
                               rtol=1e-11 if kw else 1e-12, atol=1e-14)
    assert np.abs(Tco).max() > 0


def test_coupling_classes_stand_for_every_element():
    """Every interior face's coupling (folded with its neighbour class's
    M^-T) equals its coupling class's matrix to roundoff; the graded
    lattice has one class per (face, element class, neighbour class), and
    a mesh whose couplings the classes do not determine raises."""
    ops, _, _ = _build("graded_8_p1", "torch")
    ops = tasm.permute_faces(ops, tasm.canonical_face_perm(ops))
    cls = tasm.element_classes(ops)
    reps = [int(np.flatnonzero(cls == c)[0]) for c in range(cls.max() + 1)]
    invMT_r = np.linalg.inv(np.swapaxes(ops.mass[reps], -1, -2))
    cpl, q_of = lattice_multi.coupling_classes(ops, cls, invMT_r)
    interior = ops.neighbor >= 0
    assert ((q_of >= 0) == interior).all()
    # a (face, class, neighbour class) triple each: x faces join 1 : 2 and
    # 2 : 1 neighbours, y and z faces two of a class
    assert len(cpl) == 2 * 2 + 4 * 2
    nbr_cls = cls[np.clip(ops.neighbor, 0, None)]
    folded = np.einsum("efij,efjk->efik", ops.coupling, invMT_r[nbr_cls])
    diff = np.abs(folded[interior] - cpl[q_of[interior]]).max()
    assert diff <= 1e-13 * np.abs(folded).max()
    # a coupling the classes do not determine raises
    bad = ops.coupling.copy()
    e = int(np.flatnonzero(interior[:, 0])[5])
    bad[e, 0] *= 1.5
    with pytest.raises(NotImplementedError, match="scan"):
        lattice_multi.coupling_classes(dataclasses.replace(ops, coupling=bad),
                                       cls, invMT_r)


def test_bf16_state_runs_the_multi_class_ring(monkeypatch):
    """bfloat16 state on the multi-class ring: bf16 slabs and ring, f32
    products, within bf16 rounding of the float32 steps."""
    prob = _build("graded_8_p1", "torch")
    r32 = SourceIterationSolver(*prob, BCS3, device="cpu").solve(
        tol=0, max_iter=3, verbose=False)
    monkeypatch.setenv("PBTE_RING_STATE_BF16", "1")
    ts = SourceIterationSolver(*prob, BCS3, device="cpu")
    assert ts._multi is not None and ts.state_bf16
    r16 = ts.solve(tol=0, max_iter=3, verbose=False)
    assert all(x.dtype == torch.bfloat16 for x in r16.u)
    scale = r32.Tc.abs().max()
    assert 0 < (r16.Tc - r32.Tc).abs().max() <= 2e-2 * scale


@pytest.mark.parametrize("path", list(torch_golden.LATTICE_GOLDENS),
                         ids=lambda p: p.name)
def test_lattice_golden_is_current(path):
    """Regenerating the p = 3 and graded-lattice goldens from pbte_tpu
    reproduces the committed files."""
    fresh = torch_golden.LATTICE_GOLDENS[path]()
    with np.load(path) as d:
        assert sorted(d.files) == sorted(fresh), path.name
        for key in d.files:
            np.testing.assert_allclose(fresh[key], d[key], rtol=1e-6,
                                       err_msg=f"{path.name}: {key}")


@pytest.mark.parametrize("path,build,keys", [
    (torch_golden.PATH_P3, problem.unit_cube,
     dict(torch_golden.P3_PARAMS, length=torch_golden.P3_LENGTH)),
    (torch_golden.PATH_GRADED, problem.graded_cube,
     torch_golden.GRADED_PARAMS),
], ids=["p3", "graded"])
def test_port_matches_lattice_golden_on_cpu(path, build, keys):
    """The port's own solver on the CPU against the committed golden, at
    2e-5 of max: the check chip_smoke.py repeats on a GPU (there through
    K1's cluster kernel at D = 64, and the multi-class ring)."""
    with np.load(path) as d:
        params = {k: d[k].item() for k in keys}
        bcs = dict(zip(d["bc_attrs"].tolist(), d["bc_temps"].tolist()))
        ref = d["Tc"][-1]
        steps = int(d["steps"])
    ts = SourceIterationSolver(*build(**params), bcs, device="cpu")
    assert ts.sweep_mode == "ring"
    assert (ts._multi is not None) == (path == torch_golden.PATH_GRADED)
    r = ts.solve(tol=0, max_iter=steps, verbose=False)
    assert np.abs(r.Tc.numpy() - ref).max() <= 2e-5 * np.abs(ref).max()
