"""pbte_tpu_torch's scan path against pbte_tpu's.

The same meshes (built by each package from its own host layers), angles,
tables and boundary conditions go through pbte_tpu's
``SourceIterationSolver`` (its scan: ``sweep_mode="scan"``, or ``"auto"``
where that resolves to the scan) and through the port's on the CPU; Tc,
Tv and the state u after 3 outer steps from the zero state are compared:

- float64 to 1e-12 of each field's max |.|;
- float32 at pbte_tpu's own tolerance, ``rtol=2e-5, atol=5e-7``, on each
  field divided by its max |.| in pbte_tpu (Tv holds cell integrals of
  ~1e-19 on micron meshes, so the absolute term needs a scale); the eigen
  cache's float32 cases with ``atol`` 80 eps = 9.5e-6 (``EIGEN_F32_ATOL``:
  cond(V) eps at the largest estimate among them, each estimate recorded).

Cases: 2D triangles and quads, the triangle / quad builtin
``unit-square-mixed``, the 2-element ``unit-square-iso.mesh`` with 2D
angles, ``unit-cube-tet-iso.mesh``, ``unit-cube-mixed.mesh`` (hex,
pyramids, tets and prisms), the gmsh ``cuboid_5x5x5.msh`` and a 2x2x2
6-tet cube at p = 1 and 3, under the three factor caches. pbte_tpu's default ``mfem-parity`` faces
are rank one, which leaves p >= 2 operators ill-conditioned: there the
packages agree to 1e-13 in float64 but differ by up to 1.5e-4 of max in
float32, from summation order alone (measured on the 2x2x2 tet cube at
p = 3; 1e-7 with consistent faces), so float32 cases at p >= 2 use
consistent faces. The eigen cache on the mixed mesh with mfem-parity faces
keeps its factors in float64 (condition estimate under its 1e11 bound)
and amplifies summation order to 4e-9 of max, so that case is held to the
guard's policy only.

Also: each closure on the scan (periodic, Dirichlet, diffuse, specular),
the conditioning guard of the eigen cache, BiCGStab on scan state, the
views, the resolved ``sweep_mode`` of both packages, the numpy oracle, the
memory fallbacks and the scan golden.
"""

import functools
import pathlib
import warnings

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
from pbte_tpu.validation import oracle as joracle
from pbte_tpu_torch import mesh as tmesh
from pbte_tpu_torch.angular import quadrature as tang
from pbte_tpu_torch.fem import assembly as tasm
from pbte_tpu_torch.material import nongray_smrt as tmat
from pbte_tpu_torch.problem import tet_cube
from pbte_tpu_torch.solver import scan as tscan
from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver
from pbte_tpu_torch.validation import oracle as toracle

MESH_DIR = pathlib.Path(__file__).resolve().parents[1] / "config" / "mesh"
PKG = {"jax": (jmesh, jasm, jang, jmat), "torch": (tmesh, tasm, tang, tmat)}
MESHES = {
    "tri_4x4": lambda m: m.make_cartesian_2d(4, 4, m.GEOM_TRIANGLE),
    "quad_4x4": lambda m: m.make_cartesian_2d(4, 4, m.GEOM_QUAD),
    "unit-square-iso": lambda m: m.load_mesh(
        str(MESH_DIR / "unit-square-iso.mesh")),
    "unit-cube-tet-iso": lambda m: m.load_mesh(
        str(MESH_DIR / "unit-cube-tet-iso.mesh")),
    "unit-cube-mixed": lambda m: m.load_mesh(
        str(MESH_DIR / "unit-cube-mixed.mesh")),
    "tet_2x2x2": lambda m: m.make_cartesian_3d(2, 2, 2, m.GEOM_TET),
    "hex_4x4x4_periodic_x": lambda m: m.make_periodic(
        m.make_cartesian_3d(4, 4, 4, m.GEOM_HEX), [0]),
    "unit-square-mixed": lambda m: m.load_builtin("unit-square-mixed"),
    "cuboid_5x5x5": lambda m: m.load_mesh(str(MESH_DIR / "cuboid_5x5x5.msh")),
}
STEPS = 3
POLICIES = ("full", "on-the-fly", "eigen")
# (mesh, order, face mode, float64 only); the gmsh cuboid is the legacy
# production mesh, which pbte_tpu sends to its supercell ring unless asked
# for the scan (test_resolved_sweep_mode_matches_pbte_tpu): both packages
# run it with sweep_mode="scan" here
CASES = [
    ("tri_4x4", 1, "mfem-parity", False),
    ("unit-square-mixed", 1, "mfem-parity", False),
    ("cuboid_5x5x5", 1, "consistent", False),
    ("quad_4x4", 1, "mfem-parity", False),
    ("quad_4x4", 2, "consistent", False),
    ("unit-square-iso", 1, "mfem-parity", False),
    ("unit-cube-tet-iso", 1, "mfem-parity", False),
    ("unit-cube-mixed", 1, "consistent", False),
    ("tet_2x2x2", 1, "consistent", False),
    ("tet_2x2x2", 3, "consistent", False),
    ("tet_2x2x2", 3, "mfem-parity", True),
]


@pytest.fixture(autouse=True)
def _cpu_float_env():
    """One thread, and f32 subnormals flushed as XLA's CPU backend flushes
    them (tests/test_torch_solver.py::_cpu_float_env)."""
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@functools.lru_cache(maxsize=None)
def _problem(pkg, mesh, order, face_mode, nspec=2):
    """(ops, quad, tables) from one package's host layers; 2D meshes get
    the 8-direction 2D rule, 3D meshes 2 polar x 4 azimuth."""
    m, asm, ang, mat = PKG[pkg]
    md = MESHES[mesh](m).scaled(1.0e-6)
    ops = asm.assemble(m.connect(md), order=order, face_mode=face_mode)
    opts = (dict(dimension=2, polar_points=1, azimuth_points=8)
            if md.dim == 2 else
            dict(dimension=3, polar_points=2, azimuth_points=4))
    quad = ang.build(ang.AngularOptions(**opts))
    return ops, quad, mat.build_tables(mat.SILICON, num_spectral=nspec)


def _walls(ops, hot=None):
    """Every boundary attribute isothermal: the first (or ``hot``) +0.5, the
    rest -0.5."""
    attrs = sorted(int(a) for a in np.unique(
        ops.face_attr[(ops.neighbor < 0) & ops.face_valid]))
    hot = attrs[0] if hot is None else hot
    return {a: (0.5 if a == hot else -0.5) for a in attrs}


def _pair(mesh, order, face_mode, f64, bcs=None, **kw):
    """pbte_tpu's solver and the port's on their own problems."""
    jp = _problem("jax", mesh, order, face_mode)
    tp = _problem("torch", mesh, order, face_mode)
    bcs = _walls(jp[0]) if bcs is None else bcs
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the eigen guard's
        js = JaxSolver(*jp, bcs, dtype=jnp.float64 if f64 else jnp.float32,
                       **kw)
        ts = SourceIterationSolver(
            *tp, bcs, dtype=torch.float64 if f64 else torch.float32,
            device="cpu", **kw)
    return js, ts


def _np(t):
    return t.detach().double().numpy()


def assert_fields_match(js, ts, rj, rt, f64, atol=5e-7):
    """Tc, Tv and u at the module's tolerances (see the docstring)."""
    for name, a, b in (("Tc", rj.Tc, rt.Tc), ("Tv", rj.Tv, rt.Tv),
                       ("u", rj.u, rt.u)):
        want = np.asarray(a, dtype=np.float64)
        got = _np(b)
        assert got.shape == want.shape, name
        scale = max(np.abs(want).max(), 1e-300)
        if f64:
            assert np.abs(got - want).max() <= 1e-12 * scale, name
        else:
            np.testing.assert_allclose(got / scale, want / scale, rtol=2e-5,
                                       atol=atol, err_msg=name)


RUNS = [(c[:3], f64) for c in CASES for f64 in (True, False)
        if f64 or not c[3]]
# the eigen cache's condition estimate cond(V) on each float32 case that
# keeps it (the rest fall back to the class cache), as measured
EIGEN_F32_COND = {
    ("tri_4x4", 1, "mfem-parity"): 69.0,
    ("unit-square-mixed", 1, "mfem-parity"): 79.7,
    ("cuboid_5x5x5", 1, "consistent"): 15.8,
    ("quad_4x4", 1, "mfem-parity"): 44.2,
    ("quad_4x4", 2, "consistent"): 43.8,
    ("unit-square-iso", 1, "mfem-parity"): 69.0,
    ("unit-cube-tet-iso", 1, "mfem-parity"): 49.0,
    ("unit-cube-mixed", 1, "consistent"): 17.0,
    ("tet_2x2x2", 1, "consistent"): 11.3,
}
# the factor pair V, V^-1 amplifies rounding by cond(V): the two packages'
# float32 applies differ by up to cond(V) eps of max (largest measured:
# 3.3e-6 of max on u of the p = 2 quads, estimate 43.8), so the eigen cases
# take the absolute term at the largest estimate above times float32's eps
EIGEN_F32_ATOL = 80.0 * float(np.finfo(np.float32).eps)  # 9.5e-6


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize(
    "case,f64", RUNS,
    ids=[f"{c[0]}_p{c[1]}_{c[2]}_{'f64' if f else 'f32'}" for c, f in RUNS])
def test_scan_matches_pbte_tpu(case, f64, policy):
    mesh, order, face_mode = case
    kw = dict(sweep_mode="scan") if mesh == "cuboid_5x5x5" else {}
    js, ts = _pair(mesh, order, face_mode, f64, cache_policy=policy, **kw)
    assert js.sweep_mode == ts.sweep_mode == "scan"
    assert ts.cache_policy == js.cache_policy
    assert ts._scan.ncls == js.ncls
    assert ts._scan.segments == js.segments
    np.testing.assert_array_equal(ts._perm, js._perm)
    rj = js.solve(tol=0, max_iter=STEPS, verbose=False)
    rt = ts.solve(tol=0, max_iter=STEPS, verbose=False)
    atol = 5e-7
    if ts.cache_policy == "eigen" and not f64:
        assert ts._scan.cond_max == pytest.approx(EIGEN_F32_COND[case],
                                                  abs=0.05)
        atol = EIGEN_F32_ATOL
    assert_fields_match(js, ts, rj, rt, f64, atol=atol)
    assert rt.residual == pytest.approx(rj.residual, rel=1e-9 if f64 else
                                        1e-3)


@pytest.mark.parametrize("mesh,order,face_mode,f64,want", [
    ("tet_2x2x2", 3, "consistent", True, "full"),
    ("tet_2x2x2", 3, "consistent", False, "full"),
    ("unit-cube-mixed", 1, "mfem-parity", False, "on-the-fly"),
    ("unit-cube-mixed", 1, "mfem-parity", True, "eigen"),
    ("quad_4x4", 2, "mfem-parity", True, "full"),
    ("quad_4x4", 2, "consistent", True, "eigen"),
])
def test_eigen_guard_falls_back_as_pbte_tpu(mesh, order, face_mode, f64,
                                            want):
    """The eigen cache's conditioning guard (cond(V) > 1e5 in float32,
    1e11 in float64) falls back where pbte_tpu's does, to the same policy:
    the class-batched full cache where classes exist, on-the-fly where they
    do not; the warning names the estimate."""
    jp = _problem("jax", mesh, order, face_mode)
    tp = _problem("torch", mesh, order, face_mode)
    bcs = _walls(jp[0])
    kw = dict(cache_policy="eigen")
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        js = JaxSolver(*jp, bcs, dtype=jnp.float64 if f64 else jnp.float32,
                       **kw)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        ts = SourceIterationSolver(*tp, bcs, device="cpu", dtype=(
            torch.float64 if f64 else torch.float32), **kw)
    assert js.cache_policy == ts.cache_policy == want
    assert ts._scan.ncls == js.ncls
    guard = [str(w.message) for w in wt if "condition estimate" in
             str(w.message)]
    assert len(guard) == (want != "eigen")
    assert len(guard) == len([w for w in wj if "condition estimate" in
                              str(w.message)])
    if guard:
        assert f"falling back to {'class-batched full' if want == 'full' else 'on-the-fly'}" in guard[0]


# ---- closures on the scan ---------------------------------------------------

CLOSURES = {
    "periodic": ("hex_4x4x4_periodic_x", 1, "consistent",
                 {1: -0.5, 2: -0.5, 4: -0.5, 6: 0.5}, {}),
    "dirichlet": ("tet_2x2x2", 2, "consistent",
                  {a: -0.5 for a in range(1, 6)}, dict(dirichlet_bcs={6: 0.25})),
    "diffuse": ("tet_2x2x2", 1, "consistent", {1: -0.5, 3: -0.5, 5: 0.5,
                                               6: 0.5},
                dict(diffuse_bcs=[2, 4])),
    "specular": ("tet_2x2x2", 1, "mfem-parity", {2: -0.5, 3: -0.5, 4: 0.5,
                                                 5: 0.5},
                 dict(specular_bcs=[1, 6])),
}


@pytest.mark.parametrize("policy", ["full", "on-the-fly"])
@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("closure", list(CLOSURES))
def test_scan_closures_match_pbte_tpu(closure, f64, policy):
    mesh, order, face_mode, bcs, kw = CLOSURES[closure]
    js, ts = _pair(mesh, order, face_mode, f64, bcs=bcs, cache_policy=policy,
                   **kw)
    assert js.sweep_mode == ts.sweep_mode == "scan"
    on = {"periodic": ts.has_periodic, "dirichlet": "dsrc" in ts.consts,
          "diffuse": ts._dif_on, "specular": ts._spc_on}
    assert on[closure]
    rj = js.solve(tol=0, max_iter=STEPS, verbose=False)
    rt = ts.solve(tol=0, max_iter=STEPS, verbose=False)
    assert_fields_match(js, ts, rj, rt, f64)


def test_views_match_pbte_tpu():
    """u_by_direction, heat_flux and Tc_fine of the scan state."""
    js, ts = _pair("unit-cube-mixed", 1, "consistent", True)
    rj = js.solve(tol=0, max_iter=STEPS, verbose=False)
    rt = ts.solve(tol=0, max_iter=STEPS, verbose=False)
    want = js.u_by_direction(rj.u)
    got = rt.u_dirs()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    for a, b in zip(js.heat_flux(rj.u), ts.heat_flux(rt.u)):
        a = np.asarray(a)
        assert np.abs(_np(b) - a).max() <= 1e-12 * np.abs(a).max()
    np.testing.assert_array_equal(_np(ts.Tc_fine(rt.Tc)), _np(rt.Tc))


@pytest.mark.parametrize("mesh,order,face_mode,max_iter", [
    ("unit-square-iso", 1, "mfem-parity", 10),
    ("tet_2x2x2", 2, "consistent", 14)])
def test_bicgstab_on_scan_state_matches_pbte_tpu(mesh, order, face_mode,
                                                 max_iter):
    """solve(accelerate="bicgstab", tol=0) in float64 on the scan state (one
    tensor as the Krylov tree's u leaf), held to pbte_tpu's at 1e-10 of
    max. The recurrence carries the steps' rounding: on the 2-element 2D
    mesh (relres near 3e-2 from 4 matvecs on) it grows ~1e3-fold every two
    iterations, 6.5e-13 of max at 10 step applications and 1.1e-7 at 14
    (measured); the tet cube stays at 7e-15 through 18."""
    js, ts = _pair(mesh, order, face_mode, True)
    opts = dict(tol=0, max_iter=max_iter, verbose=False,
                accelerate="bicgstab")
    rj, rt = js.solve(**opts), ts.solve(**opts)
    assert rt.iterations == rj.iterations
    for a, b in ((rj.Tc, rt.Tc), (rj.u, rt.u), (rj.Tv, rt.Tv)):
        a = np.asarray(a)
        np.testing.assert_allclose(_np(b), a, rtol=1e-10,
                                   atol=1e-10 * np.abs(a).max())
    assert rt.residual == pytest.approx(rj.residual, rel=1e-8)


@pytest.mark.parametrize("closure", ["none", "diffuse", "specular"])
def test_oracle_copy_and_port_against_oracle(closure):
    """The port's copy of the numpy oracle equals pbte_tpu's bit for bit,
    and the port's float64 scan reaches the oracle's iterate (greedy
    per-element sweeps) to 1e-12 of max."""
    mesh, order = "tet_2x2x2", 1
    jp = _problem("jax", mesh, order, "consistent")
    tp = _problem("torch", mesh, order, "consistent")
    kw = {"none": {}, "diffuse": dict(diffuse=[2, 4]),
          "specular": dict(specular=[1, 6])}[closure]
    bcs = ({1: -0.5, 3: -0.5, 5: 0.5, 6: 0.5} if closure == "diffuse" else
           {2: -0.5, 3: -0.5, 4: 0.5, 5: 0.5} if closure == "specular" else
           _walls(jp[0]))
    oj = joracle.solve_oracle(*jp, bcs, tol=0, max_iter=STEPS, **kw)
    ot = toracle.solve_oracle(*tp, bcs, tol=0, max_iter=STEPS, **kw)
    for a, b in zip(oj, ot):
        np.testing.assert_array_equal(b, a)
    skw = {k + "_bcs": v for k, v in kw.items()}
    ts = SourceIterationSolver(*tp, bcs, dtype=torch.float64, device="cpu",
                               **skw)
    rt = ts.solve(tol=0, max_iter=STEPS, verbose=False)
    Tc = oj[1]
    assert np.abs(_np(rt.Tc) - Tc).max() <= 1e-12 * np.abs(Tc).max()
    u = oj[0]
    assert np.abs(rt.u_dirs() - u).max() <= 1e-12 * np.abs(u).max()


# ---- path resolution ---------------------------------------------------------

def _tet_cube(pkg, n, order=1, nspec=2):
    m, asm, ang, mat = PKG[pkg]
    md = m.make_cartesian_3d(n, n, n, m.GEOM_TET).scaled(1.0e-6)
    ops = asm.assemble(m.connect(md), order=order, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    return ops, quad, mat.build_tables(mat.SILICON, num_spectral=nspec)


def _graded_hex(pkg, n):
    """An n^3 hex lattice whose x spacing alternates 1 : 2 (two geometry
    classes after canonical face order: a multi-class lattice)."""
    m, asm, ang, mat = PKG[pkg]
    md = m.make_cartesian_3d(n, n, n, m.GEOM_HEX)
    xs = np.concatenate([[0.0], np.cumsum(np.tile([1.0, 2.0], n)[:n])])
    v = md.vertices.copy()
    v[:, 0] = xs[np.rint(v[:, 0] * n).astype(int)] / xs[-1]
    import dataclasses

    md = dataclasses.replace(md, vertices=v).scaled(1.0e-6)
    ops = asm.assemble(m.connect(md), order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=4))
    return ops, quad, mat.build_tables(mat.SILICON, num_spectral=2)


def _config_square(pkg, refine):
    """The default config's problem as the CLIs build it at ``-r refine``
    (unit-square-iso scaled to microns, then refined; mfem-parity faces;
    24 in-plane gauss directions), with 2 x 2 bands."""
    m, asm, ang, mat = PKG[pkg]
    md = m.uniform_refine(m.load_mesh(str(MESH_DIR / "unit-square-iso.mesh"))
                          .scaled(1.0e-6), refine)
    ops = asm.assemble(m.connect(md), order=1, face_mode="mfem-parity")
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=24))
    return ops, quad, mat.build_tables(mat.SILICON, num_spectral=2)


RESOLUTION = {
    # name: (problem builder over a package, bcs, keywords, port's answer)
    "tri_4x4": (lambda p: _problem(p, "tri_4x4", 1, "mfem-parity"), None,
                {}, "scan"),
    "unit-square-iso": (lambda p: _problem(p, "unit-square-iso", 1,
                                           "mfem-parity"), None, {}, "scan"),
    "unit-cube-tet-iso": (lambda p: _problem(p, "unit-cube-tet-iso", 1,
                                             "mfem-parity"), None, {},
                          "scan"),
    "unit-cube-mixed": (lambda p: _problem(p, "unit-cube-mixed", 1,
                                           "mfem-parity"), None, {}, "scan"),
    "tet_4x4x4": (lambda p: _tet_cube(p, 4), None, {}, "scan"),
    "tet_5x5x5_supercell": (lambda p: _tet_cube(p, 5), None, {}, "ring"),
    "tet_5x5x5_scan_forced": (lambda p: _tet_cube(p, 5), None,
                              dict(sweep_mode="scan"), "scan"),
    "tet_8x8x8_dirichlet_one_hot": (lambda p: _tet_cube(p, 8), None,
                                    dict(dirichlet_bcs={6: 0.1}), "ring"),
    "tet_8x8x8_diffuse_one_hot": (lambda p: _tet_cube(p, 8),
                                  {1: -0.5, 3: -0.5, 5: -0.5, 6: 0.5},
                                  dict(diffuse_bcs=[2, 4]), "ring"),
    "unit-square-iso_r6_one_hot": (lambda p: _config_square(p, 6),
                                   {1: -0.5, 2: 0.5}, {}, "ring"),
    "hex_8x8x8_graded_multi_class": (lambda p: _graded_hex(p, 8), None, {},
                                     "ring"),
    "hex_4x4x4_periodic_x": (lambda p: _problem(p, "hex_4x4x4_periodic_x", 1,
                                             "consistent"), {1: -0.5, 2: -0.5,
                                                             4: -0.5, 6: 0.5},
                          {}, "scan"),
}


@pytest.mark.parametrize("name", list(RESOLUTION))
def test_resolved_sweep_mode_matches_pbte_tpu(name):
    """sweep_mode="auto" resolves as pbte_tpu's structural gates do (less
    its TPU memory budgets, which resolve none of these cases otherwise):
    the scan where pbte_tpu scans, the supercell ring where pbte_tpu
    merges a simplex lattice, the lattice ring on a multi-class lattice,
    and the general ring where pbte_tpu takes its one-hot ring (the 6-tet
    cube 8^3 with a wall that blocks the merge, the default config's
    triangles at -r 6)."""
    build, bcs, kw, want = RESOLUTION[name]
    jp, tp = build("jax"), build("torch")
    bcs = _walls(jp[0]) if bcs is None else bcs
    if "dirichlet_bcs" in kw:
        bcs = {a: t for a, t in bcs.items() if a not in kw["dirichlet_bcs"]}
    js = JaxSolver(*jp, bcs, dtype=jnp.float64, **kw)
    assert js.sweep_mode == want
    ts = SourceIterationSolver(*tp, bcs, dtype=torch.float64, device="cpu",
                               **kw)
    assert ts.sweep_mode == want
    # the supercell ring where pbte_tpu merges; else the lattice ring
    # (the multi-class ring here) where pbte_tpu takes its lattice ring,
    # the general ring where it takes its one-hot ring
    assert (ts._super is not None) == (js._super is not None)
    if want == "ring" and js._super is None:
        assert ts._general == (not js._ring_lattice)
        assert (ts._multi is not None) == js._ring_lattice


def test_arguments_are_validated():
    tp = _problem("torch", "tri_4x4", 1, "mfem-parity")
    bcs = _walls(tp[0])
    with pytest.raises(ValueError, match="cache_policy"):
        SourceIterationSolver(*tp, bcs, device="cpu", cache_policy="lu")
    with pytest.raises(ValueError, match="sweep_mode"):
        SourceIterationSolver(*tp, bcs, device="cpu", sweep_mode="wave")
    ts = SourceIterationSolver(*tp, bcs, device="cpu",
                               cache_policy="per-iteration")
    assert ts.cache_policy == "on-the-fly"


# ---- memory fallbacks -------------------------------------------------------

@pytest.mark.parametrize("fallback", ["window_rhs", "sequential_groups",
                                      "class_streams"])
def test_memory_fallbacks_change_no_result(fallback, monkeypatch):
    """The window-local rhs (HOIST_BUDGET), the sequential groups of the
    on-the-fly cache (SEQ_BUDGET) and the class-compressed operator streams
    (CLASS_OPS_BUDGET), each forced by a budget of 0, give the hoisted,
    batched result to 1e-13 of max in float64."""
    tp = tet_cube(2, order=2, polar=2, azimuth=4, nspec=2)
    bcs = _walls(tp[0])
    policy = "on-the-fly" if fallback == "sequential_groups" else "full"
    ref = SourceIterationSolver(*tp, bcs, dtype=torch.float64, device="cpu",
                                cache_policy=policy)
    if fallback == "window_rhs":
        monkeypatch.setattr(tscan, "HOIST_BUDGET", 0)
    elif fallback == "sequential_groups":
        monkeypatch.setattr(tscan, "SEQ_BUDGET", 0)
    else:
        monkeypatch.setattr(tscan, "CLASS_OPS_BUDGET", 0)
    ts = SourceIterationSolver(*tp, bcs, dtype=torch.float64, device="cpu",
                               cache_policy=policy)
    sv = ts._scan
    taken = {"window_rhs": not sv._hoist_rhs,
             "sequential_groups": sv._seq_groups,
             "class_streams": sv._scan_cls_ops and not sv._hoist_rhs}
    assert taken[fallback] and ref._scan._hoist_rhs
    assert not ref._scan._scan_cls_ops and not ref._scan._seq_groups
    a = ref.solve(tol=0, max_iter=STEPS, verbose=False)
    b = ts.solve(tol=0, max_iter=STEPS, verbose=False)
    for x, y in ((a.Tc, b.Tc), (a.u, b.u)):
        assert (y - x).abs().max() <= 1e-13 * x.abs().max()


def test_bench_scan_rows_and_needs_a_gpu(tmp_path):
    """bench_scan times every cache policy and the forced class streams at
    the legacy tet shape, and exits 1 without a GPU, writing nothing."""
    from pbte_tpu_torch import bench_scan

    assert {r[1] for r in bench_scan.ROWS} == set(POLICIES)
    assert [r[2] for r in bench_scan.ROWS].count(0) == 1
    out = tmp_path / "scan.json"
    if not torch.cuda.is_available():
        assert bench_scan.main(["--out", str(out)]) == 1
        assert not out.exists()


def test_step_leaves_its_input_alone():
    """The scan step writes a new state (BiCGStab re-reads x after F(x))."""
    tp = _problem("torch", "tri_4x4", 1, "mfem-parity")
    ts = SourceIterationSolver(*tp, _walls(tp[0]), dtype=torch.float64,
                               device="cpu")
    u, Tc, Tv = ts.initial_state()
    u, Tc, Tv, _ = ts.step(u, Tc, Tv)
    u0 = u.clone()
    u1, *_ = ts.step(u, Tc, Tv)
    assert torch.equal(u, u0) and not torch.equal(u1, u0)


# ---- the scan golden ---------------------------------------------------------

def test_scan_golden_file_is_current():
    """Regenerating the committed scan golden from pbte_tpu reproduces it."""
    for path, build in torch_golden.SCAN_GOLDENS.items():
        fresh = build()
        with np.load(path) as d:
            assert sorted(d.files) == sorted(fresh), path.name
            for key in d.files:
                np.testing.assert_allclose(fresh[key], d[key], rtol=1e-6,
                                           err_msg=f"{path.name}: {key}")


def test_port_matches_scan_golden_on_cpu():
    """The port's scan on the CPU against the committed golden, the check
    chip_smoke.py repeats on a GPU."""
    with np.load(torch_golden.PATH_SCAN) as d:
        prob, bcs, kw = torch_golden.scan_solver_args(d, tet_cube)
        Tc_ref, steps = d["Tc"][-1], int(d["steps"])
    ts = SourceIterationSolver(*prob, bcs, device="cpu", **kw)
    assert ts.sweep_mode == "scan" and ts._scan.ncls > 0 and ts._dif_on
    r = ts.solve(tol=0, max_iter=steps, verbose=False)
    np.testing.assert_allclose(r.Tc.numpy(), Tc_ref, rtol=2e-5, atol=5e-7)


# ---- the consts bridge -------------------------------------------------------

@pytest.mark.parametrize("case", [
    ("tet_2x2x2", 2, "consistent", "full", {}, {}),
    ("unit-cube-mixed", 1, "consistent", "full", {}, {}),
    ("tet_2x2x2", 1, "consistent", "eigen", {}, dict(diffuse_bcs=[2, 4])),
    ("unit-square-iso", 1, "mfem-parity", "eigen", {}, {}),
    ("tet_2x2x2", 1, "mfem-parity", "on-the-fly", {},
     dict(specular_bcs=[1, 6])),
    ("hex_4x4x4_periodic_x", 1, "consistent", "full",
     {1: -0.5, 2: -0.5, 4: -0.5, 6: 0.5}, {}),
    ("tet_2x2x2", 2, "consistent", "full", {a: -0.5 for a in range(1, 6)},
     dict(dirichlet_bcs={6: 0.25})),
], ids=["class_full", "element_full", "eigen_class_diffuse",
        "eigen_element", "on_the_fly_specular", "periodic", "dirichlet"])
def test_step_through_bridge(case, monkeypatch):
    """The port's scan step on pbte_tpu's own operators
    (convert.consts_from_numpy) from pbte_tpu's state after one step
    (convert.state_from_numpy) equals pbte_tpu's next step to 1e-12 of max
    in float64; with the class-compressed streams too (pbte_tpu's
    PBTE_SCAN_CLASS_OPS=1, the port's CLASS_OPS_BUDGET at 0)."""
    import jax

    from pbte_tpu_torch.convert import consts_from_numpy, state_from_numpy

    mesh, order, face_mode, bcs, kw = case[0], case[1], case[2], case[4], \
        case[5]
    for class_ops in ((False, True) if case[3] == "full" and not kw
                      and not bcs else (False,)):
        if class_ops:
            monkeypatch.setenv("PBTE_SCAN_CLASS_OPS", "1")
            monkeypatch.setattr(tscan, "CLASS_OPS_BUDGET", 0)
        js, ts = _pair(mesh, order, face_mode, True, bcs=bcs or None,
                       cache_policy=case[3], **kw)
        sv = ts._scan
        assert js.cache_policy == ts.cache_policy
        assert sv._scan_cls_ops == js._scan_cls_ops == (
            class_ops and sv.ncls > 0)
        consts = consts_from_numpy(jax.tree.map(np.asarray, js.consts),
                                   device="cpu")
        assert set(consts) == set(sv.consts)
        sv.consts = ts.consts = consts
        s1 = js.step(*js.initial_state())
        state = state_from_numpy(*(np.asarray(x) for x in s1[:3]),
                                 device="cpu")
        want = js.step(*s1[:3])
        got = ts.step(*state)
        for a, b in zip(want[:3], got[:3]):
            a = np.asarray(a)
            assert np.abs(_np(b) - a).max() <= 1e-12 * np.abs(a).max()
