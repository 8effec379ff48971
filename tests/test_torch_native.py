"""pbte_tpu_torch.native on the CPU: the C++ mirror of the reference's
solver (the baseline of bench_torch.py), the ports of
``tests/test_native.py``'s solver cases, and the copy against pbte_tpu's on
the same inputs; the sweep planner's kernels (greedy orders, levels,
inflow signatures; native and numpy forms) and the multilevel partitioner
against pbte_tpu's native ones, bit for bit; a failed build raises where it
is asked for and the planner falls back to numpy.

The problem is test_native.py's: a 3x3 triangle square (18 elements) in
microns, p = 1, consistent faces, 8 in-plane directions, 2 x 2 bands, three
cold walls and a hot one.
"""

import pathlib

import numpy as np
import pytest

from pbte_tpu import mesh as jmesh
from pbte_tpu import native as jnative
from pbte_tpu.angular import quadrature as jang
from pbte_tpu.fem import assembly as jasm
from pbte_tpu.material import nongray_smrt as jmat
from pbte_tpu_torch import mesh as tmesh
from pbte_tpu_torch import native
from pbte_tpu_torch.angular import quadrature as tang
from pbte_tpu_torch.fem import assembly as tasm
from pbte_tpu_torch.material import nongray_smrt as tmat
from pbte_tpu_torch.validation.oracle import solve_oracle

REPO = pathlib.Path(__file__).resolve().parents[1]
BCS = {1: -0.5, 2: -0.5, 3: 0.5, 4: -0.5}


def _problem(m, asm, ang, mat):
    md = m.make_cartesian_2d(3, 3, m.GEOM_TRIANGLE).scaled(1e-6)
    ops = asm.assemble(m.connect(md), order=1, face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=8))
    return ops, quad, mat.build_tables(mat.SILICON, num_spectral=2)


@pytest.fixture(scope="module")
def problem():
    return _problem(tmesh, tasm, tang, tmat)


def test_source_is_pbte_tpus():
    """The C++ source is a verbatim copy of pbte_tpu's."""
    assert ((REPO / "pbte_tpu_torch/native/solver_native.cpp").read_bytes()
            == (REPO / "pbte_tpu/native/solver_native.cpp").read_bytes())


def test_cpp_solver_matches_oracle(problem):
    """The C++ baseline reproduces the port's numpy oracle to roundoff: the
    same algorithm (lagged-Tc source iteration, upwind sweeps, dense LU),
    float64 throughout."""
    u, Tc, Tv, resid, secs = native.cpp_source_iteration(*problem, BCS, 5)
    uo, Tco, Tvo, *_ = solve_oracle(*problem, BCS, tol=0, max_iter=5)
    np.testing.assert_allclose(Tc, Tco, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(u, uo, rtol=1e-12, atol=1e-22)
    np.testing.assert_allclose(Tv, Tvo, rtol=1e-12)
    assert (secs > 0).all() and np.isfinite(resid).all()


def test_cpp_solver_cache_policies_agree(problem):
    """The full-LU cache and the on-the-fly factorisation: the same
    numbers."""
    a = native.cpp_source_iteration(*problem, BCS, 3, use_full_lu=True)
    b = native.cpp_source_iteration(*problem, BCS, 3, use_full_lu=False)
    np.testing.assert_allclose(a[0], b[0], rtol=1e-13, atol=1e-24)


def test_cpp_solver_resumes_from_state(problem):
    """5 iterations equal 3 and then 2 more from the returned state."""
    full = native.cpp_source_iteration(*problem, BCS, 5)
    part = native.cpp_source_iteration(*problem, BCS, 3)
    resumed = native.cpp_source_iteration(*problem, BCS, 2,
                                          state=part[:3])
    np.testing.assert_allclose(resumed[1], full[1], rtol=1e-13, atol=1e-24)


def test_copy_matches_pbte_tpu(problem):
    """The port's build and loader against pbte_tpu's
    ``native.cpp_source_iteration``, each on its own package's problem:
    u, Tc, Tv and the residuals to roundoff."""
    jp = _problem(jmesh, jasm, jang, jmat)
    want = jnative.cpp_source_iteration(*jp, BCS, 4)
    assert want is not None, "pbte_tpu's C++ solver library failed to build"
    got = native.cpp_source_iteration(*problem, BCS, 4)
    for a, b in zip(got[:4], want[:4]):
        assert np.abs(a - b).max() <= 1e-14 * np.abs(b).max()


def test_periodic_mesh_is_refused():
    """As pbte_tpu's: the C++ baseline has no periodic faces."""
    md = tmesh.make_periodic(tmesh.make_cartesian_2d(3, 3, tmesh.GEOM_QUAD),
                             [0]).scaled(1e-6)
    ops = tasm.assemble(tmesh.connect(md), order=1, face_mode="consistent")
    quad = tang.build(tang.AngularOptions(dimension=2, azimuth_points=8))
    with pytest.raises(NotImplementedError, match="periodic"):
        native.cpp_source_iteration(
            ops, quad, tmat.build_tables(tmat.SILICON, num_spectral=1),
            {1: -0.5, 3: 0.5}, 1)


def test_failed_build_raises(monkeypatch, tmp_path):
    """Without a working compiler the baseline raises with the compiler's
    message (pbte_tpu returns None; bench_torch.py must not print a null
    baseline)."""
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ on it
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.get_solver_lib()


# ---- the sweep planner's kernels and the multilevel partitioner --------------

@pytest.mark.parametrize("src", ["sweep_native.cpp", "partition_native.cpp"])
def test_planner_sources_are_pbte_tpus(src):
    """The planner's and the partitioner's C++ sources are verbatim copies
    of pbte_tpu's."""
    assert ((REPO / "pbte_tpu_torch/native" / src).read_bytes()
            == (REPO / "pbte_tpu/native" / src).read_bytes())


def _graph(kind):
    """(neighbor, normals, directions) of a tri 8x8 square (in-plane
    angles) or a 4^3 tet cube (3D angles)."""
    if kind == "tri":
        topo = tmesh.connect(tmesh.make_cartesian_2d(8, 8, tmesh.GEOM_TRIANGLE))
        quad = tang.build(tang.AngularOptions(dimension=2, azimuth_points=8))
    else:
        topo = tmesh.connect(tmesh.make_cartesian_3d(4, 4, 4, "tet"))
        quad = tang.build(tang.AngularOptions(dimension=3, polar_points=2,
                                              azimuth_points=4))
    return topo.elem_neighbor, topo.normals, quad.directions


@pytest.mark.parametrize("kind", ["tri", "tet"])
@pytest.mark.parametrize("form", ["native", "numpy"])
@pytest.mark.parametrize("kernel", ["greedy_orders", "compute_levels"])
def test_planner_kernels_match_pbte_tpu(kernel, form, kind):
    """greedy_orders and compute_levels, the native kernel and the numpy
    form, against pbte_tpu's native kernel: bit for bit."""
    from pbte_tpu_torch.sweep import planner

    nbr, nrm, dirs = _graph(kind)
    want = np.asarray(getattr(jnative, kernel)(nbr, nrm, dirs))
    numpy_form = {"greedy_orders": planner._greedy_orders_numpy,
                  "compute_levels": planner._levels_numpy}[kernel]
    fn = getattr(planner, kernel) if form == "native" else numpy_form
    got = fn(nbr, nrm, dirs)
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("kind", ["tri", "tet"])
def test_inflow_signatures_match_pbte_tpu(kind):
    nbr, nrm, dirs = _graph(kind)
    got = native.inflow_signatures(nbr, nrm, dirs)
    np.testing.assert_array_equal(got, jnative.inflow_signatures(nbr, nrm,
                                                                 dirs))
    assert got.dtype == np.uint8 and got.any()


@pytest.mark.parametrize("nparts", [2, 4, 8])
def test_partition_multilevel_matches_pbte_tpu(nparts):
    """The native multilevel partition of a 10^3 tet cube (6,000
    elements) equals pbte_tpu's."""
    topo = tmesh.connect(tmesh.make_cartesian_3d(10, 10, 10, "tet"))
    got = native.partition_multilevel(topo.elem_neighbor, nparts)
    want = jnative.partition_multilevel(topo.elem_neighbor, nparts)
    assert want is not None
    np.testing.assert_array_equal(got, want)
    assert np.bincount(got).max() <= 1.03 * len(got) / nparts + 1


def test_failed_planner_build_falls_back(monkeypatch, tmp_path):
    """Without a compiler the planner's loader raises where it is asked to
    build, and the planner and the partitioner run their numpy forms (the
    same results)."""
    from pbte_tpu_torch.parallel import partition
    from pbte_tpu_torch.sweep import planner

    nbr, nrm, dirs = _graph("tri")
    levels = planner.compute_levels(nbr, nrm, dirs)
    orders = planner.greedy_orders(nbr, nrm, dirs)
    part = partition._multilevel_numpy(nbr, 4)
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ on it
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.get_lib()
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.get_partition_lib()
    np.testing.assert_array_equal(planner.compute_levels(nbr, nrm, dirs),
                                  levels)
    np.testing.assert_array_equal(planner.greedy_orders(nbr, nrm, dirs),
                                  orders)
    np.testing.assert_array_equal(partition.partition_multilevel(nbr, 4),
                                  part)
