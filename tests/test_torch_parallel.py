"""pbte_tpu_torch's partitioners, SpatialShardedSolver (parallel/spatial.py)
and the dir/band sharding of SourceIterationSolver against pbte_tpu's, on
the CPU.

The partitioners run in this process: every method's plan equals
pbte_tpu's bit for bit and passes the seven invariant checks
(``validation.partition``). The sharded solvers run on spawned gloo ranks
(``parallel.launch.run_ranks``; see tests/test_torch_slab.py), one spawn
per grid: 2 x 4 (``dir`` x ``space``), 4 x 1 and 2 x 4 (``dir`` x
``band``); pbte_tpu's solvers run here on its 8-device virtual CPU mesh of
the same shape. The cases of ``tests/test_parallel.py`` (the lagged oracle,
one partition as Gauss-Seidel, the ppermute halo against the psum halo,
class factors against per-element factors, BiCGStab, reflective walls,
the ParaView pieces, band sharding past the Km ceiling) and the
dir-sharded rings of ``tests/test_ring.py``, ``tests/test_accel.py`` and
``tests/test_reflective_bcs.py``, on lattices where the port takes K1.
f64 iterates at 1e-12 of max, converged fields at 1e-9 (BiCGStab 1e-7),
f32 at rtol 2e-5 / atol 5e-7 of max.
"""

import pathlib
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pbte_tpu import mesh as jmesh
from pbte_tpu.angular import quadrature as jang
from pbte_tpu.fem import assembly as jasm
from pbte_tpu.material import nongray_smrt as jmat
from pbte_tpu.parallel import partition as jpart
from pbte_tpu.parallel.spatial import SpatialShardedSolver as JSpatial
from pbte_tpu.solver.source_iteration import SourceIterationSolver as JSolver
from pbte_tpu_torch import mesh as tmesh
from pbte_tpu_torch.parallel import partition as tpart
from pbte_tpu_torch.parallel.launch import run_ranks
from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver
from pbte_tpu_torch.validation.oracle import solve_oracle
from pbte_tpu_torch.validation.partition import validate

import torch_parallel_cases as tpc

BCS2 = {1: -0.5, 2: -0.5, 3: 0.5, 4: -0.5}
BCS3 = {1: -0.5, 2: -0.5, 3: -0.5, 4: -0.5, 5: -0.5, 6: 0.5}
TET_BCS = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}
TRI = ("tri", 4, 4, 1, 8, 3, "mfem-parity")
TRI_C = ("tri", 4, 4, 1, 8, 2, "consistent")
TET = ("tet", 3, 1, 2, 4, 2)
# converged cases on 0.3 micron squares: fewer outer steps
TRI_SMALL = ("tri", 8, 6, 1, 8, 2, "consistent", 3e-7)
QUAD_SMALL = ("quad", 6, 4, 1, 8, 2, 1e-7)
# lattices of >= 512 elements, where the port's faces go canonical and the
# ring takes K1
QUAD_LAT = ("quad", 24, 22, 1, 8, 2)
HEX_LAT = ("hex", 8, 8, 8, 1, 2, 8, 3, ())
HEX_LAT_SMALL = ("hex", 8, 8, 8, 1, 2, 8, 3, (), 3e-7)
# float32 at a millimetre edge: on micron cells the f32 state nears the
# subnormals and its rounding follows the summation order
HEX_WIN = ("hex", 16, 16, 16, 1, 2, 4, 2, (), 1e-3)
REFL = dict(bcs={5: -0.5, 3: 0.5},
            kw=dict(diffuse_bcs=[1, 2], specular_bcs=[4, 6]))

SPACE_2x4 = {
    "spatial_oracle": dict(fn="spatial_iterates", problem=TRI, bcs=BCS2,
                           iters=4, dtype="f64"),
    "halo_ppermute": dict(fn="spatial_iterates", problem=TRI_C, bcs=BCS2,
                          iters=6),
    "halo_psum": dict(fn="spatial_iterates", problem=TRI_C, bcs=BCS2,
                      iters=6, kw=dict(halo_mode="psum")),
    "class_factors": dict(fn="spatial_iterates", problem=TET, bcs=TET_BCS,
                          iters=3, kw=dict(partition_method="multilevel")),
    "element_factors": dict(fn="spatial_iterates", problem=TET, bcs=TET_BCS,
                            iters=3, kw=dict(partition_method="multilevel",
                                             force_per_element_factors=True)),
    "spatial_plain": dict(fn="spatial_iterates", problem=TRI_SMALL,
                          bcs=BCS2, tol=1e-10, iters=2000, check_every=10),
    "spatial_bicgstab": dict(fn="spatial_iterates", problem=TRI_SMALL,
                             bcs=BCS2, tol=1e-10, iters=2000, check_every=10,
                             accelerate="bicgstab"),
    "spatial_reflective": dict(
        fn="spatial_iterates", problem=QUAD_SMALL, bcs={2: 0.5, 4: -0.5},
        tol=1e-10, iters=2000, check_every=10, accelerate="bicgstab",
        kw=dict(diffuse_bcs=[1], specular_bcs=[3])),
    "pieces": dict(fn="spatial_iterates", problem=TRI, bcs=BCS2, iters=3,
                   views=True),
    "from_jax_state": dict(fn="from_state", solver="spatial", problem=TRI,
                           bcs=BCS2, iters=2),
    # dir sharding over the dir axis of this grid (each space line a
    # replica)
    "dir_windowed_f32": dict(fn="dir_sharded", problem=HEX_WIN, bcs=BCS3,
                             iters=3, dtype="f32"),
    "dir_bicgstab": dict(fn="dir_sharded", problem=HEX_LAT_SMALL, bcs=BCS3,
                         tol=1e-10, iters=2000, check_every=10,
                         accelerate="bicgstab"),
    "dir_reflective": dict(fn="dir_sharded", problem=HEX_LAT, iters=5,
                           **REFL),
}
DIR_4x1 = {
    "one_partition": dict(fn="spatial_iterates", problem=TRI, bcs=BCS2,
                          iters=4),
    "dir4_ring": dict(fn="dir_sharded", problem=QUAD_LAT, bcs=BCS2, iters=5,
                      views=True, ckpt=True),
}
BAND_2x4 = {
    "band": dict(fn="dir_sharded", problem=QUAD_LAT, bcs=BCS2, iters=5,
                 views=True),
}
BAND_2x4["band"]["problem"] = ("quad", 24, 22, 1, 8, 3)


def _jax_problem(spec):
    kind = spec[0]
    if kind == "hex":
        _, nx, ny, nz, order, polar, az, nspec, per, *edge = spec
        m = jmesh.make_cartesian_3d(nx, ny, nz, "hex")
        if per:
            m = jmesh.make_periodic(m, list(per))
        quad = jang.build(jang.AngularOptions(dimension=3, polar_points=polar,
                                              azimuth_points=az))
        fm = "consistent"
    elif kind == "tet":
        _, n, order, polar, az, nspec = spec
        m, edge, fm = jmesh.make_cartesian_3d(n, n, n, "tet"), (), "consistent"
        quad = jang.build(jang.AngularOptions(dimension=3, polar_points=polar,
                                              azimuth_points=az))
    elif kind == "quad":
        _, nx, ny, order, az, nspec, *edge = spec
        m, fm = jmesh.make_cartesian_2d(nx, ny, "quad"), "consistent"
        quad = jang.build(jang.AngularOptions(dimension=2, azimuth_points=az))
    else:
        _, nx, ny, order, az, nspec, fm, *edge = spec
        m = jmesh.make_cartesian_2d(nx, ny, jmesh.GEOM_TRIANGLE)
        quad = jang.build(jang.AngularOptions(dimension=2, azimuth_points=az))
    topo = jmesh.connect(m.scaled(edge[0] if edge else 1e-6))
    return (topo, jasm.assemble(topo, order=order, face_mode=fm), quad,
            jmat.build_tables(jmat.SILICON, num_spectral=nspec))


def _mesh(shape, names=("dir", "space")):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _spawn(tmp_path_factory, name, shape, cases):
    wd = tmp_path_factory.mktemp(name)
    return run_ranks(tpc.run_cases, int(np.prod(list(shape.values()))),
                     (shape, cases, wd), workdir=wd, timeout=120)[0]


@pytest.fixture(scope="module")
def space2x4(tmp_path_factory):
    """The 2 x 4 cases; pbte_tpu's spatial state after 3 steps is written
    first, for the state conversion."""
    path = tmp_path_factory.mktemp("jax_state") / "spatial.npz"
    r = _jax_spatial("from_jax_state").solve(tol=0, max_iter=3,
                                             verbose=False)
    np.savez(path, u=np.asarray(r.u), Tc=np.asarray(r.Tc),
             Tv=np.asarray(r.Tv))
    cases = dict(SPACE_2x4)
    cases["from_jax_state"] = dict(cases["from_jax_state"], state=str(path))
    return _spawn(tmp_path_factory, "space2x4", {"dir": 2, "space": 4},
                  cases)


@pytest.fixture(scope="module")
def dir4x1(tmp_path_factory):
    return _spawn(tmp_path_factory, "dir4x1", {"dir": 4, "space": 1},
                  DIR_4x1)


@pytest.fixture(scope="module")
def band2x4(tmp_path_factory):
    return _spawn(tmp_path_factory, "band2x4", {"dir": 2, "band": 4},
                  BAND_2x4)


def _close(got, want, rtol):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, err


def _f32_close(got, want):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=5e-7 * scale)


# ---- partitioners ----------------------------------------------------------

@pytest.fixture(scope="module")
def topos():
    m = (tmesh, jmesh)
    tri = [mm.connect(mm.make_cartesian_2d(4, 4, mm.GEOM_TRIANGLE)
                      .scaled(1e-6)) for mm in m]
    tet = [mm.connect(mm.make_cartesian_3d(4, 4, 4, "tet")) for mm in m]
    return {"tri": tri, "tet": tet}


PLAN_KEYS = ("part", "local_elems", "local_counts", "local_of_global",
             "interface", "iface_of_global", "nbr_local", "nbr_iface")


@pytest.mark.parametrize("mesh", ["tri", "tet"])
@pytest.mark.parametrize("nparts", [2, 3, 4])
@pytest.mark.parametrize("method", ["rcb", "greedy", "rcb-fm", "greedy-fm",
                                    "multilevel"])
def test_partition_plans_match(topos, mesh, nparts, method):
    """Every method's plan equals pbte_tpu's bit for bit (the multilevel
    one through both native partitioners) and passes the invariants."""
    tt, tj = topos[mesh]
    got = tpart.build_plan(tt, nparts, method=method)
    want = jpart.build_plan(tj, nparts, method=method)
    for key in PLAN_KEYS:
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key),
                                      err_msg=key)
    result = validate(got, tt)
    assert result.ok, result.errors
    assert got.load_balance() < 1.5


def test_multilevel_numpy_form_matches(topos, monkeypatch):
    """The numpy multilevel partitioner (no native library) against
    pbte_tpu's (PBTE_PARTITION_NATIVE=0)."""
    monkeypatch.setenv("PBTE_PARTITION_NATIVE", "0")
    tt, tj = topos["tet"]
    for nparts in (2, 4):
        got = tpart._multilevel_numpy(tt.elem_neighbor, nparts)
        want = jpart.partition_multilevel(tj.elem_neighbor, nparts)
        np.testing.assert_array_equal(got, want)


# ---- spatial solver ----------------------------------------------------------

def _jax_spatial(name, mesh=None):
    case = SPACE_2x4.get(name) or DIR_4x1[name]
    topo, ops, quad, tables = _jax_problem(case["problem"])
    return JSpatial(ops, quad, tables, case["bcs"],
                    device_mesh=mesh or _mesh((2, 4)), dtype=jnp.float64,
                    topo=topo, **case.get("kw", {}))


@pytest.mark.parametrize("name", ["spatial_oracle", "halo_ppermute",
                                  "halo_psum", "class_factors",
                                  "element_factors"])
def test_spatial_iterates_match_pbte_tpu(space2x4, name):
    """The port's spatial iterates against pbte_tpu's on the 2 x 4 grid:
    Tc, the residual and the partition."""
    got = space2x4[name]
    js = _jax_spatial(name)
    r = js.solve(tol=0, max_iter=SPACE_2x4[name]["iters"], verbose=False)
    _close(got["Tc"], r.Tc_global(), 1e-12)
    assert abs(got["residual"] - r.residual) <= 1e-12
    np.testing.assert_array_equal(got["part"], js.element_partition)


def test_spatial_matches_lagged_oracle(space2x4):
    got = space2x4["spatial_oracle"]
    _, ops, quad, tables = tpc.build_problem(TRI)
    _, Tco, *_ = solve_oracle(ops, quad, tables, BCS2, tol=0, max_iter=4,
                              part=got["part"])
    _close(got["Tc"], Tco, 1e-12)


def test_spatial_steps_from_pbte_tpus_state(space2x4):
    """pbte_tpu's global spatial state after 3 steps becomes the ranks'
    shards (and back, bit for bit); 2 more steps there equal pbte_tpu's 5:
    u, Tc and Tv."""
    got = space2x4["from_jax_state"]
    assert got["roundtrip"]
    r = _jax_spatial("from_jax_state").solve(tol=0, max_iter=5,
                                             verbose=False)
    for key, want in (("u", r.u), ("Tc_sh", r.Tc), ("Tv_sh", r.Tv)):
        _close(got[key], np.asarray(want), 1e-12)


def test_one_partition_is_gauss_seidel(dir4x1):
    """One partition (4 dir ranks) is the plain Gauss-Seidel sweep."""
    _, ops, quad, tables = tpc.build_problem(TRI)
    _, Tco, *_ = solve_oracle(ops, quad, tables, BCS2, tol=0, max_iter=4)
    _close(dir4x1["one_partition"]["Tc"], Tco, 1e-12)


def test_ppermute_halo_matches_psum(space2x4):
    _close(space2x4["halo_ppermute"]["Tc"], space2x4["halo_psum"]["Tc"],
           1e-12)


def test_class_factors_match_per_element(space2x4):
    cls, pe = space2x4["class_factors"], space2x4["element_factors"]
    assert cls["classes"] and not pe["classes"]
    _close(cls["Tc"], pe["Tc"], 1e-12)
    assert abs(cls["residual"] - pe["residual"]) < 1e-12


def test_spatial_bicgstab(space2x4):
    plain, acc = space2x4["spatial_plain"], space2x4["spatial_bicgstab"]
    assert acc["iterations"] * 2 < plain["iterations"], (
        acc["iterations"], plain["iterations"])
    _close(acc["Tc"], plain["Tc"], 1e-7)


def test_spatial_reflective_matches_single_device(space2x4):
    """Diffuse and specular walls: the sharded fixed point is the single
    device's."""
    case = SPACE_2x4["spatial_reflective"]
    _, ops, quad, tables = tpc.build_problem(case["problem"])
    s0 = SourceIterationSolver(ops, quad, tables, case["bcs"],
                               dtype=torch.float64, device="cpu",
                               **case["kw"])
    r0 = s0.solve(tol=1e-10, max_iter=2000, verbose=False, check_every=10,
                  accelerate="bicgstab")
    T0 = r0.Tc.numpy()
    assert np.abs(space2x4["spatial_reflective"]["Tc"] - T0).max() <= (
        1e-8 * np.abs(T0).max())


def test_paraview_pieces(space2x4, tmp_path):
    """Per-partition pieces reassemble to the global fields; the .pvtu
    names one piece per partition."""
    got = space2x4["pieces"]
    covered = np.zeros(len(got["part"]), dtype=bool)
    for p, (ids, sf, vf) in enumerate(got["pieces"]):
        assert not covered[ids].any() and (got["part"][ids] == p).all()
        covered[ids] = True
        np.testing.assert_allclose(sf["T"], got["Tc"][ids], atol=1e-12)
        np.testing.assert_allclose(vf["Q"], got["Qc"][:, ids], atol=1e-12)
    assert covered.all()
    assert got["pvd"].endswith("dd.pvd")
    cdir = pathlib.Path(got["pvd"]).parent / "Cycle000003"
    pv = ET.parse(cdir / "data.pvtu").getroot()
    srcs = [q.get("Source") for q in pv.findall(".//Piece")]
    assert srcs == [f"proc{p:06d}.vtu" for p in range(4)]
    # pbte_tpu's pieces of the same state
    js = _jax_spatial("pieces")
    u, Tc, Tv = js.initial_state()
    for _ in range(3):
        u, Tc, Tv, _ = js.step(u, Tc, Tv)
    for (ids, sf, vf), (jids, jsf, jvf) in zip(got["pieces"],
                                               js.paraview_pieces(Tc, u)):
        np.testing.assert_array_equal(ids, jids)
        _close(sf["T"], jsf["T"], 1e-12)
        _close(vf["Q"], jvf["Q"], 1e-12)


# ---- dir and band sharding -------------------------------------------------

def _jax_dir(case, sharding, dtype=jnp.float64, **kw):
    _, ops, quad, tables = _jax_problem(case["problem"])
    return JSolver(ops, quad, tables, case["bcs"], dtype=dtype,
                   dir_sharding=sharding, **case.get("kw", {}), **kw)


def _port_single(case, dtype=torch.float64, **solve_kw):
    _, ops, quad, tables = tpc.build_problem(case["problem"])
    s = SourceIterationSolver(ops, quad, tables, case["bcs"], dtype=dtype,
                              device="cpu", **case.get("kw", {}))
    return s, s.solve(verbose=False, **solve_kw)


def test_dir_sharded_ring_matches_pbte_tpu(dir4x1):
    """4 dir ranks on the quad lattice ring (K1's plain version in each
    shard) against pbte_tpu's dir-sharded solver and the port's single
    rank."""
    case, got = DIR_4x1["dir4_ring"], dir4x1["dir4_ring"]
    assert got["mode"] == "ring" and got["k1"]
    sh = NamedSharding(_mesh((4,), ("dir",)), P("dir"))
    r = _jax_dir(case, sh).solve(tol=0, max_iter=5, verbose=False)
    _close(got["Tc"], np.asarray(r.Tc), 1e-12)
    s, r0 = _port_single(case, tol=0, max_iter=5)
    _close(got["Tc"], r0.Tc.numpy(), 1e-12)
    np.testing.assert_allclose(got["u_dirs"], s.u_by_direction(r0.u),
                               rtol=0, atol=1e-12 * np.abs(
                                   got["u_dirs"]).max())


def test_dir_sharded_checkpoint(dir4x1):
    """The dir-sharded ring's checkpoint holds the full buckets (rank 0
    writes them; Km rounded up to the dir ranks, as pbte_tpu's sharded
    solver records it): each rank reloads its own shard bit for bit, and
    the file's Tc is the single rank's."""
    got = dir4x1["dir4_ring"]
    assert got["reloaded"]
    _, r0 = _port_single(DIR_4x1["dir4_ring"], tol=0, max_iter=5)
    with np.load(got["ckpt"]) as ck:
        assert int(ck["iteration"]) == 5 and int(ck["fp_Km"]) % 4 == 0
        assert str(ck["u_layout"]) == "bsd"
        _close(ck["Tc"], r0.Tc.numpy(), 1e-12)


def test_band_sharding_past_the_km_ceiling(band2x4):
    """8 ranks (2 dir x 4 band) on a problem of 2 slots a group: the band
    axis pads 6 bands to 8 with zero tables, which change nothing."""
    case, got = BAND_2x4["band"], band2x4["band"]
    assert got["BS"] == 8 and got["shard"][3] == 2 and got["k1"]
    sh = NamedSharding(_mesh((2, 4), ("dir", "band")), P("dir", "band"))
    r = _jax_dir(case, sh).solve(tol=0, max_iter=5, verbose=False)
    _close(got["Tc"], np.asarray(r.Tc), 1e-12)
    s, r0 = _port_single(case, tol=0, max_iter=5)
    _close(got["Tc"], r0.Tc.numpy(), 1e-12)
    assert got["u_dirs"].shape == s.u_by_direction(r0.u).shape


def test_dir_sharded_windowed_f32(space2x4, monkeypatch):
    """Hull windows on the dir-sharded ring in float32 (hex 16^3, as
    tests/test_ring.py's windowed dir-sharding case): the sharded Tc
    against pbte_tpu's dir-sharded solve (exact f32 operands) and one
    rank's."""
    case, got = SPACE_2x4["dir_windowed_f32"], space2x4["dir_windowed_f32"]
    assert got["windowed"] and got["k1"]
    monkeypatch.setenv("PBTE_RING_BF16", "0")
    sh = NamedSharding(_mesh((2,), ("dir",)), P("dir"))
    js = _jax_dir(case, sh, dtype=jnp.float32, sweep_mode="ring")
    assert js._ring_windowed
    _f32_close(got["Tc"], np.asarray(js.solve(tol=0, max_iter=3,
                                              verbose=False).Tc))
    torch.set_flush_denormal(True)
    _, r0 = _port_single(case, dtype=torch.float32, tol=0, max_iter=3)
    _f32_close(got["Tc"], r0.Tc.numpy())


def test_dir_sharded_bicgstab(space2x4):
    """BiCGStab over the dir-sharded state (the grid's inner product)
    against pbte_tpu's dir-sharded BiCGStab (as tests/test_accel.py's) and
    one rank's BiCGStab."""
    case, got = SPACE_2x4["dir_bicgstab"], space2x4["dir_bicgstab"]
    sh = NamedSharding(_mesh((2,), ("dir",)), P("dir"))
    rj = _jax_dir(case, sh).solve(tol=1e-10, max_iter=2000, verbose=False,
                                  check_every=10, accelerate="bicgstab")
    _close(got["Tc"], np.asarray(rj.Tc), 1e-9)
    _, r0 = _port_single(case, tol=1e-10, max_iter=2000, check_every=10,
                         accelerate="bicgstab")
    _close(got["Tc"], r0.Tc.numpy(), 1e-8)


def test_dir_sharded_reflective(space2x4):
    """Diffuse and specular walls on the dir-sharded ring (the boundary
    values gathered over dir) against pbte_tpu's."""
    case, got = SPACE_2x4["dir_reflective"], space2x4["dir_reflective"]
    sh = NamedSharding(_mesh((2,), ("dir",)), P("dir"))
    r = _jax_dir(case, sh).solve(tol=0, max_iter=5, verbose=False)
    _close(got["Tc"], np.asarray(r.Tc), 1e-12)
