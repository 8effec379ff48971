"""Dir and band sharding of pbte_tpu_torch's SourceIterationSolver on
every sweep off K1's lattice ring (the supercell ring, the multi-class
ring, the general ring and the scan) against pbte_tpu's dir-sharded
solver, on the CPU.

The port's ranks are spawned gloo processes (``parallel.launch.run_ranks``,
once for this module, four ranks, the cases of
``tests/torch_parallel_cases.py``), each case on the grid it names: 4 x 1
``dir``, 2 x 2 ``dir`` x ``band`` and 1 x 4 ``band`` (the tables' 6 bands
padded to 8 with zero tables). pbte_tpu's solver runs here on its virtual
CPU devices with the ``NamedSharding`` of the same shape
(``tests/test_parallel.py``, ``tests/test_ring.py``). In float64, Tc after
5 steps at 1e-12 of max against pbte_tpu's and against the port's single
rank, the views (``u_by_direction``, the heat flux) against the single
rank; BiCGStab on the sharded supercell ring at 1e-9 of max against
pbte_tpu's (``tests/test_accel.py``). Also: the reflective walls (whose
boundary values are gathered over the grid) on the general ring and the
scan, the scan's three factor caches, checkpoints that each rank reloads
bit for bit, and bf16 state on the sharded supercell ring.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_golden
import torch_parallel_cases as tpc
from pbte_tpu import mesh as jmesh
from pbte_tpu.angular import quadrature as jang
from pbte_tpu.fem import assembly as jasm
from pbte_tpu.material import nongray_smrt as jmat
from pbte_tpu.solver.source_iteration import SourceIterationSolver as JSolver
from pbte_tpu_torch.parallel.launch import run_ranks
from pbte_tpu_torch.problem import REPO_ROOT
from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

WALLS3 = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}
BCS2 = {1: -0.5, 2: -0.5, 3: 0.5, 4: -0.5}
# the supercell ring: the 6-tet 2 x 2 x 2 box, supercell="on" (as
# pbte_tpu's multichip dry run); 4 slots a group, 6 bands
SUPER = ("tetbox", 2, 2, 2, 1, 2, 8, 3)
# the multi-class ring: the graded hex 8^3 at p = 1
MULTI = ("graded", 8, 1, 2, 4, 2)
# the general ring: the default config's square refined 6 times (8192
# triangles, where auto takes pbte_tpu's one-hot ring)
GENERAL = ("square", 6, 8, 2)
# the scan: pbte_tpu's 3 x 3 triangle square of its band-sharding test
SCAN = ("tri", 3, 3, 1, 8, 3, "consistent")
SQUARE_BCS = {1: -0.5, 2: 0.5}

PATHS = {
    "supercell": dict(problem=SUPER, bcs=WALLS3, kw=dict(supercell="on")),
    "multi": dict(problem=MULTI, bcs=WALLS3),
    "general": dict(problem=GENERAL, bcs=SQUARE_BCS),
    "scan": dict(problem=SCAN, bcs=BCS2),
}
GRIDS = {"dir4": {"dir": 4}, "dir2band2": {"dir": 2, "band": 2},
         "band4": {"band": 4}}
ITERS = 5


def _case(path, grid, **extra):
    return dict(PATHS[path], fn="dir_sharded", grid=GRIDS[grid],
                **dict(dict(iters=ITERS), **extra))


CASES = {f"{p}_{g}": _case(p, g, views=True, convert=True)
         for g in ("dir4", "dir2band2") for p in PATHS}
CASES.update({
    "supercell_band4": _case("supercell", "band4"),
    "scan_band4": _case("scan", "band4", views=True),
    # reflective walls: the closures gather every rank's boundary values
    "general_diffuse": _case("general", "dir2band2", bcs={2: 0.5},
                             kw=dict(diffuse_bcs=[1])),
    # (the uniform azimuth rule: mirror-symmetric about both axes)
    "general_specular": _case("general", "dir2band2", bcs={2: 0.5},
                              problem=GENERAL + ("uniform",),
                              kw=dict(specular_bcs=[1])),
    "scan_diffuse": _case("scan", "dir2band2", bcs={1: -0.5, 3: 0.5},
                          kw=dict(diffuse_bcs=[2, 4])),
    # (y-normal walls: the gauss azimuth rule is symmetric about y)
    "scan_specular": _case("scan", "dir2band2", bcs={2: -0.5, 4: 0.5},
                           kw=dict(specular_bcs=[1, 3])),
    "scan_eigen": _case("scan", "dir2band2", kw=dict(cache_policy="eigen")),
    "scan_on_the_fly": _case("scan", "dir2band2",
                             kw=dict(cache_policy="on-the-fly")),
    "supercell_bicgstab": _case("supercell", "dir2band2", tol=1e-10,
                                iters=400, check_every=10,
                                accelerate="bicgstab"),
    "supercell_ckpt": _case("supercell", "dir2band2", ckpt=True,
                            ckpt_name="super"),
    "scan_ckpt": _case("scan", "dir4", ckpt=True, ckpt_name="scan"),
    "supercell_bf16": _case("supercell", "dir2band2", dtype="f32", iters=3,
                            env={"PBTE_RING_STATE_BF16": "1"}, ckpt=True,
                            ckpt_name="super_bf16"),
})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on four spawned ranks; rank 0's results."""
    wd = tmp_path_factory.mktemp("dir_sharding")
    return run_ranks(tpc.run_grid_cases, 4, (CASES, wd), workdir=wd,
                     timeout=240)[0]


def _jax_problem(spec):
    kind = spec[0]
    if kind == "tetbox":
        return torch_golden.jax_tet_box(*spec[1:])
    if kind == "graded":
        return torch_golden.jax_graded_cube(*spec[1:])
    if kind == "square":
        _, refine, az, nspec, *scheme = spec
        md = jmesh.uniform_refine(jmesh.load_mesh(str(
            REPO_ROOT / "config" / "mesh" / "unit-square-iso.mesh")).scaled(
                1e-6), refine)
        quad = jang.build(jang.AngularOptions(
            dimension=2, azimuth_points=az,
            azimuth_scheme=scheme[0] if scheme else "gauss"))
    else:
        _, nx, ny, order, az, nspec, _ = spec
        md = jmesh.make_cartesian_2d(nx, ny, jmesh.GEOM_TRIANGLE).scaled(1e-6)
        quad = jang.build(jang.AngularOptions(dimension=2, azimuth_points=az))
    ops = jasm.assemble(jmesh.connect(md), order=1, face_mode="consistent")
    return ops, quad, jmat.build_tables(jmat.SILICON, num_spectral=nspec)


def _sharding(grid):
    names = tuple(grid)
    n = int(np.prod(list(grid.values())))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(tuple(grid.values())),
                names)
    spec = P("dir" if "dir" in grid else None,
             "band" if "band" in grid else None)
    return NamedSharding(mesh, spec)


def _jax(case, **solve_kw):
    js = JSolver(*_jax_problem(case["problem"]), case["bcs"],
                 dtype=jnp.float64, dir_sharding=_sharding(case["grid"]),
                 **case.get("kw", {}))
    return js, js.solve(tol=case.get("tol", 0), max_iter=case["iters"],
                        verbose=False, **solve_kw)


def _single(case, dtype=torch.float64):
    _, ops, quad, tables = tpc.build_problem(case["problem"])
    s = SourceIterationSolver(ops, quad, tables, case["bcs"], dtype=dtype,
                              device="cpu", **case.get("kw", {}))
    return s, s.solve(tol=case.get("tol", 0), max_iter=case["iters"],
                      verbose=False, check_every=case.get("check_every", 1),
                      accelerate=case.get("accelerate"))


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, (what, err)


def _check_path(got, path, grid):
    assert got["path"] == path
    shard = got["shard"]
    n_dir, n_band = grid.get("dir", 1), grid.get("band", 1)
    assert got["Km"] % n_dir == 0 and got["BS"] % n_band == 0
    band_axis = 2 if path == "scan" else 3
    assert shard[band_axis] == got["BS"] // n_band


@pytest.mark.parametrize("grid", ["dir4", "dir2band2"])
@pytest.mark.parametrize("path", list(PATHS))
def test_sharded_sweep_matches_pbte_tpu(ranks, path, grid):
    """Tc after 5 steps on the sharded sweep against pbte_tpu's
    dir-sharded solver and the port's single rank, at 1e-12 of max in
    float64; u_by_direction and the heat flux against the single rank's;
    the state through ``convert`` against pbte_tpu's whole state."""
    case, got = CASES[f"{path}_{grid}"], ranks[f"{path}_{grid}"]
    _check_path(got, path, case["grid"])
    js, rj = _jax(case)
    assert js.sweep_mode == got["mode"]
    _close(got["Tc"], rj.Tc, 1e-12, "Tc vs pbte_tpu")
    _close(got["Tv"], rj.Tv, 1e-12, "Tv vs pbte_tpu")
    s, r0 = _single(case)
    _close(got["Tc"], r0.Tc.numpy(), 1e-12, "Tc vs one rank")
    _close(got["u_dirs"], s.u_by_direction(r0.u), 1e-12, "u vs one rank")
    _close(got["Qc"], s.heat_flux(r0.u)[0].numpy(), 1e-12, "Qc vs one rank")
    # the whole state, gathered by convert into pbte_tpu's layout (padded
    # slots and bands included), against pbte_tpu's, and back bit for bit
    assert got["convert_roundtrip"]
    want = rj.u if isinstance(rj.u, tuple) else [rj.u]
    full = got["u_full"] if isinstance(got["u_full"], list) else [
        got["u_full"]]
    if path in ("multi", "general"):  # pbte_tpu's XLA ring state is "dbs"
        want = [np.swapaxes(np.asarray(b), 3, 4) for b in want]
    for a, b in zip(full, want, strict=True):
        _close(a, b, 1e-12, "u vs pbte_tpu")


@pytest.mark.parametrize("path", ["supercell", "scan"])
def test_band_axis_pads_to_its_ranks(ranks, path):
    """4 band ranks on 6 bands: the band axis pads to 8 with zero tables,
    which change nothing (pbte_tpu's band-sharding test, its own 3 x 3
    triangle square on the scan, where auto takes the scan)."""
    case, got = CASES[f"{path}_band4"], ranks[f"{path}_band4"]
    assert got["BS"] == 8 and got["shard"][2 if path == "scan" else 3] == 2
    _check_path(got, path, case["grid"])
    _, r0 = _single(case)
    _close(got["Tc"], r0.Tc.numpy(), 1e-12, "Tc vs one rank")
    _, rj = _jax(case)
    _close(got["Tc"], rj.Tc, 1e-12, "Tc vs pbte_tpu")
    if path == "scan":
        assert got["u_dirs"].shape[1] == 6  # the padding dropped


@pytest.mark.parametrize("name", ["general_diffuse", "general_specular",
                                  "scan_diffuse", "scan_specular"])
def test_reflective_walls_gather_the_boundary(ranks, name):
    """Diffuse and specular walls on the sharded general ring and scan (the
    boundary values all-gathered over dir and band) against pbte_tpu's
    dir-sharded solver and the port's single rank."""
    case, got = CASES[name], ranks[name]
    _check_path(got, name.split("_")[0], case["grid"])
    _, rj = _jax(case)
    _close(got["Tc"], rj.Tc, 1e-12, "Tc vs pbte_tpu")
    _, r0 = _single(case)
    _close(got["Tc"], r0.Tc.numpy(), 1e-12, "Tc vs one rank")


@pytest.mark.parametrize("policy", ["eigen", "on_the_fly"])
def test_scan_factor_caches(ranks, policy):
    """The eigen and on-the-fly caches, built for the rank's slots and
    bands alone, against the single rank's."""
    case, got = CASES[f"scan_{policy}"], ranks[f"scan_{policy}"]
    assert got["policy"] == case["kw"]["cache_policy"]
    _, r0 = _single(case)
    assert r0.solver.cache_policy == got["policy"]
    _close(got["Tc"], r0.Tc.numpy(), 1e-12, "Tc vs one rank")


def test_sharded_supercell_bicgstab(ranks):
    """BiCGStab over the sharded supercell ring (the grid's inner product)
    against pbte_tpu's dir-sharded BiCGStab at 1e-9 of max, and the port's
    single rank's."""
    case, got = CASES["supercell_bicgstab"], ranks["supercell_bicgstab"]
    _, rj = _jax(case, check_every=10, accelerate="bicgstab")
    _close(got["Tc"], rj.Tc, 1e-9, "Tc vs pbte_tpu")
    _, r0 = _single(case)
    _close(got["Tc"], r0.Tc.numpy(), 1e-9, "Tc vs one rank")


@pytest.mark.parametrize("name", ["supercell_ckpt", "scan_ckpt"])
def test_sharded_checkpoint(ranks, name):
    """Rank 0 writes the full state (Km rounded up to the dir ranks, as
    pbte_tpu records it), each rank reloads its own shard bit for bit, and
    the file's Tc is the single rank's."""
    case, got = CASES[name], ranks[name]
    assert got["reloaded"]
    _, r0 = _single(case)
    with np.load(got["ckpt"]) as ck:
        assert int(ck["iteration"]) == ITERS
        assert int(ck["fp_Km"]) % case["grid"].get("dir", 1) == 0
        _close(ck["Tc"], r0.Tc.numpy(), 1e-12, "Tc")
        if name == "supercell_ckpt":
            assert str(ck["u_layout"]) == "dbs"


def test_sharded_bf16_supercell(ranks, monkeypatch):
    """bf16 state on the sharded supercell ring: the shards are bf16, the
    checkpoint reloads them bit for bit, and Tc after 3 steps lies within
    1e-5 of max of the single rank's bf16 run (measured 1.7e-7: each
    slot's and band's products are the same on both, the partials' sums
    differ in their order, and a state entry next to a bf16 rounding
    boundary can round the other way)."""
    case, got = CASES["supercell_bf16"], ranks["supercell_bf16"]
    assert got["state_dtype"] == "torch.bfloat16" and got["reloaded"]
    monkeypatch.setenv("PBTE_RING_STATE_BF16", "1")
    s, r0 = _single(case, dtype=torch.float32)
    assert s.state_bf16 and r0.u[0].dtype == torch.bfloat16
    _close(got["Tc"], r0.Tc.numpy(), 1e-5, "Tc vs one rank")
