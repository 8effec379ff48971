"""pbte_tpu_torch's SlabLatticeSolver (parallel/slab.py) against pbte_tpu's,
on the CPU: the port's ranks are spawned processes over gloo
(``parallel.launch.run_ranks``, a ``file://`` rendezvous under the test's
temporary directory, one thread a rank, a join deadline of 120 s), on the
same 2 x 4 ``dir`` x ``space`` grid as pbte_tpu's 8-device virtual CPU
mesh, and every case of this module runs in one spawn (the module's
fixture). The ranks build their problems from the port's own host layers
(``tests/torch_parallel_cases.py``); pbte_tpu's solver runs here.

The cases of ``tests/test_slab.py``: the lagged-interface oracle in 3D,
with plane-periodic and Dirichlet faces, on 2D quads at p = 2 and with
diffuse and specular walls (iterates at 1e-12 of max against pbte_tpu's
slab solver and against the port's oracle); the single-device fixed point
(1e-9 of max); checkpoint round trips within the port and across packages
(1e-12); BiCGStab against the plain loop (1e-7) and the reflective fixed
point against the single-device solve; a wall attribute without faces.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from pbte_tpu import mesh as jmesh
from pbte_tpu.angular import quadrature as jang
from pbte_tpu.fem import assembly as jasm
from pbte_tpu.io.checkpoint import load_checkpoint as jload
from pbte_tpu.io.checkpoint import save_checkpoint as jsave
from pbte_tpu.material import nongray_smrt as jmat
from pbte_tpu.parallel.slab import SlabLatticeSolver as JSlab
from pbte_tpu_torch.parallel.launch import run_ranks
from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver
from pbte_tpu_torch.validation.oracle import solve_oracle

import torch_parallel_cases as tpc

BCS3 = {1: -0.5, 2: -0.5, 3: -0.5, 4: -0.5, 5: -0.5, 6: 0.5}
BCS2 = {1: -0.5, 2: -0.5, 3: 0.5, 4: -0.5}
HEX = ("hex", 6, 4, 4, 1, 2, 4, 2, ())
HEX_PER = ("hex", 6, 4, 4, 1, 2, 4, 2, (1,))
# the converged cases on a 0.3 micron cube: fewer outer steps to the fixed
# point (more ballistic)
HEX_SMALL = ("hex", 6, 4, 4, 1, 2, 4, 2, (), 3e-7)
QUAD = ("quad", 8, 6, 2, 8, 2)
PER_BCS = {1: -0.5, 2: -0.5, 3: -0.5, 4: -0.5, 5: -0.5}
REFL = dict(bcs={5: -0.5, 3: 0.5}, kw=dict(diffuse_bcs=[1, 2],
                                           specular_bcs=[4, 6]))
# (attrs 1 z-, 6 z+) isothermal, the rest diffuse
DIF_BCS = {1: -0.5, 6: 0.5}
CASES = {
    "oracle_3d": dict(fn="slab_iterates", problem=HEX, bcs=BCS3, iters=4),
    "periodic_dirichlet": dict(fn="slab_iterates", problem=HEX_PER,
                               bcs=PER_BCS, iters=5,
                               kw=dict(dirichlet_bcs={6: 0.25})),
    "quad_2d": dict(fn="slab_iterates", problem=QUAD, bcs=BCS2, iters=5),
    "reflective": dict(fn="slab_iterates", problem=HEX, iters=5, **REFL),
    "fixed_point": dict(fn="slab_iterates", problem=HEX_SMALL, bcs=BCS3,
                        tol=1e-12, iters=2000, check_every=10, views=True),
    "bicgstab_1e10": dict(fn="slab_iterates", problem=HEX_SMALL, bcs=BCS3,
                          tol=1e-10, iters=2000, check_every=10,
                          accelerate="bicgstab"),
    "reflective_fixed_point": dict(
        fn="slab_iterates", problem=HEX_SMALL, bcs=DIF_BCS, tol=1e-11,
        iters=2000, check_every=20, accelerate="bicgstab",
        kw=dict(diffuse_bcs=[2, 3, 4, 5])),
    "inert_wall": dict(fn="slab_iterates", problem=HEX, bcs=BCS3, iters=3,
                       kw=dict(diffuse_bcs=[99])),
    "checkpoint": dict(fn="slab_checkpoint", problem=HEX, bcs=BCS3),
    "from_jax_state": dict(fn="from_state", solver="slab", problem=HEX_PER,
                           bcs=PER_BCS, iters=2,
                           kw=dict(dirichlet_bcs={6: 0.25})),
}


def _jax_problem(spec):
    kind = spec[0]
    if kind == "hex":
        _, nx, ny, nz, order, polar, az, nspec, per = spec
        m = jmesh.make_cartesian_3d(nx, ny, nz, "hex").scaled(1e-6)
        if per:
            m = jmesh.make_periodic(m, list(per))
        quad = jang.build(jang.AngularOptions(dimension=3, polar_points=polar,
                                              azimuth_points=az))
    else:
        _, nx, ny, order, az, nspec = spec
        m = jmesh.make_cartesian_2d(nx, ny, "quad").scaled(1e-6)
        quad = jang.build(jang.AngularOptions(dimension=2, azimuth_points=az))
    ops = jasm.assemble(jmesh.connect(m), order=order, face_mode="consistent")
    return ops, quad, jmat.build_tables(jmat.SILICON, num_spectral=nspec)


def _mesh2x4():
    return Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dir", "space"))


def _jax_slab(name):
    case = CASES[name]
    return JSlab(*_jax_problem(case["problem"]), case["bcs"],
                 device_mesh=_mesh2x4(), dtype=jnp.float64,
                 **case.get("kw", {}))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on one spawn of 8 ranks; pbte_tpu's checkpoint at
    iteration 3 is written first, for the cross-package resume."""
    wd = tmp_path_factory.mktemp("slab_ranks")
    js = _jax_slab("checkpoint")
    half = js.solve(tol=0, max_iter=3, verbose=False)
    jsave(str(wd / "jax_slab.npz"), js, half.u, half.Tc, half.Tv, 3,
          half.residual)
    cases = dict(CASES)
    cases["checkpoint"] = dict(cases["checkpoint"],
                               jax_ckpt=str(wd / "jax_slab.npz"))
    js = _jax_slab("from_jax_state")
    r = js.solve(tol=0, max_iter=3, verbose=False)
    np.savez(wd / "jax_state.npz", u=np.asarray(r.u), Tc=np.asarray(r.Tc),
             Tv=np.asarray(r.Tv))
    cases["from_jax_state"] = dict(cases["from_jax_state"],
                                   state=str(wd / "jax_state.npz"))
    out = run_ranks(tpc.run_cases, 8, ({"dir": 2, "space": 4}, cases, wd),
                    workdir=wd, timeout=120)
    return out[0]


def _close(got, want, rtol):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, err


@pytest.mark.parametrize("name", ["oracle_3d", "periodic_dirichlet",
                                  "quad_2d", "reflective"])
def test_iterates_match_pbte_tpu(ranks, name):
    """The port's slab iterates against pbte_tpu's slab solver on the same
    grid: Tc, the residual, the partition and the slab axis."""
    case, got = CASES[name], ranks[name]
    js = _jax_slab(name)
    r = js.solve(tol=0, max_iter=case["iters"], verbose=False)
    _close(got["Tc"], r.Tc_global(), 1e-12)
    assert abs(got["residual"] - r.residual) <= 1e-12
    np.testing.assert_array_equal(got["part"], js.element_partition)
    assert (got["a0"], got["P"], got["shifts"]) == (js.a0, js.P,
                                                    js.shift_vals)


@pytest.mark.parametrize("name", ["oracle_3d", "periodic_dirichlet",
                                  "quad_2d", "reflective"])
def test_iterates_match_lagged_oracle(ranks, name):
    """The port's slab iterates against its sequential oracle with the
    slab partition (block-Jacobi across slabs, Gauss-Seidel within)."""
    case, got = CASES[name], ranks[name]
    _, ops, quad, tables = tpc.build_problem(case["problem"])
    kw = case.get("kw", {})
    _, Tco, *_ = solve_oracle(
        ops, quad, tables, case["bcs"], tol=0, max_iter=case["iters"],
        part=got["part"], dirichlet=kw.get("dirichlet_bcs"),
        diffuse=kw.get("diffuse_bcs"), specular=kw.get("specular_bcs"))
    _close(got["Tc"], Tco, 1e-12)


def _single_device(case, **solve_kw):
    _, ops, quad, tables = tpc.build_problem(case["problem"])
    s = SourceIterationSolver(ops, quad, tables, case["bcs"],
                              dtype=torch.float64, device="cpu",
                              **case.get("kw", {}))
    return s.solve(verbose=False, **solve_kw)


def test_fixed_point_is_the_single_device_one(ranks):
    """Block-Jacobi (slab) and Gauss-Seidel (one device) share the fixed
    point; the state views of the sharded layout."""
    got = ranks["fixed_point"]
    ref = _single_device(CASES["fixed_point"], tol=1e-12, max_iter=2000,
                         check_every=10)
    Tc_ref = ref.Tc.numpy()
    assert np.abs(got["Tc"] - Tc_ref).max() <= 1e-9 * np.abs(Tc_ref).max()
    assert got["u_dirs"].shape == (8, 4, 96, 8)
    assert np.isfinite(got["u_dirs"]).all()
    assert got["Qv"].sum(axis=1)[2] < 0  # heat flows down from the hot top


def test_reflective_fixed_point(ranks):
    """Diffuse walls: the slab's BiCGStab fixed point equals the single
    device's."""
    got = ranks["reflective_fixed_point"]
    ref = _single_device(CASES["reflective_fixed_point"], tol=1e-11,
                         max_iter=2000, check_every=20,
                         accelerate="bicgstab")
    Tc_ref = ref.Tc.numpy()
    assert np.abs(got["Tc"] - Tc_ref).max() <= 1e-8 * np.abs(Tc_ref).max()


def test_bicgstab_matches_plain(ranks):
    """BiCGStab over the sharded state (the grid's inner product) reaches
    the plain loop's fixed point (solved to 1e-12) in fewer step
    applications."""
    plain, acc = ranks["fixed_point"], ranks["bicgstab_1e10"]
    assert acc["iterations"] * 2 < plain["iterations"], (
        acc["iterations"], plain["iterations"])
    assert np.abs(acc["Tc"] - plain["Tc"]).max() <= (
        1e-7 * np.abs(plain["Tc"]).max())


def test_checkpoint_round_trip(ranks):
    """3 steps, the port's checkpoint, its load and 3 more equal 6
    straight; so do 3 more from pbte_tpu's checkpoint."""
    got = ranks["checkpoint"]
    assert got["it"] == got["jit"] == 3
    _close(got["resumed"], got["full"], 1e-12)
    _close(got["from_jax"], got["full"], 1e-12)


def test_checkpoint_loads_in_pbte_tpu(ranks):
    """pbte_tpu's slab solver resumes from the port's checkpoint file and
    reaches its own 6-step state."""
    js = _jax_slab("checkpoint")
    state, it, _ = jload(ranks["checkpoint"]["path"], js)
    assert it == 3
    resumed = js.solve(tol=0, max_iter=3, verbose=False, state=state)
    full = js.solve(tol=0, max_iter=6, verbose=False)
    _close(resumed.Tc_global(), full.Tc_global(), 1e-12)
    _close(ranks["checkpoint"]["full"], full.Tc_global(), 1e-12)


def test_steps_from_pbte_tpus_state(ranks):
    """pbte_tpu's global slab state after 3 steps becomes the ranks'
    shards (convert.sharded_state_from_numpy, and back bit for bit); 2
    more steps there equal pbte_tpu's 5: the whole state, u (its padded
    slots included), Tc and Tv."""
    got = ranks["from_jax_state"]
    assert got["roundtrip"]
    r = _jax_slab("from_jax_state").solve(tol=0, max_iter=5, verbose=False)
    # the plain loop hands back Tv of its last step (its Tc)
    for key, want in (("u", r.u), ("Tc_sh", r.Tc), ("Tv_sh", r.Tv)):
        _close(got[key], np.asarray(want), 1e-12)


@pytest.mark.parametrize("walls", ["isothermal", "reflective"])
def test_hull_windows_change_nothing(monkeypatch, walls):
    """One rank (a 1 x 1 grid, in this process): the slab's sweeps on the
    hull windows of its tables (forced on) and on the full slab (forced
    off) give the same iterates bit for bit, closure sources included."""
    from pbte_tpu_torch.parallel.comm import Grid
    from pbte_tpu_torch.parallel.slab import SlabLatticeSolver
    from pbte_tpu_torch.solver import source_iteration as si

    case = CASES["oracle_3d" if walls == "isothermal" else "reflective"]
    _, ops, quad, tables = tpc.build_problem(case["problem"])
    out = []
    for share in (2.0, 0.0):
        monkeypatch.setattr(si, "WINDOW_MAX_SHARE", share)
        s = SlabLatticeSolver(ops, quad, tables, case["bcs"],
                              Grid(dir=1, space=1), dtype=torch.float64,
                              device="cpu", **case.get("kw", {}))
        assert (s.win is not None) == (share > 1)
        out.append(s.solve(tol=0, max_iter=3, verbose=False).Tc.numpy())
    np.testing.assert_array_equal(out[0], out[1])


def test_wall_without_faces_is_inert(ranks):
    """A diffuse attribute no boundary face carries turns the closure off,
    as in pbte_tpu."""
    js = JSlab(*_jax_problem(HEX), BCS3, device_mesh=_mesh2x4(),
               dtype=jnp.float64, diffuse_bcs=[99])
    assert not js._dif_on
    r = js.solve(tol=0, max_iter=3, verbose=False)
    _close(ranks["inert_wall"]["Tc"], r.Tc_global(), 1e-12)
