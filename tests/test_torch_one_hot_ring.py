"""pbte_tpu_torch's general ring (``solver/one_hot_ring.py``) against
pbte_tpu's one-hot ring, off the box lattice, on the CPU.

The same meshes (built by each package from its own host layers), angles,
tables and walls go through pbte_tpu's ``SourceIterationSolver`` with
``sweep_mode="ring"`` (its one-hot ring wherever the mesh is not a box
lattice, or with ``use_lattice=False``) and through the port's; Tc, Tv and
the state after 3 steps from the zero state are compared:

- float64 to 1e-12 of each field's max |.|;
- float32 at pbte_tpu's own ring tolerance, ``rtol=2e-5, atol=5e-7`` of
  max (``tests/test_pallas_ring.py:57-62``), on Tc and Tv; pbte_tpu stages
  no operand in bf16 on this ring (its staging is the lattice ring's). The
  float32 state u is held in float64 only: on the tet cube with diffuse
  walls pbte_tpu's own float32 u lies 1.4e-6 of max from its float64 u
  (the port's 1.1e-6), past that tolerance's 5e-7;
- the numpy oracle in float64 at 1e-12 of max.

Cases: the 6-tet cube 8^3 (upwind level gaps H = 2) with a Dirichlet, a
diffuse and a specular wall (the uniform azimuth rule at 8 points, which
is mirror-symmetric about both x and y; its 4-point rule runs along the
cubes' diagonals, in the tets' faces, and pbte_tpu refuses that mesh a
forced ring: gaps of 31 levels), the default config's triangles refined 6 times with
the 8-direction 2D rule (consistent faces: the config's mfem-parity faces
make the refined iteration diverge in both packages), hex 4^3 periodic in
x and hex 8^3 under ``use_lattice=False`` (the latter also against the
port's lattice ring), and the tet cube with one face coupling perturbed,
which the coupling classes do not determine (the per-element form).

Also: the integer (level, slot) tables against pbte_tpu's one-hot
(``ops/ring_plan.py::build_group_plan``) entry for entry, pbte_tpu's
one-hot consts and state carried across (``convert``) with one step equal,
BiCGStab, and a checkpoint round trip on this ring.
"""

import dataclasses
import functools
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pbte_tpu import mesh as jmesh
from pbte_tpu.angular import quadrature as jang
from pbte_tpu.fem import assembly as jasm
from pbte_tpu.material import nongray_smrt as jmat
from pbte_tpu.ops import ring_plan as jring_plan
from pbte_tpu.solver.source_iteration import SourceIterationSolver as JaxSolver
from pbte_tpu_torch import mesh as tmesh
from pbte_tpu_torch.angular import quadrature as tang
from pbte_tpu_torch.convert import consts_from_numpy, state_from_numpy
from pbte_tpu_torch.fem import assembly as tasm
from pbte_tpu_torch.io.checkpoint import load_checkpoint
from pbte_tpu_torch.material import nongray_smrt as tmat
from pbte_tpu_torch.ops import ring_plan
from pbte_tpu_torch.solver import one_hot_ring
from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver
from pbte_tpu_torch.validation.oracle import solve_oracle

MESH_DIR = pathlib.Path(__file__).resolve().parents[1] / "config" / "mesh"
PKG = {"jax": (jmesh, jasm, jang, jmat), "torch": (tmesh, tasm, tang, tmat)}
STEPS = 3
F32_RTOL, F32_ATOL = 2e-5, 5e-7
WALLS3 = {1: -0.5, 2: -0.5, 3: -0.5, 4: -0.5, 5: -0.5, 6: 0.5}


@pytest.fixture(autouse=True)
def _cpu_float_env():
    """One thread, and f32 subnormals flushed as XLA's CPU backend flushes
    them (tests/test_torch_solver.py says why)."""
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _mesh(pkg, name):
    m = PKG[pkg][0]
    if name.startswith("tet"):
        n = int(name[3:])
        return m.make_cartesian_3d(n, n, n, m.GEOM_TET).scaled(1e-6)
    if name.startswith("square_r"):
        md = m.load_mesh(str(MESH_DIR / "unit-square-iso.mesh"))
        return m.uniform_refine(md.scaled(1e-6), int(name[8:]))
    if name == "hex4_periodic_x":
        return m.make_periodic(m.make_cartesian_3d(4, 4, 4, m.GEOM_HEX),
                               [0]).scaled(1e-6)
    n = int(name[3:])  # hexN
    return m.make_cartesian_3d(n, n, n, m.GEOM_HEX).scaled(1e-6)


@functools.lru_cache(maxsize=None)
def _problem(pkg, name, azimuth_scheme="gauss", nspec=1):
    """(ops, quad, tables) of one package: consistent faces, p = 1; 3D
    meshes 2 polar x 4 gauss azimuth points (8 with the uniform rule), 2D
    the 8-direction rule."""
    m, asm, ang, mat = PKG[pkg]
    md = _mesh(pkg, name)
    ops = asm.assemble(m.connect(md), order=1, face_mode="consistent")
    opts = (dict(dimension=2, polar_points=1, azimuth_points=8)
            if md.dim == 2 else
            dict(dimension=3, polar_points=2,
                 azimuth_points=4 if azimuth_scheme == "gauss" else 8,
                 azimuth_scheme=azimuth_scheme))
    quad = ang.build(ang.AngularOptions(**opts))
    return ops, quad, mat.build_tables(mat.SILICON, num_spectral=nspec)


def _perturbed(prob):
    """The problem with one interior face coupling scaled by 1.5 (the same
    element and face in both packages): its couplings are no longer
    determined by the (face, class, neighbour class) triples."""
    ops = prob[0]
    e = int(np.flatnonzero(ops.neighbor[:, 0] >= 0)[5])
    bad = ops.coupling.copy()
    bad[e, 0] *= 1.5
    return (dataclasses.replace(ops, coupling=bad),) + tuple(prob[1:])


# name: (mesh, azimuth scheme, walls, solver keywords)
CASES = {
    "tet8_dirichlet": ("tet8", "gauss",
                       {a: t for a, t in WALLS3.items() if a != 6},
                       dict(dirichlet_bcs={6: 0.1})),
    "tet8_diffuse": ("tet8", "gauss",
                     {a: t for a, t in WALLS3.items() if a not in (2, 4)},
                     dict(diffuse_bcs=[2, 4])),
    "tet8_specular": ("tet8", "uniform",
                      {a: t for a, t in WALLS3.items() if a not in (3, 5)},
                      dict(specular_bcs=[3, 5])),
    "square_r6": ("square_r6", "gauss", {1: -0.5, 2: 0.5}, {}),
    "hex4_periodic_x_no_lattice": ("hex4_periodic_x", "gauss",
                                   {1: -0.5, 2: -0.5, 4: -0.5, 6: 0.5},
                                   dict(use_lattice=False)),
    "hex8_no_lattice": ("hex8", "gauss", WALLS3, dict(use_lattice=False)),
    "tet8_per_element": ("tet8", "gauss", WALLS3, {}),
}


def _build(name, pkg):
    mesh, scheme, _, _ = CASES[name]
    prob = _problem(pkg, mesh, scheme)
    return _perturbed(prob) if name.endswith("per_element") else prob


def _solvers(name, f64):
    mesh, _, bcs, kw = CASES[name]
    js = JaxSolver(*_build(name, "jax"), bcs,
                   dtype=jnp.float64 if f64 else jnp.float32,
                   sweep_mode="ring", **kw)
    ts = SourceIterationSolver(*_build(name, "torch"), bcs,
                               dtype=torch.float64 if f64 else torch.float32,
                               device="cpu", sweep_mode="ring", **kw)
    assert js.sweep_mode == ts.sweep_mode == "ring"
    assert not js._ring_lattice and js._super is None
    assert ts._general and ts._super is None
    return js, ts


def _close(got, want, f64):
    scale = np.abs(want).max()
    assert scale > 0
    if f64:
        assert np.abs(got - want).max() <= 1e-12 * scale
    else:
        np.testing.assert_allclose(got / scale, want / scale, rtol=F32_RTOL,
                                   atol=F32_ATOL)


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(CASES))
def test_ring_matches_pbte_tpu(name, f64):
    """Tc, Tv and u after 3 steps from the zero state against pbte_tpu's
    one-hot ring."""
    js, ts = _solvers(name, f64)
    if name.endswith("per_element"):
        assert "cpl_slab" in ts.consts["buckets"][0]
    elif name.startswith("tet"):
        assert "cpl_cls" in ts.consts["buckets"][0]
    rj = js.solve(tol=0, max_iter=STEPS, verbose=False)
    rt = ts.solve(tol=0, max_iter=STEPS, verbose=False)
    _close(rt.Tc.numpy(), np.asarray(rj.Tc), f64)
    _close(rt.Tv.numpy(), np.asarray(rj.Tv), f64)
    if f64:  # f32 u: see the module docstring
        _close(rt.u_dirs(), js.u_by_direction(rj.u), f64)


@pytest.mark.parametrize("name", ["tet8_dirichlet", "tet8_diffuse",
                                  "tet8_specular", "hex4_periodic_x_no_lattice",
                                  "tet8_per_element"])
def test_ring_matches_oracle(name):
    """The port's f64 ring against the numpy oracle, 2 steps (the lagged
    closures act from the second; the sequential oracle is the slow side)."""
    mesh, _, bcs, kw = CASES[name]
    prob = _build(name, "torch")
    ts = SourceIterationSolver(*prob, bcs, dtype=torch.float64, device="cpu",
                               sweep_mode="ring", **kw)
    assert ts._general
    rt = ts.solve(tol=0, max_iter=2, verbose=False)
    u, Tc, Tv, *_ = solve_oracle(
        *prob, bcs, tol=0, max_iter=2, dirichlet=kw.get("dirichlet_bcs"),
        diffuse=kw.get("diffuse_bcs"), specular=kw.get("specular_bcs"))
    _close(rt.Tc.numpy(), Tc, True)
    _close(rt.u_dirs(), u, True)


def test_general_ring_matches_lattice_ring():
    """hex 8^3 on the general ring (use_lattice=False) and on the lattice
    ring (K1's plain version on the CPU): the same fixed-point map, f64 to
    1e-12 of max."""
    _, _, bcs, _ = CASES["hex8_no_lattice"]
    prob = _build("hex8_no_lattice", "torch")
    gen = SourceIterationSolver(*prob, bcs, dtype=torch.float64, device="cpu",
                                sweep_mode="ring", use_lattice=False)
    lat = SourceIterationSolver(*prob, bcs, dtype=torch.float64, device="cpu")
    assert gen._general and not lat._general and lat.sweep_mode == "ring"
    rg = gen.solve(tol=0, max_iter=STEPS, verbose=False)
    rl = lat.solve(tol=0, max_iter=STEPS, verbose=False)
    _close(rg.Tc.numpy(), rl.Tc.numpy(), True)
    _close(rg.u_dirs(), rl.u_dirs(), True)


@pytest.mark.parametrize("name", ["tet8", "square_r5"])
def test_slot_tables_match_one_hot(name):
    """pbte_tpu's one-hot ring on each mesh: per group and active face, its
    ``build_group_plan`` one-hot (the port's copy gives the same) read back
    as (level, slot) tables (``ring_plan.slots_from_onehot``, entry for
    entry) equals the port's ``ring_plan.upwind_slots``, and so does the
    per-level one-hot it uploaded; the tet cube reads neighbours two
    levels back (H = 2)."""
    prob = _problem("jax", name)
    bcs = WALLS3 if name.startswith("tet") else {1: -0.5, 2: 0.5}
    js = JaxSolver(*prob, bcs, dtype=jnp.float64, sweep_mode="ring",
                   supercell="off")
    assert js.sweep_mode == "ring" and not js._ring_lattice
    H, L, W = js._ring_H, js.L, js.W
    assert H == (2 if name.startswith("tet") else 1)
    nbr_pos = np.asarray(js.consts["nbr_pos"])
    uploaded = {}
    for (gs, _), cb in zip(js._ring_buckets, js.consts["ring_b"]):
        oh = np.asarray(cb["oh"])  # (L, Gb, nf_act, H W, W)
        uploaded.update({int(g): oh[:, i] for i, g in enumerate(gs)})
    n_reads = 0
    for g in range(js.G):
        act = js._ring_act_f[g][js._ring_act_valid[g]]
        want = jring_plan.build_group_plan(nbr_pos[g], js._pos_valid[g], L, W,
                                           H).onehot[act]  # (nf, H W, L, W)
        np.testing.assert_array_equal(ring_plan.build_group_plan(
            nbr_pos[g], js._pos_valid[g], L, W, H).onehot[act], want)
        lev, slot, use = ring_plan.upwind_slots(nbr_pos[g][act],
                                                js._pos_valid[g], L, W)
        for oh in (want.transpose(2, 0, 1, 3), uploaded[g][:, :len(act)]):
            got = ring_plan.slots_from_onehot(oh, W)
            for a, b in zip(got, (lev, slot, use)):
                np.testing.assert_array_equal(a, b)
        n_reads += int(use.sum())
        if H > 1:
            gap = np.arange(L)[None, :, None] - lev
            assert gap[use].max() == H
    assert n_reads > 0


def test_consts_and_state_carry_across():
    """pbte_tpu's one-hot consts (class coupling on hex 8^3 without the
    lattice; per-element couplings on the tet cube) and its state, mapped
    to numpy: the port steps from them to pbte_tpu's next step (f64, 1e-12
    of max), and the carried tables equal the port's own."""
    for name in ("hex8_no_lattice", "tet8_diffuse"):
        js, ts = _solvers(name, True)
        own = ts.consts
        ts.consts = consts_from_numpy(jax.tree.map(np.asarray, js.consts),
                                      device="cpu")
        for cb, ob in zip(ts.consts["buckets"], own["buckets"]):
            for key in ("nb_lev", "nb_slot"):
                assert torch.equal(cb[key], ob[key]), (name, key)
            np.testing.assert_allclose(cb["nb_cin"].numpy(),
                                       ob["nb_cin"].numpy(), rtol=1e-14,
                                       atol=1e-300)
        assert ("cpl_cls" in ts.consts["buckets"][0]) == js._ring_ccpl
        u, Tc, Tv = js.initial_state()
        for _ in range(2):
            u, Tc, Tv, _ = js.step(u, Tc, Tv)
        ut, Tct, Tvt = state_from_numpy(u, Tc, Tv, device="cpu",
                                        layout="dbs")
        u, Tc, Tv, r = js.step(u, Tc, Tv)
        ut, Tct, Tvt, rt = ts.step(ut, Tct, Tvt)
        _close(Tct.numpy(), np.asarray(Tc), True)
        _close(ts.u_by_direction(ut), js.u_by_direction(u), True)
        assert abs(float(rt) - float(r)) <= 1e-12 * abs(float(r))


def test_bicgstab_on_the_general_ring():
    """solve(accelerate="bicgstab") on the tet cube's general ring against
    pbte_tpu's on its one-hot ring, f64, 12 step applications (below the
    plateau where summation order grows, ~19 on the flagship lattice)."""
    js, ts = _solvers("tet8_dirichlet", True)
    rj = js.solve(tol=0, max_iter=12, verbose=False, accelerate="bicgstab")
    rt = ts.solve(tol=0, max_iter=12, verbose=False, accelerate="bicgstab")
    assert rt.iterations == rj.iterations
    Tc = np.asarray(rj.Tc)
    assert np.abs(rt.Tc.numpy() - Tc).max() <= 1e-10 * np.abs(Tc).max()


def test_checkpoint_round_trip(tmp_path):
    """3 steps checkpointed and 2 resumed equal 5 straight steps; the file
    holds the general ring's per-bucket slabs."""
    _, _, bcs, kw = CASES["tet8_diffuse"]
    ts = SourceIterationSolver(*_build("tet8_diffuse", "torch"), bcs,
                               dtype=torch.float64, device="cpu", **kw)
    assert ts._general
    path = str(tmp_path / "ck.npz")
    ts.solve(tol=0, max_iter=3, verbose=False, checkpoint_path=path,
             checkpoint_every=3)
    state, it, _ = load_checkpoint(path, ts)
    assert it == 3
    assert [tuple(b.shape) for b in state[0]] == [
        (ts.L, len(gs), km, ts.BS, ts.D, ts.W) for gs, km in ts._ring_buckets]
    resumed = ts.solve(tol=0, max_iter=2, state=state, verbose=False)
    straight = ts.solve(tol=0, max_iter=5, verbose=False)
    _close(resumed.Tc.numpy(), straight.Tc.numpy(), True)


def test_bf16_state_is_the_lattice_rings(monkeypatch):
    """PBTE_RING_STATE_BF16=1 leaves the general ring in float32 state, as
    pbte_tpu's one-hot ring (its bf16 state is the lattice ring's)."""
    monkeypatch.setenv("PBTE_RING_STATE_BF16", "1")
    _, _, bcs, kw = CASES["tet8_dirichlet"]
    ts = SourceIterationSolver(*_build("tet8_dirichlet", "torch"), bcs,
                               device="cpu", **kw)
    assert ts._general and not ts.state_bf16
    assert ts.initial_state()[0][0].dtype == torch.float32


def test_working_set_budget_sends_auto_to_the_scan(monkeypatch):
    """Past one_hot_ring.GENERAL_BUDGET ``auto`` scans the mesh it would
    ring; ``sweep_mode="ring"`` rings regardless."""
    _, _, bcs, kw = CASES["tet8_dirichlet"]
    prob = _build("tet8_dirichlet", "torch")
    assert SourceIterationSolver(*prob, bcs, device="cpu",
                                 **kw).sweep_mode == "ring"
    monkeypatch.setattr(one_hot_ring, "GENERAL_BUDGET", 0)
    assert SourceIterationSolver(*prob, bcs, device="cpu",
                                 **kw).sweep_mode == "scan"
    ts = SourceIterationSolver(*prob, bcs, device="cpu", sweep_mode="ring",
                               **kw)
    assert ts.sweep_mode == "ring" and ts._general
