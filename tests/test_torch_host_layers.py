"""pbte_tpu_torch's own copy of the numpy host layers against pbte_tpu's.

Each layer is built through pbte_tpu and through the port from the same
parameters, and the arrays must be equal bit for bit: the port copies the
same float64 operations in the same order (pbte_tpu's native C++
levelization, where built, gives the same integer levels as the port's
numpy fixpoint). Cases: 8^3 and 9x8x8 hex lattices (9x8x8 makes x the
major axis), p = 1 and 2, azimuth 4 and 8 (one or two Km buckets), x faces
periodic or not.
"""

import functools

import numpy as np
import pytest

from pbte_tpu import mesh as jmesh
from pbte_tpu.angular import quadrature as jang
from pbte_tpu.fem import assembly as jasm
from pbte_tpu.material import nongray_smrt as jmat
from pbte_tpu.models import macroscopic as jmac
from pbte_tpu.solver.source_iteration import _lattice_ring_tables
from pbte_tpu.sweep import planner as jplan
from pbte_tpu.validation.oracle import mirror_direction_map
from pbte_tpu_torch import mesh as tmesh
from pbte_tpu_torch.angular import quadrature as tang
from pbte_tpu_torch.fem import assembly as tasm
from pbte_tpu_torch.material import nongray_smrt as tmat
from pbte_tpu_torch.models import macroscopic as tmac
from pbte_tpu_torch.solver import lattice_tables as tlt
from pbte_tpu_torch.sweep import planner as tplan

# (nx, ny, nz, order, azimuth, periodic axes)
CASES = {
    "8x8x8_p2_az4": (8, 8, 8, 2, 4, ()),
    "9x8x8_p1_az8": (9, 8, 8, 1, 8, ()),
    "8x8x8_p1_az4_periodic_x": (8, 8, 8, 1, 4, (0,)),
    "9x8x8_p2_az8_periodic_x": (9, 8, 8, 2, 8, (0,)),
}
TOPO_KEYS = ("face_verts", "face_elems", "face_attr", "elem_face",
             "elem_neighbor", "elem_face_attr", "normals", "centroids",
             "elem_face_periodic", "periodic_offset")
OPS_KEYS = ("basis_int", "mass", "stiff", "face_mass", "face_int",
            "coupling", "normals", "neighbor", "face_attr", "periodic")
QUAD_KEYS = ("polar", "azimuth", "weights", "directions", "polar_nodes",
             "polar_weights", "azimuth_nodes", "azimuth_weights")
TABLE_KEYS = ("k", "omega", "dw", "vg", "inv_kn", "density", "heat_cap")


@functools.lru_cache(maxsize=None)
def _topos(case):
    nx, ny, nz, _, _, periodic = CASES[case]
    out = []
    for m in (jmesh, tmesh):
        mesh = m.make_cartesian_3d(nx, ny, nz, "hex").scaled(1.0e-6)
        if periodic:
            mesh = m.make_periodic(mesh, list(periodic))
        out.append(m.connect(mesh))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _ops(case):
    order = CASES[case][3]
    tj, tt = _topos(case)
    return (jasm.assemble(tj, order=order, face_mode="consistent"),
            tasm.assemble(tt, order=order))


def _canonical(asm, ops):
    """The solver's canonical face order (ne >= 512) and classes."""
    ops_c = asm.permute_faces(ops, asm.canonical_face_perm(ops))
    return ops_c, asm.element_classes(ops_c)


def _quads(azimuth, polar=2):
    return tuple(m.build(m.AngularOptions(dimension=3, polar_points=polar,
                                          azimuth_points=azimuth))
                 for m in (jang, tang))


@functools.lru_cache(maxsize=None)
def _plans(case):
    (oj, _), (ot, _) = (_canonical(jasm, _ops(case)[0]),
                        _canonical(tasm, _ops(case)[1]))
    qj, qt = _quads(CASES[case][4])
    return (jplan.build_plan(oj.sweep_neighbor, oj.normals, qj.directions),
            tplan.build_plan(ot.sweep_neighbor, ot.normals, qt.directions),
            oj, ot, qj, qt)


def _equal_fields(a, b, keys):
    for key in keys:
        np.testing.assert_array_equal(getattr(b, key), getattr(a, key),
                                      err_msg=key)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_topology(case):
    tj, tt = _topos(case)
    _equal_fields(tj, tt, TOPO_KEYS)
    np.testing.assert_array_equal(tt.mesh.vertices, tj.mesh.vertices)
    np.testing.assert_array_equal(tt.mesh.bdry_verts, tj.mesh.bdry_verts)
    assert tt.elem_face_periodic.any() == bool(CASES[case][5])


@pytest.mark.parametrize("case", list(CASES))
def test_element_ops(case):
    oj, ot = _ops(case)
    _equal_fields(oj, ot, OPS_KEYS)
    np.testing.assert_array_equal(ot.sweep_neighbor, oj.sweep_neighbor)
    np.testing.assert_array_equal(ot.face_valid, oj.face_valid)


@pytest.mark.parametrize("case", list(CASES))
def test_classes_and_face_order(case):
    """canonical_face_perm, permute_faces, element_classes (fine and merged)
    and class_coupling, on the raw and the canonical face order."""
    oj, ot = _ops(case)
    np.testing.assert_array_equal(tasm.canonical_face_perm(ot),
                                  jasm.canonical_face_perm(oj))
    for merge in (False, True):
        np.testing.assert_array_equal(
            tasm.element_classes(ot, merge=merge),
            jasm.element_classes(oj, merge=merge))
    (cj_ops, cj), (ct_ops, ct) = _canonical(jasm, oj), _canonical(tasm, ot)
    _equal_fields(cj_ops, ct_ops, OPS_KEYS)
    np.testing.assert_array_equal(ct, cj)
    assert int(ct.max()) == 0  # translation-invariant: one class
    np.testing.assert_array_equal(tasm.class_coupling(ct_ops, ct),
                                  jasm.class_coupling(cj_ops, cj))


@pytest.mark.parametrize("polar,azimuth,scheme", [
    (2, 4, "gauss"), (2, 8, "gauss"), (4, 16, "gauss"), (3, 8, "uniform"),
])
def test_angular_quadrature(polar, azimuth, scheme):
    opts = dict(dimension=3, polar_points=polar, azimuth_points=azimuth,
                polar_scheme=scheme, azimuth_scheme=scheme)
    qj = jang.build(jang.AngularOptions(**opts))
    qt = tang.build(tang.AngularOptions(**opts))
    _equal_fields(qj, qt, QUAD_KEYS)
    assert (qt.num_directions, qt.total_weight) == (
        qj.num_directions, qj.total_weight)


@pytest.mark.parametrize("nspec", [2, 20])
def test_phonon_tables(nspec):
    tj = jmat.build_tables(jmat.SILICON, num_spectral=nspec)
    tt = tmat.build_tables(tmat.SILICON, num_spectral=nspec)
    _equal_fields(tj, tt, TABLE_KEYS)
    for key in ("heat_cap_v", "k_max", "ref_temp", "ref_len"):
        assert getattr(tt, key) == getattr(tj, key), key
    for key in TABLE_KEYS:
        np.testing.assert_array_equal(tt.flat(key), tj.flat(key))


@pytest.mark.parametrize("case", list(CASES))
def test_sweep_plan(case):
    pj, pt, *_ = _plans(case)
    for key in ("group_of_dir", "levels", "n_levels", "level_of_elem"):
        np.testing.assert_array_equal(getattr(pt, key), getattr(pj, key),
                                      err_msg=key)
    assert len(pt.dirs_of_group) == len(pj.dirs_of_group)
    for a, b in zip(pt.dirs_of_group, pj.dirs_of_group):
        np.testing.assert_array_equal(a, b)
    dirs_pad = np.full((pt.num_groups, 4), -1)
    for g, d in enumerate(pt.dirs_of_group):
        dirs_pad[g, :len(d)] = d[:4]
    for a, b in zip(tplan.dir_slot_maps(dirs_pad),
                    jplan.dir_slot_maps(dirs_pad)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_lattice_detection(case):
    _, _, oj, ot, _, _ = _plans(case)
    lj = jplan.detect_lattice(oj.sweep_neighbor, oj.normals)
    lt = tplan.detect_lattice(ot.sweep_neighbor, ot.normals)
    assert lj is not None and lt is not None
    assert lt.dims == lj.dims == tuple(CASES[case][:3])
    for key in ("coords", "face_minus", "face_plus"):
        np.testing.assert_array_equal(getattr(lt, key), getattr(lj, key))
    # the raw (not canonical) face order is no lattice for either
    rj, rt = _ops(case)
    assert (tplan.detect_lattice(rt.sweep_neighbor, rt.normals) is None) == (
        jplan.detect_lattice(rj.sweep_neighbor, rj.normals) is None)


@pytest.mark.parametrize("case", list(CASES))
def test_lattice_ring_tables(case):
    pj, pt, oj, ot, qj, qt = _plans(case)
    lj = jplan.detect_lattice(oj.sweep_neighbor, oj.normals)
    lt = tplan.detect_lattice(ot.sweep_neighbor, ot.normals)
    want = _lattice_ring_tables(lj, pj, qj.directions[:, :3])
    got = tlt.lattice_ring_tables(lt, pt, qt.directions[:, :3])
    assert want is not None and got is not None
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_ring_windows(case):
    """The per-level hull windows against win_lo / win_hi recomputed from
    pbte_tpu's lattice tables as its constructor does
    (pbte_tpu/solver/source_iteration.py:799-804; its win_hi is the last
    valid slot, the port's hi one past it)."""
    pj, pt, oj, ot, qj, qt = _plans(case)
    lj = jplan.detect_lattice(oj.sweep_neighbor, oj.normals)
    lt = tplan.detect_lattice(ot.sweep_neighbor, ot.normals)
    lat_tables = _lattice_ring_tables(lj, pj, qj.directions[:, :3])[0]
    vm = (lat_tables >= 0).any(axis=0)
    win_lo = np.argmax(vm, axis=1)
    win_hi = vm.shape[1] - 1 - np.argmax(vm[:, ::-1], axis=1)
    win = tlt.ring_windows(
        tlt.lattice_ring_tables(lt, pt, qt.directions[:, :3])[0])
    assert win.dtype == np.int32 and win.shape == (vm.shape[0], 2)
    np.testing.assert_array_equal(win[:, 0], win_lo)
    np.testing.assert_array_equal(win[:, 1] - 1, win_hi)
    # every valid slot lies in its level's window, in every group
    inside = ((np.arange(vm.shape[1]) >= win[:, :1])
              & (np.arange(vm.shape[1]) < win[:, 1:]))
    assert not ((lat_tables >= 0) & ~inside).any()
    assert tlt.window_slots(win) == int((win_hi - win_lo + 1).sum())
    assert tlt.window_slots(win, 16) % 16 == 0
    assert tlt.window_slots(win) <= tlt.window_slots(win, 16) <= vm.size


def test_ring_windows_of_an_empty_level():
    tables = np.full((2, 3, 8), -1)
    tables[0, 0, 2:5] = 0
    tables[1, 0, 4:7] = 0
    tables[1, 2, 7] = 0
    np.testing.assert_array_equal(tlt.ring_windows(tables),
                                  [[2, 7], [0, 0], [7, 8]])
    assert tlt.window_slots([[2, 7], [0, 0], [7, 8]]) == 6
    assert tlt.window_slots([[2, 7], [0, 0], [7, 8]], 4) == 12


def test_lattice_ring_tables_refuse_grazing_directions():
    """A one-polar-point rule lies in the xy plane: both refuse it."""
    _, _, oj, ot, _, _ = _plans("8x8x8_p2_az4")
    qj, qt = _quads(4, polar=1)
    pj = jplan.build_plan(oj.sweep_neighbor, oj.normals, qj.directions)
    pt = tplan.build_plan(ot.sweep_neighbor, ot.normals, qt.directions)
    lj = jplan.detect_lattice(oj.sweep_neighbor, oj.normals)
    lt = tplan.detect_lattice(ot.sweep_neighbor, ot.normals)
    assert _lattice_ring_tables(lj, pj, qj.directions) is None
    assert tlt.lattice_ring_tables(lt, pt, qt.directions) is None


@pytest.mark.parametrize("azimuth,scheme,axes", [
    (4, "gauss", (1, 2)), (8, "gauss", None), (8, "uniform", (0, 1, 2)),
])
def test_mirror_direction_map(azimuth, scheme, axes):
    """Equal maps where pbte_tpu builds one, and the same refusal where it
    raises (the Gauss azimuth rule is not symmetric about x)."""
    opts = dict(dimension=3, polar_points=2, azimuth_points=azimuth,
                azimuth_scheme=scheme)
    qj = jang.build(jang.AngularOptions(**opts))
    qt = tang.build(tang.AngularOptions(**opts))
    try:
        want = mirror_direction_map(qj, 3, axes=axes)
    except ValueError as e:
        with pytest.raises(ValueError, match="mirror-symmetric"):
            tlt.mirror_direction_map(qt, 3, axes=axes)
        assert "mirror-symmetric" in str(e)
        return
    np.testing.assert_array_equal(tlt.mirror_direction_map(qt, 3, axes=axes),
                                  want)


@pytest.mark.parametrize("azimuth,nspec", [(4, 2), (8, 2), (16, 20)])
def test_macro_and_flux_weights(azimuth, nspec):
    qj, qt = _quads(azimuth)
    tj = jmat.build_tables(jmat.SILICON, num_spectral=nspec)
    tt = tmat.build_tables(tmat.SILICON, num_spectral=nspec)
    np.testing.assert_array_equal(tmac.macro_weights(qt, tt),
                                  jmac.macro_weights(qj, tj))
    np.testing.assert_array_equal(tmac.flux_weights(qt, tt, 3),
                                  jmac.flux_weights(qj, tj, 3))
