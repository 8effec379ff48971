"""pbte_tpu_torch's own copy of the numpy host layers against pbte_tpu's.

Each layer is built through pbte_tpu and through the port from the same
parameters, and the arrays must be equal bit for bit: the port copies the
same float64 operations in the same order (pbte_tpu's native C++
levelization, where built, gives the same integer levels as the port's
numpy fixpoint). Cases: 8^3 and 9x8x8 hex lattices (9x8x8 makes x the
major axis), p = 1 and 2, azimuth 4 and 8 (one or two Km buckets), x faces
periodic or not; and, for the scan path, the tri, quad, tet and mixed
builders, the gmsh and MFEM readers on config/mesh/*, every quadrature
rule and reference element, assembly in both face modes, the geometry
classes of simplex meshes, supercell detection and merge, and the level
segments; the supercell block factor (torch) against pbte_tpu's numpy one
at 1e-12 of max.
"""

import functools
import pathlib

import numpy as np
import pytest

from pbte_tpu import mesh as jmesh
from pbte_tpu.angular import quadrature as jang
from pbte_tpu.fem import assembly as jasm
from pbte_tpu.fem import quadrature as jquad
from pbte_tpu.fem import reference as jref
from pbte_tpu.fem import supercell as jsc
from pbte_tpu.material import nongray_smrt as jmat
from pbte_tpu.models import macroscopic as jmac
from pbte_tpu.solver.source_iteration import (
    _lattice_ring_tables,
    _pick_level_segments,
)
from pbte_tpu.sweep import planner as jplan
from pbte_tpu.validation.oracle import mirror_direction_map
from pbte_tpu_torch import mesh as tmesh
from pbte_tpu_torch.angular import quadrature as tang
from pbte_tpu_torch.fem import assembly as tasm
from pbte_tpu_torch.fem import quadrature as tquad
from pbte_tpu_torch.fem import reference as tref
from pbte_tpu_torch.fem import supercell as tsc
from pbte_tpu_torch.solver.scan import pick_level_segments
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
            tasm.assemble(tt, order=order, face_mode="consistent"))


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


@pytest.mark.parametrize("major_axis", [0, 1, 2])
def test_lattice_ring_tables_major_axis(major_axis):
    """The slab solver's major axis on a non-cubic box, every axis."""
    pj, pt, oj, ot, qj, qt = _plans("9x8x8_p1_az8")
    lj = jplan.detect_lattice(oj.sweep_neighbor, oj.normals)
    lt = tplan.detect_lattice(ot.sweep_neighbor, ot.normals)
    want = _lattice_ring_tables(lj, pj, qj.directions[:, :3],
                                major_axis=major_axis)
    got = tlt.lattice_ring_tables(lt, pt, qt.directions[:, :3],
                                  major_axis=major_axis)
    assert want is not None and got is not None
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[2][major_axis] == 0


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


# ---- the scan path's host layers: every geometry ------------------------

MESH_DIR = pathlib.Path(__file__).resolve().parents[1] / "config" / "mesh"
# name -> builder over a mesh module
MESHES = {
    "tri_4x3": lambda m: m.make_cartesian_2d(4, 3, m.GEOM_TRIANGLE),
    "quad_3x4": lambda m: m.make_cartesian_2d(3, 4, m.GEOM_QUAD),
    "mixed_2d_4x4": lambda m: m.make_mixed_2d(4, 4),
    "tet_2x3x2": lambda m: m.make_cartesian_3d(2, 3, 2, m.GEOM_TET),
    "prism_2x2x2": lambda m: m.make_cartesian_3d(2, 2, 2, "prism"),
    "mixed_3d": lambda m: m.load_builtin("unit-cube-mixed"),
    "unit-square-mixed": lambda m: m.load_builtin("unit-square-mixed"),
    "unit-cube-tet": lambda m: m.load_builtin("unit-cube-tet"),
    **{f.name: (lambda m, f=f: m.load_mesh(str(f)))
       for f in sorted(MESH_DIR.iterdir())},
}
MESH_KEYS = ("vertices", "elem_verts", "elem_attr", "bdry_verts",
             "bdry_attr", "elem_geom")


@functools.lru_cache(maxsize=None)
def _geo_topos(name):
    return tuple(tmod.connect(MESHES[name](tmod).scaled(1.0e-6))
                 for tmod in (jmesh, tmesh))


@functools.lru_cache(maxsize=None)
def _geo_ops(name, order, face_mode):
    tj, tt = _geo_topos(name)
    return (jasm.assemble(tj, order=order, face_mode=face_mode),
            tasm.assemble(tt, order=order, face_mode=face_mode))


@pytest.mark.parametrize("name", list(MESHES))
def test_builders_and_readers(name):
    """Builtins and the gmsh / MFEM readers: the same MeshData and the same
    face tables."""
    mj, mt = MESHES[name](jmesh), MESHES[name](tmesh)
    assert (mt.dim, mt.geom) == (mj.dim, mj.geom)
    for key in MESH_KEYS:
        a, b = getattr(mj, key), getattr(mt, key)
        assert (a is None) == (b is None), key
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=key)
    tj, tt = _geo_topos(name)
    _equal_fields(tj, tt, TOPO_KEYS)


@pytest.mark.parametrize("face_mode", ["mfem-parity", "consistent"])
@pytest.mark.parametrize("name,order", [
    ("tri_4x3", 1), ("tri_4x3", 3), ("quad_3x4", 2), ("mixed_2d_4x4", 2),
    ("tet_2x3x2", 1), ("tet_2x3x2", 3), ("prism_2x2x2", 1), ("mixed_3d", 2),
    ("unit-square-iso.mesh", 1), ("unit-cube-tet-iso.mesh", 2),
    ("unit-cube-mixed.mesh", 1),
])
def test_assemble_every_geometry(name, order, face_mode):
    oj, ot = _geo_ops(name, order, face_mode)
    _equal_fields(oj, ot, OPS_KEYS + ("elem_face",))
    np.testing.assert_array_equal(ot.face_valid, oj.face_valid)
    assert (ot.geom, ot.order, ot.dim) == (oj.geom, oj.order, oj.dim)


def test_assemble_defaults_to_mfem_parity():
    """The port's default face mode is pbte_tpu's (golden parity)."""
    tj, tt = _geo_topos("tri_4x3")
    _equal_fields(jasm.assemble(tj, order=1), tasm.assemble(tt, order=1),
                  OPS_KEYS)
    with pytest.raises(ValueError, match="face_mode"):
        tasm.assemble(tt, order=1, face_mode="textbook")


@pytest.mark.parametrize("name,order,face_mode", [
    ("tri_4x3", 1, "mfem-parity"), ("quad_3x4", 1, "consistent"),
    ("tet_2x3x2", 3, "consistent"), ("mixed_3d", 1, "consistent"),
    ("cuboid_5x5x5.msh", 1, "consistent"),
    ("unit-cube-tet-iso.mesh", 1, "mfem-parity"),
])
def test_simplex_classes_and_face_order(name, order, face_mode):
    """element_classes (fine and merged), canonical_face_perm,
    permute_faces and class_coupling on simplex and mixed meshes."""
    oj, ot = _geo_ops(name, order, face_mode)
    for merge in (False, True):
        np.testing.assert_array_equal(tasm.element_classes(ot, merge=merge),
                                      jasm.element_classes(oj, merge=merge))
    np.testing.assert_array_equal(tasm.canonical_face_perm(ot),
                                  jasm.canonical_face_perm(oj))
    (cj_ops, cj), (ct_ops, ct) = _canonical(jasm, oj), _canonical(tasm, ot)
    _equal_fields(cj_ops, ct_ops, OPS_KEYS)
    np.testing.assert_array_equal(ct, cj)
    a, b = tasm.class_coupling(ct_ops, ct), jasm.class_coupling(cj_ops, cj)
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["cuboid_5x5x5.msh", "tet_2x3x2"])
def test_supercell_detection(name):
    """detect and verify_acyclic on the canonical 6-tet split (the 5^3
    cuboid merges into 125 cells; 2x3x2 merges too): the fields the
    solver's supercell gate reads."""
    (cj_ops, cj), (ct_ops, ct) = (_canonical(jasm, _geo_ops(name, 1,
                                                            "consistent")[0]),
                                  _canonical(tasm, _geo_ops(name, 1,
                                                            "consistent")[1]))
    sj, st = jsc.detect(cj_ops, cj), tsc.detect(ct_ops, ct)
    assert (sj is None) == (st is None)
    assert st is not None
    assert (st.gsz, st.ncell, st.lat_dims) == (sj.gsz, sj.ncell, sj.lat_dims)
    for key in ("int_normals", "int_dst", "int_src"):
        np.testing.assert_array_equal(getattr(st, key), getattr(sj, key),
                                      err_msg=key)
    qj, qt = _quads(8)
    assert tsc.verify_acyclic(st, qt.directions) == jsc.verify_acyclic(
        sj, qj.directions)


# the merge's fields beyond what the gate reads
SUPER_KEYS = ("gsz", "ncell", "D", "Dp", "cell_of", "cls_of", "elem_at",
              "int_normals", "int_fmass", "int_cpl", "int_dst", "int_src",
              "basis_int_cells", "lat_dims", "ne_fine")


def _supercells(name, order):
    """pbte_tpu's and the port's detected supercell of a mesh in canonical
    face order, with 2D (triangles) or 3D angles of each package."""
    (cj_ops, cj), (ct_ops, ct) = (
        _canonical(jasm, _geo_ops(name, order, "consistent")[0]),
        _canonical(tasm, _geo_ops(name, order, "consistent")[1]))
    sj, st = jsc.detect(cj_ops, cj), tsc.detect(ct_ops, ct)
    assert sj is not None and st is not None
    dim = cj_ops.dim
    qj, qt = (m.build(m.AngularOptions(
        dimension=dim, polar_points=1 if dim == 2 else 2, azimuth_points=8))
        for m in (jang, tang))
    return sj, st, qj, qt


@pytest.mark.parametrize("name,order", [
    ("tri_4x3", 1), ("tri_4x3", 2), ("tri_4x3", 3),
    ("tet_2x3x2", 1), ("tet_2x3x2", 2), ("tet_2x3x2", 3),
])
def test_supercell_merge(name, order):
    """detect's merged structure bit for bit: the SuperCell fields, the
    merged ElementOps, scatter_fine, to_fine and gmat_internal."""
    sj, st, qj, qt = _supercells(name, order)
    for key in SUPER_KEYS:
        np.testing.assert_array_equal(getattr(st, key), getattr(sj, key),
                                      err_msg=key)
    _equal_fields(sj.super_ops, st.super_ops, OPS_KEYS)
    assert (st.super_ops.geom, st.super_ops.order, st.super_ops.dim) == (
        sj.super_ops.geom, sj.super_ops.order, sj.super_ops.dim)
    np.testing.assert_array_equal(st.scatter_fine(), sj.scatter_fine())
    blocks = np.random.default_rng(order).standard_normal(
        (sj.ncell, sj.Dp, 3))
    np.testing.assert_array_equal(st.to_fine(blocks), sj.to_fine(blocks))
    np.testing.assert_array_equal(st.gmat_internal(qt.directions),
                                  sj.gmat_internal(qj.directions))


@pytest.mark.parametrize("name,order", [("tri_4x3", 1), ("tri_4x3", 2),
                                        ("tet_2x3x2", 1), ("tet_2x3x2", 2)])
def test_block_triangular_factor(name, order):
    """The port's block forward substitution (torch, float64) against
    pbte_tpu's numpy one on the super transport operator of every
    quadrature direction and 4 bands: 1e-12 of max."""
    import torch

    sj, st, qj, _ = _supercells(name, order)
    ops = sj.super_ops
    dk = qj.directions[:, :ops.dim]
    fd = np.einsum("fd,kd->kf", ops.normals[0], dk)
    G_k = (-np.einsum("kd,dij->kij", dk, ops.stiff[0])
           + np.einsum("kf,fij->kij", np.maximum(fd, 0.0), ops.face_mass[0])
           + sj.gmat_internal(dk))
    vg = np.array([0.02, 0.3, 1.0, 4.0])
    A = ops.mass[0] + vg[None, :, None, None] * G_k[:, None]
    D = sj.D
    massT = np.stack([ops.mass[0].T[c * D:(c + 1) * D, c * D:(c + 1) * D]
                      for c in range(sj.gsz)])
    want = jsc.block_triangular_factor(sj, A, dk, massT)
    got = tsc.block_triangular_factor(st, torch.from_numpy(A), dk,
                                      torch.from_numpy(massT)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    # and it is B = M^T A^-1 of the whole block operator
    full = np.einsum("ij,kbjl->kbil", ops.mass[0].T, np.linalg.inv(A))
    assert np.abs(got - full).max() <= 1e-9 * np.abs(full).max()


@pytest.mark.parametrize("degree", [1, 2, 3, 5, 7])
def test_quadrature_rules(degree):
    for rule in ("segment_rule", "triangle_rule", "quad_rule", "tet_rule",
                 "hex_rule", "prism_rule", "pyramid_rule"):
        for a, b in zip(getattr(tquad, rule)(degree),
                        getattr(jquad, rule)(degree)):
            np.testing.assert_array_equal(a, b, err_msg=rule)
    for geom in ("triangle", "quad", "tet", "hex", "prism", "pyramid"):
        for a, b in zip(tquad.volume_rule(geom, degree),
                        jquad.volume_rule(geom, degree)):
            np.testing.assert_array_equal(a, b, err_msg=geom)
    for geom in ("triangle", "quad", "tet", "hex"):
        for a, b in zip(tquad.face_rule(geom, degree),
                        jquad.face_rule(geom, degree)):
            np.testing.assert_array_equal(a, b, err_msg=geom)
    for nv in (2, 3, 4):
        for a, b in zip(tquad.face_rule_nv(nv, degree),
                        jquad.face_rule_nv(nv, degree)):
            np.testing.assert_array_equal(a, b, err_msg=str(nv))


@pytest.mark.parametrize("geom", ["triangle", "quad", "tet", "hex", "prism",
                                  "pyramid"])
def test_reference_elements(geom):
    """Nodes, exponents, the nodal basis and its gradients, and the vertex
    shapes and their gradients at seeded reference points."""
    dim = 2 if geom in ("triangle", "quad") else 3
    pts = np.random.default_rng(3).uniform(0.05, 0.3, (7, dim))
    for p in (0, 1, 2, 3):
        np.testing.assert_array_equal(tref.nodes(geom, p),
                                      jref.nodes(geom, p))
        np.testing.assert_array_equal(tref.exponents(geom, p),
                                      jref.exponents(geom, p))
        bj, bt = jref.basis(geom, p), tref.basis(geom, p)
        np.testing.assert_array_equal(bt.coeff, bj.coeff)
        np.testing.assert_array_equal(bt.eval(pts), bj.eval(pts))
        np.testing.assert_array_equal(bt.eval_grad(pts), bj.eval_grad(pts))
    np.testing.assert_array_equal(tref.vertex_shape(geom, pts),
                                  jref.vertex_shape(geom, pts))
    np.testing.assert_array_equal(tref.vertex_shape_grad(geom, pts),
                                  jref.vertex_shape_grad(geom, pts))


@pytest.mark.parametrize("name", ["tri_4x3", "unit-square-iso.mesh",
                                  "unit-cube-tet-iso.mesh"])
def test_scan_plan_and_greedy_orders(name):
    """The sweep plan, the level segments of the compact layout and the
    reference's greedy orders on simplex meshes."""
    oj, ot = _geo_ops(name, 1, "mfem-parity")
    dim = ot.dim
    qj, qt = (m.build(m.AngularOptions(dimension=dim, polar_points=2,
                                       azimuth_points=8))
              for m in (jang, tang))
    pj = jplan.build_plan(oj.sweep_neighbor, oj.normals, qj.directions)
    pt = tplan.build_plan(ot.sweep_neighbor, ot.normals, qt.directions)
    for key in ("group_of_dir", "levels", "n_levels", "level_of_elem"):
        np.testing.assert_array_equal(getattr(pt, key), getattr(pj, key))
    assert pt.max_width == pj.max_width
    counts = (pt.levels >= 0).sum(axis=2)
    assert pick_level_segments(counts) == _pick_level_segments(counts)
    for a, b in zip(tplan.greedy_orders(ot.sweep_neighbor, ot.normals,
                                        qt.directions[:, :dim]),
                    jplan.greedy_orders(oj.sweep_neighbor, oj.normals,
                                        qj.directions[:, :dim])):
        np.testing.assert_array_equal(a, b)


def test_load_mesh_refuses_missing_files(tmp_path):
    with pytest.raises(FileNotFoundError):
        tmesh.load_mesh(str(tmp_path / "none.mesh"))
    with pytest.raises(ValueError, match="built-in"):
        tmesh.load_mesh("unit-torus")
