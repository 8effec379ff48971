"""pbte_tpu_torch's copies of the CLI's host modules against pbte_tpu's.

Each module is fed the same inputs through both packages: parsed configs
and YAML must be equal, refined meshes, angle sets and assembled operators
equal bit for bit (the exact volume operators also against quadrature at
pbte_tpu's tolerances), and every writer's file equal byte for byte on seeded
arrays: config/yamlish, the legacy Control.yaml reader and angle patterns,
uniform refinement and the MFEM writer, fem.exact, the mesh summary, the
angles, phonon-table and sweep-order logs, the three golden dumps, the
slices and the ParaView writers.
"""

import dataclasses
import os
import pathlib
import sys

import numpy as np
import pytest

from pbte_tpu import config as jcfg
from pbte_tpu import mesh as jmesh
from pbte_tpu.angular import legacy_patterns as jleg
from pbte_tpu.angular import quadrature as jang
from pbte_tpu.fem import assembly as jasm
from pbte_tpu.fem import exact as jexact
from pbte_tpu.io import slice as jslice
from pbte_tpu.io import vtu as jvtu
from pbte_tpu.io import writers as jwr
from pbte_tpu.io import yamlish as jyaml
from pbte_tpu.material import nongray_smrt as jmat
from pbte_tpu.mesh import summary as jsum
from pbte_tpu.sweep import planner as jplan
from pbte_tpu_torch import config as tcfg
from pbte_tpu_torch import mesh as tmesh
from pbte_tpu_torch.angular import legacy_patterns as tleg
from pbte_tpu_torch.angular import quadrature as tang
from pbte_tpu_torch.fem import assembly as tasm
from pbte_tpu_torch.fem import exact as texact
from pbte_tpu_torch.io import slice as tslice
from pbte_tpu_torch.io import vtu as tvtu
from pbte_tpu_torch.io import writers as twr
from pbte_tpu_torch.io import yamlish as tyaml
from pbte_tpu_torch.material import nongray_smrt as tmat
from pbte_tpu_torch.mesh import summary as tsum
from pbte_tpu_torch.sweep import planner as tplan

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = ("config/config.yaml", "config/si.yaml")
BUILTINS = ("unit-square-tri", "unit-square-quad", "unit-cube-tet",
            "unit-cube-hex", "unit-square-mixed", "unit-cube-prism",
            "unit-cube-mixed")
INLINE_YAML = {
    "scientific": "a: 1e-7\nb: 1.0e+3\nc: -2.5E-2\nd: 7\n",
    "lists": ("xs: [1, 2.5, -3e-1]\nempty: []\nitems:\n  - 1\n  - two\n"
              "maps:\n  - attr: 1\n    temperature: -0.5\n  - attr: 2\n"
              "    type: diffuse\n"),
    "comments": ("# head\nouter:  # trailing\n  inner: 3 # three\n"
                 "  flag: yes\n  off_flag: off\n  none: ~\n  s: 'q'\n"),
}
MESH_KEYS = ("dim", "geom", "vertices", "elem_verts", "elem_attr",
             "bdry_verts", "bdry_attr", "source", "elem_geom")
OPS_KEYS = ("basis_int", "mass", "stiff", "face_mass", "face_int",
            "coupling", "normals", "neighbor", "face_attr", "periodic",
            "elem_face")


def _same(a, b, what=""):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def _same_mesh(a, b):
    for k in MESH_KEYS:
        _same(getattr(a, k), getattr(b, k), k)


def _same_bytes(paths_a, paths_b):
    for pa, pb in zip(paths_a, paths_b):
        assert pathlib.Path(pa).read_bytes() == pathlib.Path(pb).read_bytes(), pa


def _both(tmp_path, name):
    """Two output paths of one name, one per package."""
    return [str(tmp_path / pkg / name) for pkg in ("jax", "torch")]


# ---- parsers and configs ---------------------------------------------------


@pytest.mark.parametrize("src", list(CONFIGS) + sorted(INLINE_YAML))
def test_loads_subset(src):
    """The subset parser gives the same values in both packages: the repo's
    configs and inline scientific notation, lists, block lists of maps and
    comments."""
    text = INLINE_YAML[src] if src in INLINE_YAML else (REPO / src).read_text()
    got = tyaml.loads_subset(text)
    assert got == jyaml.loads_subset(text) and got
    if src == "scientific":
        assert got == {"a": 1e-7, "b": 1e3, "c": -2.5e-2, "d": 7}


@pytest.mark.parametrize("src", CONFIGS)
@pytest.mark.parametrize("pyyaml", [True, False], ids=["pyyaml", "subset"])
def test_load_yaml_file(src, pyyaml, monkeypatch):
    """load_yaml_file with PyYAML and with the subset parser it falls back
    to without PyYAML: the same values in both packages."""
    if not pyyaml:
        monkeypatch.setitem(sys.modules, "yaml", None)
    path = str(REPO / src)
    got = tyaml.load_yaml_file(path)
    assert got == jyaml.load_yaml_file(path) and got


def _cfg_dict(rc):
    d = dataclasses.asdict(rc)
    d["legacy_pattern"] = getattr(rc, "legacy_pattern", None)
    return d


@pytest.mark.parametrize("pyyaml", [True, False], ids=["pyyaml", "subset"])
def test_load_run_config(pyyaml, monkeypatch):
    """Both repo configs (config.yaml with si.yaml beside it) read to the
    same RunConfig, the mesh path resolved relative to the config."""
    if not pyyaml:
        monkeypatch.setitem(sys.modules, "yaml", None)
    monkeypatch.chdir(REPO / "tests")  # the mesh path resolves by the config
    path = str(REPO / "config/config.yaml")
    rc_t, rc_j = tcfg.load_run_config(path), jcfg.load_run_config(path)
    assert _cfg_dict(rc_t) == _cfg_dict(rc_j)
    assert rc_t.tolerance == 1e-7 and os.path.exists(rc_t.mesh_spec)
    si = str(REPO / "config/si.yaml")
    assert dataclasses.asdict(tmat.load_material(si)) == dataclasses.asdict(
        jmat.load_material(si))


CONTROL = """\
POLYDEG: 2
SPATIAL_DIM: {sdim}
SOLID_ANGLE_PATTERN: 2
NPOLE: 6
NAZIM: 12
NSPEC: 7
TOL: 1e-6
TMAX: 55
MESH_PATH: meshes
MESH_TAG: cube
OUTPUT_PATH: results
T_REF: 310.0
L_REF: 2.0e-6
BOUNDARY_COND:
  1: [1, 0.5]
  2: [2, 0.0]
  3: [3, 0.0]
  4: [4, 0.0]
  5: [7, 0.25]
  6: [{last}, -0.5]
"""
SI_MODEL = """\
C_LA: [9.01e+3, -2.0e-7]
C_TA: [5.23e+3, -2.26e-7]
LATTICE_DIST: 5.43e-10
Ai: 1.498e-45
BL: 1.18e-24
BT: 8.708e-13
BU: 2.890e-18
"""


@pytest.mark.parametrize("sdim", [2, 3])
def test_load_legacy_control(sdim, tmp_path):
    """A legacy Control.yaml with every boundary type (1, 2, 3, 4, 7) and
    the Si_PhononModel.yaml beside it read to the same RunConfig in both
    packages, through load_legacy_control and through load_run_config; an
    unsupported type raises NotImplementedError in both."""
    ctl = tmp_path / "Control.yaml"
    ctl.write_text(CONTROL.format(sdim=sdim, last=1))
    (tmp_path / "Si_PhononModel.yaml").write_text(SI_MODEL)
    rc_t = tcfg.load_legacy_control(str(ctl))
    assert _cfg_dict(rc_t) == _cfg_dict(jcfg.load_legacy_control(str(ctl)))
    assert _cfg_dict(tcfg.load_run_config(str(ctl))) == _cfg_dict(rc_t)
    assert rc_t.bc_temps == {1: 0.5, 6: -0.5}
    assert (rc_t.diffuse_attrs, rc_t.specular_attrs, rc_t.periodic_attrs,
            rc_t.dirichlet_bcs) == ([2], [3], [4], {5: 0.25})
    assert rc_t.angles.polar_points == (1 if sdim == 2 else 6)
    assert rc_t.material.ref_len == 2.0e-6 and rc_t.legacy_pattern == 2
    ctl.write_text(CONTROL.format(sdim=sdim, last=5))
    for mod in (tcfg, jcfg):
        with pytest.raises(NotImplementedError, match="legacy boundary type 5"):
            mod.load_legacy_control(str(ctl))


# ---- angles, meshes, assembly ----------------------------------------------


@pytest.mark.parametrize("dim,pattern,npole,nazim", [
    (2, 1, 1, 8), (2, 2, 1, 8), (3, 1, 4, 8), (3, 2, 4, 8),
])
def test_build_legacy(dim, pattern, npole, nazim):
    t = tleg.build_legacy(dim, npole, nazim, pattern)
    j = jleg.build_legacy(dim, npole, nazim, pattern)
    for f in dataclasses.fields(j):
        _same(getattr(t, f.name), getattr(j, f.name), f.name)


@pytest.mark.parametrize("args", [(3, 3, 8, 1), (2, 1, 6, 1), (4, 2, 2, 1),
                                  (3, 4, 7, 2)])
def test_build_legacy_rejects(args):
    for mod in (tleg, jleg):
        with pytest.raises(ValueError):
            mod.build_legacy(*args)


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("name", BUILTINS)
def test_uniform_refine(name, levels, tmp_path):
    """Every builtin, prism and mixed included, refined 1 and 2 levels:
    vertices, element vertices, attributes, boundary and element
    geometries bit-equal, and write_mfem_mesh's files byte-equal."""
    t = tmesh.uniform_refine(tmesh.load_builtin(name), levels)
    j = jmesh.uniform_refine(jmesh.load_builtin(name), levels)
    _same_mesh(t, j)
    paths = _both(tmp_path, "refined.mesh")
    tmesh.write_mfem_mesh(t, paths[1])
    jmesh.write_mfem_mesh(j, paths[0])
    _same_bytes(paths[:1], paths[1:])
    # the written file reads back to the same mesh
    back = tmesh.load_mfem_mesh(paths[1])
    np.testing.assert_array_equal(back.vertices, t.vertices)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("geom", ["triangle", "tet"])
def test_exact_volume_operators(geom, order):
    """fem.exact and assemble(volume_mode="exact") on a builtin simplex
    mesh: bit-equal to pbte_tpu's, and equal to the port's quadrature
    operators at pbte_tpu's tolerances for that check."""
    name = "unit-square-tri" if geom == "triangle" else "unit-cube-tet"
    t_ops, j_ops = [
        m.assemble(pm.connect(pm.load_builtin(name).scaled(1e-6)),
                   order=order, volume_mode="exact")
        for m, pm in ((tasm, tmesh), (jasm, jmesh))
    ]
    for k in OPS_KEYS:
        _same(getattr(t_ops, k), getattr(j_ops, k), k)
    quad_ops = tasm.assemble(
        tmesh.connect(tmesh.load_builtin(name).scaled(1e-6)), order=order)
    # pbte_tpu's own tolerances for the same check (tests/test_fem.py)
    np.testing.assert_allclose(t_ops.basis_int, quad_ops.basis_int,
                               rtol=1e-11, atol=1e-14)
    np.testing.assert_allclose(t_ops.mass, quad_ops.mass, rtol=1e-11,
                               atol=1e-13)
    np.testing.assert_allclose(t_ops.stiff, quad_ops.stiff, rtol=1e-11,
                               atol=1e-13)
    verts = np.random.default_rng(order).normal(
        size=(5, 3 if geom == "triangle" else 4, 2 if geom == "triangle"
              else 3))
    for a, b in zip(texact.volume_operators(geom, order, verts),
                    jexact.volume_operators(geom, order, verts)):
        _same(a, b)


def test_exact_volume_mode_rejects():
    topo = tmesh.connect(tmesh.load_builtin("unit-square-mixed"))
    with pytest.raises(ValueError, match="affine-simplex"):
        tasm.assemble(topo, order=1, volume_mode="exact")
    with pytest.raises(ValueError, match="unknown volume_mode"):
        tasm.assemble(topo, order=1, volume_mode="closed")
    with pytest.raises(ValueError, match="simplex"):
        texact.volume_operators("quad", 1, np.zeros((1, 4, 2)))


# ---- logs and writers -------------------------------------------------------


def _problem(pkg, name, refine, order, periodic=()):
    pmesh, asm = (tmesh, tasm) if pkg == "torch" else (jmesh, jasm)
    m = pmesh.uniform_refine(pmesh.load_builtin(name).scaled(1e-6), refine)
    if periodic:
        m = pmesh.make_periodic(m, list(periodic))
    topo = pmesh.connect(m)
    return m, topo, asm.assemble(topo, order=order, face_mode="consistent")


@pytest.mark.parametrize("name,periodic", [
    ("unit-square-tri", ()), ("unit-cube-hex", (0,)),
    ("unit-square-mixed", ()), ("unit-cube-mixed", ()),
])
def test_host_logs(name, periodic, tmp_path):
    """write_summary, write_quadrature, write_tables and
    write_sweep_orders (with a periodic mesh, whose pairs the sweep log
    masks) write the same bytes; the plan's padding ratio is equal."""
    dim = 2 if "square" in name else 3
    opts = dict(dimension=dim, polar_points=2, azimuth_points=8,
                azimuth_scheme="uniform")
    out = {}
    for pkg, ang, mat, summ, plan in (
            ("jax", jang, jmat, jsum, jplan),
            ("torch", tang, tmat, tsum, tplan)):
        m, topo, ops = _problem(pkg, name, 0, 2, periodic)
        if periodic:
            assert topo.elem_face_periodic.any()
        quad = ang.build(ang.AngularOptions(**opts))
        d = tmp_path / pkg
        summ.write_summary(topo, 2, ops.ndof * m.num_elements,
                           str(d / "mesh.txt"))
        ang.write_quadrature(quad, str(d / "angles.txt"))
        mat.write_tables(mat.build_tables(mat.SILICON, num_spectral=5),
                         str(d / "phonon_properties.txt"))
        plan.write_sweep_orders(quad, topo, str(d / "sweep.txt"))
        p = plan.build_plan(ops.sweep_neighbor, ops.normals,
                            quad.directions)
        out[pkg] = (p.padding_ratio(), summ.make_summary(topo, 2, 7))
    assert out["torch"] == out["jax"]
    assert 0.0 <= out["torch"][0] < 1.0
    for f in ("mesh.txt", "angles.txt", "phonon_properties.txt",
              "sweep.txt"):
        _same_bytes([tmp_path / "jax" / f], [tmp_path / "torch" / f])


@pytest.mark.parametrize("scheme", ["gauss", "Gauss-Legendre", "legendre",
                                    "uniform", "UNIFORM"])
def test_angles_from_config(scheme):
    cfg = {"angles": {"dimension": 3, "polar_points": "4",
                      "azimuth_points": 6, "polar_scheme": scheme}}
    assert dataclasses.asdict(tang.options_from_config(cfg)) == \
        dataclasses.asdict(jang.options_from_config(cfg))
    assert tang.parse_scheme(scheme) == jang.parse_scheme(scheme)
    for mod in (tang, jang):
        with pytest.raises(ValueError, match="unknown discretization"):
            mod.parse_scheme("lobatto")


@pytest.mark.parametrize("name,order", [("unit-square-tri", 1),
                                        ("unit-cube-hex", 2),
                                        ("unit-square-mixed", 2)])
def test_golden_dumps(name, order, tmp_path):
    """write_coefficients, write_temperature and write_element_integrals
    on seeded arrays and the mesh's own operators: byte-equal."""
    rng = np.random.default_rng(7)
    _, _, ops_j = _problem("jax", name, 0, order)
    _, _, ops_t = _problem("torch", name, 0, order)
    quad = tang.build(tang.AngularOptions(dimension=3, polar_points=2,
                                          azimuth_points=4))
    u = rng.normal(size=(quad.num_directions, 6, ops_t.num_elements,
                         ops_t.ndof))
    Tc = rng.normal(size=(ops_t.num_elements, ops_t.ndof)).astype(np.float32)
    for pkg, wr, ops in (("jax", jwr, ops_j), ("torch", twr, ops_t)):
        d = tmp_path / pkg
        wr.write_coefficients(u, quad, 2, str(d / "coeff_all.txt"))
        wr.write_temperature(Tc, str(d / "Tc_all.txt"))
        wr.write_element_integrals(ops, str(d / "integrals_all.txt"))
    for f in ("coeff_all.txt", "Tc_all.txt", "integrals_all.txt"):
        _same_bytes([tmp_path / "jax" / f], [tmp_path / "torch" / f])


def _fields(m, order, seed):
    """Seeded (ne, D) coefficients and (dim, ne, D) flux of a mesh."""
    from pbte_tpu_torch.fem import reference as tref

    if m.geom == "mixed":
        D = max(tref.basis(tmesh.core.MFEM_GEOM_CODES[int(c)], order).ndof
                for c in np.unique(m.elem_geom))
    else:
        D = tref.basis(m.geom, order).ndof
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m.num_elements, D)),
            rng.normal(size=(m.dim, m.num_elements, D)))


@pytest.mark.parametrize("name,order", [("unit-square-tri", 1),
                                        ("unit-square-quad", 2),
                                        ("unit-square-mixed", 1)])
def test_2d_slices(name, order, tmp_path):
    """write_2d_slice (the golden T_slice.txt) and write_2d_slice_tq on
    seeded fields: byte-equal files and equal samples."""
    m = tmesh.load_builtin(name).scaled(1e-6)
    Tc, Qc = _fields(m, order, 3)
    outs = []
    for pkg, sl in (("jax", jslice), ("torch", tslice)):
        d = tmp_path / pkg
        a = sl.write_2d_slice(m, order, Tc, str(d / "T_slice.txt"), 30, 20)
        b = sl.write_2d_slice_tq(m, order, Tc, Qc, str(d / "tq.txt"), 15,
                                 12)
        outs.append((a, *b))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(outs[1][0]).all()
    for f in ("T_slice.txt", "tq.txt"):
        _same_bytes([tmp_path / "jax" / f], [tmp_path / "torch" / f])


@pytest.mark.parametrize("name,order", [("unit-cube-hex", 2),
                                        ("unit-cube-tet", 1),
                                        ("unit-cube-mixed", 1)])
def test_3d_slices(name, order, tmp_path):
    """locate_points and sample_field, the z-plane and the line slices
    (every axis) on seeded fields: equal samples, byte-equal files."""
    m = tmesh.load_builtin(name).scaled(1e-6)
    Tc, Qc = _fields(m, order, 4)
    pts = np.random.default_rng(5).uniform(-0.1e-6, 1.1e-6, size=(200, 3))
    for a, b in zip(tslice.locate_points(m, pts),
                    jslice.locate_points(m, pts)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tslice.sample_field(m, order, Tc, pts),
        jslice.sample_field(m, order, Tc, pts))
    for pkg, sl in (("jax", jslice), ("torch", tslice)):
        d = tmp_path / pkg
        sl.write_3d_slice(m, order, Tc, Qc, 0.4e-6, str(d / "z.txt"), 12, 9)
        for axis in range(3):
            sl.write_3d_line_slice(m, order, Tc, Qc, axis, 0.5e-6, 0.3e-6,
                                   str(d / f"line{axis}.txt"), n=17)
    for f in ["z.txt"] + [f"line{a}.txt" for a in range(3)]:
        _same_bytes([tmp_path / "jax" / f], [tmp_path / "torch" / f])
    T = np.loadtxt(tmp_path / "torch" / "line2.txt", skiprows=1)[:, 3]
    assert np.isfinite(T).all()
    with pytest.raises(ValueError, match="invalid line axis"):
        tslice.write_3d_line_slice(m, order, Tc, Qc, 3, 0, 0,
                                   str(tmp_path / "x.txt"))


@pytest.mark.parametrize("name,order,lod", [
    ("unit-square-quad", 1, 0), ("unit-square-tri", 2, None),
    ("unit-cube-hex", 2, None), ("unit-cube-tet", 3, 1),
    ("unit-square-mixed", 2, 1), ("unit-cube-mixed", 2, None),
])
def test_vtu(name, order, lod, tmp_path):
    """write_vtu at lod 0 and at high order (the default lod subdivides
    p >= 2), write_pvtu over three partitions and ParaViewCollection (one
    piece, and partitioned) over two cycles: byte-equal trees."""
    m = tmesh.load_builtin(name).scaled(1e-6)
    Tc, Qc = _fields(m, order, 6)
    part = (np.arange(m.num_elements) % 3).astype(np.int32)
    pieces = [(ids, {"T": Tc[ids]}, {"Q": Qc[:, ids]})
              for p in range(3) for ids in (np.flatnonzero(part == p),)]
    for pkg, vt in (("jax", jvtu), ("torch", tvtu)):
        d = tmp_path / pkg
        vt.write_vtu(m, order, {"T": Tc}, {"Q": Qc}, str(d / "fields"),
                     lod=lod)
        vt.write_pvtu(m, order, pieces, str(d / "part" / "fields"), lod=lod)
        for kw in ({}, {"part": part}):
            coll = vt.ParaViewCollection(
                m, order, name="c" + str(len(kw)), root=str(d / "vis"),
                lod=lod, **kw)
            for cyc in (3, 6):
                coll.save({"T": Tc * cyc}, {"Q": Qc}, cycle=cyc)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert sorted(p.relative_to(tmp_path / "torch")
                  for p in (tmp_path / "torch").rglob("*")
                  if p.is_file()) == files
    assert len(files) == 1 + 4 + 5 + 9  # vtu, pvtu, two collections
    _same_bytes([tmp_path / "jax" / f for f in files],
                [tmp_path / "torch" / f for f in files])


def test_compare_outputs(tmp_path):
    """io.outputs.compare_outputs: host logs byte for byte; fields within
    rtol of their block's largest value beside a last printed digit that
    rounds the other way; a column of one stem is one block."""
    from pbte_tpu_torch.io.outputs import compare_outputs

    def tree(name, tc, line, log="angles 1\n"):
        d = tmp_path / name
        (d / "log").mkdir(parents=True)
        (d / "log/angles_x.txt").write_text(log)
        (d / "log/Tc_all.txt").write_text("# Tc matrix\nelem 0\n" + tc)
        (d / "T_line.txt").write_text("x y z T Qx Qy Qz\n" + line)
        return d

    ref = tree("ref", "0.123457 2.5e-09\n", "1 0 0 0.5 1e3 0 2\n")
    # the sixth digit rounded the other way, and 1e-12 of a block's max
    same = tree("same", "0.123456 2.5e-09\n", "1 0 0 0.5 1e3 1e-9 2\n")
    errs = compare_outputs(same, ref, 1e-11)
    assert errs["T_line.txt"] == pytest.approx(1e-12)
    assert errs["log/Tc_all.txt"] < 1e-15
    for name, kw in (("far", dict(tc="0.123447 2.5e-09\n")),
                     ("qz", dict(line="1 0 0 0.5 1e3 0 2.1\n")),
                     ("log", dict(log="angles 2\n"))):
        args = dict(tc="0.123457 2.5e-09\n", line="1 0 0 0.5 1e3 0 2\n")
        args.update(kw)
        with pytest.raises(AssertionError):
            compare_outputs(tree(name, **args), ref, 1e-6)
    (same / "extra.txt").write_text("1\n")
    with pytest.raises(AssertionError, match="file sets differ"):
        compare_outputs(same, ref, 1e-11)
