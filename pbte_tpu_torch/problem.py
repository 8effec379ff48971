"""Unit-cube problems, built from this package's numpy host layers.

The flagship is ``unit_cube(16, 16, 16, order=2, polar=4, azimuth=16,
nspec=20)`` with ``WALL_BCS``: the problem ``bench.py`` and
``__graft_entry__._build_problem`` build for pbte_tpu (unit cube scaled to
microns, consistent DG faces, silicon 2 x nspec bands). ``DIFFUSE_WALLS``
turns it into a film between two isothermal x faces whose other four faces
reflect diffusely.

``tet_cube(**LEGACY_TET)`` with ``WALL_BCS`` is the reference's legacy
production shape (pbte_tpu's ``scripts/bench_tet.py``): the 5^3 cuboid
split into 6 tets per cell (750 elements) at p=3 (D=20), 16 x 24 = 384
directions and 2 x 20 bands, consistent faces. With the solver's defaults
both packages merge it into a 5^3 lattice of super elements (D' = 120) and
take the supercell ring; ``LEGACY_TET_SOLVER`` (``sweep_mode="scan"``)
scans the fine mesh instead.

``graded_cube`` is the same cube with its x spacing alternating 1 : 2, a
lattice of two geometry classes (from 512 elements, where faces are put in
canonical order): both packages sweep it on the multi-class lattice ring.
``unit_square`` is the 2D quad lattice of the same kind.

``config_problem(refine)`` is the problem of the repository's default
``config/config.yaml`` as the command-line interface builds it: the
unit-square-iso triangle mesh scaled to microns and refined ``refine``
times, p = 1, 24 in-plane gauss directions, 2 x 20 bands, attribute 1 at
-0.5 and 2 at +0.5. From ``refine=6`` (8,192 triangles) both packages
sweep it on their general ring (pbte_tpu's one-hot ring); at ``refine=7``
(32,768 triangles) it is the general ring's full-width case.

Boundary attributes of the cube: 1 and 6 are the z faces (bottom, top),
2 and 4 the y faces, 3 and 5 the x faces. Of the square: 1 and 3 the y
faces (bottom, top), 2 and 4 the x faces.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from pbte_tpu_torch import mesh as pmesh
from pbte_tpu_torch.angular import quadrature as ang
from pbte_tpu_torch.fem import assembly
from pbte_tpu_torch.material import nongray_smrt as mat

REPO_ROOT = Path(__file__).resolve().parents[1]
DEFAULT_CONFIG = REPO_ROOT / "config" / "config.yaml"
# isothermal walls: attr 6 hot, the rest cold
WALL_BCS = {1: -0.5, 2: -0.5, 3: -0.5, 4: -0.5, 5: -0.5, 6: 0.5}
# the square's: attr 3 (top) hot, the rest cold
SQUARE_BCS = {1: -0.5, 2: -0.5, 3: 0.5, 4: -0.5}
FLAGSHIP = dict(nx=16, ny=16, nz=16, order=2, polar=4, azimuth=16, nspec=20)
LEGACY_TET = dict(n=5, order=3, polar=16, azimuth=24, nspec=20)
# the scan path's solver keywords for it: the class-batched full cache
LEGACY_TET_SOLVER = dict(sweep_mode="scan", cache_policy="full")
# x faces isothermal, the other four diffuse (keyword arguments of the solver
# after ops, quad, tables)
DIFFUSE_WALLS = dict(bc_temps={3: 0.5, 5: -0.5}, diffuse_bcs=[1, 2, 4, 6])


def unit_cube(nx, ny, nz, order, polar, azimuth, nspec, periodic=(),
              length=1.0e-6):
    """(ops, quad, tables) of an nx x ny x nz hex unit-cube lattice of edge
    ``length`` metres (a micron by default), its faces normal to the
    ``periodic`` axes (0 = x, 1 = y, 2 = z) paired."""
    m = pmesh.make_cartesian_3d(nx, ny, nz, "hex").scaled(length)
    if len(periodic):
        m = pmesh.make_periodic(m, [int(a) for a in periodic])
    ops = assembly.assemble(pmesh.connect(m), order=order,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(
        dimension=3, polar_points=polar, azimuth_points=azimuth))
    tables = mat.build_tables(mat.SILICON, num_spectral=nspec)
    return ops, quad, tables


def graded_cube(n, order, polar, azimuth, nspec):
    """(ops, quad, tables) of ``unit_cube(n, n, n, ...)`` with the x
    spacing alternating 1 : 2 (x faces at the cumulative sums of 1, 2, 1,
    2, ..., scaled to unit length)."""
    md = pmesh.make_cartesian_3d(n, n, n, "hex")
    xs = np.concatenate([[0.0], np.cumsum(np.tile([1.0, 2.0], n)[:n])])
    v = md.vertices.copy()
    v[:, 0] = xs[np.rint(v[:, 0] * n).astype(int)] / xs[-1]
    md = dataclasses.replace(md, vertices=v).scaled(1.0e-6)
    ops = assembly.assemble(pmesh.connect(md), order=order,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(
        dimension=3, polar_points=polar, azimuth_points=azimuth))
    tables = mat.build_tables(mat.SILICON, num_spectral=nspec)
    return ops, quad, tables


def unit_square(nx, ny, order, azimuth, nspec, length=1.0e-6):
    """(ops, quad, tables) of an nx x ny quad unit-square lattice of edge
    ``length`` metres (a micron by default), consistent faces, 2D
    angles."""
    m = pmesh.make_cartesian_2d(nx, ny, "quad").scaled(length)
    ops = assembly.assemble(pmesh.connect(m), order=order,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(dimension=2, azimuth_points=azimuth))
    tables = mat.build_tables(mat.SILICON, num_spectral=nspec)
    return ops, quad, tables


def tet_cube(n, order, polar, azimuth, nspec):
    """(ops, quad, tables) of the n^3 unit cube split into 6 tets per cell,
    in microns, with consistent faces."""
    return tet_box(n, n, n, order, polar, azimuth, nspec)


def tet_topology(nx, ny, nz):
    """The face topology of ``tet_box``'s mesh (the spatially sharded
    solver's partitioner reads it)."""
    return pmesh.connect(
        pmesh.make_cartesian_3d(nx, ny, nz, "tet").scaled(1.0e-6))


def tet_box(nx, ny, nz, order, polar, azimuth, nspec):
    """(ops, quad, tables) of an nx x ny x nz box of unit extent split into
    6 tets per cell, in microns, with consistent faces."""
    m = pmesh.make_cartesian_3d(nx, ny, nz, "tet").scaled(1.0e-6)
    ops = assembly.assemble(pmesh.connect(m), order=order,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(
        dimension=3, polar_points=polar, azimuth_points=azimuth))
    tables = mat.build_tables(mat.SILICON, num_spectral=nspec)
    return ops, quad, tables


def config_problem(refine, face_mode="mfem-parity", nspec=None):
    """((ops, quad, tables), bc_temps) of ``config/config.yaml``'s problem
    as ``python -m pbte_tpu_torch.cli -c config/config.yaml -r REFINE``
    builds it: its mesh, scaled by reference_length and refined
    ``refine`` times, assembled at p = 1 with ``face_mode`` (the CLI's
    default mfem-parity), and its angles, bands and walls; ``nspec``,
    where given, replaces the config's spectral bands."""
    from pbte_tpu_torch.config import load_run_config

    rc = load_run_config(str(DEFAULT_CONFIG))
    m = pmesh.uniform_refine(pmesh.load_mesh(str(
        REPO_ROOT / rc.mesh_spec)).scaled(rc.material.ref_len), refine)
    ops = assembly.assemble(pmesh.connect(m), order=1, face_mode=face_mode)
    tables = mat.build_tables(rc.material, num_spectral=(
        rc.n_spectral if nspec is None else nspec))
    return (ops, ang.build(rc.angles), tables), dict(rc.bc_temps)
