"""Unit-cube lattice problems, built from pbte_tpu's numpy host layers.

The flagship is ``unit_cube(16, 16, 16, order=2, polar=4, azimuth=16,
nspec=20)`` with ``WALL_BCS``: the problem ``bench.py`` and
``__graft_entry__._build_problem`` build for pbte_tpu (unit cube scaled to
microns, consistent DG faces, silicon 2 x nspec bands).
"""

from __future__ import annotations

from pbte_tpu import mesh as pmesh
from pbte_tpu.angular import quadrature as ang
from pbte_tpu.fem import assembly
from pbte_tpu.material import nongray_smrt as mat

# isothermal walls: attr 6 hot, the rest cold
WALL_BCS = {1: -0.5, 2: -0.5, 3: -0.5, 4: -0.5, 5: -0.5, 6: 0.5}
FLAGSHIP = dict(nx=16, ny=16, nz=16, order=2, polar=4, azimuth=16, nspec=20)


def unit_cube(nx, ny, nz, order, polar, azimuth, nspec):
    """(ops, quad, tables) of an nx x ny x nz hex unit-cube lattice."""
    m = pmesh.make_cartesian_3d(nx, ny, nz, "hex").scaled(1.0e-6)
    ops = assembly.assemble(pmesh.connect(m), order=order,
                            face_mode="consistent")
    quad = ang.build(ang.AngularOptions(
        dimension=3, polar_points=polar, azimuth_points=azimuth))
    tables = mat.build_tables(mat.SILICON, num_spectral=nspec)
    return ops, quad, tables
