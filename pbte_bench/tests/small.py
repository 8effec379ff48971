"""Small copies of the configurations: the same problem kinds at sizes a
test run holds."""

import copy

from pbte_bench import harness

# small sizes per configuration: both flagship lattices at 8^3 (512
# elements, where the port takes the lattice ring) and the tet box at its
# own 5^3 (750 tets, where it merges supercells), all at p = 1 with 2 x 4
# directions and 2 x 2 bands
SMALL = {
    "flagship_hex16_p2": dict(cells=[8, 8, 8], order=1, angles=(2, 4),
                              nspec=2),
    "flagship_hex14_p2": dict(cells=[8, 8, 8], order=1, angles=(2, 4),
                              nspec=2),
    "legacy_tet_cuboid5_p3": dict(order=1, angles=(2, 4), nspec=2),
}


def small_config(name):
    c = copy.deepcopy(harness.load_json("configs", name))
    s = SMALL[name]
    if "cells" in s:
        c["mesh"]["cells"] = s["cells"]
    c["order"] = s["order"]
    c["angles"]["polar_points"], c["angles"]["azimuth_points"] = s["angles"]
    c["material"]["num_spectral"] = s["nspec"]
    return c
