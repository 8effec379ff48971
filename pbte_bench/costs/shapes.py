"""The problem's shapes, from a configuration file alone."""

from __future__ import annotations

import math

# element DOF count by element type and order p
NDOF = {"hex": lambda p: (p + 1) ** 3,
        "tet": lambda p: (p + 1) * (p + 2) * (p + 3) // 6}
# fine elements a lattice cell is split into
SPLIT = {"hex": 1, "tet": 6}
# bytes of one value of the state, by state type
STATE_BYTES = {"float32": 4, "bfloat16": 2, "float64": 8}


def shapes(config):
    """K directions, BS bands, cells of the lattice, fine elements, the
    fine element's D, the dimension and the bytes of an operand (float64
    operands with float64 state, float32 otherwise)."""
    m = config["mesh"]
    a = config["angles"]
    dim = a["dimension"]
    K = a["azimuth_points"] * (a["polar_points"] if dim == 3 else 1)
    BS = config["material"]["num_branches"] * config["material"]["num_spectral"]
    cells = math.prod(m["cells"])
    return dict(K=K, BS=BS, cells=cells, ne=cells * SPLIT[m["element"]],
                D=NDOF[m["element"]](int(config["order"])), dim=dim)


def operand_bytes(state):
    return 8 if state == "float64" else 4
