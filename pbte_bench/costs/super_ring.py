"""Work of one sweep of the supercell ring: the 6-tet (or 2-triangle)
split of a box lattice swept as a lattice of super elements of D' = split
D DOFs, written as ``lattice_ring.py`` is. Every input read once and every
output written once: the state read and written (K BS cells D' values),
the lagged temperature (cells D'), the wall source (K cells D'), the
inflow coefficients (K cells nf), the block factors (K BS D'^2: one per
direction and band), the face couplings (2^dim nf D'^2: geometry only,
one per sweep octant and inflow face), the macroscopic weights (K BS) and
the partials written (K cells D'). Flop: the factor apply and the nf
couplings, 2 (1 + nf) D'^2 per (cell, direction, band)."""

from __future__ import annotations

from pbte_bench.costs.shapes import SPLIT, STATE_BYTES, operand_bytes, shapes


def work(config, state):
    s = shapes(config)
    K, BS, cells, nf = s["K"], s["BS"], s["cells"], s["dim"]
    Dp = SPLIT[config["mesh"]["element"]] * s["D"]
    n_state = K * BS * cells * Dp
    n_ops = (cells * Dp + K * cells * Dp + K * cells * nf + K * BS * Dp * Dp
             + 2 ** s["dim"] * nf * Dp * Dp + K * BS + K * cells * Dp)
    nbytes = 2 * n_state * STATE_BYTES[state] + operand_bytes(state) * n_ops
    return nbytes, 2 * n_state * (1 + nf) * Dp
