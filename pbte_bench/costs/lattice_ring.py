"""Work of one sweep of the single-class lattice ring (K1's problem).

The formula of the port's ``ops.lattice_ring.sweep_cost`` as it stood when
the benchmark was written, frozen here and counted over the problem's
elements rather than the ring's slab: padded and in-window slots that hold
no element are no work the problem asks for. Every input is read once and
every output written once: the state ``v`` read and ``ys`` written (K BS
ne D values at the state's size), the lagged temperature (ne D), the wall
source (K ne D), the inflow coefficients (K ne nf), the folded factors
``[B | -vg B C_f]`` (K BS D J), the macroscopic weights (K BS), the band
vectors (4 BS) and the macroscopic partials written (K ne D), operands at
8 bytes with float64 state and 4 otherwise. Flop: 2 D J per (element,
direction, band), J = (1 + nf) D, nf = dim inflow faces of a box cell."""

from __future__ import annotations

from pbte_bench.costs.shapes import STATE_BYTES, operand_bytes, shapes


def work(config, state):
    s = shapes(config)
    K, BS, ne, D, nf = s["K"], s["BS"], s["ne"], s["D"], s["dim"]
    J = (1 + nf) * D
    n_state = K * BS * ne * D
    n_ops = (ne * D + K * ne * D + K * ne * nf + K * BS * D * J + K * BS
             + 4 * BS + K * ne * D)
    nbytes = 2 * n_state * STATE_BYTES[state] + operand_bytes(state) * n_ops
    return nbytes, 2 * n_state * J
