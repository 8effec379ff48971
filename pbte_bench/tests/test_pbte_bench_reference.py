"""The plain reference against the port at small sizes on the CPU, in
float64, through the same configuration files."""

import pytest
import torch

from pbte_bench import port, problem
from pbte_bench.reference import check
from pbte_bench.tests.small import small_config

WALLS = {1: -0.45, 2: -0.55, 3: -0.5, 4: -0.6, 5: -0.4, 6: 0.55}


def _solver(config):
    from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

    ops, quad, tables = problem.build(config, port.layers())
    return SourceIterationSolver(ops, quad, tables, bc_temps=WALLS,
                                 dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("name,path", [("flagship_hex16_p2", "_sweep"),
                                       ("legacy_tet_cuboid5_p3", "_super")])
def test_three_steps_match_the_port(name, path):
    config = small_config(name)
    s = _solver(config)
    # the lattice ring (no scan, no supercell) or the supercell ring
    assert (getattr(s, path) is None) == (path == "_sweep")
    state = s.initial_state()
    readings = []
    for _ in range(3):
        state = s.step(*state[:3])
        readings.append((s.Tc_fine(state[1]), state[2], float(state[3])))
    plain = check.plain_step(config, WALLS, "cpu")
    gaps = check.steps_gaps(plain, readings)
    assert max(gaps.values()) < 1e-11, gaps


@pytest.mark.parametrize("name", ["flagship_hex16_p2",
                                  "legacy_tet_cuboid5_p3"])
def test_a_step_from_the_ports_own_state(name):
    """The reference follows one step from a state the port reached."""
    config = small_config(name)
    s = _solver(config)
    state = s.initial_state()
    for _ in range(5):
        state = s.step(*state[:3])
    u, Tc, Tv, _ = state
    before = (s.u_by_direction(u), s.Tc_fine(Tc), Tv)
    _, Tc, Tv, _ = s.step(u, Tc, Tv)
    plain = check.plain_step(config, WALLS, "cpu")
    gaps = check.follow_gaps(plain, before + (s.Tc_fine(Tc), Tv))
    assert max(gaps.values()) < 1e-11, gaps


def test_fixed_point_of_a_converged_solve():
    config = small_config("flagship_hex16_p2")
    s = _solver(config)
    res = s.solve(accelerate="bicgstab", tol=1e-11, max_iter=1500,
                  check_every=20, verbose=False)
    plain = check.plain_step(config, WALLS, "cpu")
    assert check.fixed_point_gap(plain, s.Tc_fine(res.Tc)) < 1e-8
    # a solve stopped early is far from the fixed point
    early = s.solve(accelerate="bicgstab", tol=1e-3, max_iter=1500,
                    check_every=20, verbose=False)
    assert check.fixed_point_gap(plain, s.Tc_fine(early.Tc)) > 1e-6


def test_upwind_levels_on_a_chain():
    import numpy as np

    from pbte_bench.reference.sweep import upwind_levels

    # three elements in a row along x, faces (-x, +x); direction +x
    nbr = np.array([[-1, 1], [0, 2], [1, -1]])
    fdot = np.array([[[-1.0, 1.0], [-1.0, 1.0], [-1.0, 1.0]]])
    assert upwind_levels(nbr, fdot).tolist() == [[0, 1, 2]]
    with pytest.raises(ValueError):
        upwind_levels(np.array([[1], [0]]), np.array([[[-1.0], [-1.0]]]))
