"""The frozen work counts against numbers worked out by hand."""

import copy

import pytest

from pbte_bench import harness
from pbte_bench.costs import lattice_ring, super_ring


def _config(name, cells, order, polar, azimuth, nspec):
    c = copy.deepcopy(harness.load_json("configs", name))
    c["mesh"]["cells"] = cells
    c["order"] = order
    c["angles"]["polar_points"], c["angles"]["azimuth_points"] = polar, azimuth
    c["material"]["num_spectral"] = nspec
    return c


# hex 2^3 p=1: ne 8, D 8, K 8, BS 2, nf 3, J 32; K BS ne D = 1024 state
# values; operands 64 + 512 + 192 + 4096 + 16 + 8 + 512 = 5400
@pytest.mark.parametrize("state,nbytes", [("float32", 2 * 1024 * 4 + 4 * 5400),
                                          ("bfloat16", 2 * 1024 * 2 + 4 * 5400),
                                          ("float64", 2 * 1024 * 8 + 8 * 5400)])
def test_lattice_ring_by_hand(state, nbytes):
    c = _config("flagship_hex16_p2", [2, 2, 2], 1, 2, 4, 1)
    assert lattice_ring.work(c, state) == (nbytes, 2 * 1024 * 32)


def test_super_ring_by_hand():
    # one cell of 6 tets, p=1: D 4, D' 24, K 8, BS 2, nf 3; 384 state
    # values; operands 24 + 192 + 24 + 9216 + 13824 + 16 + 192 = 23488;
    # flop 2 * 384 * (1 + 3) * 24
    c = _config("legacy_tet_cuboid5_p3", [1, 1, 1], 1, 2, 4, 1)
    assert super_ring.work(c, "float32") == (2 * 384 * 4 + 4 * 23488,
                                             2 * 384 * 96)


def test_flagship_bound():
    """The flagship's f32 sweep is bound by its bytes: 1.41 ms a step."""
    c = harness.load_json("configs", "flagship_hex16_p2")
    nbytes, flop = lattice_ring.work(c, "float32")
    peaks = harness.load_json(".", "peaks")
    t_bytes = nbytes / peaks["bytes_per_s"]
    assert t_bytes > flop / peaks["flop_per_s"]["float32"]
    assert t_bytes == pytest.approx(1.406e-3, rel=1e-3)
