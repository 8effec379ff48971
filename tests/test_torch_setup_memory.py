"""The solver's host set-up in chunks, on the CPU.

``fem.assembly.element_classes`` (its hash pass and its merge pass) and
``class_coupling`` run over chunks of elements (``CLASS_CHUNK``), and
``element_classes(..., perm=)`` classifies the face-permuted operators
without their copy. Each is held bit for bit to pbte_tpu's unchunked
function at chunk sizes that split hex 6^3 and 8^3 p=3 (216 and 512
elements) unevenly; the merge pass takes a fine split past pbte_tpu's cap
of 8,192 classes; the solver's device operators and its 3-step Tc do not
depend on the chunk; and ``probe_setup_torch.py`` records the
constructor's stages.
"""

import json
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

from pbte_tpu.fem import assembly as jasm
from pbte_tpu_torch import problem
from pbte_tpu_torch.fem import assembly as tasm
from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

REPO = pathlib.Path(__file__).resolve().parents[1]
# uneven splits of 216 and 512 rows, and one chunk
CHUNKS = (1, 7, 100, 333, 10 ** 9)


@pytest.fixture(scope="module", params=[6, 8], ids=["hex6_p3", "hex8_p3"])
def lattice(request):
    """(ops, canonical face permutation, face-permuted ops) of hex n^3
    p=3."""
    n = request.param
    ops = problem.unit_cube(n, n, n, order=3, polar=2, azimuth=4,
                            nspec=1)[0]
    perm = tasm.canonical_face_perm(ops)
    return ops, perm, tasm.permute_faces(ops, perm)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_element_classes_in_chunks(lattice, chunk, monkeypatch):
    """Fine and merged classes, of the operators as assembled and of their
    canonical face order (``perm=``, no copy), equal pbte_tpu's."""
    ops, perm, ops_c = lattice
    monkeypatch.setattr(tasm, "CLASS_CHUNK", chunk)
    for merge in (False, True):
        np.testing.assert_array_equal(
            tasm.element_classes(ops, merge=merge),
            jasm.element_classes(ops, merge=merge))
        np.testing.assert_array_equal(
            tasm.element_classes(ops, merge=merge, perm=perm),
            jasm.element_classes(ops_c, merge=merge))


@pytest.mark.parametrize("chunk", CHUNKS)
def test_class_coupling_in_chunks(lattice, chunk, monkeypatch):
    """The class couplings of the canonical order (one class), and the
    refusal (None) where one class's couplings differ (every element in
    one class in the assembled face order), equal pbte_tpu's."""
    ops, _, ops_c = lattice
    monkeypatch.setattr(tasm, "CLASS_CHUNK", chunk)
    cls = jasm.element_classes(ops_c)
    assert cls.max() == 0
    got = tasm.class_coupling(ops_c, cls)
    np.testing.assert_array_equal(got, jasm.class_coupling(ops_c, cls))
    one = np.zeros(ops.num_elements, dtype=np.int64)
    assert jasm.class_coupling(ops, one) is None
    assert tasm.class_coupling(ops, one) is None


def _noisy_copies(ne, noise, seed=3):
    """``ne`` copies of one element's operators (D = 2, two faces), every
    entry but each part's largest (1.0) moved by up to ``noise`` of it:
    base entries sit a quarter of the merge pass's 1e-9 grid from its
    rounding points, so the noise crosses none of them."""
    rng = np.random.default_rng(seed)

    def part(*shape):
        cols = int(np.prod(shape))
        base = (rng.integers(1, 10 ** 8, cols) + 0.25) * 1e-9
        base[0] = 1.0
        rows = np.tile(base, (ne, 1))
        rows[:, 1:] += rng.uniform(-noise, noise, (ne, cols - 1))
        return rows.reshape((ne,) + shape)

    return types.SimpleNamespace(
        num_elements=ne, mass=part(2, 2), stiff=part(3, 2, 2),
        face_mass=part(2, 2, 2), face_int=part(2, 2), basis_int=part(2),
        normals=part(2, 3))


def test_merge_takes_any_number_of_fine_classes(monkeypatch):
    """9,000 copies of one element, each entry moved by up to 3e-11: the
    fine hash (a 1e-11 grain) splits them into more than 8,192 classes.
    pbte_tpu's merge pass stops there (its cap) and keeps the split; the
    port's, which reads the representatives in chunks, merges them into
    one class (they agree to 1e-9), as both merge a smaller split."""
    monkeypatch.setattr(tasm, "CLASS_CHUNK", 1000)
    ops = _noisy_copies(9000, 3e-11)
    fine = tasm.element_classes(ops, merge=False)
    np.testing.assert_array_equal(fine, jasm.element_classes(ops,
                                                             merge=False))
    assert fine.max() + 1 > 8192
    assert jasm.element_classes(ops).max() + 1 == fine.max() + 1
    assert tasm.element_classes(ops).max() == 0
    small = _noisy_copies(4000, 3e-11)
    assert tasm.element_classes(small, merge=False).max() + 1 > 1000
    np.testing.assert_array_equal(tasm.element_classes(small),
                                  jasm.element_classes(small))
    assert tasm.element_classes(small).max() == 0


def _device_arrays(solver):
    """Every tensor the solver put on its device, by path."""
    out = {}

    def walk(prefix, x):
        if isinstance(x, torch.Tensor):
            out[prefix] = x
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                walk(f"{prefix}/{i}", v)
        elif hasattr(x, "_fields"):
            for k in x._fields:
                walk(f"{prefix}/{k}", getattr(x, k))

    walk("consts", solver.consts)
    walk("multi", solver._multi or ())
    return out


SOLVER_CASES = {
    # K1's single-class lattice: canonical faces, merged classes, class
    # coupling
    "hex8_p3_f64": (problem.unit_cube, dict(nx=8, ny=8, nz=8, order=3,
                                            polar=2, azimuth=4, nspec=2),
                    torch.float64),
    # two geometry classes: the multi-class ring's coupling classes
    "graded8_p1_f32": (problem.graded_cube, dict(n=8, order=1, polar=2,
                                                 azimuth=4, nspec=2),
                       torch.float32),
}


@pytest.mark.parametrize("case", list(SOLVER_CASES))
def test_solver_does_not_depend_on_the_chunk(case, monkeypatch):
    """The solver built with CLASS_CHUNK = 7 and with one chunk: every
    device tensor and Tc after 3 steps equal bit for bit."""
    make, size, dtype = SOLVER_CASES[case]
    prob = make(**size)
    built = {}
    for chunk in (7, 10 ** 9):
        monkeypatch.setattr(tasm, "CLASS_CHUNK", chunk)
        s = SourceIterationSolver(*prob, problem.WALL_BCS, dtype=dtype,
                                  device="cpu")
        st = s.initial_state()
        for _ in range(3):
            st = s.step(*st)[:3]
        built[chunk] = (s.sweep_mode, _device_arrays(s), st[1])
    (mode, a, tc), (mode1, b, tc1) = built[7], built[10 ** 9]
    assert mode == mode1 == "ring"
    assert sorted(a) == sorted(b) and len(a) > 10
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert torch.equal(tc, tc1)


def test_probe_records_the_constructor_stages(monkeypatch, capsys):
    """probe_setup_torch.py --constructor at hex 8^3 p=1: the child's
    stages, with each element_classes call's classes and the path the
    solver took."""
    sys.path.insert(0, str(REPO))
    try:
        import probe_setup_torch
    finally:
        sys.path.remove(str(REPO))
    for k, v in {"PBTE_BENCH_ORDER": "1", "PBTE_BENCH_POLAR": "2",
                 "PBTE_BENCH_AZIMUTH": "4", "PBTE_BENCH_NSPEC": "1"}.items():
        monkeypatch.setenv(k, v)
    assert probe_setup_torch.main(["--device", "cpu", "--constructor",
                                   "8"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mode"] == "constructor" and out["device"] == "cpu"
    stages = out["sizes"]["8"]["stages"]
    names = [st["stage"] for st in stages]
    assert names[:2] == ["start", "assembled"] and names[-1] == "constructed"
    classes = [st["classes"] for st in stages
               if st["stage"] == "constructor: element_classes"]
    assert len(classes) == 2 and classes[-1] == 1
    assert stages[-1]["sweep_mode"] == "ring" and stages[-1]["k1"]
    assert all(st["rss_gb"] > 0 and st["maxrss_gb"] > 0 for st in stages)
