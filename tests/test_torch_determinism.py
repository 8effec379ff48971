"""Run-to-run reproducibility of pbte_tpu_torch (bit-equal results from one
input on the card): the collision-free scatters of ``ops/scatter.py`` on
random maps and on the solvers' own closure maps (against ``index_add_``,
``scatter_add_`` and pbte_tpu's ``.at[].add``), the closure path against
pbte_tpu's f64 ring, every sweep path stepping without touching the
process's determinism flag, and a source audit: no colliding float scatter
or float atomic is left in the port (the CUDA side runs on the card only:
``chip_smoke.py`` phase 16)."""

from __future__ import annotations

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_golden
from pbte_tpu.solver.source_iteration import SourceIterationSolver as JaxSolver
from pbte_tpu_torch import problem
from pbte_tpu_torch.ops import scatter
from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

PKG_DIR = pathlib.Path(__file__).resolve().parents[1] / "pbte_tpu_torch"
# hex 8^3 p=1, 2 x 8 directions, 2 x 2 bands (tests/test_torch_closures.py's
# "all_two_buckets": the diffuse sum and the specular mirror cross buckets)
CLOSURES = dict(
    periodic=((0,), {1: -0.5, 2: -0.5, 4: 0.5, 6: 0.5}, {}),
    diffuse=((), {5: -0.5, 3: 0.5}, dict(diffuse_bcs=[1, 2, 4, 6])),
    specular=((), {5: -0.5, 3: 0.5}, dict(specular_bcs=[1, 2, 4, 6])),
    all=((0,), {1: -0.5, 6: 0.5}, dict(diffuse_bcs=[2], specular_bcs=[4])),
)
# the cases with walls of one kind on two faces that share an edge, whose
# edge elements add two terms into one closure row
EDGES = ("diffuse", "specular")


@pytest.fixture(autouse=True)
def _cpu_float_env():
    """One thread, and f32 subnormals flushed as XLA's CPU backend flushes
    them (tests/test_torch_solver.py::_cpu_float_env)."""
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _held(rows, layers):
    """Each layer's targets are distinct in every map, and the layers hold
    every column exactly once."""
    rows = np.asarray(rows).reshape(-1, np.asarray(rows).shape[-1])
    cols = np.concatenate([c.numpy() for c in layers])
    assert np.array_equal(np.sort(cols), np.arange(rows.shape[1]))
    for c in layers:
        c = c.numpy()
        assert np.all(np.diff(c) > 0)
        for r in rows:
            assert len(np.unique(r[c])) == len(c)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("groups", [None, 3])
def test_unique_layers_on_random_maps(seed, groups):
    """Random maps with repeats (a target up to ~6 times), 1D and per
    group: the layers are collision-free and cover every column once; a
    target that repeats k times spreads over k layers at least."""
    rng = np.random.default_rng(seed)
    n = 200
    shape = (n,) if groups is None else (groups, n)
    rows = rng.integers(0, 40, shape)
    layers = scatter.unique_layers(rows)
    _held(rows, layers)
    most = max(np.bincount(r).max()
               for r in np.asarray(rows).reshape(-1, n))
    assert len(layers) >= most
    if groups is None:
        assert len(layers) == most  # 1D: exactly the largest repeat
    # a map with no repeats is one layer
    assert len(scatter.unique_layers(np.arange(7))) == 1


def _sums(out0, dim, index, src, layers):
    """(layered, index_add_) sums of ``src`` into ``out0`` along dim."""
    got = scatter.index_add_layered_(out0.clone(), dim, index, src, layers)
    want = out0.clone().index_add_(dim, index, src)
    return got, want


def _close(got, want, tol=1e-15):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= tol * scale


def test_layered_sums_equal_index_add_on_random_maps():
    """In f64 the layered sum equals index_add_ and pbte_tpu's scatter
    (``.at[].add``) to 1e-15 of max, on rows of several dims, and
    scatter_add_layered_ equals scatter_add_ along the last axis."""
    rng = np.random.default_rng(7)
    idx = torch.from_numpy(rng.integers(0, 30, 120))
    src = torch.from_numpy(rng.standard_normal((120, 3, 4)))
    out0 = torch.from_numpy(rng.standard_normal((30, 3, 4)))
    layers = scatter.unique_layers(idx)
    got, want = _sums(out0, 0, idx, src, layers)
    _close(got, want)
    ref = jnp.asarray(out0.numpy()).at[jnp.asarray(idx.numpy())].add(
        jnp.asarray(src.numpy()))
    _close(got, ref)
    # along dim 1 of a (G, N, ...) tensor
    out1 = torch.from_numpy(rng.standard_normal((2, 30, 5)))
    src1 = torch.from_numpy(rng.standard_normal((2, 120, 5)))
    got, want = _sums(out1, 1, idx, src1, layers)
    _close(got, want)
    # per-group positions along the last axis
    pos = torch.from_numpy(rng.integers(0, 30, (3, 50)))
    val = torch.from_numpy(rng.standard_normal((3, 2, 4, 50)))
    base = torch.from_numpy(rng.standard_normal((3, 2, 4, 30)))
    lay = scatter.unique_layers(pos)
    _held(pos.numpy(), lay)
    got = scatter.scatter_add_layered_(base.clone(), pos, val, lay)
    want = base.clone().scatter_add_(
        -1, pos[:, None, None, :].expand(3, 2, 4, 50), val)
    _close(got, want)


@functools.lru_cache(maxsize=None)
def _problem(case, build=problem.unit_cube):
    periodic, bcs, kw = CLOSURES[case]
    prob = build(8, 8, 8, order=1, polar=2, azimuth=8, nspec=2,
                 periodic=periodic)
    return prob, bcs, kw


def _solver(case, dtype=torch.float64, **extra):
    prob, bcs, kw = _problem(case)
    return SourceIterationSolver(*prob, bcs, dtype=dtype, device="cpu",
                                 **kw, **extra)


@pytest.mark.parametrize("case", list(CLOSURES))
def test_ring_closure_maps_layer(case):
    """The ring's closure maps (rows of ``per_uid``, ``refl_uid`` per
    bucket, as ``_closure_sources`` adds them): collision-free layers, and
    the layered sums equal index_add_ and ``.at[].add`` on seeded values
    (1e-15 of max, f64). Elements on an edge between two walls of one
    kind repeat: there a map needs more than one layer."""
    s = _solver(case)
    assert s.sweep_mode == "ring" and s._general is False
    rng = np.random.default_rng(1)
    most = 1
    for bi, cb in enumerate(s.consts["buckets"]):
        n_u = s._closure_u[bi]
        for key in ("per_uid", "refl_uid"):
            if key not in cb:
                continue
            uid = cb[key]
            rows = (s._bucket_gi[bi] * n_u + uid).reshape(-1)
            layers = scatter.unique_layers(rows)
            _held(rows.numpy(), layers)
            most = max(most, len(layers))
            src = torch.from_numpy(rng.standard_normal((rows.numel(), 2, 3)))
            out0 = torch.zeros((cb["xmap"].shape[1] * n_u, 2, 3),
                               dtype=torch.float64)
            got, want = _sums(out0, 0, rows, src, layers)
            _close(got, want)
            _close(got, jnp.zeros(out0.shape).at[jnp.asarray(
                rows.numpy())].add(jnp.asarray(src.numpy())))
    assert (most > 1) == (case in EDGES)


@pytest.mark.parametrize("case", ["periodic", "diffuse", "specular"])
def test_scan_closure_maps_layer(case):
    """The scan's ``per_pos``, ``dif_pos`` and ``spc_pos`` (per group, along
    the element axis): collision-free layers, and the layered scatter
    equals ``scatter_add_`` (1e-15 of max, f64)."""
    s = _solver(case, sweep_mode="scan")
    c = s._scan.consts
    key = dict(periodic="per_pos", diffuse="dif_pos", specular="spc_pos")[case]
    rng = np.random.default_rng(2)
    pos = c[key]
    layers = scatter.unique_layers(pos)
    _held(pos.numpy(), layers)
    assert (len(layers) > 1) == (case in EDGES)
    G, P = pos.shape
    val = torch.from_numpy(rng.standard_normal((G, 2, 3, P)))
    base = torch.from_numpy(rng.standard_normal((G, 2, 3, s.ne)))
    got = scatter.scatter_add_layered_(base.clone(), pos, val, layers)
    want = base.clone().scatter_add_(
        -1, pos[:, None, None, :].expand(G, 2, 3, P), val)
    _close(got, want)


def test_closures_match_pbte_tpu_and_repeat():
    """The slice end to end: the port's ring with periodic, diffuse and
    specular walls (its closure sums layered) against pbte_tpu's f64 XLA
    ring from the same problem, 3 steps at 1e-12 of max, and the port's
    steps repeated bit for bit."""
    prob, bcs, kw = _problem("all", torch_golden.jax_unit_cube)
    js = JaxSolver(*prob, bcs, dtype=jnp.float64, sweep_mode="ring",
                   use_pallas="off", **kw)
    ts = _solver("all")
    st = js.initial_state()
    for _ in range(3):
        st = js.step(*st)[:3]
    runs = []
    for _ in range(2):
        tst = ts.initial_state()
        for _ in range(3):
            tst = ts.step(*tst)[:3]
        runs.append(tst[1])
    _close(runs[0].numpy(), np.asarray(st[1]), 1e-12)
    assert torch.equal(runs[0], runs[1])


def _paths():
    """Small problems of each sweep path (name: a function that builds
    its solver)."""
    return {
        "lattice_ring": lambda: _solver("all", dtype=torch.float32),
        "scan": lambda: _solver("all", sweep_mode="scan"),
        "general_ring": lambda: _solver("all", sweep_mode="ring",
                                        use_lattice=False),
        "supercell_ring": lambda: SourceIterationSolver(
            *problem.tet_box(3, 2, 2, order=1, polar=2, azimuth=4, nspec=2),
            problem.WALL_BCS, device="cpu", supercell="on"),
        "multi_class_ring": lambda: SourceIterationSolver(
            *problem.graded_cube(8, order=1, polar=2, azimuth=4, nspec=2),
            problem.WALL_BCS, device="cpu"),
    }


def _path_of(s):
    if s._super is not None:
        return "supercell_ring"
    if s.sweep_mode == "scan":
        return "scan"
    if s._general:
        return "general_ring"
    return "multi_class_ring" if s._multi is not None else "lattice_ring"


@pytest.mark.parametrize("flag", [False, True])
@pytest.mark.parametrize("path", list(_paths()))
def test_solvers_leave_the_determinism_flag_alone(path, flag):
    """Building and stepping each sweep path leaves
    ``torch.are_deterministic_algorithms_enabled()`` as it found it (the
    port makes its scatters collision-free instead of setting the
    process's flag), and the steps repeat bit for bit."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(flag, warn_only=True)
    try:
        s = _paths()[path]()
        assert _path_of(s) == path
        tcs = []
        for _ in range(2):
            st = s.initial_state()
            for _ in range(2):
                st = s.step(*st)[:3]
            tcs.append(st[1])
        assert torch.are_deterministic_algorithms_enabled() is flag
        assert torch.equal(tcs[0], tcs[1])
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def _code_lines(path):
    """(line number, line) of a source file, comments dropped."""
    out = []
    for i, line in enumerate(path.read_text().splitlines(), 1):
        code = line.split("#", 1)[0] if path.suffix == ".py" else (
            line.split("//", 1)[0])
        if code.strip():
            out.append((i, code))
    return out


def test_no_colliding_float_scatter_in_the_package():
    """No index_add_, scatter_add_, scatter_reduce_ or index_put_(...,
    accumulate=True) under pbte_tpu_torch/ outside ops/scatter.py, and no
    process-wide determinism flag set by the package."""
    bad = []
    pat = re.compile(r"\b(index_add_?|scatter_add_?|scatter_reduce_?)\s*\(|"
                     r"accumulate\s*=\s*True|use_deterministic_algorithms|"
                     r"CUBLAS_WORKSPACE_CONFIG")
    for f in sorted(PKG_DIR.rglob("*.py")):
        if f == PKG_DIR / "ops" / "scatter.py":
            continue
        for i, code in _code_lines(f):
            if pat.search(code):
                bad.append(f"{f.relative_to(PKG_DIR)}:{i}: {code.strip()}")
    assert not bad, bad


@pytest.mark.parametrize("src", ["lattice_ring.cu", "lattice_ring_tiled.cu"])
def test_k1_sources_have_no_float_atomics(src):
    """K1's sources add no float by atomics: every atomicAdd takes the
    launch's int32 ticket counter, the band sum of ms runs in band order
    (the level flags' acquire and release, ``flag_wait`` and
    ``flag_release``), and the ms path stores with plain stores."""
    text = "\n".join(code for _, code in
                     _code_lines(PKG_DIR / "csrc" / src))
    calls = re.findall(r"atomicAdd\s*\(\s*([^,]+),", text)
    assert calls and set(calls) == {"scratch"}, calls
    assert not re.search(r"\bred\.\w*\.f|atom\.\w*\.f|float4\s*\*\s*>\s*\(ms",
                         text)
    assert "flag_wait(" in text and "flag_release(" in text
