"""K2 and K3, the streaming copies: pbte_tpu_torch's plain version and its
wrappers on CPU tensors against the Pallas copy kernels of
scripts/bench_pallas_dma.py run by the Pallas interpreter, on the same
input; and the copy probe's host code. The CUDA kernels run only on a GPU
and are held bit-exact to their input there by chip_smoke.py."""

import functools
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pbte_tpu_torch import bench_dma, tracing
from pbte_tpu_torch.ops import dma_copy

REPO = pathlib.Path(__file__).resolve().parents[1]
ROWS = 64  # the (64, 128) f32 input the interpreter copies in well under 1 s


@pytest.fixture(scope="module")
def script():
    """scripts/bench_pallas_dma.py as a module (nothing in it is edited)."""
    spec = importlib.util.spec_from_file_location(
        "bench_pallas_dma", REPO / "scripts" / "bench_pallas_dma.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(script, monkeypatch):
    """Run the script's pallas_call under the Pallas interpreter."""
    monkeypatch.setattr(
        script.pl, "pallas_call",
        functools.partial(script.pl.pallas_call, interpret=True))
    return script


def _x(rows=ROWS, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (rows, dma_copy.LANE)).astype(np.float32)


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _rows_for(rows_per_block):
    """A total of at least ROWS rows and two blocks, a whole number of
    blocks (the Pallas kernels copy whole blocks only)."""
    return rows_per_block * max(2, -(-ROWS // rows_per_block))


def _cu_constant(name):
    """An integer constexpr of csrc/dma_copy.cu (a product of literals)."""
    src = (REPO / "pbte_tpu_torch" / "csrc" / "dma_copy.cu").read_text()
    expr = re.search(rf"constexpr int {name} = ([0-9 *]+);", src).group(1)
    return int(np.prod([int(t) for t in expr.split("*")]))


def test_copy_ref_matches_xla_copy(script):
    x = _x()
    want = np.asarray(script.xla_copy()(jnp.asarray(x)))
    got = dma_copy.copy_ref(torch.from_numpy(x)).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(got), _bits(x))


@pytest.mark.parametrize("rows_per_block",
                         sorted({8, 16, 32, 64, *bench_dma.AUTO_ROWS}))
def test_auto_copy_matches_pallas_interpret(interpret, rows_per_block):
    rows = _rows_for(rows_per_block)
    x = _x(rows, seed=rows_per_block)
    want = np.asarray(interpret.auto_copy(rows_per_block, rows)(
        jnp.asarray(x)))
    got = dma_copy.auto_copy(torch.from_numpy(x), rows_per_block)
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    assert torch.equal(got, torch.from_numpy(x))


@pytest.mark.parametrize("n_bufs", [2, 3, 4])
@pytest.mark.parametrize("rows_per_block",
                         sorted({8, 16, *bench_dma.MANUAL_ROWS}))
def test_manual_copy_matches_pallas_interpret(interpret, rows_per_block,
                                              n_bufs):
    rows = _rows_for(rows_per_block)
    x = _x(rows, seed=10 * n_bufs + rows_per_block)
    want = np.asarray(interpret.manual_copy(rows_per_block, rows, n_bufs)(
        jnp.asarray(x)))
    got = dma_copy.manual_copy(torch.from_numpy(x), rows_per_block, n_bufs)
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    assert torch.equal(got, torch.from_numpy(x))


@pytest.mark.parametrize("rows", [ROWS + 8, 1000])
def test_wrappers_copy_ragged_totals_on_cpu(rows):
    """A total that is not a multiple of the block: exact copies, and CPU
    tensors never count as kernel launches."""
    x = torch.from_numpy(_x(rows, seed=rows))
    before = tracing.report()["counts"]
    assert torch.equal(dma_copy.auto_copy(x, 16), x)
    assert torch.equal(dma_copy.manual_copy(x, 16, 3), x)
    assert tracing.report()["counts"] == before


@pytest.mark.parametrize("case", [
    "noncontiguous", "not_16_bytes", "empty", "bad_bufs", "too_much_smem",
    "bad_threads", "zero_rows", "other_device", "auto_too_much_smem",
    "auto_threads_over_1024",
])
def test_argument_checks(case):
    """What the kernels do not take raises before any launch (host code,
    so it runs here)."""
    x = torch.zeros((32, dma_copy.LANE))
    call = functools.partial(dma_copy.manual_copy, rows_per_block=8,
                             n_bufs=2)
    if case == "noncontiguous":
        x = x.t()
    elif case == "not_16_bytes":
        x = torch.zeros(7)
    elif case == "empty":
        x = torch.zeros((0, dma_copy.LANE))
    elif case == "bad_bufs":
        call = functools.partial(dma_copy.manual_copy, n_bufs=5)
    elif case == "too_much_smem":
        call = functools.partial(dma_copy.manual_copy, rows_per_block=64,
                                 n_bufs=4)
    elif case == "bad_threads":
        call = functools.partial(dma_copy.auto_copy, threads=100)
    elif case == "zero_rows":
        call = functools.partial(dma_copy.auto_copy, rows_per_block=0)
    elif case == "other_device":
        x = x.to("meta")
    elif case == "auto_too_much_smem":  # a tile over a CTA's shared memory
        rows = (dma_copy.SMEM_LIMIT - dma_copy.BARRIER_BYTES) \
            // dma_copy.ROW_BYTES + 1
        call = functools.partial(dma_copy.auto_copy, rows_per_block=rows)
    elif case == "auto_threads_over_1024":
        call = functools.partial(dma_copy.auto_copy, threads=2048)
    with pytest.raises(ValueError):
        call(x)


def test_smem_layout_matches_the_kernels():
    """The wrappers' shared-memory sizes follow csrc/dma_copy.cu: a block of
    four mbarrier sets and two slot -> chunk tables (8 bytes a slot, up to
    max(N_BUFS) slots), 128-byte aligned, then K2's tile or K3's n_bufs
    in-stages and n_bufs out-stages."""
    assert _cu_constant("kBarrierBytes") == dma_copy.BARRIER_BYTES
    assert _cu_constant("kMaxBufs") == max(dma_copy.N_BUFS)
    assert _cu_constant("kSmemLimit") == dma_copy.SMEM_LIMIT
    assert dma_copy.BARRIER_BYTES % 128 == 0
    assert dma_copy.BARRIER_BYTES >= (4 + 2) * max(dma_copy.N_BUFS) * 8
    for r in (1, 16, 48):
        assert dma_copy.auto_smem_bytes(r) == dma_copy.BARRIER_BYTES + r * 512
        for b in dma_copy.N_BUFS:
            assert dma_copy.manual_smem_bytes(r, b) == (
                dma_copy.BARRIER_BYTES + 2 * b * r * 512)
    # the largest stage of each depth that fits is accepted, one more row
    # is refused before any launch
    x = torch.zeros((64, dma_copy.LANE))
    for b in dma_copy.N_BUFS:
        r = (dma_copy.SMEM_LIMIT - dma_copy.BARRIER_BYTES) // (2 * b * 512)
        assert dma_copy.manual_smem_bytes(r, b) <= dma_copy.SMEM_LIMIT
        assert torch.equal(dma_copy.manual_copy(x, r, b), x)
        with pytest.raises(ValueError):
            dma_copy.manual_copy(x, r + 1, b)


@pytest.mark.parametrize("rows_per_block,threads", [
    (1, 32), (8, 256), (16, 512), (32, 1024), (64, 1024), (128, 1024),
])
def test_auto_threads_keep_tile_bytes_per_sm(rows_per_block, threads):
    """K2's default CTA size puts about AUTO_SM_BYTES of tiles on an SM,
    within one CTA of 32 to 1024 threads."""
    assert dma_copy.auto_threads(rows_per_block) == threads
    ctas = dma_copy.SM_THREADS // threads
    tile = rows_per_block * dma_copy.ROW_BYTES
    if 32 < threads < 1024:
        assert ctas * tile == dma_copy.AUTO_SM_BYTES


def test_probe_sweep_fits_the_card():
    """Every row the probe runs fits one CTA's shared memory and covers
    n_bufs 2, 3, 4; the rows of a total follow the script's rounding."""
    names = [name for name, _, _ in bench_dma.configs()]
    assert len(names) == len(set(names))
    for name, _, info in bench_dma.configs():
        assert info["smem_per_cta"] <= dma_copy.SMEM_LIMIT, name
        if info["kernel"] == "K2":
            assert info["smem_per_cta"] == dma_copy.auto_smem_bytes(
                info["rows_per_block"])
            assert 32 <= info["threads"] <= 1024, name
            assert info["threads"] % 32 == 0, name
        else:
            assert info["smem_per_cta"] == dma_copy.manual_smem_bytes(
                info["rows_per_block"], info["n_bufs"])
    bufs = {info["n_bufs"] for _, _, info in bench_dma.configs()
            if info["kernel"] == "K3"}
    assert bufs == set(dma_copy.N_BUFS)
    assert bench_dma.total_rows_for(512) == 1_000_000
    assert bench_dma.total_rows_for(1) == 1952


def test_probe_refuses_tpu_artifacts_and_needs_a_gpu(tmp_path):
    """The probe never writes bench_artifacts/ (the TPU results) and exits
    1 without a GPU, writing nothing."""
    target = REPO / "bench_artifacts" / "pallas_dma_bw.json"
    before = target.read_bytes()
    assert bench_dma.main(["--out", str(target)]) == 2
    assert target.read_bytes() == before
    out = tmp_path / "dma.json"
    if not torch.cuda.is_available():
        assert bench_dma.main(["--out", str(out)]) == 1
        assert not out.exists()
