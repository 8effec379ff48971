"""bench_torch.py, the port's benchmark entry point, at a tiny size on the
CPU: its last line parses and has bench.py's keys, the C++ baseline is
measured, the extra rows are there (the general ring's at the default
config refined 3 times), and the entry point refuses to fall back from the
GPU."""

import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = {"PBTE_BENCH_NX": "8", "PBTE_BENCH_ORDER": "1", "PBTE_BENCH_POLAR": "2",
        "PBTE_BENCH_AZIMUTH": "4", "PBTE_BENCH_NSPEC": "1",
        "PBTE_BENCH_STEPS": "2", "PBTE_BENCH_GENERAL_REFINE": "3"}
# bench.py:219-231, less frac_f32_peak (a share of a TPU's matmul peak),
# which k1_share_of_bound stands in for
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline",
              "cpp_baseline_dof_per_s", "shape", "rows"}


def _run(args, env_extra, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(REPO), **TINY, **env_extra)
    env.pop("PBTE_RING_STATE_BF16", None)
    return subprocess.run([sys.executable, "bench_torch.py", *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


@pytest.fixture(scope="module")
def cpu_result():
    proc = _run(["--device", "cpu", "--p3-wide"], {})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_last_line_has_bench_keys(cpu_result):
    """8 directions x 2 bands on hex 8^3 p=1, 2 timed steps."""
    res = cpu_result
    assert BENCH_KEYS <= res.keys()
    assert "frac_f32_peak" not in res
    assert res["metric"] == "element_ordinate_dof_per_s"
    assert res["unit"] == "dof/s"
    assert res["shape"] == {"ne": 512, "D": 8, "K": 8, "BS": 2}
    assert res["value"] == res["rows"]["f32"]["dof_per_s"] > 0
    assert res["device"] == "cpu" and res["steps"] == 2


def test_no_device_number_from_a_cpu_run(cpu_result):
    """The C++ baseline is measured (a host number: on a CPU run
    ``vs_baseline`` compares two CPU runs), as bench.py measures it, on the
    8-direction subset; a CPU run states no kernel share of a bound and no
    device memory."""
    res = cpu_result
    assert res["cpp_baseline_dof_per_s"] > 0
    assert res["vs_baseline"] == pytest.approx(
        res["value"] / res["cpp_baseline_dof_per_s"])
    assert res["cpp_baseline"]["iters"] == 1
    assert res["cpp_baseline"]["directions"] == 8
    assert res["cpp_baseline"]["seconds"] > 0
    assert "baseline_note" not in res
    assert res["k1_share_of_bound"] is None
    assert "max_memory_allocated" not in res["rows"]["f32"]


def test_rows(cpu_result):
    """The twelve rows with --p3-wide; each extra row ran under its own
    settings, the float64 ones in float64 (the accelerated row to its
    tolerance); the tet rows are held by test_tet_scan_row and
    test_tet_super_row, the wide and graded lattices by
    test_wide_and_graded_rows, the p3_wide_f64 row by test_p3_wide_row,
    the general ring's by test_general_ring_row."""
    rows = dict(cpu_result["rows"])
    assert list(rows) == ["f32", "bf16_state", "diffuse_walls", "p3_f32",
                          "f64_state", "wide_f32", "graded_f32",
                          "p3_wide_f64", "f64_bicgstab", "tet_scan",
                          "tet_super", "general_ring"]
    rows.pop("general_ring")
    rows.pop("tet_scan")
    rows.pop("tet_super")
    rows.pop("p3_wide_f64")
    acc = rows.pop("f64_bicgstab")
    for name, row in rows.items():
        assert "error" not in row, (name, row)
        assert row["dof_per_s"] > 0 and row["ms_per_step"] > 0
        # the multi-class ring runs the full slab
        assert row["windows"] == (name != "graded_f32")
        assert row["state"] == {"bf16_state": "torch.bfloat16",
                                "f64_state": "torch.float64"}.get(
                                    name, "torch.float32")
    assert rows["diffuse_walls"]["residual"] != rows["f32"]["residual"]
    assert "error" not in acc, acc
    assert acc["state"] == "torch.float64"
    assert 0 < acc["linear_relres"] < acc["tol"] == 1e-8
    assert 3 <= acc["step_applications"] < 1500
    assert acc["wall_s"] > 0 and acc["ms_per_step_application"] > 0
    assert "max_memory_allocated" not in acc


def test_p3_wide_row(cpu_result):
    """The p3_wide_f64 row ran in its child process: hex 14^3 here (7/4 of
    the run's 8 per axis, W = 196) with the run's order, angles and bands,
    float64 state on the lattice ring, its set-up and the host's peak
    memory recorded."""
    row = cpu_result["rows"]["p3_wide_f64"]
    assert "error" not in row, row
    assert row["state"] == "torch.float64" and row["sweep_mode"] == "ring"
    assert row["shape"] == {"ne": 2744, "D": 8, "K": 8, "BS": 2, "W": 196,
                            "nx": 14, "order": 1}
    assert row["dof_per_s"] > 0 and row["setup_s"] > 0
    assert row["host_peak_rss_gb"] > 0
    assert "k1_share_of_bound" not in row  # a device number: GPU only
    # the host memory at each stage the child reached (shares: GPU only)
    stages = row["stages"]
    assert [st["stage"] for st in stages] == [
        "start", "assembled", "constructed", "initial state", "first step",
        "warm-up", "timed", "done"]
    for st in stages:
        assert 0 < st["rss_gb"] <= st["hwm_gb"] and st["maxrss_gb"] > 0
        assert "device_peak_gb" not in st
    assert [st["s"] for st in stages] == sorted(st["s"] for st in stages)
    assert stages[2]["sweep_mode"] == "ring" and stages[2]["k1"]
    assert max(st["maxrss_gb"] for st in stages) <= row["host_peak_rss_gb"]


def test_wide_and_graded_rows(cpu_result):
    """The wide lattice is 1.5 times the run's per axis (12^3 here) on the
    lattice ring; the graded one is the run's lattice with its x spacing
    alternating 1 : 2, on the multi-class ring; both keep the run's order,
    angles and bands."""
    rows = cpu_result["rows"]
    assert rows["wide_f32"]["shape"] == {"ne": 1728, "D": 8, "K": 8,
                                         "BS": 2}
    assert rows["graded_f32"]["shape"] == {"ne": 512, "D": 8, "K": 8,
                                           "BS": 2}
    for name in ("wide_f32", "graded_f32"):
        assert rows[name]["sweep_mode"] == "ring"
        assert not rows[name]["supercell"]
        assert "k1_launches" not in rows[name]  # counted on the GPU only
    assert rows["graded_f32"]["residual"] != rows["f32"]["residual"]


def test_tet_scan_row(cpu_result):
    """The legacy tet row: the 5^3 6-tet cube on the scan path, f32, with
    the run's order, angles and bands (p=1, 8 directions, 2 bands here);
    the primary value stays the f32 flagship's."""
    row = cpu_result["rows"]["tet_scan"]
    assert "error" not in row, row
    assert row["sweep_mode"] == "scan" and not row["windows"]
    assert row["state"] == "torch.float32"
    assert row["shape"] == {"ne": 750, "D": 4, "K": 8, "BS": 2, "n": 5,
                            "order": 1}
    assert row["dof_per_s"] > 0 and row["ms_per_step"] > 0
    assert cpu_result["value"] == cpu_result["rows"]["f32"]["dof_per_s"]
    assert cpu_result["rows"]["f32"]["sweep_mode"] == "ring"


def test_tet_super_row(cpu_result):
    """The same tet shape with the solver's defaults: the supercell ring
    (125 super elements of D' = 6 D), timed, then solved to a Tv residual
    of 1e-7 with the residual read every 20 steps."""
    row = cpu_result["rows"]["tet_super"]
    assert "error" not in row, row
    assert row["sweep_mode"] == "ring" and row["supercell"]
    assert not row["windows"] and row["state"] == "torch.float32"
    assert row["shape"] == {"ne": 125, "D": 24, "K": 8, "BS": 2, "n": 5,
                            "order": 1}
    assert row["dof_per_s"] > 0 and row["ms_per_step"] > 0
    assert row["converge_residual"] < row["converge_tol"] == 1e-7
    assert row["converge_steps"] % 20 == 0 and row["converge_wall_s"] > 0
    assert not cpu_result["rows"]["tet_scan"]["supercell"]


def test_general_ring_row(cpu_result):
    """The default config refined 3 times (128 triangles, 24 in-plane
    directions, the run's 2 bands, consistent faces) on the general ring,
    f32, then on the scan, with its C++ baseline: a number, with
    vs_baseline the ring's DOF/s over it."""
    row = cpu_result["rows"]["general_ring"]
    assert "error" not in row, row
    assert row["sweep_mode"] == "ring" and not row["supercell"]
    assert not row["windows"] and row["state"] == "torch.float32"
    assert row["shape"] == {"ne": 128, "D": 3, "K": 24, "BS": 2,
                            "refine": 3}
    assert row["dof_per_s"] > 0 and row["scan_ms_per_step"] > 0
    assert row["ring_over_scan"] == pytest.approx(
        row["ms_per_step"] / row["scan_ms_per_step"])
    assert row["cpp_baseline_dof_per_s"] > 0
    assert row["vs_baseline"] == pytest.approx(
        row["dof_per_s"] / row["cpp_baseline_dof_per_s"])
    assert row["residual"] == pytest.approx(row["scan_residual"], rel=1e-4)
    assert "max_memory_allocated" not in row


@pytest.mark.parametrize("arg,want", [
    ("no_ms=:PBTE_K1_NO_MS", ("no_ms", None, ("PBTE_K1_NO_MS",), set())),
    ("v=build/x.cu:A,@full,B", ("v", "build/x.cu", ("A", "B"), {"full"})),
    ("old=build/k1_old.cu:@nowin",
     ("old", "build/k1_old.cu", (), {"full", "nowin"})),
])
def test_bench_k1_design_arguments(arg, want):
    """bench_k1's --design NAME=[PATH][:DEFINE,...]: defines go to nvcc,
    @flags say how the design is launched (@nowin, an entry point from
    before the window argument, runs on the full slab only)."""
    from pbte_tpu_torch import bench_k1

    name, path, defines, flags = bench_k1.parse_design(arg)
    assert (name, path, defines, set(flags)) == want
    with pytest.raises(ValueError, match="unknown flags"):
        bench_k1.parse_design("x=:@fulll")


@pytest.mark.parametrize("states,want", [
    (["f64"], [(0, "f64", True), (1, "f64", True)]),
    (["f32", "bf16"], [(0, "f32", False), (0, "bf16", False),
                       (1, "f32", True), (1, "bf16", False)]),
    (None, None),
])
def test_bench_k1_cases(states, want):
    """bench_k1 times the float64 kernel at both flagship buckets with a
    Dirichlet source (the f64 flagship's launches), beside the f32 and bf16
    cases; --state keeps the cases of the types asked for, and an earlier
    source given as a design (the FMA kernel of commit fdfeb19: no flags)
    is timed in turns."""
    from pbte_tpu_torch import bench_k1

    got = bench_k1.cases_of(states)
    assert got == (list(bench_k1.CASES) if want is None else want)
    assert {s for _, s, _ in got} <= set(bench_k1.STATES)
    with pytest.raises(ValueError, match="unknown states"):
        bench_k1.cases_of(["f16"])
    assert bench_k1.parse_design("pr8=build/k1_pr8.cu") == (
        "pr8", "build/k1_pr8.cu", (), frozenset())


def test_extra_rows_can_be_skipped():
    proc = _run(["--device", "cpu"], {"PBTE_BENCH_ROWS": "0"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(res["rows"]) == ["f32"]


def test_default_device_is_the_gpu_and_never_falls_back():
    """Without --device the entry point asks for the GPU; with none it
    raises and prints no result."""
    proc = _run([], {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA GPU" in proc.stderr
    assert proc.stdout.strip() == ""


def test_an_extra_row_records_its_error_and_the_primary_raises(monkeypatch,
                                                               capsys):
    """A failing extra row becomes {"error": ...}; a failing primary row
    ends the run. The shape the GPU once refused for such a row (D = 64
    at W = 1537, past the 16 CTAs of the earlier cluster kernel) now gets a tiled plan
    within one CTA's shared memory."""
    import torch

    import bench_torch
    from pbte_tpu_torch.ops import lattice_ring as tlr

    v = torch.zeros((2, 1, 1, 2, 64, 1537), device="meta")
    plan = tlr._kernel_args_ok(v, dict(v=v), False, (0, 4, 1))
    assert plan.variant == "tiled" and plan.smem <= 232448
    assert (plan.C - 1) * plan.Wt < 1537 <= plan.C * plan.Wt

    for k, val in TINY.items():
        monkeypatch.setenv(k, val)
    real = bench_torch.run_row

    def failing(name, *a, **kw):
        if name in ("p3_f32", "bf16_state"):
            raise ValueError(f"{name}: an injected failure")
        return real(name, *a, **kw)

    monkeypatch.setattr(bench_torch, "run_row", failing)
    assert bench_torch.main(["--device", "cpu"]) == 0
    rows = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["rows"]
    assert rows["p3_f32"] == {"error": "ValueError: p3_f32: an injected "
                                       "failure"}
    # the p3_wide_f64 row runs only when asked for (--p3-wide)
    assert "p3_wide_f64" not in rows and "f64_bicgstab" in rows
    assert "error" in rows["bf16_state"] and "dof_per_s" in rows["f32"]
    assert "dof_per_s" in rows["diffuse_walls"]

    def primary_fails(name, *a, **kw):
        raise ValueError("primary")

    monkeypatch.setattr(bench_torch, "run_row", primary_fails)
    with pytest.raises(ValueError, match="primary"):
        bench_torch.main(["--device", "cpu"])


def test_p3_wide_child_stopped_past_its_host_memory(monkeypatch):
    """The p3_wide_f64 row's child is stopped once its host memory passes
    the limit the parent allows, and the row then says so, with the last
    stage the child logged."""
    import torch

    import bench_torch

    for k, val in TINY.items():
        monkeypatch.setenv(k, val)
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    monkeypatch.setattr(bench_torch, "P3_WIDE_HOST_LIMIT_GB", 0.02)
    row = bench_torch.p3_wide_row(torch.device("cpu"), 2,
                                  bench_torch.p3_wide_size(8))
    assert "past the 0.02 GB allowed" in row["error"], row
    assert row["exit"] != 0 and row["host_peak_gb"] > 0.02
    assert row["size"]["nx"] == 14
    last = row["last_stage"]
    assert last is None or re.search(
        r"p3_wide_f64 stage [a-z -]+ at [0-9.]+ s, host [0-9.]+ GB, peak "
        r"[0-9.]+ GB \(ru_maxrss [0-9.]+ GB\)", last), last


# (reads every 2 matvecs, cadence) -> where pbte_tpu's guard stops: a
# plateau of 60 matvecs after a gain at matvec 21, read at both cadences; a
# steady fall; the plateau read every 20 matvecs ends before its 6th read
def _plateau_reads(length):
    falls = [(n, 0.5 ** ((n - 1) // 2)) for n in range(3, 22, 2)]
    flat = [(n, falls[-1][1]) for n in range(23, 22 + length, 2)]
    return falls + flat + [(22 + length, 1e-9)]


REPLAY_CASES = {
    "plateau_every_read": (_plateau_reads(60), 2, 81),
    "steady_fall": ([(n, 0.5 ** n) for n in range(3, 60, 2)], 2, None),
    "plateau_cadence_20": (_plateau_reads(60), 20, None),
    "long_plateau_cadence_20": (_plateau_reads(160), 20, 141),
}


@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_bench_accel_replay(case):
    from pbte_tpu_torch import bench_accel

    reads, every, want = REPLAY_CASES[case]
    assert bench_accel.replay(reads, every) == want


def test_bench_accel_plateaus():
    from pbte_tpu_torch import bench_accel

    assert bench_accel.plateaus(_plateau_reads(60)) == [(21, 61)]
    assert bench_accel.plateaus(_plateau_reads(20)) == []
