"""bench_torch.py, the port's benchmark entry point, at a tiny size on the
CPU: its last line parses and has bench.py's keys, the extra rows are there,
and the entry point refuses to fall back from the GPU."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = {"PBTE_BENCH_NX": "8", "PBTE_BENCH_ORDER": "1", "PBTE_BENCH_POLAR": "2",
        "PBTE_BENCH_AZIMUTH": "4", "PBTE_BENCH_NSPEC": "1",
        "PBTE_BENCH_STEPS": "2"}
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
    proc = _run(["--device", "cpu"], {})
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
    """No baseline is measured (and the note says why), and a CPU run
    states no kernel share of a bound."""
    res = cpu_result
    assert res["vs_baseline"] is None
    assert res["cpp_baseline_dof_per_s"] is None
    assert "pbte_tpu/native" in res["baseline_note"]
    assert res["k1_share_of_bound"] is None
    assert "max_memory_allocated" not in res["rows"]["f32"]


def test_rows(cpu_result):
    """The six rows; each extra row ran under its own settings, the
    float64 ones in float64 (the accelerated row to its tolerance)."""
    rows = cpu_result["rows"]
    assert list(rows) == ["f32", "bf16_state", "diffuse_walls", "p3_f32",
                          "f64_state", "f64_bicgstab"]
    acc = rows.pop("f64_bicgstab")
    for name, row in rows.items():
        assert "error" not in row, (name, row)
        assert row["dof_per_s"] > 0 and row["ms_per_step"] > 0
        assert row["windows"]
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
    """A failing extra row becomes {"error": ...} (as the p3_f32 row does on
    the GPU, where the kernel has no D = 64: its message names the ROADMAP
    item); a failing primary row ends the run."""
    import torch

    import bench_torch
    from pbte_tpu_torch.ops import lattice_ring as tlr

    v = torch.zeros((2, 1, 1, 2, 64, 16))
    with pytest.raises(ValueError, match="queue 2, K1 item 5"):
        tlr._kernel_args_ok(v, dict(v=v), False, (0, 4, 1))

    for k, val in TINY.items():
        monkeypatch.setenv(k, val)
    real = bench_torch.run_row

    def failing(name, *a, **kw):
        if name in ("p3_f32", "bf16_state"):
            raise ValueError(f"{name}: the CUDA kernel is built for D in "
                             f"(8, 27)")
        return real(name, *a, **kw)

    monkeypatch.setattr(bench_torch, "run_row", failing)
    assert bench_torch.main(["--device", "cpu"]) == 0
    rows = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["rows"]
    assert rows["p3_f32"] == {"error": "ValueError: p3_f32: the CUDA kernel "
                                       "is built for D in (8, 27)"}
    assert "error" in rows["bf16_state"] and "dof_per_s" in rows["f32"]
    assert "dof_per_s" in rows["diffuse_walls"]

    def primary_fails(name, *a, **kw):
        raise ValueError("primary")

    monkeypatch.setattr(bench_torch, "run_row", primary_fails)
    with pytest.raises(ValueError, match="primary"):
        bench_torch.main(["--device", "cpu"])
