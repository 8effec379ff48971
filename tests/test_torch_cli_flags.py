"""pbte_tpu_torch's command-line interface: its boundary flags against
pbte_tpu's CLI, and its own flag behaviour, as CPU subprocesses.

- ``--periodic 0`` and ``--diffuse 1`` on ``unit-square-quad -r 2`` (1,024
  quads: the lattice ring at D = 4 with the lagged closures, through the
  CLIs' flag handling; a small config of 8 in-plane directions and 2 x
  3 bands) against pbte_tpu's files, as tests/test_torch_cli.py compares
  them;
- checkpoint and resume: 6 + 4 iterations bit-equal to 10 straight;
- the angle overrides (-ad/-ap/-az/-aps/-aas) name the angles log;
- ``--vtu-every`` writes a ParaView collection, ``--profile`` a trace;
- ``--platform default`` without a GPU exits non-zero and writes no result.
"""

import json

import pytest
import torch

from pbte_tpu_torch.io.outputs import compare_outputs, files
from test_torch_cli import F64_RTOL, checked, run_cli, sweep_mode

# in-plane angles and 2 x 3 bands, no boundary conditions (the CLIs'
# defaults: attr 3 hot, the rest cold)
SMALL = """\
angles:
  dimension: 2
  azimuth_points: 8
numerical:
  n_spectral: 3
"""
QUAD = ["-c", "small.yaml", "-m", "unit-square-quad", "-r", "2", "-o", "1",
        "--face-mode", "consistent", "--max-iter", "5", "--tol", "0"]
TRI = ["-c", "small.yaml", "-m", "unit-square-tri", "-o", "1",
       "--face-mode", "consistent", "--tol", "0"]


@pytest.fixture(autouse=True)
def small_config(tmp_path):
    (tmp_path / "small.yaml").write_text(SMALL)


@pytest.mark.parametrize("flag", [["--periodic", "0"], ["--diffuse", "1"]],
                         ids=["periodic", "diffuse"])
def test_closure_flags(flag, tmp_path):
    """The periodic and diffuse flags on the quad lattice: both CLIs
    take the ring, pair or free the same faces, and write the same files
    (host logs byte-equal, fields within 1e-10 of max, f64)."""
    out = {}
    for pkg in ("pbte_tpu", "pbte_tpu_torch"):
        proc = checked(run_cli(pkg, QUAD + flag + ["--out", pkg], tmp_path))
        assert sweep_mode(proc) == "ring", proc.stdout
        assert ("periodic_faces=64" in proc.stdout) == (flag[0] == "--periodic")
        out[pkg] = proc
    compare_outputs(tmp_path / "pbte_tpu_torch", tmp_path / "pbte_tpu",
                    F64_RTOL)


def test_checkpoint_resume(tmp_path):
    """An interrupted run and --resume equal the uninterrupted run bit for
    bit on the CPU (Tc_all.txt and coeff_all.txt)."""
    full = checked(run_cli("pbte_tpu_torch",
                           TRI + ["--max-iter", "10", "--out", "full"],
                           tmp_path))
    ck = str(tmp_path / "ck.npz")
    checked(run_cli("pbte_tpu_torch",
                    TRI + ["--max-iter", "6", "--out", "p1", "--checkpoint",
                           ck, "--checkpoint-every", "6"], tmp_path))
    assert (tmp_path / "ck.npz").exists()
    second = checked(run_cli("pbte_tpu_torch",
                             TRI + ["--max-iter", "4", "--out", "p2",
                                    "--checkpoint", ck, "--resume"],
                             tmp_path))
    assert "resumed from" in second.stdout and "done: 10 iters" in \
        full.stdout
    for f in ("log/Tc_all.txt", "log/coeff_all.txt"):
        assert (tmp_path / "full" / f).read_text() == \
            (tmp_path / "p2" / f).read_text()


def test_angle_overrides(tmp_path):
    """-ad/-ap/-az/-aps/-aas override the config's angles block: the
    angles log's name and the direction count follow them; -ad 3 lifts the
    in-plane config to full solid angle on a 3D mesh."""
    proc = checked(run_cli(
        "pbte_tpu_torch",
        TRI + ["--max-iter", "2", "-ad", "2", "-ap", "1", "-az", "6", "-aas",
               "uniform"], tmp_path))
    assert (tmp_path / "output/log/angles_dim2_np1_gauss_na6_uniform.txt"
            ).exists(), files(tmp_path / "output")
    assert "K=6" in proc.stdout
    proc3 = checked(run_cli(
        "pbte_tpu_torch",
        ["-c", "small.yaml", "-m", "unit-cube-hex", "-o", "1", "--face-mode",
         "consistent", "--max-iter", "1", "--tol", "0", "-ad", "3", "-ap",
         "2", "-az", "4", "-aps", "uniform", "--out", "o3"], tmp_path))
    assert (tmp_path / "o3/log/angles_dim3_np2_uniform_na4_gauss.txt"
            ).exists()
    assert "K=8" in proc3.stdout


def test_vtu_every_and_profile(tmp_path):
    """--vtu-every writes collection cycles during the solve plus a final
    one; --profile writes a torch.profiler Chrome trace of the solve and
    the program's spans and counters."""
    proc = checked(run_cli(
        "pbte_tpu_torch",
        ["-c", "small.yaml", "-m", "unit-square-quad", "-o", "1",
         "--max-iter", "6",
         "--vtu-every", "3", "--no-dumps", "--profile", "prof", "--out",
         "out"], tmp_path))
    pvd = (tmp_path / "out/vis/pbte_fields/pbte_fields.pvd").read_text()
    for cyc in (3, 6):
        assert f"Cycle{cyc:06d}/data.pvtu" in pvd
        assert (tmp_path / f"out/vis/pbte_fields/Cycle{cyc:06d}/"
                "proc000000.vtu").exists()
    assert not (tmp_path / "out/log/Tc_all.txt").exists()  # --no-dumps
    traces = list((tmp_path / "prof").glob("*_trace.json"))
    assert len(traces) == 1 and "profiler trace written" in proc.stdout
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    # the program's spans and counters beside it (tracing.report())
    spans = json.loads((tmp_path / "prof/pbte_tpu_torch_spans.json")
                       .read_text())
    assert spans["spans"]["pbte.solve"]["calls"] == 1
    assert spans["spans"]["pbte.step"]["calls"] == 6
    assert spans["spans"]["pbte.step"]["parents"] == ["pbte.solve"]
    assert any(e.get("name") == "pbte.step" for e in events)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without a GPU")
def test_default_platform_needs_a_gpu(tmp_path):
    """Without --platform cpu the CLI solves on the GPU; with none it
    exits non-zero with the solver's message and writes nothing."""
    proc = run_cli("pbte_tpu_torch", TRI + ["--max-iter", "2"], tmp_path,
                   platform=())
    assert proc.returncode != 0
    assert "no CUDA GPU" in proc.stderr
    assert not (tmp_path / "output").exists()
