"""pbte_tpu_torch's command-line interface against pbte_tpu's, as subprocesses.

``python -m pbte_tpu_torch.cli --platform cpu`` and ``python -m
pbte_tpu.cli --platform cpu`` (JAX_PLATFORMS=cpu) run with the same flags
from a scratch working directory and must write the same file set: the host
logs (mesh summary, angles, sweep orders, phonon properties, element
integrals) byte for byte, the fields (Tc_all.txt, coeff_all.txt, the
slices, the VTU, the residual history) as parsed floats within 1e-10 of
their largest value in float64 (``io.outputs.compare_outputs``, which also
lets a last printed digit round the other way). Cases: the demo config (the 2-element
triangle mesh on the scan path, 101 iterations), the hex lattice ``-r 1``
on the lattice ring (K1's plain version), the tet builtin on the scan, a
float32 run of the port against pbte_tpu's float64 files, and the demo
config at ``-r 6`` (8,192 triangles) on the general ring, pbte_tpu's
one-hot ring, 3 iterations without dumps: with its mfem-parity faces
(both diverge alike) and with consistent faces (the fields compared).
tests/test_torch_cli_flags.py has the boundary flags and the port's own
flag behaviour. Each pbte_tpu command runs once per module.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from pbte_tpu_torch.io.outputs import compare_outputs, files

REPO = pathlib.Path(__file__).resolve().parents[1]
F64_RTOL = 1e-10
# a float32 run against float64 files: pbte_tpu's f32 kernel tolerance
# (tests/test_pallas_ring.py), relative to the largest value
F32_RTOL = 2e-5
HEX = ["-m", "unit-cube-hex", "-r", "1", "-o", "1", "--face-mode",
       "consistent", "-ad", "3", "-ap", "2", "-az", "4", "--max-iter", "5",
       "--tol", "0", "--slice-z", "0.4", "--line-slice", "2", "0.5", "0.5",
       "--vtu"]
TET = ["-m", "unit-cube-tet", "-o", "1", "--face-mode", "consistent", "-ad",
       "3", "-ap", "2", "-az", "4", "--max-iter", "5", "--tol", "0"]


SQUARE_R6 = ["-r", "6", "--max-iter", "3", "--no-dumps"]


def run_cli(pkg, args, cwd, timeout=600, platform=("--platform", "cpu")):
    """One CLI subprocess of ``pkg`` ("pbte_tpu" or "pbte_tpu_torch") in
    ``cwd``; returns the CompletedProcess."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # one torch thread: the test problems are small, and the tests run
    # beside other workers
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f)
    return subprocess.run(
        [sys.executable, "-m", f"{pkg}.cli", *platform, *args], cwd=cwd,
        env=env, capture_output=True, text=True, timeout=timeout)


def checked(proc):
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc


def sweep_mode(proc):
    return re.search(r"solver\[(\w+)\]", proc.stdout).group(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Runs each (package, case) once per module, on first use; returns
    a function of (pkg, case) -> (CompletedProcess, output directory)."""
    cache = {}
    demo = ["-c", str(REPO / "config/config.yaml")]
    cases = {"demo": demo, "hex": HEX,
             "tet": TET, "hex_f32": HEX + ["--dtype", "f32"],
             "square_r6": demo + SQUARE_R6,
             "square_r6_consistent": demo + SQUARE_R6 + [
                 "--face-mode", "consistent"]}

    def get(pkg, case):
        if (pkg, case) not in cache:
            cwd = tmp_path_factory.mktemp(f"{pkg}_{case}")
            proc = checked(run_cli(pkg, cases[case] + ["--out", "out"], cwd))
            cache[pkg, case] = (proc, cwd / "out")
        return cache[pkg, case]

    return get


def test_demo_config(runs):
    """The demo config (config/config.yaml: the 2-element triangle mesh,
    p=1, 24 in-plane directions, 20 bands, 101 iterations, f64) on the
    port's scan path: all seven logs, T_slice.txt and the residual
    history."""
    (pt, ours), (pj, ref) = runs("pbte_tpu_torch", "demo"), runs(
        "pbte_tpu", "demo")
    assert sweep_mode(pt) == sweep_mode(pj) == "scan"
    errs = compare_outputs(ours, ref, F64_RTOL)
    assert sorted(errs) == ["2D/log/PBTE_NonGraySMRT_step_resisual.txt",
                            "2D/results/T_slice.txt", "log/Tc_all.txt",
                            "log/coeff_all.txt"]
    hist = np.loadtxt(ours / "2D/log/PBTE_NonGraySMRT_step_resisual.txt")
    assert hist.shape == (101, 2)
    assert len(files(ours)) == 9


def test_hex_lattice(runs):
    """unit-cube-hex -r 1 (512 hexes in refinement order) on the lattice
    ring, K1's plain version on the CPU: logs, fields, the 3D plane and
    line slices and the VTU."""
    (pt, ours), (pj, ref) = runs("pbte_tpu_torch", "hex"), runs(
        "pbte_tpu", "hex")
    assert sweep_mode(pt) == sweep_mode(pj) == "ring"
    errs = compare_outputs(ours, ref, F64_RTOL)
    for f in ("3D/results/T_slice_z.txt", "3D/results/T_line.txt",
              "vis/pbte_fields.vtu", "log/coeff_all.txt"):
        assert f in errs
    assert "ne=512" in pt.stdout


def test_tet_builtin(runs):
    """unit-cube-tet: both CLIs resolve the same sweep (the scan: 384
    tets are below the lattice and supercell gates) and write the same
    files."""
    (pt, ours), (pj, ref) = runs("pbte_tpu_torch", "tet"), runs(
        "pbte_tpu", "tet")
    assert sweep_mode(pt) == sweep_mode(pj)
    compare_outputs(ours, ref, F64_RTOL)


def test_f32_against_f64(runs):
    """The port's float32 run of the hex lattice against pbte_tpu's
    float64 run: the host logs byte-equal, the fields within pbte_tpu's f32
    tolerance of max (the port does not flush the f32 state's subnormals;
    ROADMAP.md section 3 records 2.5e-7 to 3.6e-7 of max unflushed)."""
    (pt, ours), (_, ref) = runs("pbte_tpu_torch", "hex_f32"), runs(
        "pbte_tpu", "hex")
    errs = compare_outputs(ours, ref, F32_RTOL)
    assert max(errs.values()) > 0.0  # a float32 run, not the f64 one


def test_default_config_refined_takes_the_general_ring(runs):
    """``-c config/config.yaml -r 6 --max-iter 3`` (the config's defaults:
    mfem-parity faces, f64): both CLIs exit 0 and sweep on a ring, the
    port's general ring where pbte_tpu takes its one-hot ring (G = 6, L =
    254, W = 64). The rank-one mfem-parity faces make this refined
    iteration diverge in both packages (the residual 1, 1, then NaN from
    an overflow; both scans do the same): the histories agree, NaNs in
    the same places, and the NaN fields are not compared."""
    (pt, ours), (pj, ref) = runs("pbte_tpu_torch", "square_r6"), runs(
        "pbte_tpu", "square_r6")
    assert sweep_mode(pt) == sweep_mode(pj) == "ring"
    assert "groups=6 levels<=254 width<=64" in pt.stdout
    assert "slab=254x64" in pt.stdout
    hist = "2D/log/PBTE_NonGraySMRT_step_resisual.txt"
    from pbte_tpu_torch.io.outputs import field_err

    assert field_err(ours / hist, ref / hist) <= F64_RTOL
    assert files(ours) == files(ref)


def test_default_config_refined_consistent_faces(runs):
    """The same at ``--face-mode consistent``, where the iteration
    converges: the fields (T_slice.txt, the residual history) within 1e-10
    of max of pbte_tpu's."""
    (pt, ours), (pj, ref) = runs("pbte_tpu_torch", "square_r6_consistent"), \
        runs("pbte_tpu", "square_r6_consistent")
    assert sweep_mode(pt) == sweep_mode(pj) == "ring"
    errs = compare_outputs(ours, ref, F64_RTOL)
    assert sorted(errs) == ["2D/log/PBTE_NonGraySMRT_step_resisual.txt",
                            "2D/results/T_slice.txt"]
    hist = np.loadtxt(ours / "2D/log/PBTE_NonGraySMRT_step_resisual.txt")
    assert np.isfinite(hist).all() and hist[-1, 1] < hist[0, 1]
