"""``python -m pbte_tpu_torch.cli -p 2x2`` under ``torchrun --standalone
--nproc-per-node 4`` (gloo ranks on the CPU) against ``python -m
pbte_tpu.cli -p 2x2`` on a 4-device virtual CPU mesh, as subprocesses.

The cases of ``tests/test_cli.py``'s parallel runs: the quad lattice, which
both CLIs give the slab-lattice solver (K1's plain version in each shard),
and the triangle square, which both give the spatially sharded solver, each
writing the same files (host logs byte for byte, fields within 1e-10 of
max, f64, the ``.pvtu`` and its per-partition pieces); the parallel run's
file set against the serial run's (checkpoints included); BiCGStab under
``-p`` against the serial BiCGStab solve; a world size other than 4, which
exits with pbte_tpu's "needs 4 devices" message; and ``python -m
pbte_tpu_torch.validation`` against ``python -m pbte_tpu.validation``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from pbte_tpu_torch.io.outputs import compare_outputs, files
from test_torch_cli import F64_RTOL, REPO, checked, run_cli

SMALL = """\
angles:
  dimension: 2
  azimuth_points: 8
numerical:
  n_spectral: 3
"""
QUAD = ["-c", "small.yaml", "-m", "unit-square-quad", "-r", "2", "-o", "1",
        "--face-mode", "consistent", "--max-iter", "5", "--tol", "0",
        "--vtu"]
TRI = ["-c", "small.yaml", "-m", "unit-square-tri", "-o", "1",
       "--face-mode", "consistent", "--max-iter", "6", "--tol", "0",
       "--vtu", "--checkpoint", "ck.npz", "--checkpoint-every", "3"]
ACCEL = ["-c", "small.yaml", "-m", "unit-square-tri", "-o", "1",
         "--face-mode", "consistent", "--tol", "1e-9", "--max-iter", "3000",
         "--check-every", "10", "--dtype", "f64", "--accelerate", "bicgstab"]


def _env(n_devices=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    if n_devices:
        flags.append(f"--xla_force_host_platform_device_count={n_devices}")
    env["XLA_FLAGS"] = " ".join(flags)
    return env


def run_torchrun(args, cwd, nproc=4, timeout=300):
    """The port's CLI on ``nproc`` gloo ranks under torchrun."""
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", "pbte_tpu_torch.cli",
         "--platform", "cpu", *args], cwd=cwd, env=_env(),
        capture_output=True, text=True, timeout=timeout)


def run_jax_parallel(args, cwd, timeout=300):
    """pbte_tpu's CLI on a 4-device virtual CPU mesh."""
    return subprocess.run(
        [sys.executable, "-m", "pbte_tpu.cli", "--platform", "cpu", *args],
        cwd=cwd, env=_env(4), capture_output=True, text=True,
        timeout=timeout)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each (runner, case) once per module, on first use: returns its
    CompletedProcess and output directory."""
    cache = {}
    cases = {"quad": QUAD, "tri": TRI, "accel": ACCEL}

    def get(runner, case):
        if (runner, case) not in cache:
            cwd = tmp_path_factory.mktemp(f"{runner}_{case}")
            (cwd / "small.yaml").write_text(SMALL)
            args = cases[case] + ["--out", "out"]
            if runner == "port":
                proc = run_torchrun(args + ["-p", "2x2"], cwd)
            elif runner == "jax":
                proc = run_jax_parallel(args + ["-p", "2x2"], cwd)
            else:  # the port's serial run
                proc = run_cli("pbte_tpu_torch", args, cwd)
            cache[runner, case] = (checked(proc), cwd)
        return cache[runner, case]

    return get


def test_slab_lattice_matches_pbte_tpu(runs):
    """The quad lattice on the slab-lattice solver: the same files as
    pbte_tpu -p 2x2 (fields, slice, .pvtu pieces)."""
    (pt, ours), (pj, ref) = runs("port", "quad"), runs("jax", "quad")
    assert "slab-lattice solver" in pt.stdout
    assert "slab-lattice solver" in pj.stdout + pj.stderr
    errs = compare_outputs(ours / "out", ref / "out", F64_RTOL)
    assert {"log/Tc_all.txt", "log/coeff_all.txt", "vis/pbte_fields.pvtu",
            "vis/pbte_fields.000001.vtu"} <= set(errs)


def test_spatial_matches_pbte_tpu(runs):
    """The triangle square on the spatially sharded solver: the same files
    as pbte_tpu -p 2x2, a piece per partition (space rank) under the
    .pvtu."""
    (pt, ours), (pj, ref) = runs("port", "tri"), runs("jax", "tri")
    assert "parallel solver (general mesh" in pt.stdout
    assert "parallel solver (general mesh" in pj.stdout + pj.stderr
    errs = compare_outputs(ours / "out", ref / "out", F64_RTOL)
    pieces = {f for f in errs if f.startswith("vis/pbte_fields.0")}
    assert pieces == {f"vis/pbte_fields.{p:06d}.vtu" for p in range(2)}


def test_parallel_writes_the_serial_file_set(runs):
    """-p 2x2 writes the serial run's files (the .vtu as a .pvtu of
    per-partition pieces) and its checkpoints, which load back."""
    (_, par), (_, ser) = runs("port", "tri"), runs("serial", "tri")
    fp, fs = set(files(par / "out")), set(files(ser / "out"))
    assert fs - {"vis/pbte_fields.vtu"} == {f for f in fp
                                            if not f.startswith("vis/")}
    assert "vis/pbte_fields.pvtu" in fp
    assert (par / "ck.npz").exists() and (ser / "ck.npz").exists()
    ck = np.load(par / "ck.npz")
    assert int(ck["iteration"]) == 6 and int(ck["fp_nparts"]) == 2
    assert ck["u"].shape[0] == 2  # pbte_tpu's (P, G, Km, BS, D, ne_max)


def test_parallel_bicgstab_matches_serial(runs):
    """BiCGStab under -p converges to the serial fixed point (the
    block-Jacobi fixed point is the Gauss-Seidel one)."""
    (pt, par), (_, ser) = runs("port", "accel"), runs("serial", "accel")
    assert "bicgstab done" in pt.stdout
    na, nb = (np.array([float(x) for x in (d / "out/log/Tc_all.txt")
                        .read_text().split() if _isfloat(x)])
              for d in (ser, par))
    assert na.shape == nb.shape
    np.testing.assert_allclose(nb, na, rtol=0,
                               atol=1e-7 * float(np.abs(na).max()))


def _isfloat(x):
    try:
        float(x)
    except ValueError:
        return False
    return True


def test_parallel_needs_its_ranks(tmp_path):
    """-p 2x2 on one process exits non-zero with pbte_tpu's message and
    writes nothing."""
    (tmp_path / "small.yaml").write_text(SMALL)
    proc = run_cli("pbte_tpu_torch", QUAD + ["-p", "2x2"], tmp_path)
    assert proc.returncode != 0
    assert "needs 4 devices, found 1" in proc.stderr
    assert not (tmp_path / "output").exists()


def test_validation_entry_point(tmp_path):
    """python -m pbte_tpu_torch.validation prints pbte_tpu's partition
    statistics and exits 0 (all seven invariant checks pass)."""
    cmd = ["4", "--mesh", "unit-cube-tet", "--refine", "1", "--method",
           "multilevel"]
    out = {}
    for pkg in ("pbte_tpu_torch", "pbte_tpu"):
        proc = subprocess.run([sys.executable, "-m", f"{pkg}.validation",
                               *cmd], cwd=tmp_path, env=_env(),
                              capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "all validations passed" in proc.stdout
        out[pkg] = [ln for ln in proc.stdout.splitlines()
                    if "partition sizes" in ln or "edge cut" in ln]
    assert out["pbte_tpu_torch"] == out["pbte_tpu"] and out["pbte_tpu"]
