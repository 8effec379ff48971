"""The C++ mirror of the reference's solver: the measured CPU baseline.

This package's copy of ``pbte_tpu/native/solver_native.cpp`` (verbatim) and
of the part of ``pbte_tpu/native/__init__.py`` that builds and calls it
(``_build_and_load``, ``get_solver_lib``, ``cpp_source_iteration``). The
source is compiled with ``g++ -O3 -fopenmp`` at first use into
``build/pbte_tpu_torch/native/`` at the root of the checkout, keyed by a
hash of the source, and loaded with ``ctypes``; nothing is built when the
module is imported. It is host code for numpy arrays: no CUDA, no torch.

Where pbte_tpu's loader returns None without a compiler (its callers fall
back to numpy), this one raises with the compiler's message: the baseline
has no fallback, and a benchmark that asks for it fails rather than
printing none.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent.parent / "build" / "pbte_tpu_torch" / "native"
_lock = threading.Lock()


def _build_and_load(src, lib_path, extra_flags=(), timeout=120):
    """Compile ``src`` into ``lib_path`` unless the library there was built
    from the same source (its recorded hash; mtimes are unreliable, a fresh
    checkout stamps all files identically), and load it. Portable -O3
    only: -march=native output can SIGILL if the build directory moves
    between machines. Raises RuntimeError with g++'s output when the build
    fails."""
    lib_path = Path(lib_path)
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    stamp = Path(str(lib_path) + ".sha256")
    src_hash = hashlib.sha256(Path(src).read_bytes()).hexdigest()
    fresh = False
    try:
        fresh = stamp.read_text().strip() == src_hash and lib_path.exists()
    except OSError:
        pass
    if not fresh:
        # a temporary of this process: concurrent builds do not collide
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", *extra_flags,
               str(src), "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True,
                           timeout=timeout)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{e.stderr}") from e
        except (subprocess.SubprocessError, OSError) as e:
            raise RuntimeError(f"{' '.join(cmd)} failed: {e}") from e
        os.replace(tmp, lib_path)
        stamp.write_text(src_hash)
    return ctypes.CDLL(str(lib_path))


_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64

_solver_lib = None


def get_solver_lib():
    """ctypes handle to the C++ source-iteration solver (built at first
    use; raises when it cannot be built)."""
    global _solver_lib
    with _lock:
        if _solver_lib is not None:
            return _solver_lib
        lib = _build_and_load(
            _HERE / "solver_native.cpp", BUILD_DIR / "_solver_native.so",
            extra_flags=("-fopenmp",), timeout=180,
        )
        lib.pbte_cpp_source_iteration.restype = ctypes.c_int32
        lib.pbte_cpp_source_iteration.argtypes = (
            [_i64] * 7 + [ctypes.c_int32]
            + [_i32p, _i32p]
            + [_f64p] * 13
            + [ctypes.c_double, ctypes.c_double]
            + [_f64p] * 5
        )
        _solver_lib = lib
        return _solver_lib


def cpp_source_iteration(ops, quad, tables, bc_temps, n_iter,
                         use_full_lu=True, state=None):
    """Run the C++ reference-mirror solver; returns (u, Tc, Tv, residuals,
    iter_seconds).

    Mirrors the reference algorithm exactly (same operators, same lagged-Tc
    source iteration; ref: src/PBTESolver.cpp:208-332): the measured
    baseline ``bench_torch.py`` compares the port against. ``state`` (u,
    Tc, Tv) resumes an earlier run; u is (K, BS, ne, D)."""
    if ops.periodic.any():
        raise NotImplementedError(
            "the C++ baseline solver does not support periodic meshes"
        )
    lib = get_solver_lib()
    from pbte_tpu_torch.models import macroscopic
    from pbte_tpu_torch.sweep import planner

    ne, D, nf, dim = ops.num_elements, ops.ndof, ops.faces_per_elem, ops.dim
    K = quad.num_directions
    inv_kn = np.ascontiguousarray(tables.flat("inv_kn"), dtype=np.float64)
    vg = np.ascontiguousarray(tables.flat("vg"), dtype=np.float64)
    heat_cap = np.ascontiguousarray(tables.flat("heat_cap"), dtype=np.float64)
    BS = len(inv_kn)
    dt_inv = float(inv_kn.max())
    dirs = np.ascontiguousarray(quad.directions[:, :dim], dtype=np.float64)
    orders = planner.greedy_orders(ops.neighbor, ops.normals, quad.directions)
    orders = np.ascontiguousarray(orders, dtype=np.int32)
    fdot = np.ascontiguousarray(
        np.einsum("efd,kd->kef", ops.normals, dirs), dtype=np.float64
    )
    mw = np.ascontiguousarray(
        macroscopic.macro_weights(quad, tables), dtype=np.float64
    )
    bc_T = np.zeros((ne, nf))
    for attr, T in bc_temps.items():
        bc_T[ops.face_attr == int(attr)] = float(T)

    if state is None:
        u = np.zeros((K, BS, ne, D))
        Tc = np.zeros((ne, D))
        Tv = np.zeros(ne)
    else:
        u, Tc, Tv = (np.ascontiguousarray(a, dtype=np.float64) for a in state)
    resid = np.zeros(n_iter)
    secs = np.zeros(n_iter)
    rc = lib.pbte_cpp_source_iteration(
        ne, nf, D, dim, K, BS, n_iter, 1 if use_full_lu else 0,
        np.ascontiguousarray(ops.neighbor, dtype=np.int32), orders,
        dirs, fdot,
        np.ascontiguousarray(ops.mass, dtype=np.float64),
        np.ascontiguousarray(ops.stiff, dtype=np.float64),
        np.ascontiguousarray(ops.face_mass, dtype=np.float64),
        np.ascontiguousarray(ops.face_int, dtype=np.float64),
        np.ascontiguousarray(ops.coupling, dtype=np.float64),
        np.ascontiguousarray(bc_T, dtype=np.float64),
        np.ascontiguousarray(ops.basis_int, dtype=np.float64),
        inv_kn, vg, heat_cap, mw, dt_inv, float(quad.total_weight),
        u, Tc, Tv, resid, secs,
    )
    if rc != 0:
        raise RuntimeError(f"pbte_cpp_source_iteration failed rc={rc}")
    return u, Tc, Tv, resid, secs
