"""Native (C++) host code: the sweep planner's kernels, the multilevel
partitioner and the C++ mirror of the reference's solver (the measured CPU
baseline).

This package's copies of ``pbte_tpu/native/sweep_native.cpp``,
``partition_native.cpp`` and ``solver_native.cpp`` (verbatim) and of
``pbte_tpu/native/__init__.py``'s loaders (``get_lib``, ``compute_levels``,
``greedy_orders``, ``inflow_signatures``, ``get_partition_lib``,
``partition_multilevel``, ``get_solver_lib``, ``cpp_source_iteration``).
Each source is compiled with g++ at first use into
``build/pbte_tpu_torch/native/`` at the root of the checkout, keyed by a
hash of the source, and loaded with ``ctypes``; nothing is built when the
module is imported. It is host code for numpy arrays: no CUDA, no torch.

Where pbte_tpu's loaders return None without a compiler, these raise with
the compiler's message (a failed build is remembered and raised again
without a second attempt). The planner and the partitioner catch that,
log it once and run their numpy forms, which give the same results; the
solver baseline has no fallback, and a benchmark that asks for it fails
rather than printing none.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
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
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64
log = logging.getLogger(__name__)

# name -> loaded CDLL, or the RuntimeError its build raised
_libs = {}
_logged = set()


def _cached_lib(name, src, flags=(), timeout=120, declare=None):
    """The library ``name`` built from ``src`` (once per process); a
    failed build raises the same RuntimeError at every later call."""
    with _lock:
        got = _libs.get(name)
        if got is None:
            try:
                got = _build_and_load(_HERE / src, BUILD_DIR / f"_{name}.so",
                                      extra_flags=flags, timeout=timeout)
                declare(got)
            except RuntimeError as e:
                got = e
            _libs[name] = got
    if isinstance(got, RuntimeError):
        raise got
    return got


def log_fallback(what, err):
    """Log once per ``what`` that a native kernel is not built and its numpy
    form runs instead."""
    if what not in _logged:
        _logged.add(what)
        log.warning("%s: native library unavailable, numpy fallback (%s)",
                    what, str(err).splitlines()[0])


def _declare_sweep(lib):
    lib.pbte_compute_levels.restype = ctypes.c_int32
    lib.pbte_compute_levels.argtypes = [
        _i64, _i64, _i64, _i64, _i32p, _f64p, _f64p, _i32p,
    ]
    lib.pbte_greedy_orders.restype = ctypes.c_int32
    lib.pbte_greedy_orders.argtypes = [
        _i64, _i64, _i64, _i64, _i32p, _f64p, _f64p, _i32p,
    ]
    lib.pbte_inflow_signature.restype = None
    lib.pbte_inflow_signature.argtypes = [
        _i64, _i64, _i64, _i64, _i32p, _f64p, _f64p, _u8p, _i64,
    ]


def get_lib():
    """The sweep planner's kernels (``sweep_native.cpp``), built at first
    use; raises RuntimeError when they cannot be built."""
    return _cached_lib("sweep_native", "sweep_native.cpp",
                       declare=_declare_sweep)


def _graph_args(neighbor, normals, directions):
    neighbor = np.ascontiguousarray(neighbor, dtype=np.int32)
    normals = np.ascontiguousarray(normals, dtype=np.float64)
    ne, nf = neighbor.shape
    dim = normals.shape[-1]
    dirs = np.ascontiguousarray(directions[:, :dim], dtype=np.float64)
    return ne, nf, dim, len(dirs), neighbor, normals, dirs


def compute_levels(neighbor, normals, directions):
    """Kahn levelization, (K, ne) int32; raises ValueError on a cycle."""
    lib = get_lib()
    ne, nf, dim, K, neighbor, normals, dirs = _graph_args(
        neighbor, normals, directions)
    levels = np.empty((K, ne), dtype=np.int32)
    rc = lib.pbte_compute_levels(ne, nf, dim, K, neighbor, normals, dirs,
                                 levels)
    if rc < 0:
        raise ValueError("cycle")
    return levels


def greedy_orders(neighbor, normals, directions):
    """The reference's greedy sweep orders, (K, ne) int32; raises
    ValueError when a pass stalls."""
    lib = get_lib()
    ne, nf, dim, K, neighbor, normals, dirs = _graph_args(
        neighbor, normals, directions)
    orders = np.empty((K, ne), dtype=np.int32)
    rc = lib.pbte_greedy_orders(ne, nf, dim, K, neighbor, normals, dirs,
                                orders)
    if rc < 0:
        raise ValueError("cycle")
    return orders


def inflow_signatures(neighbor, normals, directions):
    """Packed inflow-bit signatures (K, ceil(ne nf / 8)) uint8."""
    lib = get_lib()
    ne, nf, dim, K, neighbor, normals, dirs = _graph_args(
        neighbor, normals, directions)
    stride = (ne * nf + 7) // 8
    packed = np.empty((K, stride), dtype=np.uint8)
    lib.pbte_inflow_signature(ne, nf, dim, K, neighbor, normals, dirs, packed,
                              stride)
    return packed


def _declare_partition(lib):
    lib.pbte_partition_multilevel.restype = ctypes.c_int32
    lib.pbte_partition_multilevel.argtypes = [
        _i64, _i64, _i32p, _i64, _i64, _i64, ctypes.c_double, _i32p,
    ]


def get_partition_lib():
    """The C++ multilevel k-way partitioner (``partition_native.cpp``),
    built at first use; raises RuntimeError when it cannot be built."""
    return _cached_lib("partition_native", "partition_native.cpp",
                       declare=_declare_partition)


def partition_multilevel(neighbor, nparts, seed=0,
                         coarse_target_per_part=30, max_ratio=1.03):
    """Native multilevel k-way partition of the element dual graph: (ne,)
    int32, or None where the kernel reports a failure (the caller then runs
    the numpy form, as pbte_tpu's does)."""
    lib = get_partition_lib()
    neighbor = np.ascontiguousarray(neighbor, dtype=np.int32)
    ne, nf = neighbor.shape
    out = np.empty(ne, dtype=np.int32)
    rc = lib.pbte_partition_multilevel(
        ne, nf, neighbor, int(nparts), int(seed),
        int(coarse_target_per_part), float(max_ratio), out,
    )
    if rc != 0:
        return None
    return out


def _declare_solver(lib):
    lib.pbte_cpp_source_iteration.restype = ctypes.c_int32
    lib.pbte_cpp_source_iteration.argtypes = (
        [_i64] * 7 + [ctypes.c_int32]
        + [_i32p, _i32p]
        + [_f64p] * 13
        + [ctypes.c_double, ctypes.c_double]
        + [_f64p] * 5
    )


def get_solver_lib():
    """ctypes handle to the C++ source-iteration solver (built at first
    use; raises when it cannot be built)."""
    return _cached_lib("solver_native", "solver_native.cpp",
                       flags=("-fopenmp",), timeout=180,
                       declare=_declare_solver)


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
