"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled at first
use into a shared library under ``build/pbte_tpu_torch/`` at the root of the
checkout, keyed by a hash of the source, the headers of ``csrc/`` (which it
may include) and the flags, and loaded with
``ctypes``. Nothing is built when a module is imported; ``load_all`` runs
one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from pbte_tpu_torch import tracing

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "pbte_tpu_torch"

# -Xptxas -v prints each kernel's registers, shared memory and spills into
# the build log
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    path: Path
    log: str  # nvcc's output, including the ptxas resource report


_locks_lock = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, Built] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH); the CUDA "
            "kernels of pbte_tpu_torch need the CUDA toolkit"
        )
    return found


def load(name: str, src: Path | None = None, defines=()) -> Built:
    """Compile ``csrc/<name>.cu`` (or the source ``src``, built and cached
    under ``name``, with ``-D`` for each of ``defines``) if no build for
    its hash exists, then load it, once a process (the stage
    ``pbte.setup.kernel_build``, ``tracing``). Raises RuntimeError with
    nvcc's stderr when the build fails."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        with tracing.stage("pbte.setup.kernel_build"):
            src = CSRC_DIR / f"{name}.cu" if src is None else Path(src)
            flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
            # the shared headers of csrc/ are part of every build's key
            headers = b"".join(h.read_bytes()
                               for h in sorted(CSRC_DIR.glob("*.cuh")))
            key = hashlib.sha256(
                src.read_bytes() + headers + " ".join(flags).encode()
            ).hexdigest()[:16]
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            so = BUILD_DIR / f"{name}_{key}.so"
            log_path = BUILD_DIR / f"{name}_{key}.log"
            if not so.is_file():
                tmp = BUILD_DIR / f"{so.name}.{os.getpid()}.tmp"
                cmd = [nvcc_path(), *flags, "-I", str(CSRC_DIR), "-o",
                       str(tmp), str(src)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(
                        f"nvcc failed (exit {proc.returncode}) building "
                        f"{src}:\n{' '.join(cmd)}\n{proc.stderr}"
                    )
                log_path.write_text(proc.stdout + proc.stderr)
                os.replace(tmp, so)
            log = log_path.read_text() if log_path.is_file() else ""
            built = Built(ctypes.CDLL(str(so)), so, log)
        _loaded[name] = built
        return built


def load_all(names, sources=None) -> dict[str, Built]:
    """``load`` every name, the nvcc builds running concurrently;
    ``sources`` maps a name to its ``(src, defines)`` where it is not
    ``csrc/<name>.cu`` as it stands."""
    names = list(names)
    sources = sources or {}

    def one(name):
        return load(name, *sources.get(name, ()))

    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(one, names)))
