"""Streaming copies y = x: the plain PyTorch version and the CUDA kernels'
wrappers.

Port of the two Pallas TPU copy probes of ``scripts/bench_pallas_dma.py``:
``auto_copy`` (K2, the auto-pipelined copy over a grid of row blocks) and
``manual_copy`` (K3, an ``n_bufs``-deep hand-written async-copy pipeline).
``copy_ref`` is the counterpart of the script's ``xla_copy`` (``x + 0.0``).
The CUDA kernels are in ``csrc/dma_copy.cu``.

The TPU blocks are VMEM tiles of 0.5-8 MB; a CTA has at most 227 KB of shared
memory, so the port's sweep parameters are per-CTA bytes instead: K2's tile
(``rows_per_block`` rows of 128 float32 per CTA, moved into shared memory and
back by two TMA bulk copies, ``threads`` setting how many CTAs share an SM)
and K3's stage (``rows_per_block`` rows per pipeline stage, ``n_bufs``
stages in and ``n_bufs`` out per persistent CTA, with warp-specialised
producer, worker and store roles).

``auto_copy`` and ``manual_copy`` take the plain version for CPU tensors
and launch their kernel for CUDA tensors; they never fall back from one to
the other. Each launch adds one to the counter
``dma_copy.launches.auto`` or ``.manual`` (``tracing``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pbte_tpu_torch import tracing
from pbte_tpu_torch.ops import _build

LANE = 128  # float32 values per row, the script's lane width
ROW_BYTES = LANE * 4
VEC_BYTES = 16  # both kernels move whole 16-byte vectors
SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on Hopper
N_BUFS = (2, 3, 4)
SM_THREADS = 2048  # threads one Hopper SM holds at once
# K2's tile bytes in flight per SM: more CTAs per SM than this lowered the
# copy rate on an H100 (PERF.md, PR 3)
AUTO_SM_BYTES = 32 * 1024
# the block ahead of the buffers (csrc/dma_copy.cu kBarrierBytes): K3's four
# mbarrier sets (full, empty, out_ready, out_free) and its two slot -> chunk
# tables, max(N_BUFS) 8-byte entries each, padded to 128 bytes; K2 uses one
# mbarrier of it
BARRIER_BYTES = -(-(4 + 2) * max(N_BUFS) * 8 // 128) * 128


def copy_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch copy, ``x + 0.0`` (the script's ``xla_copy``)."""
    return x + 0.0


def auto_smem_bytes(rows_per_block: int) -> int:
    """Shared memory of one K2 CTA: the mbarrier block, then the tile."""
    return BARRIER_BYTES + rows_per_block * ROW_BYTES


def manual_smem_bytes(rows_per_block: int, n_bufs: int) -> int:
    """Shared memory of one K3 CTA: the mbarrier block, then n_bufs input
    and n_bufs output stages of rows_per_block rows."""
    return BARRIER_BYTES + 2 * n_bufs * rows_per_block * ROW_BYTES


def _check(x, rows_per_block, name):
    if rows_per_block < 1:
        raise ValueError(f"{name}: rows_per_block must be >= 1")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if x.numel() == 0 or (x.numel() * x.element_size()) % VEC_BYTES:
        raise ValueError(
            f"{name}: the kernel copies whole {VEC_BYTES}-byte vectors, got "
            f"{x.numel() * x.element_size()} bytes"
        )


def _check_cuda(x, name):
    if x.data_ptr() % VEC_BYTES:
        raise ValueError(f"{name}: x must be {VEC_BYTES}-byte aligned")


def _raise_on(lib, err, name):
    if err != 0:
        msg = lib.pbte_dma_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


@functools.cache
def _lib():
    lib = _build.load("dma_copy").lib
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pbte_dma_auto_copy.argtypes = [p, p, ll, i, i, p]
    lib.pbte_dma_auto_copy.restype = i
    lib.pbte_dma_manual_copy.argtypes = [p, p, ll, i, i,
                                         ctypes.POINTER(i), p]
    lib.pbte_dma_manual_copy.restype = i
    lib.pbte_dma_error_string.argtypes = [i]
    lib.pbte_dma_error_string.restype = ctypes.c_char_p
    return lib


def _device(x, name):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no copy kernel for device {x.device}")
    return x.device.type


def auto_threads(rows_per_block: int) -> int:
    """K2's CTA size for a tile of rows_per_block rows: enough threads that
    the CTAs sharing an SM (SM_THREADS / threads of them) hold about
    AUTO_SM_BYTES of tiles, within [32, 1024]."""
    tile = rows_per_block * ROW_BYTES
    return min(1024, max(32, SM_THREADS * tile // AUTO_SM_BYTES))


def auto_copy(x: torch.Tensor, rows_per_block: int = 32,
              threads: int | None = None) -> torch.Tensor:
    """K2: y = x, one CTA of ``threads`` threads per tile of
    ``rows_per_block`` rows of 128 float32 (``rows_per_block * 512``
    bytes); its thread 0 moves the tile into shared memory and back with
    two TMA bulk copies. The other threads do nothing: the CTA size only
    sets how many tiles share an SM (default ``auto_threads``)."""
    if threads is None:
        threads = auto_threads(rows_per_block)
    _check(x, rows_per_block, "auto_copy")
    if threads < 32 or threads > 1024 or threads % 32:
        raise ValueError(f"auto_copy: threads must be a multiple of 32 in "
                         f"[32, 1024], got {threads}")
    smem = auto_smem_bytes(rows_per_block)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"auto_copy: a tile of {rows_per_block} rows needs {smem} B of "
            f"shared memory, a CTA has {SMEM_LIMIT}"
        )
    if _device(x, "auto_copy") == "cpu":
        return copy_ref(x)
    _check_cuda(x, "auto_copy")
    y = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pbte_dma_auto_copy(
            x.data_ptr(), y.data_ptr(), x.numel() * x.element_size(),
            rows_per_block * ROW_BYTES, threads, stream,
        )
    _raise_on(lib, err, "auto_copy")
    tracing.count("dma_copy.launches.auto")
    return y


def manual_copy(x: torch.Tensor, rows_per_block: int = 16,
                n_bufs: int = 2) -> torch.Tensor:
    """K3: y = x through ``n_bufs`` pipeline stages of ``rows_per_block``
    rows (``rows_per_block * 512`` bytes) per persistent CTA."""
    _check(x, rows_per_block, "manual_copy")
    if n_bufs not in N_BUFS:
        raise ValueError(f"manual_copy: n_bufs must be in {N_BUFS}, got "
                         f"{n_bufs}")
    smem = manual_smem_bytes(rows_per_block, n_bufs)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"manual_copy: {n_bufs} x 2 stages of {rows_per_block} rows need "
            f"{smem} B of shared memory, a CTA has {SMEM_LIMIT}"
        )
    if _device(x, "manual_copy") == "cpu":
        return copy_ref(x)
    _check_cuda(x, "manual_copy")
    y = torch.empty_like(x)
    lib = _lib()
    grid = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pbte_dma_manual_copy(
            x.data_ptr(), y.data_ptr(), x.numel() * x.element_size(),
            rows_per_block * ROW_BYTES, n_bufs, ctypes.byref(grid), stream,
        )
    _raise_on(lib, err, "manual_copy")
    tracing.count("dma_copy.launches.manual")
    manual_copy.last_grid = grid.value
    return y


manual_copy.last_grid = 0
