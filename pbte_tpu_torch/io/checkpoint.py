"""Checkpoint / resume for the outer source iteration.

Port of ``pbte_tpu/io/checkpoint.py``: one ``.npz`` per checkpoint with the
solver state (u, Tc, Tv), the iteration, the residual and the problem's
fingerprint, verified on load. The fields and the fingerprint are
pbte_tpu's, so a checkpoint of one package loads in the other for the same
problem:

- scan path: ``u`` of shape (G, Km, BS, D, ne), no state kind;
- lattice ring: ``u_0 .. u_{n-1}`` per Km bucket with ``u_nbuckets``,
  ``u_layout`` and ``fp_state_kind = 1``. This package's ring state is
  pbte_tpu's Pallas layout (L, Gb, Km_b, BS, D, W): it writes
  ``u_layout="bsd"`` and loads ``"bsd"`` and pbte_tpu's XLA-ring ``"dbs"``
  (BS and D swapped);
- supercell ring: the same bucket fields in pbte_tpu's XLA-ring layout
  (L, Gb, Km_b, D', BS, W), tagged ``"dbs"`` (this package's ring holds
  (L, Gb, Km_b, BS, W, D') and permutes on save and load; ``"bsd"`` files
  load too), Tc per super element (ncell, D') and Tv per fine element.

The sharded solvers (``parallel.slab``, ``parallel.spatial``) write
pbte_tpu's files of their kind (the global state, gathered over the grid,
written by rank 0) and read their own slice: ``save_checkpoint`` and
``load_checkpoint`` hand them to the solver's methods of those names, which
use ``write_npz`` and ``read_npz``. Under ``dir_sharding`` every path's
file holds the full state (``gather_buckets``, rank 0 writes; Km as
rounded up to the dir ranks, as pbte_tpu records it) and each rank loads
its own slots and bands (``shard_buckets``). bfloat16 state is written as
float32 (exact) and loads back in the solver's state dtype.

pbte_tpu's hull-windowed XLA-ring checkpoints (``fp_ring_windowed``, state
``u_{bucket}_{segment}`` in 128-lane windows) do not store the windows'
slot offsets and are refused with a ValueError that says so.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pbte_tpu_torch.solver.super_ring import from_pbte_layout, to_pbte_layout

_POLICY = {"full": 0, "on-the-fly": 1, "eigen": 2}


def _fingerprint(solver) -> dict:
    """The problem's shape fields as pbte_tpu records them; the state kind
    marks the ring's mass-transformed state v = M^T u."""
    fp = dict(
        G=solver.G, Km=solver.Km, BS=solver.BS, D=solver.D, ne=solver.ne,
        K=solver.K, dt_inv=solver.dt_inv, ne_pad=solver.ne_pad,
        cache_policy=_POLICY[solver.cache_policy],
        use_pallas=0,  # pbte_tpu's field from a removed layout, always 0
    )
    if solver.sweep_mode == "ring":
        fp["state_kind"] = 1
    return fp


def _expected_u_shape(solver):
    if solver.sweep_mode == "ring":
        # the file's "bsd" layout (the "dbs" files swap BS and D)
        return [(solver.L, len(gs), km_b, solver.BS, solver.D, solver.W)
                for gs, km_b in solver._ring_buckets]
    return (solver.G, solver.Km, solver.BS, solver.D, solver.ne_pad)


def _np(t):
    """Host copy; bfloat16 upcast to float32 (lossless)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def write_npz(path: str, fields: dict, fp: dict):
    """Write ``fields`` and the fingerprint ``fp`` (as ``fp_*``) to
    ``path`` (``.npz`` appended if missing) through a sibling temporary
    file, so a crash mid-save keeps the previous checkpoint."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    final = path if path.endswith(".npz") else path + ".npz"
    tmp = final + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **fields,
                            **{f"fp_{k}": v for k, v in fp.items()})
    os.replace(tmp, final)


def read_npz(path: str, fp: dict):
    """The checkpoint's arrays after checking every field of the
    fingerprint ``fp`` (ValueError on a missing or different one)."""
    data = np.load(path)
    for k, v in fp.items():
        if f"fp_{k}" not in data:
            raise ValueError(f"checkpoint missing fingerprint field {k!r}")
        stored = data[f"fp_{k}"]
        if not np.allclose(stored, v):
            raise ValueError(
                f"checkpoint mismatch: {k} was {stored}, solver has {v}")
    return data


def save_checkpoint(path: str, solver, u, Tc, Tv, iteration: int,
                    residual: float):
    """Write the state to ``path`` (``.npz`` appended if missing) through a
    sibling temporary file, so a crash mid-save keeps the previous
    checkpoint. A sharded solver writes its own kind (collective)."""
    if hasattr(solver, "save_checkpoint"):
        return solver.save_checkpoint(path, u, Tc, Tv, iteration, residual)
    grid = getattr(solver, "dir_sharding", None)
    if grid is not None:
        # dir/band-sharded ring state: the full buckets, written by rank 0
        u = solver.gather_buckets(u)  # every path's full state
        if grid.rank != 0:
            grid.barrier()
            return
    if isinstance(u, (tuple, list)):  # bucketed ring state
        if solver._super is not None:
            u = [to_pbte_layout(b) for b in u]
        u_fields = {f"u_{i}": _np(b) for i, b in enumerate(u)}
        u_fields["u_nbuckets"] = len(u)
        u_fields["u_layout"] = "bsd" if solver._super is None else "dbs"
    else:
        u_fields = {"u": _np(u)}
    write_npz(path, dict(Tc=_np(Tc), Tv=_np(Tv), iteration=iteration,
                         residual=residual, **u_fields),
              _fingerprint(solver))
    if grid is not None:
        grid.barrier()


def accel_ckpt_saver(path: str, solver, Tv):
    """save_ckpt closure for Krylov-accelerated solves
    (``accel.bicgstab_outer``). Tv is not part of the Krylov state: the
    checkpoints carry the zeros the caller gives (the resumed solve
    recomputes Tv)."""

    def save_ckpt(u, Tc, nmv, res):
        save_checkpoint(path, solver, u, Tc, Tv, nmv, res)

    return save_ckpt


def load_checkpoint(path: str, solver):
    """Returns ((u, Tc, Tv), iteration, residual), the state on the
    solver's device, ready for ``solver.solve(state=...)`` (a sharded
    solver's: this rank's slice)."""
    if hasattr(solver, "load_checkpoint"):
        return solver.load_checkpoint(path)
    fp = _fingerprint(solver)
    data = read_npz(path, fp)
    if "fp_ring_windowed" in data or "u_nsegs" in data:
        raise ValueError(
            "checkpoint holds pbte_tpu's hull-windowed XLA-ring state (per "
            "bucket, per 128-lane window segment); the file does not record "
            "the segments' slot offsets, so it cannot be placed into the "
            "full (L, W) slab: resume it in pbte_tpu, or write it from "
            "pbte_tpu's Pallas path (use_pallas='on')")
    if "fp_state_kind" in data and "state_kind" not in fp:
        raise ValueError(
            "checkpoint mismatch: it holds ring state (v = M^T u) and the "
            "solver is on the scan path")
    want = _expected_u_shape(solver)
    put = dict(device=solver.device)
    if isinstance(want, list):  # bucketed ring state
        n = int(data["u_nbuckets"]) if "u_nbuckets" in data else -1
        if n != len(want):
            raise ValueError(
                f"checkpoint has {n} state buckets, solver expects "
                f"{len(want)}")
        layout = str(data["u_layout"]) if "u_layout" in data else None
        if layout not in ("bsd", "dbs"):
            raise ValueError(
                f"ring checkpoint without a known u_layout tag ({layout!r}): "
                "its (BS, D) axis order is not recorded")
        bufs = []
        for i, w in enumerate(want):
            arr = data[f"u_{i}"]
            if layout == "dbs":
                arr = np.swapaxes(arr, 3, 4)
            if tuple(arr.shape) != w:
                raise ValueError(
                    f"checkpoint u_{i} has shape {tuple(arr.shape)}, solver "
                    f"expects {w}")
            t = torch.as_tensor(arr, **put).to(solver.state_dtype)
            if solver._super is not None:  # (L, Gb, Km_b, BS, D', W) ->
                t = from_pbte_layout(t.transpose(3, 4))
            bufs.append(t)
        u = tuple(bufs)
        if getattr(solver, "dir_sharding", None) is not None:
            u = solver.shard_buckets(u)
    else:
        if "u" not in data or tuple(data["u"].shape) != want:
            got = tuple(data["u"].shape) if "u" in data else None
            raise ValueError(
                f"checkpoint u has shape {got}, solver expects {want}")
        u = torch.as_tensor(data["u"], **put).to(solver.dtype)
        if getattr(solver, "dir_sharding", None) is not None:
            u = solver.shard_buckets(u)
    Tc = torch.as_tensor(data["Tc"], **put).to(solver.dtype)
    Tv = torch.as_tensor(data["Tv"], **put).to(solver.dtype)
    return (u, Tc, Tv), int(data["iteration"]), float(data["residual"])
