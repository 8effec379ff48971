"""Carry pbte_tpu's lattice-ring operators and state into this package.

``pbte_tpu``'s ``SourceIterationSolver`` on its lattice ring (the Pallas
kernel path, or the XLA ring ``_step_ring`` with its lagged closures) keeps
its operators in a ``consts`` pytree; mapped to numpy (for example with
``jax.tree.map(np.asarray, solver.consts)``) they become this package's
consts dict, so both packages can step from the same operators and the same
state. This module imports no JAX: it takes numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from pbte_tpu_torch.solver.source_iteration import (
    REFL_KEYS,
    checked_device,
    closure_scatter,
)


def _tensor(a, device):
    """numpy (or array-like) -> tensor on device, always a copy.

    bfloat16 arrays (ml_dtypes) go through float32, which torch.from_numpy
    can read, and come back as torch.bfloat16 (exact both ways). Integer
    arrays become int64 index tensors."""
    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16"
    if bf16:
        a = a.astype(np.float32)
    elif a.dtype.kind in "iu":
        a = a.astype(np.int64)
    t = torch.from_numpy(np.array(a, copy=True))  # read-only buffers too
    if bf16:
        t = t.to(torch.bfloat16)
    return t.to(device).contiguous()


# per-bucket periodic tables (the wrap sources; the targets become the
# port's closure_scatter tables)
_PER_KEYS = ("per_cpl", "per_cin", "per_sl", "per_sw")


def consts_from_numpy(np_consts: dict, device="cuda") -> dict:
    """pbte_tpu lattice-ring consts (numpy leaves) -> this package's consts.

    Takes the Pallas path's consts and the XLA ring's (``sweep_mode="ring"``
    with ``use_pallas="off"``; not hull-windowed, which no closure problem
    is). The folded factor is ``mats[bi][4]`` on both. The inflow
    coefficients move from pbte_tpu's ``(L, Gb, nf, Km, W)`` to the
    kernel's ``(L, Gb, Km, nf, W)`` layout. The periodic tables, which
    pbte_tpu ships as zero-valid dummies on every problem, are taken only
    when some entry is valid. ``device`` defaults to the GPU and raises
    without one (``device="cpu"`` for the CPU)."""
    device = checked_device(device)
    mats = np_consts["mats"]
    periodic = bool(np.asarray(np_consts["per_valid"]).any())
    buckets = []
    for bi, cb in enumerate(np_consts["ring_b"]):
        b = dict(
            bcat=_tensor(mats[bi][4], device),
            cin=_tensor(np.transpose(cb["cin"], (0, 1, 3, 2, 4)), device),
            bsrc0=_tensor(cb["bsrc0"], device),
            macro_w=_tensor(cb["macro_w"], device),
        )
        if "dsrc0" in cb:
            b["dsrc0"] = _tensor(cb["dsrc0"], device)
        if periodic:
            b.update({k: _tensor(cb[k], device) for k in _PER_KEYS})
        if "refl_pl" in cb:
            b["refl_pl"] = _tensor(cb["refl_pl"], device)
            b["refl_pw"] = _tensor(cb["refl_pw"], device)
        if periodic or "refl_pl" in cb:
            L, _, W = np.asarray(np_consts["valid_slab"]).shape
            pairs = [None] * 4
            if periodic:
                pairs[:2] = np.asarray(cb["per_pl"]), np.asarray(cb["per_pw"])
            if "refl_pl" in cb:
                pairs[2:] = np.asarray(cb["refl_pl"]), np.asarray(cb["refl_pw"])
            scat = closure_scatter(L, W, *pairs)
            b["xmap"] = _tensor(scat.pop("xmap"), device).to(torch.int32)
            b.update({k: _tensor(v, device) for k, v in scat.items()})
        buckets.append(b)
    return dict(
        perm=_tensor(np_consts["perm"], device),
        valid_slab=_tensor(np_consts["valid_slab"], device),
        massT=_tensor(np.asarray(mats[0][2])[0, 0], device),
        wvec=_tensor(np_consts["wvec"], device),
        pos_of_elem=_tensor(np_consts["pos_of_elem"], device),
        ring_invMT=_tensor(np_consts["ring_invMT"], device),
        basis_int_glob=_tensor(np_consts["basis_int_glob"], device),
        flux_w=_tensor(np_consts["flux_w"], device),
        **{k: _tensor(np_consts[k], device) for k in REFL_KEYS
           if k in np_consts},
        buckets=tuple(buckets),
    )


def state_from_numpy(u, Tc, Tv, device="cuda", layout="bsd"):
    """pbte_tpu lattice-ring state (per-bucket slabs, Tc, Tv) -> tensors.

    ``layout`` names the slabs' trailing axes as pbte_tpu's checkpoints
    tag them: "bsd" for the Pallas path's ``(L, Gb, Km, BS, D, W)`` (this
    package's layout), "dbs" for the XLA ring's ``(L, Gb, Km, D, BS, W)``,
    whose BS and D axes are swapped here. ``device`` defaults to the GPU
    and raises without one (``device="cpu"`` for the CPU)."""
    device = checked_device(device)
    if layout not in ("bsd", "dbs"):
        raise ValueError(f"layout must be 'bsd' or 'dbs', got {layout!r}")
    if layout == "dbs":
        u = [np.swapaxes(np.asarray(ub), 3, 4) for ub in u]
    return (
        tuple(_tensor(ub, device) for ub in u),
        _tensor(Tc, device),
        _tensor(Tv, device),
    )
