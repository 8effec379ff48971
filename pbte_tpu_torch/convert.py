"""Carry pbte_tpu's lattice-ring operators and state into this package.

``pbte_tpu``'s ``SourceIterationSolver`` on its Pallas lattice path keeps
its operators in a ``consts`` pytree; mapped to numpy (for example with
``jax.tree.map(np.asarray, solver.consts)``) they become this package's
consts dict, so both packages can step from the same operators and the same
state. This module imports no JAX: it takes numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch


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


def consts_from_numpy(np_consts: dict, device="cpu") -> dict:
    """pbte_tpu Pallas-path consts (numpy leaves) -> this package's consts.

    The inflow coefficients move from pbte_tpu's ``(L, Gb, nf, Km, W)`` to
    the kernel's ``(L, Gb, Km, nf, W)`` layout."""
    mats = np_consts["mats"]
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
        buckets.append(b)
    return dict(
        perm=_tensor(np_consts["perm"], device),
        valid_slab=_tensor(np_consts["valid_slab"], device),
        massT=_tensor(np.asarray(mats[0][2])[0, 0], device),
        wvec=_tensor(np_consts["wvec"], device),
        pos_of_elem=_tensor(np_consts["pos_of_elem"], device),
        ring_invMT=_tensor(np_consts["ring_invMT"], device),
        basis_int_glob=_tensor(np_consts["basis_int_glob"], device),
        buckets=tuple(buckets),
    )


def state_from_numpy(u, Tc, Tv, device="cpu"):
    """pbte_tpu Pallas-path state (per-bucket slabs, Tc, Tv) -> tensors."""
    return (
        tuple(_tensor(ub, device) for ub in u),
        _tensor(Tc, device),
        _tensor(Tv, device),
    )
