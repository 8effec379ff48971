"""The general ring: pbte_tpu's one-hot ring on meshes that are not box
lattices.

Port of the general branch of pbte_tpu's ``_step_ring``: its slab layout
over the sweep plan's levels, active faces and one-hot selection plan
(``pbte_tpu/solver/source_iteration.py:1187-1226``, ``ops/ring_plan.py``),
its per-element or class couplings (``:1325-1333``) and its level body
(``:3174-3183``): per level, the rhs; per active face, each receiving
slot's upwind neighbour, scaled by its inflow coefficient and coupled;
the class-selected factor apply and the band sum. pbte_tpu runs this body
in XLA, not in a Pallas kernel (its fused wavefront kernel was removed,
``pbte_tpu/ops/ring_plan.py:1-12``), so the port runs it as torch products
and launches no kernel.

Where pbte_tpu selects the upwind neighbours with one-hot matrices from a
ring of the last H solved levels, here each receiving slot reads its
neighbour from the sweep's output ``ys`` at the integer ``(level, slot)``
of ``ops.ring_plan.upwind_slots``: the neighbour's level is already there
whatever the gap H, so no one-hot and no H-deep ring is kept. State and
operands keep the lattice rings' layout, ``(L, Gb, Km, BS, D, W)`` per
bucket, and no level copies the state into another layout. A level runs:

- the rhs and, after the neighbour terms, the class factors and the band
  sum, as the multi-class lattice ring (``lattice_multi.LevelSweep``);
- one gather of every active face's upwind values ``(Gb, W, Km, BS,
  nf_act, D)`` from ``ys``, scaled by the inflow coefficients (zero where
  the one-hot has no entry: boundaries, padding, inactive faces);
- one batched product over the (group, slot) rows that applies every
  face's coupling at once, ``[x_0 | x_1 | ...] @ [C_0^T; C_1^T; ...]``.
  Where the coupling classes determine the couplings
  (``lattice_multi.coupling_classes``), a level gathers each slot's
  matrices from the ``(Q, D, D)`` class stack; elsewhere the per-element
  couplings ``(L, Gb W, nf_act D, D)`` are kept, as pbte_tpu's
  ``cpl_slab``.

float32 and float64 state; the float32 products run with TF32 off (the
caller's ``exact_f32_products`` scope). pbte_tpu gates its bf16 staging and
bf16 state on the lattice ring, so ``PBTE_RING_STATE_BF16=1`` leaves this
ring in float32 state, as there.
"""

from __future__ import annotations

import numpy as np
import torch

from pbte_tpu_torch.ops.ring_plan import upwind_slots
from pbte_tpu_torch.solver.lattice_multi import LevelSweep

# past this many bytes of the ring's device working set (three state-sized
# buffers, the factors, couplings and tables) sweep_mode="auto" scans; the
# 80 GB card's counterpart of pbte_tpu's one-hot (700e6 B) and state
# (4.5e9 B) budgets for its 16 GB chip
GENERAL_BUDGET = 60e9


def ring_bytes(n_slots, BS, D, L, W, G, Km, nf, ncls, itemsize):
    """An upper bound of the general ring's device working set in bytes:
    three state-sized buffers over ``n_slots`` (group, slot) pairs (the
    slots with a group's worth of padding, as pbte_tpu counts them), the
    class factors, per-element couplings on every face, the inflow
    coefficients and the int64 (level, slot) tables."""
    state = n_slots * BS * D * L * W
    ops = G * Km * BS * ncls * D * D + L * G * W * nf * (D * D + Km)
    return (3 * state + ops) * itemsize + 2 * 8 * L * G * W * nf


def bucket_tables(gs, km_b, a_cls, cls, couplings, perm_safe, pos_valid,
                  nbr_pos, act_f, act_valid, cin_act, L, W, put, iput,
                  ks=slice(None), bs=slice(None)):
    """A bucket's operands of the general ring, a dict of device tensors.

    ``gs`` the bucket's groups with ``km_b`` slots; ``a_cls`` (G, ncls,
    Km, BS, D, D) the class factors and ``cls`` (ne,) the element classes;
    ``couplings`` either ``(cpl, q_of)`` of ``lattice_multi.
    coupling_classes`` or the per-element couplings (ne, nf, D, D), each
    folded with its neighbour's M^-T; the slab layout ``perm_safe``,
    ``pos_valid`` (G, L W) and ``nbr_pos`` (G, nf, L W); the active faces
    ``act_f`` and ``act_valid`` (G, nf_act); ``cin_act`` (G, nf_act, Km,
    L W) their inflow coefficients on interior faces. ``put`` uploads in
    the solver dtype, ``iput`` as int64; ``ks`` and ``bs`` select this
    rank's slots of the bucket and bands under dir/band sharding.

    Keys: ``bstack`` and ``cls_oh`` as ``lattice_multi.MultiBucket``'s;
    ``nb_lev`` and ``nb_slot`` (L, Gb, W, 1, 1, nf_act) the upwind
    neighbour's (level, slot); ``nb_cin`` (L, Gb, W, Km, 1, nf_act, 1) its
    inflow coefficient, zero where the one-hot has no entry; and either
    ``cpl_cls`` (Q, D, D) the transposed coupling classes with ``nb_q``
    (L, Gb, W, nf_act) each read's class, or ``cpl_slab`` (L, Gb W,
    nf_act D, D) the transposed per-element couplings."""
    ncls = a_cls.shape[1]
    D = a_cls.shape[-1]
    Gb = len(gs)
    nf = act_f.shape[1]
    valid = pos_valid[gs]  # (Gb, L W)
    elem = perm_safe[gs]  # (Gb, L W)
    cls_pos = np.where(valid, cls[elem], -1)
    oh = np.stack([(cls_pos == c) for c in range(ncls)]).astype(np.float64)
    oh = oh.reshape(ncls, Gb, L, W).transpose(0, 2, 1, 3)  # (ncls, L, Gb, W)
    lev = np.empty((Gb, nf, L, W), dtype=np.int64)
    slot = np.empty((Gb, nf, L, W), dtype=np.int64)
    use = np.empty((Gb, nf, L, W), dtype=bool)
    for i, g in enumerate(gs):
        lev[i], slot[i], use[i] = upwind_slots(nbr_pos[g][act_f[g]],
                                               pos_valid[g], L, W)
        use[i] &= act_valid[g][:, None, None]
    lev, slot = np.where(use, lev, 0), np.where(use, slot, 0)
    cin = cin_act[gs][:, :, :km_b].reshape(Gb, nf, km_b, L, W)[:, :, ks]
    cin = np.where(use[:, :, None], cin, 0.0)
    a_b = a_cls[gs][:, :, :km_b][:, :, ks][:, :, :, bs]  # this rank's
    out = dict(
        bstack=put(np.moveaxis(a_b, 1, 3).reshape(
            Gb, a_b.shape[2], a_b.shape[3], ncls * D, D)),
        cls_oh=put(oh),
        nb_lev=iput(lev.transpose(2, 0, 3, 1)[:, :, :, None, None]),
        nb_slot=iput(slot.transpose(2, 0, 3, 1)[:, :, :, None, None]),
        nb_cin=put(cin.transpose(3, 0, 4, 2, 1)[:, :, :, :, None, :, None]),
    )
    # each read's coupling: the face act_f[g, f] of the receiving element
    face = act_f[gs][:, :, None]  # (Gb, nf, 1)
    rcv = elem[:, None, :]  # (Gb, 1, L W)
    if isinstance(couplings, tuple):
        cpl, q_of = couplings
        q = np.where(use.reshape(Gb, nf, L * W), q_of[rcv, face], -1)
        used = np.unique(q[q >= 0])
        pos_of = np.zeros(max(int(cpl.shape[0]), 1), dtype=np.int64)
        pos_of[used] = np.arange(len(used))
        q = np.where(q >= 0, pos_of[np.maximum(q, 0)], 0)
        out["cpl_cls"] = put(np.swapaxes(cpl[used], 1, 2)
                             if len(used) else np.zeros((1, D, D)))
        out["nb_q"] = iput(q.reshape(Gb, nf, L, W).transpose(2, 0, 3, 1))
    else:
        c = couplings[rcv, face]  # (Gb, nf, L W, D, D)
        c = np.where(use.reshape(Gb, nf, L * W)[..., None, None], c, 0.0)
        c = c.reshape(Gb, nf, L, W, D, D).transpose(2, 0, 3, 1, 5, 4)
        out["cpl_slab"] = put(c.reshape(L, Gb * W, nf * D, D))
    return out


def one_hot_sweep(v, ttc, bsrc, cb, macro_w, wvec, *, dsrc=None, xsrc=None):
    """One sweep of one Km bucket on the general ring.

    ``v``, ``ttc``, ``bsrc``, ``macro_w``, ``wvec``, ``dsrc`` and ``xsrc``
    are those of ``lattice_multi.multi_class_sweep`` and ``cb`` the
    bucket's ``bucket_tables``. Returns ``(ys, ms)``: the new state shaped
    and typed like ``v`` and the per-slot macroscopic partials ``(Gb, Km,
    L, D, W)``. A level reads every active face's upwind values from the
    levels already in ``ys`` (one gather), scales them by the inflow
    coefficients and couples them in one batched product over the (group,
    slot) rows, before the factors."""
    L, Gb, Km, BS, D, W = v.shape
    lv = LevelSweep(v, ttc, bsrc, cb["bstack"], cb["cls_oh"], macro_w, wvec,
                    dsrc, xsrc)
    ys, acc = lv.ys, lv.acc
    nf = cb["nb_lev"].shape[-1]
    dev = v.device
    gi = torch.arange(Gb, device=dev)[:, None, None, None, None]
    ki = torch.arange(Km, device=dev)[:, None, None]
    bi = torch.arange(BS, device=dev)[:, None]
    by_class = "cpl_cls" in cb
    if by_class:
        cpl_cls = cb["cpl_cls"].to(acc)
    for l in range(L):
        rhs = lv.rhs(l)
        if l:  # level 0 has no upwind neighbour
            # (Gb, W, Km, BS, nf, D): face f's upwind value of each slot
            x = ys[cb["nb_lev"][l], gi, ki, bi, :, cb["nb_slot"][l]]
            x = x.to(acc).mul_(cb["nb_cin"][l].to(acc))
            cpl = (cpl_cls[cb["nb_q"][l]] if by_class
                   else cb["cpl_slab"][l].to(acc))  # (Gb W, nf D, D)
            term = torch.bmm(x.view(Gb * W, Km * BS, nf * D),
                             cpl.view(Gb * W, nf * D, D))
            rhs.addcmul_(lv.vg, term.view(Gb, W, Km, BS, D).permute(
                0, 2, 3, 4, 1), value=-1)
        lv.solve(l, rhs)
    return ys, lv.ms
