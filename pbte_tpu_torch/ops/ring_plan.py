"""Host-side selection plans for the general (non-lattice) ring sweep.

This package's copy of ``pbte_tpu/ops/ring_plan.py`` (``FusedSweepPlan``
and ``build_group_plan``, the level-padded one-hot plan pbte_tpu's one-hot
ring consumes on unstructured meshes, where upwind neighbours sit at
arbitrary slots of the previous H levels), and ``upwind_slots``, the form
this package's ring takes: per face and slab position, the integer
``(level, slot)`` of the upwind neighbour that the one-hot selects. The
one-hot ``(nf, H W, L, W)`` matrices feed the TPU's matrix unit; on the
GPU each receiving slot reads its neighbour from the sweep's output at
that pair, so no one-hot and no H-deep ring buffer is uploaded.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FusedSweepPlan:
    """Host-built, level-padded selection tensors for one direction group."""

    H: int  # ring depth (max upwind level gap)
    L: int
    W: int
    onehot: np.ndarray  # (nf, H*W, L, W) ring-slot -> neighbor map
    valid: np.ndarray  # (L, W) 1.0 real / 0.0 padding


def build_group_plan(nbr_pos, valid_pos, L, W, H) -> FusedSweepPlan:
    """Level-PADDED layout: position p holds (level p//W, slot p%W).
    nbr_pos (nf, L*W) with -1 boundary/padding; valid_pos (L*W,) bool."""
    nf, ne_pad = nbr_pos.shape
    onehot = np.zeros((nf, H * W, L, W), dtype=np.float32)
    valid = valid_pos.reshape(L, W).astype(np.float32)
    # vectorized over all (face, position) pairs (the per-position Python
    # loop was ~G*ne_pad*nf iterations of setup time)
    pos = np.arange(ne_pad)
    l, w = pos // W, pos % W
    nb = nbr_pos  # (nf, ne_pad)
    gl, gw = nb // W, nb % W
    gap = l[None, :] - gl
    # downwind (gap <= 0) neighbors never contribute (their inflow factor
    # cin is zero); invalid/boundary positions carry no entry
    use = (nb >= 0) & (gap > 0) & valid_pos[None, :]
    if np.any(use & (gap > H)):
        raise ValueError("upwind level gap exceeds ring depth")
    fi, pi = np.nonzero(use)
    onehot[fi, (gl[fi, pi] % H) * W + gw[fi, pi], l[pi], w[pi]] = 1.0
    return FusedSweepPlan(H=H, L=L, W=W, onehot=onehot, valid=valid)


def upwind_slots(nbr_pos, valid_pos, L, W):
    """The upwind reads of one group's slab as integer tables.

    ``nbr_pos`` (nf, L W) the slab position of each face's neighbour (-1 on
    boundaries and padding) and ``valid_pos`` (L W,) as ``build_group_plan``
    takes them. Returns ``(lev, slot, use)``, each (nf, L, W): where
    ``use`` holds, the slot (l, w) reads its face-f neighbour at level
    ``lev`` < l and slot ``slot``, the entry at which ``build_group_plan``'s
    one-hot is 1 (its row ``(lev % H) W + slot``); elsewhere both are 0
    (level 0 slot 0, which a sweep has written before any level reads
    it)."""
    nf, ne_pad = nbr_pos.shape
    l = np.arange(ne_pad) // W
    gl, gw = nbr_pos // W, nbr_pos % W
    use = (nbr_pos >= 0) & (l[None, :] - gl > 0) & valid_pos[None, :]
    lev = np.where(use, gl, 0)
    slot = np.where(use, gw, 0)
    return (lev.reshape(nf, L, W), slot.reshape(nf, L, W),
            use.reshape(nf, L, W))


def slots_from_onehot(oh, W):
    """pbte_tpu's per-level one-hot ``(L, nf, H W, W)`` of one group ->
    ``(lev, slot, use)`` (nf, L, W) as ``upwind_slots`` gives them. Row r
    of level l holds ring slot r % W of the level l' < l with l' % H = r //
    W and l - l' <= H."""
    L, nf, HW, _ = oh.shape
    H = HW // W
    li, fi, ri, wi = np.nonzero(oh)
    lev = np.zeros((nf, L, W), dtype=np.int64)
    slot = np.zeros((nf, L, W), dtype=np.int64)
    use = np.zeros((nf, L, W), dtype=bool)
    lev[fi, li, wi] = li - 1 - (li - 1 - ri // W) % H
    slot[fi, li, wi] = ri % W
    use[fi, li, wi] = True
    return lev, slot, use
