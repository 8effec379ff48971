"""The lattice ring on multi-class lattices and per-element couplings.

Port of the lattice branch of pbte_tpu's ``_step_ring`` for a Cartesian
box lattice whose elements fall into 2-8 geometry classes (a graded
lattice), or whose neighbour couplings differ within a class
(``assembly.class_coupling`` is None): the class factors and one-hots of
its constructor (``pbte_tpu/solver/source_iteration.py:1437-1530``), the
class-selected lagged temperature (``:3009-3021``), the per-element
couplings applied to the unshifted ring and then shifted and masked by the
inflow coefficients (``:3154-3170``), and the class-selected factor apply
(``:3186-3193``). pbte_tpu runs this body in XLA, not in its Pallas kernel,
so the port runs it as torch products and launches no kernel.

State and operands keep the single-class ring's layout, ``(L, Gb, Km, BS,
D, W)`` per bucket, and every product is written so that no level copies
the state into another layout:

- the couplings: a lattice has few distinct coupling matrices (a face's
  coupling is set by the geometry of the element and of its neighbour), so
  the constructor groups the per-element matrices into coupling classes q
  (``coupling_classes``), and a level applies all of them at once, one
  batched product ``[C_0; C_1; ...] @ ring`` over the (group, slot, band)
  rows with W the free axis; per face, each receiving slot gathers its
  own class's output at its upwind slot (the face's lattice offset back)
  and adds it scaled by its inflow coefficient;
- the factor: one batched product ``[B_0; B_1; ...] @ rhs`` of the class
  factors stacked by rows, each slot then keeping its own class's rows
  (one-hot ``cls_oh``).

The float32 products run with TF32 off (the caller's ``exact_f32_products``
scope), so float32 is exact here as in K1. bfloat16 state carries the ring
in bfloat16 and computes in float32, as pbte_tpu's bf16 state does on this
body.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# the couplings of one coupling class agree to this share of their largest
# entry (assembly.class_coupling's tolerance)
COUPLING_RTOL = 1e-10


class MultiBucket(NamedTuple):
    """One Km bucket's operands of the multi-class ring (device tensors).

    ``bstack``: ``(Gb, Km, BS, ncls D, D)`` the class factors B_c = M_c^T
    A_c^-1 stacked by rows, class-major: one batched product applies all.
    ``cls_oh``: ``(ncls, L, Gb, W)`` one-hot class of each slab slot (zero
    on padding).
    ``cstack``: ``(Q D, D)`` the coupling classes the bucket uses, stacked
    by rows: one batched product applies them all to the ring.
    ``faces``: per active face f, ``(qpos, cin)``: ``qpos`` ``(L, Gb, W)``
    int64, the position in ``cstack`` of each receiving slot's coupling
    class (0 where it has none), and ``cin`` ``(L, Gb, Km, W)`` its inflow
    coefficient (0 where it has no coupling).
    """

    bstack: torch.Tensor
    cls_oh: torch.Tensor
    cstack: torch.Tensor
    faces: tuple


def class_factors(ops, cls, dirs_np, dirs_safe, vg_s, np_dtype):
    """Per-class transport factors B = M^T A^-1 of every (group, class,
    slot, band) ``(G, ncls, Km, BS, D, D)``, float64 host math cast to
    ``np_dtype`` (pbte_tpu's ``_factor_group``, each class represented by
    its first element), with each class's M^T and M^-T ``(ncls, D, D)``."""
    ncls = int(cls.max()) + 1
    reps = np.array([int(np.flatnonzero(cls == c)[0]) for c in range(ncls)])
    mass_r = ops.mass[reps]  # (ncls, D, D)
    massT_r = np.swapaxes(mass_r, -1, -2)
    invMT_r = np.linalg.inv(massT_r)
    G, Km = dirs_safe.shape
    D = ops.ndof
    a_cls = np.empty((G, ncls, Km, len(vg_s), D, D), dtype=np_dtype)
    for g in range(G):
        dk = dirs_np[dirs_safe[g]]  # (Km, dim)
        fd = np.einsum("cfd,kd->ckf", ops.normals[reps], dk)
        G_k = -np.einsum("kd,cdij->ckij", dk, ops.stiff[reps]) + np.einsum(
            "ckf,cfij->ckij", np.maximum(fd, 0.0), ops.face_mass[reps])
        A = (mass_r[:, None, None]
             + vg_s[None, None, :, None, None] * G_k[:, :, None])
        a_cls[g] = np.matmul(massT_r[:, None, None],
                             np.linalg.inv(A)).astype(np_dtype)
    return a_cls, massT_r, invMT_r


def coupling_classes(ops, cls, invMT_r):
    """The distinct neighbour couplings of a lattice, each folded with its
    neighbour class's M^-T (the ring carries v = M^T u): returns ``(cpl,
    q_of)``, ``cpl`` ``(Q, D, D)`` one matrix per coupling class (its
    first member's) and ``q_of`` ``(ne, nf)`` the class of each element
    face (-1 on boundary faces, which the inflow coefficients mask).

    A face's coupling is set by the geometry of the two elements it joins,
    so a coupling class is a (face, element class, neighbour class)
    triple; every member is checked against the class's matrix (to
    ``COUPLING_RTOL`` of its largest entry), and a mesh whose couplings
    those triples do not determine raises NotImplementedError."""
    ne, nf = ops.neighbor.shape
    ncls = len(invMT_r)
    interior = ops.neighbor >= 0
    nbr_cls = cls[np.clip(ops.neighbor, 0, None)]
    folded = np.einsum("efij,efjk->efik", ops.coupling, invMT_r[nbr_cls])
    key = (np.arange(nf)[None, :] * ncls + cls[:, None]) * ncls + nbr_cls
    _, first, inv = np.unique(key[interior], return_index=True,
                              return_inverse=True)
    rows = folded[interior]  # (n_interior, D, D)
    cpl = rows[first]
    dev = np.abs(rows - cpl[inv]).max(axis=(1, 2))
    scale = np.abs(cpl).max(axis=(1, 2))[inv]
    if (dev > COUPLING_RTOL * scale).any():
        raise NotImplementedError(
            "neighbour couplings that the geometry classes of the two "
            "elements do not determine (not a box lattice); "
            "sweep_mode='scan' solves the same problem")
    q_of = np.full((ne, nf), -1, dtype=np.int64)
    q_of[interior] = inv.reshape(-1)
    return cpl, q_of


def bucket_tables(gs, km_b, a_cls, cls, cpl, q_of, perm_safe, pos_valid,
                  act_f, ring_cin, L, W, np_dtype, put, iput, ks=slice(None),
                  bs=slice(None)):
    """A bucket's ``MultiBucket`` from the host tables: the groups ``gs``
    with ``km_b`` slots, the class factors ``a_cls``, the element classes,
    the coupling classes ``cpl`` and each face's ``q_of``, the slab layout
    (``perm_safe``, ``pos_valid`` (G, L W)), the active faces ``act_f``
    (G, nf_act) and the inflow coefficients ``ring_cin`` (L, G, Km,
    nf_act, W); ``put`` uploads a numpy array in the solver dtype, ``iput``
    an index array as int64. ``ks`` and ``bs`` select this rank's slots
    of the bucket and bands under dir/band sharding (the factors and
    inflow coefficients of the others are not uploaded)."""
    ncls = a_cls.shape[1]
    Gb = len(gs)
    valid = pos_valid[gs]  # (Gb, L W)
    elem = perm_safe[gs]  # (Gb, L W)
    cls_pos = np.where(valid, cls[elem], -1)
    oh = np.stack([(cls_pos == c) for c in range(ncls)]).astype(np_dtype)
    oh = oh.reshape(ncls, Gb, L, W).transpose(0, 2, 1, 3)  # (ncls, L, Gb, W)
    q_face, used = [], set()
    for f in range(act_f.shape[1]):
        q = np.where(valid, q_of[elem, act_f[gs, f][:, None]], -1)
        q = q.reshape(Gb, L, W).transpose(1, 0, 2)  # (L, Gb, W)
        q_face.append(q)
        used |= {int(x) for x in np.unique(q[q >= 0])}
    used = sorted(used)
    pos_of = np.zeros(max(used, default=0) + 1, dtype=np.int64)
    pos_of[used] = np.arange(len(used))
    faces = []
    for f, q in enumerate(q_face):
        cin_f = ring_cin[:, gs][:, :, :km_b, f][:, :, ks]  # (L,Gb,Km_b,W)
        faces.append((iput(np.where(q >= 0, pos_of[np.maximum(q, 0)], 0)),
                      put(np.where((q >= 0)[:, :, None, :], cin_f, 0.0))))
    D = a_cls.shape[-1]
    # (Gb, Km, BS, ncls, D, D), this rank's slots and bands
    bstack = np.moveaxis(a_cls[gs][:, :, :km_b][:, :, ks][:, :, :, bs], 1, 3)
    return MultiBucket(
        bstack=put(bstack.reshape(bstack.shape[:3] + (ncls * D, D))),
        cls_oh=put(oh), cstack=put(cpl[used].reshape(-1, D)),
        faces=tuple(faces))


def class_ttc(massT, cls_oh, tc_slab):
    """The lagged-temperature slab M_c^T Tc of each slot's class:
    ``massT`` (ncls, D, D), ``cls_oh`` (ncls, L, G, W), ``tc_slab``
    (L, G, D, W) -> (L, G, D, W)."""
    out = None
    for c in range(massT.shape[0]):
        t = torch.einsum("ij,lgjw->lgiw", massT[c], tc_slab)
        t = t * cls_oh[c][:, :, None, :]
        out = t if out is None else out + t
    return out


class LevelSweep:
    """The per-level pieces the torch rings share (this module's and the
    general one-hot ring's, ``solver/one_hot_ring.py``): the rhs of a
    level from the state, the lagged temperature and the sources, and the
    class-selected factor apply with the band sum of the macroscopic
    partials, written into the new state ``ys`` and the partials ``ms``.

    ``v`` (L, Gb, Km, BS, D, W) the state, ``ttc``, ``bsrc``, ``dsrc``,
    ``xsrc``, ``macro_w`` and ``wvec`` those of
    ``ops.lattice_ring.lattice_ring_sweep_ref``, ``bstack`` (Gb, Km, BS,
    ncls D, D) and ``cls_oh`` (ncls, L, Gb, W) a ``MultiBucket``'s."""

    def __init__(self, v, ttc, bsrc, bstack, cls_oh, macro_w, wvec, dsrc,
                 xsrc):
        L, Gb, Km, BS, D, W = v.shape
        self.v, self.ttc, self.bsrc, self.dsrc = v, ttc, bsrc, dsrc
        self.N = N = Gb * Km * BS
        self.acc = acc = (torch.float64 if v.dtype == torch.float64
                          else torch.float32)
        self.w_src, self.w_rel, self.w_bcv, self.w_dir = (
            wvec[i].to(acc)[:, None, None] for i in range(4))
        self.vg = self.w_dir  # (BS, 1, 1): the non-dimensional group velocity
        self.ncls = ncls = cls_oh.shape[0]
        if ncls > 1:
            # each slot's class, (L, Gb, 1, 1, 1, 1, W) for the gather along
            # the class rows; padded slots read class 0, whose factor
            # applied to their zero rhs gives the zero a one-hot would
            self.cls_idx = cls_oh.argmax(dim=0).view(L, Gb, 1, 1, 1, 1, W)
        self.bstack = bstack.to(acc).view(N, ncls * D, D)
        self.xsrc = xsrc
        if xsrc is not None:
            self.gi = torch.arange(Gb, device=v.device)[:, None]
            self.xval = xsrc.xval.to(acc)
            self.none = torch.zeros((), dtype=acc, device=v.device)
        self.mw = macro_w.to(acc).view(Gb * Km, 1, BS)
        self.ys = torch.empty_like(v)
        # level-major, so a level's band sum lands in place
        self.ms_l = torch.empty((L, Gb, Km, D, W), dtype=acc, device=v.device)
        self.ms = self.ms_l.permute(1, 2, 0, 3, 4)  # (Gb, Km, L, D, W)

    def rhs(self, l):
        """Level l's rhs (Gb, Km, BS, D, W) in the accumulation type,
        contiguous, without the neighbour terms: the state term first (a
        sum of two terms rounds the same in either order)."""
        acc = self.acc
        rhs = self.w_rel * self.v[l].to(acc)
        rhs.addcmul_(self.w_src, self.ttc[l].to(acc)[:, None, None])
        rhs.addcmul_(self.w_bcv, self.bsrc[l].to(acc)[:, :, None], value=-1)
        if self.dsrc is not None:
            rhs.addcmul_(self.w_dir, self.dsrc[l].to(acc)[:, :, None],
                         value=-1)
        if self.xsrc is not None:
            m = self.xsrc.xmap[l].long()  # (Gb, W)
            add = self.xval[self.gi, m.clamp(min=0)]  # (Gb, W, Km, BS, D)
            add = torch.where((m >= 0)[:, :, None, None, None], add,
                              self.none)
            rhs += add.permute(0, 2, 3, 4, 1)
        return rhs

    def solve(self, l, rhs):
        """Every class factor against the rhs, each slot keeping its own
        class's rows (one gather), written into ``ys[l]`` (through a
        temporary where the state's type is not the accumulation type),
        and the band sum into ``ms[:, :, l]``; returns the level's solution
        in the accumulation type."""
        Gb, Km, BS, D, W = rhs.shape
        N, ncls, acc = self.N, self.ncls, self.acc
        v = self.v
        sol = self.ys[l] if v.dtype == acc else torch.empty_like(rhs)
        if ncls == 1:
            torch.bmm(self.bstack, rhs.view(N, D, W), out=sol.view(N, D, W))
        else:
            sol_all = torch.bmm(self.bstack, rhs.view(N, D, W)).view(
                Gb, Km, BS, ncls, D, W)
            torch.gather(sol_all, 3, self.cls_idx[l].expand(
                Gb, Km, BS, 1, D, W), out=sol.view(Gb, Km, BS, 1, D, W))
        if v.dtype != acc:
            self.ys[l] = sol.to(v.dtype)
        # the band sum of the macroscopic partials, one batched product
        torch.bmm(self.mw, sol.view(Gb * Km, BS, D * W),
                  out=self.ms_l[l].view(Gb * Km, 1, D * W))
        return sol


def multi_class_sweep(v, ttc, bsrc, mb, macro_w, wvec, *, shifts, dsrc=None,
                      xsrc=None):
    """One sweep of one Km bucket on the multi-class lattice ring.

    ``v``, ``ttc``, ``bsrc``, ``macro_w``, ``wvec``, ``dsrc`` and ``xsrc``
    are those of ``ops.lattice_ring.lattice_ring_sweep_ref`` (the operands
    in the solver dtype) and ``mb`` the bucket's ``MultiBucket``. Returns
    ``(ys, ms)`` as the single-class sweep does: the new state shaped and
    typed like ``v`` and the per-slot macroscopic partials
    ``(Gb, Km, L, D, W)`` in the accumulation type (float64 for float64
    state, else float32). A level runs two batched products over the
    (group, slot, band) rows: every coupling class against the ring, then
    every class factor against the rhs."""
    L, Gb, Km, BS, D, W = v.shape
    lv = LevelSweep(v, ttc, bsrc, mb.bstack, mb.cls_oh, macro_w, wvec, dsrc,
                    xsrc)
    N, acc = lv.N, lv.acc
    # the stacked couplings as a batch of one matrix (no copy)
    cstack = mb.cstack.to(acc).expand(N, -1, D)
    ring = None  # the previous level's solution (bf16 state: in bf16)
    for l in range(L):
        rhs = lv.rhs(l)
        # the neighbour terms: out[w] = cin_f[w] C_{q_f(w)} ring[w - s_f]
        if ring is not None and cstack.shape[1]:
            y = torch.bmm(cstack, ring.to(acc).view(N, D, W))
            y = y.view(Gb, Km, BS, -1, D, W)  # every coupling class
            term = torch.zeros_like(rhs)
            for (qpos, cin), s in zip(mb.faces, shifts):
                s = int(s)
                # each receiving slot's own class, read at w - s
                idx = qpos[l][:, None, None, None, None, s:].expand(
                    Gb, Km, BS, 1, D, W - s)
                sel = torch.gather(y[..., :W - s], 3, idx)[:, :, :, 0]
                term[..., s:].addcmul_(cin[l][:, :, None, None, s:].to(acc),
                                       sel)
            rhs.addcmul_(lv.vg, term, value=-1)
        sol = lv.solve(l, rhs)
        ring = lv.ys[l] if v.dtype == torch.bfloat16 else sol
    return lv.ys, lv.ms
