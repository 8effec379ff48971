"""Carry pbte_tpu's operators and state into this package.

``pbte_tpu``'s ``SourceIterationSolver`` keeps its operators in a
``consts`` pytree; mapped to numpy (for example with
``jax.tree.map(np.asarray, solver.consts)``) they become this package's
consts dict, on the lattice ring (the Pallas kernel path, or the XLA ring
``_step_ring`` with its lagged closures), on its one-hot ring off the box
lattice (this package's general ring) and on the scan, so both packages
can step from the same operators and the same state. pbte_tpu's supercell
ring state carries over both ways (``state_from_numpy(..., supercell=True)``,
``super_state_to_numpy``); its supercell consts do not (this package builds
its own factors from the same operators). The global states of its sharded
solvers (slab, spatial, dir/band-sharded ring) become each rank's shard and
back (``sharded_state_from_numpy``, ``sharded_state_to_numpy``). This module imports no JAX: it
takes numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from pbte_tpu_torch.ops.ring_plan import slots_from_onehot
from pbte_tpu_torch.solver.scan import level_tables, pick_level_segments
from pbte_tpu_torch.solver.super_ring import from_pbte_layout, to_pbte_layout
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
    """pbte_tpu consts (numpy leaves) -> this package's consts: the scan
    path's (``scan_consts_from_numpy``) where they hold no ring buckets,
    the general ring's where the buckets hold one-hot selections
    (``general_bucket``), else the lattice ring's.

    Takes the Pallas path's consts and the XLA ring's (``sweep_mode="ring"``
    with ``use_pallas="off"``; not hull-windowed, which no closure problem
    is). The folded factor is ``mats[bi][4]`` on both. The inflow
    coefficients move from pbte_tpu's ``(L, Gb, nf, Km, W)`` to the
    kernel's ``(L, Gb, Km, nf, W)`` layout. The periodic tables, which
    pbte_tpu ships as zero-valid dummies on every problem, are taken only
    when some entry is valid. ``device`` defaults to the GPU and raises
    without one (``device="cpu"`` for the CPU)."""
    device = checked_device(device)
    if "super_scat" in np_consts:
        raise ValueError(
            "pbte_tpu's supercell ring consts: build this package's solver "
            "from the same ops (it forms its own factors) and carry the "
            "state over with state_from_numpy(..., supercell=True)")
    if "ring_b" not in np_consts:
        return scan_consts_from_numpy(np_consts, device)
    mats = np_consts["mats"]
    periodic = bool(np.asarray(np_consts["per_valid"]).any())
    general = "oh" in np_consts["ring_b"][0]
    buckets = []
    for bi, cb in enumerate(np_consts["ring_b"]):
        b = dict(
            **(general_bucket(cb, mats[bi], device) if general else dict(
                bcat=_tensor(mats[bi][4], device),
                cin=_tensor(np.transpose(cb["cin"], (0, 1, 3, 2, 4)),
                            device))),
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
        # the class M^T: (ncls, D, D) on the general ring, else (D, D)
        massT=_tensor(np.asarray(mats[0][2])[0, :] if general
                      else np.asarray(mats[0][2])[0, 0], device),
        wvec=_tensor(np_consts["wvec"], device),
        pos_of_elem=_tensor(np_consts["pos_of_elem"], device),
        ring_invMT=_tensor(np_consts["ring_invMT"], device),
        basis_int_glob=_tensor(np_consts["basis_int_glob"], device),
        flux_w=_tensor(np_consts["flux_w"], device),
        **{k: _tensor(np_consts[k], device) for k in REFL_KEYS
           if k in np_consts},
        buckets=tuple(buckets),
    )


def general_bucket(cb, mats_b, device):
    """One bucket of pbte_tpu's one-hot ring -> the general ring's
    ``one_hot_ring.bucket_tables`` keys: the one-hot ``oh`` (L, Gb,
    nf_act, H W, W) becomes each read's (level, slot)
    (``ring_plan.slots_from_onehot``) and masks the inflow coefficients
    ``cin`` (L, Gb, nf_act, Km, W); the class factors ``mats_b[0]`` (Gb,
    ncls, Km, BS, D, D) are stacked by rows and the class one-hots
    ``mats_b[1]`` (L, Gb, ncls, W) made class-major; the couplings are the
    class coupling ``mats_b[3]`` (Gb, nf_act, D, D), a class per (group,
    face), or the per-element ``cpl`` (L, Gb, nf_act, D, D, W)."""
    oh = np.asarray(cb["oh"])
    a_cls, cls_oh = np.asarray(mats_b[0]), np.asarray(mats_b[1])
    L, Gb, nf, _, W = oh.shape
    _, ncls, Km, BS, D, _ = a_cls.shape
    lev, slot, use = (np.stack(t, axis=1) for t in zip(
        *(slots_from_onehot(oh[:, g], W) for g in range(Gb))))  # (nf, Gb..)
    # (nf, Gb, L, W) -> (L, Gb, W, nf)
    lev, slot, use = (t.transpose(2, 1, 3, 0) for t in (lev, slot, use))
    cin = np.transpose(np.asarray(cb["cin"]), (0, 1, 4, 3, 2))  # L,Gb,W,Km,f
    cin = np.where(use[:, :, :, None, :], cin, 0.0).astype(cin.dtype)
    out = dict(
        bstack=_tensor(np.moveaxis(a_cls, 1, 3).reshape(
            Gb, Km, BS, ncls * D, D), device),
        cls_oh=_tensor(np.transpose(cls_oh, (2, 0, 1, 3)), device),
        nb_lev=_tensor(lev[:, :, :, None, None], device),
        nb_slot=_tensor(slot[:, :, :, None, None], device),
        nb_cin=_tensor(cin[:, :, :, :, None, :, None], device),
    )
    if len(mats_b) > 3:  # the class coupling: one class a (group, face)
        ccpl = np.asarray(mats_b[3])
        out["cpl_cls"] = _tensor(np.swapaxes(ccpl, -1, -2).reshape(
            Gb * nf, D, D), device)
        q = np.arange(Gb)[:, None] * nf + np.arange(nf)[None, :]
        out["nb_q"] = _tensor(np.broadcast_to(
            q[None, :, None, :], (L, Gb, W, nf)), device)
    else:
        cpl = np.asarray(cb["cpl"])  # (L, Gb, nf, D_i, D_j, W)
        out["cpl_slab"] = _tensor(np.transpose(cpl, (0, 1, 5, 2, 4, 3))
                                  .reshape(L, Gb * W, nf * D, D), device)
    return out


# pbte_tpu's scan consts this package reads as they are (mass_t and
# coupling are 1-wide dummies under its class-compressed streams)
_SCAN_KEYS = ("perm", "pos_of_elem", "basis_int_glob", "macro_w", "flux_w",
              "src_w", "relax_w", "vg", "mass_t", "coupling", "dif_pos",
              "dif_fint", "dif_cin", "dif_wplus", "dif_norm", "spc_pos",
              "spc_fm", "spc_cin", "spc_gk")


def scan_consts_from_numpy(c: dict, device="cuda") -> dict:
    """pbte_tpu scan consts (numpy leaves) -> this package's scan consts.

    The factor cache follows from the shape of ``mats``: the class cache
    (A^-1 per class and its one-hot), A^-1 per element, the eigen factors
    per class or per element, or the on-the-fly transport blocks beside
    ``mass``. The constant sources (``bsrc``, ``dsrc``) and inflow
    coefficients (``cin_int``, ``per_cin``) are formed from pbte_tpu's
    ``fdot``, ``nbr_pos``, ``bc_T``, ``face_int`` and ``dvec`` as its step
    forms them, and the level windows from its ``offsets``, ``counts`` and
    ``nbr_pos`` (the segments recomputed: ``pick_level_segments`` is its
    function). The periodic tables, zero-valid dummies on every pbte_tpu
    problem, are taken only when some entry is valid."""
    device = checked_device(device)
    a = {k: np.asarray(v) for k, v in c.items()
         if k not in ("mats", "levels")}
    mats = c["mats"]
    mats = (tuple(np.asarray(m) for m in mats) if isinstance(mats, tuple)
            else np.asarray(mats))
    class_ops = "cls_massT" in a  # pbte_tpu's class-compressed streams
    out = {k: _tensor(a[k], device) for k in _SCAN_KEYS
           if k in a and not (class_ops and k in ("mass_t", "coupling"))}
    nbr_pos, fdot = a["nbr_pos"], a["fdot"]  # (G, nf, ne), (G, Km, nf, ne)
    cin = np.minimum(fdot, 0.0)
    is_b = (nbr_pos < 0)[:, None]
    cin_bnd = np.where(is_b, cin, 0.0)
    out["cin_int"] = _tensor(np.where(is_b, 0.0, cin), device)
    out["vg_bc_w"] = _tensor(a["vg"] * a["bc_w"], device)
    if not class_ops:
        bsrc = np.einsum("gkfE,gfE,gfiE->gkiE", cin_bnd, a["bc_T"],
                         a["face_int"])
    else:  # the face integral per class
        cls_pos = np.argmax(mats[1], axis=1)  # (G, ne)
        fint = np.moveaxis(a["cls_fint"][cls_pos], 1, -1)  # (G, nf, D, ne)
        bsrc = np.einsum("gkfE,gfE,gfiE->gkiE", cin_bnd, a["bc_T"], fint)
        out["cls_massT"] = _tensor(a["cls_massT"], device)
        out["cls_cpl"] = _tensor(a["cls_cpl"], device)
        out["cls_pos"] = _tensor(cls_pos, device)
        if "dvec" in a:  # the scalar g per face
            a["dvec"] = a["dvec"][:, :, None] * fint
    out["bsrc"] = _tensor(bsrc, device)
    if "dvec" in a:
        out["dsrc"] = _tensor(np.einsum("gkfE,gfiE->gkiE", cin_bnd,
                                        a["dvec"]), device)
    if a["per_valid"].any():
        gi = np.arange(fdot.shape[0])[:, None]
        per_cin = (np.minimum(fdot[gi, :, a["per_face"], a["per_pos"]], 0.0)
                   * a["per_valid"][:, :, None]).transpose(0, 2, 1)
        out.update(per_pos=_tensor(a["per_pos"], device),
                   per_src=_tensor(a["per_src"], device),
                   per_cpl=_tensor(a["per_cpl"], device),
                   per_cin=_tensor(per_cin, device))
    cls_pos, ncls, policy = None, 0, "full"
    if isinstance(mats, tuple) and len(mats) == 2:  # class A^-1
        out["a_cls"] = _tensor(np.moveaxis(mats[0], -1, 3), device)
        cls_pos, ncls = np.argmax(mats[1], axis=1), mats[1].shape[1]
    elif isinstance(mats, tuple):  # eigen, per class (4) or element (3)
        policy = "eigen"
        for k, m in zip(("eig_P", "eig_Q", "eig_lam"), mats):
            out[k] = _tensor(m, device)
        if len(mats) == 4:
            cls_pos, ncls = np.argmax(mats[3], axis=1), mats[3].shape[1]
    elif mats.ndim == 6:  # A^-1 per element
        out["a_inv"] = _tensor(mats, device)
    else:  # on-the-fly
        policy = "on-the-fly"
        out["g_mat"] = _tensor(mats, device)
        out["mass"] = _tensor(a["mass"], device)
    out["levels"] = level_tables(
        a["offsets"], a["counts"], nbr_pos, pick_level_segments(a["counts"]),
        cls_pos, ncls, policy == "full", device)
    return out


def state_from_numpy(u, Tc, Tv, device="cuda", layout="bsd",
                     supercell=False, state_dtype=None):
    """pbte_tpu state (u, Tc, Tv) -> tensors.

    On the scan u is one array (G, Km, BS, D, ne) and ``layout`` is not
    read. On the lattice ring u is the per-bucket slabs, and ``layout``
    names their trailing axes as pbte_tpu's checkpoints tag them: "bsd"
    for the Pallas path's ``(L, Gb, Km, BS, D, W)`` (this package's
    layout), "dbs" for the XLA ring's ``(L, Gb, Km, D, BS, W)``, whose BS
    and D axes are swapped here. With ``supercell=True`` u is the
    supercell ring's per-bucket ``(L, Gb, Km_b, D', BS, W)`` (pbte_tpu's
    XLA ring; ``layout`` not read), carried into this package's ``(L, Gb,
    Km_b, BS, W, D')``; Tc is then per super element and Tv per fine
    element. ``state_dtype`` casts a ring's u (torch.bfloat16 for the
    bf16 state of a float32 solver; None keeps the arrays' type, a
    bfloat16 array of pbte_tpu's becoming bfloat16). ``device`` defaults
    to the GPU and raises without one (``device="cpu"`` for the CPU)."""
    device = checked_device(device)
    if not isinstance(u, (tuple, list)):
        return _tensor(u, device), _tensor(Tc, device), _tensor(Tv, device)

    def ring(ub):
        t = _tensor(ub, device)
        return t if state_dtype is None else t.to(state_dtype)

    if supercell:
        return (tuple(from_pbte_layout(ring(ub)) for ub in u),
                _tensor(Tc, device), _tensor(Tv, device))
    if layout not in ("bsd", "dbs"):
        raise ValueError(f"layout must be 'bsd' or 'dbs', got {layout!r}")
    if layout == "dbs":
        u = [np.swapaxes(np.asarray(ub), 3, 4) for ub in u]
    return (
        tuple(ring(ub) for ub in u),
        _tensor(Tc, device),
        _tensor(Tv, device),
    )


def super_state_to_numpy(u):
    """The supercell ring's per-bucket state -> pbte_tpu's XLA-ring layout
    ``(L, Gb, Km_b, D', BS, W)`` as numpy arrays (a bfloat16 state as
    float32, exact; ``state_from_numpy(..., supercell=True, state_dtype=
    torch.bfloat16)`` takes it back)."""
    return [to_pbte_layout(ub).detach().cpu().float().numpy()
            if ub.dtype == torch.bfloat16
            else to_pbte_layout(ub).detach().cpu().numpy() for ub in u]


def sharded_state_from_numpy(solver, u, Tc, Tv):
    """A global state of pbte_tpu's sharded solvers (numpy, as its
    ``SlabLatticeSolver`` holds it: u ``(P, L, G, Km, D, BS, W)``, Tc
    ``(P, ne_loc, D)``, Tv ``(P, ne_loc)``; or its
    ``SpatialShardedSolver``: u ``(P, G, Km, BS, D, ne_max)``, Tc ``(P,
    ne_max, D)``, Tv ``(P, ne_max)``) -> this rank's shard on the port's
    solver of the same kind (``solver.shard_state``); under a
    ``dir_sharding`` grid, ``SourceIterationSolver``'s full state
    (``state_from_numpy``'s input: the ring's or the supercell ring's
    buckets, the scan's tensor) -> this rank's slots and bands."""
    if hasattr(solver, "shard_state"):
        return solver.shard_state(u, Tc, Tv)
    ub, Tc, Tv = state_from_numpy(u, Tc, Tv, device=solver.device,
                                  supercell=solver._super is not None,
                                  state_dtype=solver.state_dtype)
    return solver.shard_buckets(ub), Tc, Tv


def sharded_state_to_numpy(solver, u, Tc, Tv):
    """The inverse (collective: every rank takes part and gets the global
    numpy arrays in pbte_tpu's layout)."""
    if hasattr(solver, "gather_state"):
        return solver.gather_state(u, Tc, Tv)
    u = solver.gather_buckets(u)
    if not isinstance(u, tuple):  # the scan
        u = u.detach().cpu().numpy()
    elif solver._super is not None:
        u = super_state_to_numpy(u)
    else:
        u = [b.detach().cpu().float().numpy() if b.dtype == torch.bfloat16
             else b.detach().cpu().numpy() for b in u]
    return u, Tc.detach().cpu().numpy(), Tv.detach().cpu().numpy()
