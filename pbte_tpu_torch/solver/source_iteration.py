"""Source-iteration PBTE solver on the lattice ring sweep (PyTorch + CUDA).

Port of ``pbte_tpu/solver/source_iteration.py::SourceIterationSolver``,
restricted to a single-class Cartesian box lattice swept by the
shift-structured ring on one device (no supercell merge): the path of its
Pallas kernel, plus the lagged closures its XLA ring ``_step_ring`` runs on
the same lattice (periodic wraps, diffuse and specular walls). The flagship
(hex 16^3, p=2, 64 directions x 40 bands, f32) takes this path.

Construction is numpy host math on this package's own host layers (FEM
class helpers, sweep plan, lattice tables); the results become tensors on
``device`` (the GPU unless the caller asks for the CPU) in a ``consts``
dict. The constructor reads ``ops``, ``quad`` and ``tables`` by their
fields only, so it takes pbte_tpu's objects as well as this package's. One
outer step:

1. builds the lagged-temperature slab ``M^T Tc`` (one einsum);
2. with periodic or reflective faces, gathers the previous iterate's
   boundary values across all buckets and sums each bucket's lagged
   closure contributions per closure element (the sweep's sparse
   ``ClosureSource``);
3. runs ``ops.lattice_ring.lattice_ring_sweep`` once per Km bucket (the
   CUDA kernel for CUDA tensors, the plain version for CPU tensors);
4. regroups the per-level macroscopic partials into Tc through the
   ``pos_of_elem`` gather and ``M^-T``, then Tv;
5. computes the scale-invariant residual.

State layout: a tuple of per-bucket ``(L, Gb, Km_b, BS, D, W)`` slabs of
the mass-transformed state ``v = M^T u`` (band-major, as on the JAX
Pallas path), float32 or, with ``PBTE_RING_STATE_BF16=1``, bfloat16, or
float64 (``dtype=torch.float64``, on the CPU or the GPU: every operand, the
sweep's sums, Tc, Tv and the residual are then float64).

``solve(accelerate="bicgstab")`` solves the same fixed point by BiCGStab
over the affine step (``solver/accel.py``), in far fewer steps with
float64 state.

Hull windows (pbte_tpu's default on the flagship, its ``_step_ring_win``).
The slab pads every level to the full plane of W slots; the constructor
computes each level's hull ``[lo_l, hi_l)`` of valid slots once
(``lattice_tables.ring_windows``) and every sweep runs each level on its
window alone. The gate is pbte_tpu's: windows are taken when, rounded out
to the kernel's 16-slot tiles, they keep under 95% of the L W slots
(``WINDOW_MAX_SHARE``). pbte_tpu re-lays its windowed state
out in segments and therefore windows only problems without lagged
closures; here the state keeps the full-slab layout, and the closures'
``(level, slot)`` gathers and ``xmap`` address valid elements, which lie
inside the windows, so the same windows serve closure problems too. Slots
outside a window are padding (exact-zero fixed points), so the results
with and without windows are equal bit for bit.

The solver's own float32 products (the einsums of ``step``, of the closure
sources and of ``heat_flux``) run with TF32 off; the two process-wide flags
are saved and restored around each, so the caller's settings stand.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from pbte_tpu_torch.fem import assembly
from pbte_tpu_torch.models import macroscopic
from pbte_tpu_torch.ops.lattice_ring import (
    ClosureSource,
    lattice_ring_sweep,
    windows_on_device,
)
from pbte_tpu_torch.solver.lattice_tables import (
    lattice_ring_tables,
    mirror_direction_map,
    ring_windows,
    window_slots,
)
from pbte_tpu_torch.sweep import planner

_RING_FAMILY = "ROADMAP.md queue 1, item 6 (the rest of the ring family)"
# the reflective-wall consts, global (the gather crosses buckets)
REFL_KEYS = ("dif_fint", "dif_cin", "dif_wplus", "dif_norm", "dif_fvec",
             "spc_cin", "spc_gk", "spc_fmv")
_SCAN_PATH = "ROADMAP.md queue 1, item 7 (scan path)"
_CHECKPOINT = "ROADMAP.md queue 1, item 9 (io/checkpoint.py)"
_COMPENSATED = ('ROADMAP.md "Not to port": accel.compensated_outer reaches '
                'the same floor as the plain float32 iteration')
# windows are rounded out to the kernel's m-tiles of this many slots, and
# taken when they keep under this share of the slab (pbte_tpu's gate)
WINDOW_TILE = 16
WINDOW_MAX_SHARE = 0.95


@contextlib.contextmanager
def exact_f32_products():
    """TF32 (about three decimal digits) off for the float32 matrix
    products and convolutions inside; both process-wide flags are restored
    on the way out. ``@exact_f32_products()`` wraps a function in it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def checked_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device raises when no GPU is
    visible (the entry points run on the card and never fall back to the
    CPU: pass ``device="cpu"`` for that)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA GPU is available; pass "
            "device='cpu' to run on the CPU"
        )
    return device


class SourceIterationSolver:
    """Build once per (mesh, angles, material, bcs) problem; step on
    ``device``."""

    def __init__(
        self,
        ops,  # fem.assembly.ElementOps (this package's or pbte_tpu's)
        quad,  # angular.quadrature.AngularQuad
        tables,  # material.nongray_smrt.PhononTables
        bc_temps: dict,  # boundary attr -> temperature deviation
        dirichlet_bcs: dict | None = None,  # attr -> prescribed incoming
        dtype: torch.dtype = torch.float32,
        device="cuda",
        *,
        diffuse_bcs=None,
        specular_bcs=None,
        require_bcs: bool = True,  # False: a boundary attribute without a
        # condition is taken as an isothermal wall at deviation 0
    ):
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        # bf16 state (same opt-in as pbte_tpu): halves the state streams;
        # the product operands and the ring are then bf16 as well, and the
        # macroscopic partials stay f32
        self.state_bf16 = os.environ.get("PBTE_RING_STATE_BF16", "") == "1"
        if self.state_bf16 and dtype == torch.float64:
            raise ValueError("PBTE_RING_STATE_BF16=1 rounds float32 state to "
                             "bfloat16; unset it for float64 state")
        self.device = device = checked_device(device)
        self.dtype = dtype
        np_dtype = np.float32 if dtype == torch.float32 else np.float64

        self.ne = ne = ops.num_elements
        self.D = D = ops.ndof
        dim = ops.dim
        self.K = quad.num_directions
        self.BS = BS = tables.num_branches * tables.num_spectral
        omega = quad.total_weight

        inv_kn = tables.flat("inv_kn").astype(np.float64)
        vg = tables.flat("vg").astype(np.float64)
        heat_cap = tables.flat("heat_cap").astype(np.float64)
        dt_inv = float(inv_kn.max())

        # ---- canonical face ordering: collapses the geometry-class count
        # of translation-invariant meshes (hex 6 -> 1). Gated to ne >= 512
        # exactly as pbte_tpu is, so small meshes keep their face order
        # (and their classes) there and here.
        if ne >= 512:
            cls0 = assembly.element_classes(ops, merge=False)
            ops_c = assembly.permute_faces(
                ops, assembly.canonical_face_perm(ops)
            )
            cls1 = assembly.element_classes(ops_c)
            if cls1.max() < cls0.max():
                ops, cls = ops_c, cls1
            else:
                cls = assembly.element_classes(ops)
        else:
            cls = assembly.element_classes(ops)

        # boundary check as pbte_tpu's: reflective walls need no
        # temperature, and periodic faces have a neighbour (no boundary)
        dirichlet_bcs = dirichlet_bcs or {}
        diffuse_bcs = sorted(int(a) for a in (diffuse_bcs or ()))
        specular_bcs = sorted(int(a) for a in (specular_bcs or ()))
        bdry_attrs = set(int(a) for a in np.unique(
            ops.face_attr[(ops.neighbor < 0) & ops.face_valid]
        ))
        missing = (
            bdry_attrs
            - set(int(k) for k in bc_temps)
            - set(int(k) for k in dirichlet_bcs)
            - set(diffuse_bcs)
            - set(specular_bcs)
        )
        if missing and require_bcs:
            raise ValueError(
                f"boundary attributes without isothermal BC: {sorted(missing)}"
            )

        nf = ops.faces_per_elem
        bc_T = np.zeros((ne, nf))
        for attr, T in bc_temps.items():
            bc_T[ops.face_attr == int(attr)] = float(T)
        dvec = np.zeros((ne, nf, D))
        for attr, gval in dirichlet_bcs.items():
            sel = ops.face_attr == int(attr)
            dvec[sel] = float(gval) * ops.face_int[sel]

        # ---- sweep plan, slot-major (G, Km) layout, Km buckets -------------
        sweep_nbr = ops.sweep_neighbor
        plan = planner.build_plan(sweep_nbr, ops.normals, quad.directions)
        self.G = G = plan.num_groups
        sizes = np.array([len(d) for d in plan.dirs_of_group])
        self.Km = Km = int(sizes.max())
        dirs_pad = np.full((G, Km), -1, dtype=np.int64)
        for g, d in enumerate(plan.dirs_of_group):
            dirs_pad[g, : len(d)] = d
        self.dirs_pad = dirs_pad  # slot (g, k) -> global direction or -1
        dir_valid = dirs_pad >= 0
        dirs_np = quad.directions[:, :dim]
        dirs_safe = np.where(dir_valid, dirs_pad, 0)
        # groups of equal slot count run as one bucket with exactly that
        # many slots (flagship octants: [10]*4 and [6]*4)
        km_req = np.maximum(sizes, 1)
        self._ring_buckets = [
            (np.flatnonzero(km_req == kv), int(kv))
            for kv in sorted({int(x) for x in km_req}, reverse=True)
        ]
        self.L = L = plan.max_levels

        # ---- the kernel's gate: single-class lattice with class coupling --
        if int(cls.max()) + 1 != 1:
            raise NotImplementedError(
                f"{int(cls.max()) + 1} geometry classes (multi-class "
                f"lattices, and meshes below 512 elements, whose faces are "
                f"not canonicalised): {_RING_FAMILY}"
            )
        lat = planner.detect_lattice(sweep_nbr, ops.normals)
        lt = None if lat is None else lattice_ring_tables(lat, plan, dirs_np)
        if lt is None:
            raise NotImplementedError(
                "not a Cartesian box lattice with an octant leveling "
                f"(simplex, unstructured or axis-grazing): {_RING_FAMILY} "
                f"and {_SCAN_PATH}"
            )
        lat_tabs, act_f, lat_shifts = lt
        ccpl = assembly.class_coupling(ops, cls)
        if ccpl is None:
            raise NotImplementedError(
                f"per-element neighbour coupling: {_RING_FAMILY}"
            )
        self.shifts = tuple(int(s) for s in lat_shifts)
        self.W = W = lat_tabs.shape[2]
        # per-level hull windows (L, 2), or None where they save too little
        win = ring_windows(lat_tabs)
        self.win = (win if window_slots(win, WINDOW_TILE)
                    < WINDOW_MAX_SHARE * L * W else None)
        # on a GPU the sweeps take the windows as a tensor, uploaded once
        self.win_dev = (
            windows_on_device(self.win, L, W, device)
            if self.win is not None and device.type == "cuda" else None
        )
        self.ne_pad = ne_pad = L * W
        nf_act = dim

        # ---- padded (L, W) slab layout per group ---------------------------
        perm = lat_tabs.reshape(G, ne_pad).astype(np.int64)  # -1 padded
        pos_valid = perm >= 0
        perm_safe = np.where(pos_valid, perm, 0)
        pos_of_elem = np.zeros((G, ne), dtype=np.int64)
        for g in range(G):
            pos_of_elem[g, perm_safe[g][pos_valid[g]]] = np.flatnonzero(
                pos_valid[g]
            )
        self._perm = perm
        nbr_g = sweep_nbr[perm_safe]  # (G, ne_pad, nf)
        nbr_pos = np.where(
            (nbr_g >= 0) & pos_valid[..., None],
            np.take_along_axis(
                pos_of_elem, np.clip(nbr_g, 0, None).reshape(G, -1), axis=1
            ).reshape(G, ne_pad, nf),
            -1,
        )
        nbr_pos = np.swapaxes(nbr_pos, 1, 2)  # (G, nf, ne_pad)
        # every valid interior upwind read must hit the previous level's
        # slab at exactly the static shift
        for g in range(G):
            for j, f in enumerate(act_f[g]):
                psel = np.flatnonzero(pos_valid[g] & (nbr_pos[g, f] >= 0))
                d = psel - nbr_pos[g, f, psel]
                if psel.size and not np.all(d == W + self.shifts[j]):
                    raise RuntimeError(
                        f"lattice shift mismatch g={g} axis={j}: offsets "
                        f"{np.unique(d)} != {W + self.shifts[j]}"
                    )

        def gperm(a):
            """a (ne, ...) -> (G, ..., ne_pad) in group order, zero padded."""
            t = a[perm_safe].astype(np_dtype, copy=False)
            t = np.where(
                pos_valid.reshape(G, ne_pad, *([1] * (t.ndim - 2))),
                t, np.zeros((), dtype=np_dtype),
            )
            return np.moveaxis(t, 1, -1)

        # ---- inflow coefficients and boundary sources ----------------------
        # (periodic faces have no upwind neighbour in the sweep and no
        # temperature: their inflow arrives lagged through xsrc)
        fdot = np.einsum(
            "gefd,gkd->gkfe", ops.normals[perm_safe], dirs_np[dirs_safe]
        )  # (G, Km, nf, ne_pad)
        cin_np = np.minimum(fdot, 0.0)
        isb = nbr_pos < 0  # (G, nf, ne_pad)
        cin_bnd = np.where(isb[:, None], cin_np, 0.0)
        cin_int = np.where(isb[:, None], 0.0, cin_np)
        cin_act = cin_int[np.arange(G)[:, None], :, act_f]  # (G,nf_act,Km,E)
        # kernel layout (L, G, Km, nf_act, W)
        ring_cin = cin_act.reshape(G, nf_act, Km, L, W).transpose(3, 0, 2, 1, 4)
        bsrc0 = np.einsum(
            "gkfE,gfE,gfiE->gkiE", cin_bnd, gperm(bc_T), gperm(ops.face_int),
            optimize=True,
        )
        ring_bsrc0 = bsrc0.reshape(G, Km, D, L, W).transpose(3, 0, 1, 2, 4)
        ring_dsrc0 = None
        if dirichlet_bcs:
            dsrc0 = np.einsum(
                "gkfE,gfiE->gkiE", cin_bnd, gperm(dvec), optimize=True
            )
            ring_dsrc0 = dsrc0.reshape(G, Km, D, L, W).transpose(3, 0, 1, 2, 4)

        # ---- class transport factors (host, float64) -----------------------
        # the ring carries v = M^T u: the apply factor is B = M^T A^-1 and
        # M^-T folds into the neighbour couplings
        vg_s = vg / dt_inv  # non-dimensionalized group velocity
        rep = int(np.flatnonzero(cls == 0)[0])
        mass_r = ops.mass[rep]
        massT_r = mass_r.T
        invMT_r = np.linalg.inv(massT_r)
        a_cls = np.empty((G, Km, BS, D, D), dtype=np_dtype)
        for g in range(G):
            dk = dirs_np[dirs_safe[g]]  # (Km, dim)
            fd = np.einsum("fd,kd->kf", ops.normals[rep], dk)
            G_k = -np.einsum("kd,dij->kij", dk, ops.stiff[rep]) + np.einsum(
                "kf,fij->kij", np.maximum(fd, 0.0), ops.face_mass[rep]
            )
            A = mass_r + vg_s[None, :, None, None] * G_k[:, None]
            a_cls[g] = np.matmul(massT_r, np.linalg.inv(A)).astype(np_dtype)
        ccpl_G = np.einsum("fij,jk->fik", ccpl[0], invMT_r).astype(
            np_dtype
        )[act_f]  # (G, nf_act, D, D)
        # folded + concatenated factor: sol = [B | -vg B C_0 | ...] @ xcat
        a64 = a_cls.astype(np.float64)
        bcv = np.einsum(
            "gkbij,gfjl,b->gfkbil", a64, ccpl_G.astype(np.float64), vg_s
        )  # (G, nf_act, Km, BS, D, D)
        bcat = np.concatenate([a64[:, None], -bcv], axis=1)
        bcat = np.moveaxis(bcat, 1, -2).reshape(G, Km, BS, D, -1)
        # per-element M^-T for the closure and the u views
        self._ring_invMT = invMT_r[None].repeat(ne, axis=0)  # (ne, D, D) f64

        # ---- lagged closures (periodic wraps, diffuse/specular walls) -----
        per = _periodic_tables(ops, perm_safe, pos_valid, pos_of_elem, fdot,
                               self._ring_invMT, W)
        refl = _reflective_tables(ops, quad, dirs_pad, pos_of_elem,
                                  self._ring_invMT, W, diffuse_bcs,
                                  specular_bcs)
        self.has_periodic = per is not None
        self._refl_Pd = 0 if refl is None else refl["Pd"]
        self._dif_on = refl is not None and "dif_fvec" in refl
        self._spc_on = refl is not None and "spc_fmv" in refl

        mw = macroscopic.macro_weights(quad, tables)  # (K, BS)
        mw_slots = np.where(dir_valid[..., None], mw[dirs_safe], 0.0)
        fw = macroscopic.flux_weights(quad, tables, dim)  # (dim, K, BS)
        fw_slots = np.where(
            dir_valid[None, ..., None],
            fw[:, dirs_safe.reshape(-1)].reshape(dim, G, Km, BS), 0.0,
        )
        wvec = np.stack([
            inv_kn * heat_cap / (omega * dt_inv),  # src_w
            1.0 - inv_kn / dt_inv,  # relax_w
            vg_s * heat_cap / omega,  # vg * bc_w
            vg_s,
        ])  # (4, BS)

        def put(a, dt=dtype):
            return torch.as_tensor(
                np.ascontiguousarray(a), device=device
            ).to(dt).contiguous()

        def iput(a):
            return put(a, torch.int64)

        def bucket_scatter(gs):
            """The closure targets of the groups gs (closure_scatter)."""
            pairs = [None] * 4
            if per is not None:
                pairs[:2] = per["pl"][gs], per["pw"][gs]
            if refl is not None:
                pairs[2:] = refl["pl"][gs], refl["pw"][gs]
            return closure_scatter(L, W, *pairs)

        scat = [
            bucket_scatter(gs) if per is not None or refl is not None else {}
            for gs, _ in self._ring_buckets
        ]
        # closure elements U of each bucket (the rows of its xval)
        self._closure_u = tuple(int(sc["xmap"].max()) + 1 for sc in scat
                                if sc)

        self.consts = dict(
            perm=iput(perm_safe),  # (G, ne_pad)
            valid_slab=put(
                pos_valid.reshape(G, L, W).transpose(1, 0, 2)
            ),  # (L, G, W): zeroes the lagged source on padded slots
            massT=put(massT_r),  # (D, D): the single geometry class
            wvec=put(wvec),
            pos_of_elem=iput(pos_of_elem),  # (G, ne)
            ring_invMT=put(self._ring_invMT),  # (ne, D, D)
            basis_int_glob=put(ops.basis_int),  # (ne, D)
            flux_w=put(np.moveaxis(fw_slots, 0, -1)),  # (G, Km, BS, dim)
            **{k: (iput(v) if k == "spc_gk" else put(v))
               for k, v in (refl or {}).items() if k in REFL_KEYS},
            buckets=tuple(
                dict(
                    bcat=put(bcat[gs][:, :km_b]),
                    cin=put(ring_cin[:, gs][:, :, :km_b]),
                    bsrc0=put(ring_bsrc0[:, gs, :km_b]),
                    macro_w=put(mw_slots[gs, :km_b]),
                    **(
                        {"dsrc0": put(ring_dsrc0[:, gs, :km_b])}
                        if ring_dsrc0 is not None else {}
                    ),
                    # periodic wraps stay inside a group: per-bucket tables
                    **(
                        dict(
                            per_cpl=put(per["cpl"][gs]),  # (Gb, P, D, D)
                            per_cin=put(per["cin"][gs][:, :km_b]),
                            per_sl=iput(per["sl"][gs]),  # (Gb, P) sources
                            per_sw=iput(per["sw"][gs]),
                        )
                        if per is not None else {}
                    ),
                    **(
                        dict(refl_pl=iput(refl["pl"][gs]),  # (Gb, P)
                             refl_pw=iput(refl["pw"][gs]))
                        if refl is not None else {}
                    ),
                    # xmap (int32, the kernel's), per_uid, refl_uid
                    **{k: put(v, torch.int32) if k == "xmap" else iput(v)
                       for k, v in sc.items()},
                )
                for (gs, km_b), sc in zip(self._ring_buckets, scat)
            ),
        )
        order = np.concatenate([gs for gs, _ in self._ring_buckets])
        inv_order = np.empty(G, dtype=np.int64)
        inv_order[order] = np.arange(G)
        self._inv_order = torch.as_tensor(inv_order, device=device)
        self._bucket_groups = tuple(
            torch.as_tensor(gs, device=device) for gs, _ in self._ring_buckets
        )
        self._bucket_gi = tuple(  # (Gb, 1) group index of a bucket
            torch.arange(len(gs), device=device)[:, None]
            for gs, _ in self._ring_buckets
        )
        self.state_dtype = torch.bfloat16 if self.state_bf16 else dtype
        # the sweep the step calls; the wrapper launches the CUDA kernel for
        # CUDA tensors (assign lattice_ring_sweep_ref to compare with the
        # plain version on the same device)
        self.ring_sweep = lattice_ring_sweep

    # -- state -------------------------------------------------------------

    def initial_state(self):
        """Zero state slabs, Tc and Tv (ref: PBTESolver::CreateInitialCoefficients)."""
        u = tuple(
            torch.zeros(
                (self.L, len(gs), km_b, self.BS, self.D, self.W),
                dtype=self.state_dtype, device=self.device,
            )
            for gs, km_b in self._ring_buckets
        )
        Tc = torch.zeros((self.ne, self.D), dtype=self.dtype, device=self.device)
        Tv = torch.zeros((self.ne,), dtype=self.dtype, device=self.device)
        return u, Tc, Tv

    # -- one outer iteration -------------------------------------------------

    @exact_f32_products()
    def step(self, u, Tc, Tv_prev):
        """One outer iteration: returns (u, Tc, Tv, residual), the residual
        a 0-d tensor on the device. The state's dtype picks the sweep's
        mode: bfloat16 slabs run with bfloat16 product operands, float32 or
        float64 slabs exactly (so a solver built for bfloat16 state also
        steps a float32 copy of it exactly: the polish of ``solve``)."""
        c = self.consts
        G, W, L, D = self.G, self.W, self.L, self.D
        tc_slab = (
            Tc.T[:, c["perm"]].reshape(D, G, L, W).permute(2, 1, 0, 3)
            * c["valid_slab"][:, :, None, :]
        )  # (L, G, D, W), padded slots zeroed (exact-zero fixed points)
        ttc_all = torch.einsum("ij,lgjw->lgiw", c["massT"], tc_slab)
        xsrc = self._closure_sources(u)

        m_parts = []
        v_new = []
        for bi, cb in enumerate(c["buckets"]):
            ys, ms = self.ring_sweep(
                u[bi], ttc_all[:, self._bucket_groups[bi]].contiguous(),
                cb["bsrc0"], cb["cin"], cb["bcat"], cb["macro_w"], c["wvec"],
                shifts=self.shifts, dsrc=cb.get("dsrc0"), xsrc=xsrc[bi],
                cast_bf16=u[bi].dtype == torch.bfloat16,
                win=self.win if self.win_dev is None else self.win_dev,
            )
            v_new.append(ys)
            m_parts.append(ms.sum(dim=1))  # (Gb, L, D, W)

        # macroscopic closure: per-slot partials -> element Tc
        m_cat = torch.cat(m_parts, dim=0)[self._inv_order]  # (G, L, D, W)
        partial = m_cat.permute(0, 2, 1, 3).reshape(G, D, self.ne_pad)
        pos = c["pos_of_elem"][:, None, :].expand(G, D, self.ne)
        Tc_v = torch.gather(partial, 2, pos).sum(dim=0).T  # (ne, D)
        Tc_new = torch.einsum("eij,ej->ei", c["ring_invMT"], Tc_v)
        Tv_new = macroscopic.compute_tv(Tc_new, c["basis_int_glob"])
        res = macroscopic.residual(Tv_new, Tv_prev)
        return tuple(v_new), Tc_new, Tv_new, res

    @exact_f32_products()
    def _closure_sources(self, u):
        """Per-bucket lagged closure sources from the previous iterate u
        (the rhs additions of pbte_tpu's ``_step_ring``,
        ``source_iteration.py:2947-3054``) as the sweep's sparse
        ``ClosureSource``, in the solver dtype; Nones when the problem has
        no periodic or reflective faces."""
        if not (self.has_periodic or self._dif_on or self._spc_on):
            return (None,) * len(u)
        c = self.consts
        acc = self.dtype  # the closure arithmetic (bf16 state upcasts)
        vg = c["wvec"][3]  # (BS,) non-dimensional group velocity
        # contributions add up per closure element (corner elements have
        # several closure faces) in a (Gb, U, Km_b, BS, D) buffer that the
        # sweep reads through the bucket's slot map xmap
        sums = [
            torch.zeros((len(gs), n_u, km_b, self.BS, self.D), dtype=acc,
                        device=self.device)
            for (gs, km_b), n_u in zip(self._ring_buckets, self._closure_u)
        ]

        def add(bi, uid, con):
            """sums[bi][g, uid[g, p]] += con[g, p]."""
            n_u = sums[bi].shape[1]
            rows = (self._bucket_gi[bi] * n_u + uid).reshape(-1)
            sums[bi].view((-1,) + sums[bi].shape[2:]).index_add_(
                0, rows, con.reshape((-1,) + con.shape[2:]))

        # periodic: the wrap partner lies in the same group (and bucket)
        if self.has_periodic:
            for bi, cb in enumerate(c["buckets"]):
                gi = self._bucket_gi[bi]
                v_src = u[bi][cb["per_sl"], gi, :, :, :, cb["per_sw"]].to(acc)
                con = -torch.einsum(  # (Gb, P, Km_b, BS, D)
                    "gpij,gkp,b,gpkbj->gpkbi",
                    cb["per_cpl"], cb["per_cin"], vg, v_src,
                )
                add(bi, cb["per_uid"], con)

        # reflective: diffuse sums outgoing flux over every (group, slot) and
        # the specular mirror slot can lie in any group or bucket, so gather
        # every bucket's boundary values first, dense over (G, Km)
        if self._dif_on or self._spc_on:
            parts = []
            for bi, (gs, km_b) in enumerate(self._ring_buckets):
                cb = c["buckets"][bi]
                vb = u[bi][cb["refl_pl"], self._bucket_gi[bi], :, :, :,
                           cb["refl_pw"]].to(acc)  # (Gb, P, Km_b, BS, D)
                if km_b < self.Km:
                    vb = torch.nn.functional.pad(
                        vb, (0, 0, 0, 0, 0, self.Km - km_b))
                parts.append(vb)
            v_bnd = torch.cat(parts)[self._inv_order]  # (G, P, Km, BS, D)
            pd = self._refl_Pd
            cons = []
            if self._dif_on:
                out_flux = torch.einsum(
                    "gkp,pj,gpkbj->bp",
                    c["dif_wplus"], c["dif_fvec"], v_bnd[:, :pd],
                )
                u_in = out_flux * c["dif_norm"]  # (BS, P_d)
                cons.append(-torch.einsum(
                    "gkp,b,bp,pi->gpkbi",
                    c["dif_cin"], vg, u_in, c["dif_fint"],
                ))
            if self._spc_on:
                v_s = v_bnd[:, pd:].transpose(1, 2)  # (G, Km, P_s, BS, D)
                v_sf = v_s.reshape((-1,) + v_s.shape[2:])  # (G*Km, P_s, ..)
                p_idx = torch.arange(v_s.shape[2], device=v_s.device)
                v_m = v_sf[c["spc_gk"], p_idx]  # (G, Km, P_s, BS, D)
                cons.append(-torch.einsum(
                    "gkp,b,pij,gkpbj->gpkbi",
                    c["spc_cin"], vg, c["spc_fmv"], v_m,
                ))
            refl_con = torch.cat(cons, dim=1)  # (G, P, Km, BS, D)
            for bi, (gs, km_b) in enumerate(self._ring_buckets):
                add(bi, c["buckets"][bi]["refl_uid"],
                    refl_con[self._bucket_groups[bi], :, :km_b])
        return tuple(ClosureSource(cb["xmap"], sm)
                     for cb, sm in zip(c["buckets"], sums))

    def solve(self, tol: float = 1e-7, max_iter: int = 101, state=None,
              verbose: bool = True, callback=None, check_every: int = 1,
              checkpoint_path: str | None = None, checkpoint_every: int = 25,
              accelerate: str | None = None, cycle_hook=None,
              cycle_every: int = 0, polish_iters: int = 0,
              polish_extrapolate: bool = False):
        """Outer source iteration (ref: src/PBTESolver.cpp:208-332). The
        residual is fetched to the host every ``check_every`` iterations.

        ``cycle_hook(it, u, Tc, Tv)`` is called with the live device state
        every ``cycle_every`` iterations (a field-output cadence).

        ``polish_iters`` exact steps follow the loop: the state slabs are
        cast to the solver dtype (float32 after a bfloat16-state solve) and
        stepped without operand rounding, which contracts the bias of the
        rounded fixed point by the iteration's rate per step; the result
        then carries exact-dtype slabs. ``polish_extrapolate`` adds two
        exact steps, estimates the slowest mode's ratio r from their
        successive Tc differences d1, d2 and jumps to the limit of its
        geometric tail, x2 + d2 r / (1 - r) (Aitken), as pbte_tpu does.

        ``accelerate="bicgstab"`` solves the same fixed point as the linear
        system (I - A) x = b by BiCGStab, one plain step per matvec
        (``accel.bicgstab_outer``; float32 or float64 state, float64 for
        deep tolerances): ``tol`` is then the linear relative residual, the
        result carries the Tv residual of a final plain step, and
        ``iterations`` counts step applications. ``None`` or ``"none"`` is
        the plain loop.

        ``checkpoint_path`` is not taken yet."""
        if accelerate not in (None, "none", "bicgstab", "compensated"):
            raise ValueError(f"unknown accelerate={accelerate!r}")
        if checkpoint_path is not None:
            raise NotImplementedError(
                f"solve(checkpoint_path=...): {_CHECKPOINT}")
        if accelerate == "compensated":
            raise NotImplementedError(
                f"solve(accelerate='compensated'): {_COMPENSATED}")
        if accelerate == "bicgstab":
            return self._solve_bicgstab(tol, max_iter, state, verbose,
                                        callback, check_every)
        u, Tc, Tv = state if state is not None else self.initial_state()
        prev_Tv = Tv
        res = float("inf")
        it = 0
        for it in range(1, max_iter + 1):
            u, Tc_new, Tv_new, res_dev = self.step(u, Tc, prev_Tv)
            if it % check_every == 0 or it == max_iter:
                res = float(res_dev)
                if verbose:
                    print(f"[pbte_tpu_torch] iter {it}, residual = {res:.6e}")
                if callback is not None:
                    callback(it, res)
                if res < tol:
                    Tc, prev_Tv = Tc_new, Tv_new
                    break
            prev_Tv = Tv_new
            Tc = Tc_new
            if cycle_hook and cycle_every > 0 and it % cycle_every == 0:
                cycle_hook(it, u, Tc, prev_Tv)
        if polish_iters > 0:
            u = tuple(x.to(self.dtype) for x in u)
            for _ in range(polish_iters):
                u, Tc, prev_Tv, res_dev = self.step(u, Tc, prev_Tv)
                it += 1
            if polish_extrapolate:
                u1, Tc1, Tv1, _ = self.step(u, Tc, prev_Tv)
                u2, Tc2, Tv2, res_dev = self.step(u1, Tc1, Tv1)
                it += 2
                d1 = (Tc1 - Tc).reshape(-1)
                d2 = (Tc2 - Tc1).reshape(-1)
                ratio = float(torch.dot(d2, d1)) / (
                    float(torch.dot(d1, d1)) + 1e-300)
                ratio = min(max(ratio, 0.0), 0.99995)
                fac = ratio / (1.0 - ratio)
                Tc = Tc2 + fac * d2.reshape(Tc2.shape)
                u = tuple(a2 + fac * (a2 - a1) for a2, a1 in zip(u2, u1))
                prev_Tv = Tv2
                if verbose:
                    print(f"[pbte_tpu_torch] polish extrapolation: mode "
                          f"ratio r = {ratio:.6f}, jump factor {fac:.1f}")
            res = float(res_dev)
            if verbose:
                print(f"[pbte_tpu_torch] polish x{polish_iters}: residual = "
                      f"{res:.6e}")
        return SolveResult(
            u=u, Tc=Tc, Tv=prev_Tv, residual=res, iterations=it, solver=self
        )

    def _solve_bicgstab(self, tol, max_iter, state, verbose, callback,
                        check_every):
        """BiCGStab on (I - A) x = b, one matvec = one plain step
        (accel.bicgstab_outer); ``iterations`` counts step applications so
        they compare with the plain loop."""
        from pbte_tpu_torch.solver import accel

        if self.state_bf16:
            raise ValueError(
                "accelerate='bicgstab' needs exact-dtype state recurrences; "
                "unset PBTE_RING_STATE_BF16"
            )
        u_f, Tc_f, Tv_f, tv_res, nmv = accel.bicgstab_outer(
            self.step, self.initial_state(), state, tol, max_iter,
            verbose=verbose, callback=callback, check_every=check_every,
            label="pbte_tpu_torch",
        )
        return SolveResult(u=u_f, Tc=Tc_f, Tv=Tv_f, residual=tv_res,
                           iterations=nmv, solver=self)

    # -- views ----------------------------------------------------------------

    def _ring_u_standard(self, u):
        """Bucketed ring state -> standard (G, Km, BS, D, ne_pad) numpy."""
        host_dt = torch.float64 if self.dtype == torch.float64 else torch.float32
        out = np.zeros((self.G, self.Km, self.BS, self.D, self.ne_pad),
                       dtype=np.float64 if self.dtype == torch.float64
                       else np.float32)
        for bi, (gs, km_b) in enumerate(self._ring_buckets):
            ub = u[bi].detach().to("cpu", host_dt).numpy()
            out[gs, :km_b] = ub.transpose(1, 2, 3, 4, 0, 5).reshape(
                len(gs), km_b, self.BS, self.D, self.ne_pad
            )
        return out

    def u_by_direction(self, u):
        """Map the bucketed ring state to direction-major physical
        coefficients (K, BS, ne, D) (numpy)."""
        us = self._ring_u_standard(u)
        out = np.zeros((self.K, self.BS, self.ne, self.D), dtype=us.dtype)
        for g in range(self.G):
            valid = self._perm[g] >= 0
            elems = self._perm[g][valid]
            for k in range(self.Km):
                d = self.dirs_pad[g, k]
                if d >= 0:
                    out[d, :, elems, :] = us[g, k][:, :, valid].transpose(
                        2, 0, 1
                    )
        # ring state is v = M^T u: convert to physical coefficients
        return np.einsum("eij,kbej->kbei", self._ring_invMT, out)

    def Tc_fine(self, Tc):
        """Per-element temperature coefficients (ne, D): the identity here
        (pbte_tpu de-blocks supercell problems, which this path never
        builds)."""
        return Tc

    @exact_f32_products()
    def heat_flux(self, u):
        """Heat-flux coefficients Qc (dim, ne, D) and cell integrals Qv
        (dim, ne) of the bucketed state, on its device."""
        c = self.consts
        G, D, ne = self.G, self.D, self.ne
        parts = []
        for bi, (gs, km_b) in enumerate(self._ring_buckets):
            fw = c["flux_w"][self._bucket_groups[bi], :km_b]  # (Gb,Km,BS,dim)
            p = torch.einsum("gkbd,lgkbiw->gdilw", fw, u[bi].to(self.dtype))
            parts.append(p.reshape(len(gs), -1, D, self.ne_pad))
        partial = torch.cat(parts)[self._inv_order]  # (G, dim, D, ne_pad)
        dim = partial.shape[1]
        pos = c["pos_of_elem"][:, None, None, :].expand(G, dim, D, ne)
        Qc = torch.gather(partial, 3, pos).sum(dim=0).transpose(1, 2)
        # ring state is v = M^T u: convert the flux coefficients
        Qc = torch.einsum("eij,dej->dei", c["ring_invMT"], Qc)
        Qv = torch.einsum("dei,ei->de", Qc, c["basis_int_glob"])
        return Qc, Qv


def closure_scatter(L, W, per_pl=None, per_pw=None, refl_pl=None,
                    refl_pw=None):
    """Where a bucket's lagged closure contributions land (numpy): per
    contribution, the row of its target among the distinct (level, slot)
    targets of its group, ``per_uid`` (Gb, P_per) and ``refl_uid``
    (Gb, P_refl); and ``xmap`` (L, Gb, W) int32, the row of each slab slot
    or -1. Inputs are the (Gb, P) (level, slot) pairs of the periodic and
    the reflective tables (either may be None). Every group of a box lattice
    holds every element, so each has the same number U of closure
    elements."""
    parts = [a * W + b for a, b in ((per_pl, per_pw), (refl_pl, refl_pw))
             if a is not None]
    flat = np.concatenate(parts, axis=1)  # (Gb, P_per + P_refl)
    uniq, uid = zip(*(np.unique(f, return_inverse=True) for f in flat))
    if len({len(x) for x in uniq}) != 1:
        raise ValueError("groups have different closure target counts")
    uniq, uid = np.stack(uniq), np.stack(uid)
    Gb, U = uniq.shape
    xmap = np.full((Gb, L * W), -1, dtype=np.int32)
    xmap[np.arange(Gb)[:, None], uniq] = np.arange(U, dtype=np.int32)
    out = dict(xmap=np.ascontiguousarray(
        xmap.reshape(Gb, L, W).transpose(1, 0, 2)))
    n_per = 0
    if per_pl is not None:
        n_per = per_pl.shape[1]
        out["per_uid"] = uid[:, :n_per]
    if refl_pl is not None:
        out["refl_uid"] = uid[:, n_per:]
    return out


def _periodic_tables(ops, perm_safe, pos_valid, pos_of_elem, fdot, invMT, W):
    """Lagged periodic wraps as per-group slot lists (pbte_tpu's constructor,
    ``source_iteration.py:1018-1058`` and their ring form at :1346-1361):
    face f of the element at slab position p wraps to the element at
    position src of the same group. Returns None without periodic faces,
    else numpy tables over (G, P), P padded with zero-valid entries:
    ``cpl`` (G, P, D, D) the coupling folded with the source's M^-T, ``cin``
    (G, Km, P) the inflow coefficients, and the (level, slot) pairs ``pl``,
    ``pw`` (destination) and ``sl``, ``sw`` (source)."""
    if not ops.periodic.any():
        return None
    G = perm_safe.shape[0]
    D = ops.ndof
    rows = []
    for g in range(G):
        e_at = perm_safe[g]
        # position-major, then face: pbte_tpu's loop order
        p, f = np.nonzero(pos_valid[g][:, None] & ops.periodic[e_at])
        e = e_at[p]
        rows.append((f, p, pos_of_elem[g, ops.neighbor[e, f]],
                     ops.coupling[e, f]))
    n_per = max(max(len(r[0]) for r in rows), 1)
    face = np.zeros((G, n_per), dtype=np.int64)
    pos = np.zeros((G, n_per), dtype=np.int64)
    src = np.zeros((G, n_per), dtype=np.int64)
    cpl = np.zeros((G, n_per, D, D))
    valid = np.zeros((G, n_per))
    for g, (f, p, sp, c) in enumerate(rows):
        n = len(f)
        face[g, :n], pos[g, :n], src[g, :n], cpl[g, :n] = f, p, sp, c
        valid[g, :n] = 1.0
    src_elem = perm_safe[np.arange(G)[:, None], src]
    cpl = np.einsum("gpij,gpjk->gpik", cpl, invMT[src_elem])
    gi = np.arange(G)[:, None]
    cin = (
        np.minimum(fdot[gi, :, face, pos], 0.0) * valid[:, :, None]
    ).transpose(0, 2, 1)  # (G, Km, P)
    return dict(cpl=cpl, cin=cin, pl=pos // W, pw=pos % W, sl=src // W,
                sw=src % W)


def _reflective_tables(ops, quad, dirs_pad, pos_of_elem, invMT, W,
                       diffuse_bcs, specular_bcs):
    """Lagged diffuse and specular walls (pbte_tpu's constructor,
    ``source_iteration.py:1060-1161``). Returns None without reflective
    faces, else numpy tables: diffuse ``dif_fint`` (P_d, D), ``dif_cin`` and
    ``dif_wplus`` (G, Km, P_d), ``dif_norm`` (P_d,) and ``dif_fvec``
    (P_d, D) = fint M^-T; specular ``spc_cin`` (G, Km, P_s), ``spc_gk``
    (G, Km, P_s) the flat (group, slot) of the mirror direction and
    ``spc_fmv`` (P_s, D, D) = face mass M^-T; the (level, slot) scatter
    pairs ``pl``, ``pw`` (G, P_d + P_s), diffuse rows first; and P_d."""
    dim = ops.dim
    Km = dirs_pad.shape[1]
    dir_valid = dirs_pad >= 0
    dirs_safe = np.where(dir_valid, dirs_pad, 0)
    dirs_np = quad.directions[:, :dim]
    w_glob = quad.weights
    bnd = (ops.neighbor < 0) & ops.face_valid
    out, pls, pws = {}, [], []
    rows_d = np.argwhere(np.isin(ops.face_attr, diffuse_bcs) & bnd)
    if len(rows_d):
        d_e, d_f = rows_d[:, 0], rows_d[:, 1]
        n_d = ops.normals[d_e, d_f]  # (P, dim)
        sdotn_g = np.einsum(
            "gkd,pd->gkp", dirs_np[dirs_safe], n_d
        ) * dir_valid[..., None]  # (G, Km, P), padded slots zeroed
        cn = (
            w_glob[:, None]
            * np.maximum(-np.einsum("kd,pd->kp", dirs_np, n_d), 0.0)
        ).sum(axis=0)  # (P,) incoming-hemisphere weight
        area = ops.face_int[d_e, d_f].sum(axis=-1)  # |F|
        fint = ops.face_int[d_e, d_f]
        pos = pos_of_elem[:, d_e]  # (G, P)
        out.update(
            dif_fint=fint,
            dif_cin=np.minimum(sdotn_g, 0.0),
            dif_wplus=(w_glob[dirs_safe][..., None] * dir_valid[..., None]
                       * np.maximum(sdotn_g, 0.0)),
            dif_norm=1.0 / np.maximum(cn * area, 1e-300),
            dif_fvec=np.einsum("pi,pij->pj", fint, invMT[d_e]),
        )
        pls.append(pos // W)
        pws.append(pos % W)
    rows_s = np.argwhere(np.isin(ops.face_attr, specular_bcs) & bnd)
    if len(rows_s):
        s_e, s_f = rows_s[:, 0], rows_s[:, 1]
        n_s = ops.normals[s_e, s_f]  # (P, dim)
        if np.abs(np.abs(n_s).max(axis=-1) - 1.0).max() > 1e-9:
            raise ValueError("specular faces must be axis-aligned")
        ax_p = np.argmax(np.abs(n_s), axis=-1)  # (P,)
        mirror = mirror_direction_map(
            quad, dim, axes=set(int(a) for a in ax_p)
        )  # (dim, K) global-direction map
        g_of_dir, k_of_dir = planner.dir_slot_maps(dirs_pad)
        km_glob = np.where(
            dir_valid[..., None],
            mirror[ax_p[None, None, :], dirs_safe[..., None]], 0,
        )  # (G, Km, P)
        sdotn_g = np.einsum(
            "gkd,pd->gkp", dirs_np[dirs_safe], n_s
        ) * dir_valid[..., None]
        pos = pos_of_elem[:, s_e]
        out.update(
            spc_cin=np.minimum(sdotn_g, 0.0),
            spc_gk=g_of_dir[km_glob] * Km + k_of_dir[km_glob],
            spc_fmv=np.einsum("pil,plj->pij", ops.face_mass[s_e, s_f],
                              invMT[s_e]),
        )
        pls.append(pos // W)
        pws.append(pos % W)
    if not out:
        return None
    out["pl"] = np.concatenate(pls, axis=1)
    out["pw"] = np.concatenate(pws, axis=1)
    out["Pd"] = len(rows_d)
    return out


@dataclasses.dataclass
class SolveResult:
    u: tuple  # per-bucket (L, Gb, Km_b, BS, D, W) state slabs
    Tc: torch.Tensor  # (ne, D)
    Tv: torch.Tensor  # (ne,)
    residual: float
    iterations: int
    solver: SourceIterationSolver

    def u_dirs(self):
        """Direction-major physical coefficients (K, BS, ne, D) (numpy)."""
        return self.solver.u_by_direction(self.u)
