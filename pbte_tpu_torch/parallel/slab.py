"""Slab-lattice domain decomposition over a grid of ranks.

Port of ``pbte_tpu/parallel/slab.py::SlabLatticeSolver``. The lattice box
is cut into contiguous slabs along a major axis a0 (the largest
non-periodic axis); the ranks form a ``dir`` x ``space`` grid
(``parallel.comm.Grid``): space rank p owns slab p, dir rank d owns a
contiguous block of the Km direction slots of every group. Each rank holds
only its shard: state ``(L, G, Kl, BS, D, W)`` (Kl = Km / n_dir, band-major
as K1 takes it), Tc ``(ne_loc, D)`` and Tv ``(ne_loc,)``.

With transformed slab offsets o'_p, partition p's local level l_loc is the
global level o'_p + l_loc at the same slot w, so every local table is a
slice of the global lattice ring's tables; the owner mask ``0 <= l_loc -
s_w < n_p`` (s_w the plane coordinate sum of slot w) zeroes the slots of
other slabs, which stay exact-zero fixed points of the sweep.

One outer step on every rank:

1. the lagged closure source: the exit layer of the previous iterate
   (``l_loc = n_p - 1 + s_w``) goes downstream over ``space``
   (``Grid.ppermute``, one per sweep sign of a0) and enters the entry rows
   ``l_loc = s_w``; the plane-periodic wraps read the previous iterate at
   static (level, slot) offsets; diffuse walls sum their outgoing flux over
   ``dir`` (``psum``), specular walls read the mirror slot from the
   boundary block gathered over ``dir`` (``all_gather``). pbte_tpu adds
   these terms in solution space after its factor B (``hsol = BCv_a0 @
   (cin_a0 has_up halo)``); here each is the same coupling term before B,
   ``-vg C_f M^-T (cin v)``, added to the rhs through K1's
   ``ClosureSource``, whose product with B gives the same solution term;
2. the shard's sweep: ``ops.lattice_ring.lattice_ring_sweep`` once for all
   groups, K1 on the card, its plain version on the CPU (pbte_tpu's slab
   runs an XLA scan here), on hull windows of the local tables where they
   save enough (the single-device gate);
3. Tc: the macroscopic partials summed over the shard's slots, ``psum``
   over ``dir``, then M^-T; Tv and the residual (max over the grid,
   ``psum`` over ``space``).

Scope as pbte_tpu's: class-uniform Cartesian lattices (one geometry class
after canonical face ordering), isothermal, Dirichlet, diffuse and specular
walls, periodic along the plane axes. ``solve`` runs the plain loop or
``accelerate="bicgstab"`` (``accel.bicgstab_outer`` with the grid's inner
product). Checkpoints keep pbte_tpu's file layout (the global state): rank
0 writes the gathered state, every rank reads the file and takes its
slice, so a file of either package loads in the other. ``gather_Tc``,
``u_by_direction``, ``heat_flux``, ``gather_state`` and the result's
``Tc_global``/``u_dirs`` are collective: every rank calls them, each gets
the global numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbte_tpu_torch import tracing
from pbte_tpu_torch.fem import assembly as _assembly
from pbte_tpu_torch.models import macroscopic
from pbte_tpu_torch.ops.lattice_ring import (
    ClosureSource,
    lattice_ring_sweep,
    windows_on_device,
)
from pbte_tpu_torch.ops.scatter import LayerMemo, index_add_layered_
from pbte_tpu_torch.parallel.comm import Grid
from pbte_tpu_torch.solver.lattice_tables import (
    lattice_ring_tables,
    mirror_direction_map,
    ring_windows,
    window_slots,
)
from pbte_tpu_torch.solver import accel
from pbte_tpu_torch.solver import source_iteration as _si
from pbte_tpu_torch.solver.source_iteration import (
    checked_device,
    exact_f32_products,
)
from pbte_tpu_torch.sweep import planner


class SlabLatticeSolver:
    """Domain-decomposed lattice ring solver over a ``dir`` x ``space``
    grid; this rank's shard on ``device``."""

    @tracing.stage("pbte.setup.solver")
    def __init__(
        self,
        ops,  # fem.assembly.ElementOps (this package's or pbte_tpu's)
        quad,
        tables,
        bc_temps: dict,
        grid: Grid,  # axes ("dir", "space"), pbte_tpu's device_mesh
        dtype: torch.dtype = torch.float32,
        dirichlet_bcs: dict | None = None,
        diffuse_bcs=None,
        specular_bcs=None,
        require_bcs: bool = True,
        device="cuda",
    ):
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        self.device = device = checked_device(device)
        self.dtype = dtype
        self.grid = grid
        self._closure_layers = LayerMemo()  # the closure maps' layers
        n_dir = grid.n("dir")
        P = grid.n("space")
        self.P = P
        self.p = p_me = grid.index("space")
        d_me = grid.index("dir")

        self.ne = ne = ops.num_elements
        self.D = D = ops.ndof
        self.nf = ops.faces_per_elem
        self.dim = dim = ops.dim
        self.K = quad.num_directions
        self.BS = BS = tables.num_branches * tables.num_spectral
        self.omega = quad.total_weight
        self._quad = quad
        self._tables = tables

        inv_kn = tables.flat("inv_kn").astype(np.float64)
        vg = tables.flat("vg").astype(np.float64)
        heat_cap = tables.flat("heat_cap").astype(np.float64)
        self.dt_inv = float(inv_kn.max())
        vg_s = vg / self.dt_inv

        # ---- canonical faces + lattice + single-class requirement ----------
        ops_c = _assembly.permute_faces(ops, _assembly.canonical_face_perm(ops))
        if (_assembly.element_classes(ops_c).max()
                < _assembly.element_classes(ops).max()):
            ops = ops_c
        cls = _assembly.element_classes(ops)
        if int(cls.max()) != 0:
            raise NotImplementedError(
                f"SlabLatticeSolver needs a class-uniform lattice (got "
                f"{int(cls.max()) + 1} classes); use SourceIterationSolver "
                f"with dir_sharding or SpatialShardedSolver instead"
            )
        sweep_nbr = ops.sweep_neighbor
        lat = planner.detect_lattice(sweep_nbr, ops.normals)
        if lat is None:
            raise NotImplementedError(
                "SlabLatticeSolver requires a Cartesian lattice mesh; use "
                "SpatialShardedSolver for unstructured meshes"
            )
        dims = np.asarray(lat.dims)
        self._ops_basis_int = ops.basis_int.copy()

        dirichlet_bcs = dirichlet_bcs or {}
        self.has_dirichlet = bool(dirichlet_bcs)
        diffuse_bcs = sorted(int(a) for a in (diffuse_bcs or ()))
        specular_bcs = sorted(int(a) for a in (specular_bcs or ()))
        self._dif_on = bool(diffuse_bcs)
        self._spc_on = bool(specular_bcs)
        bdry = set(int(a) for a in np.unique(ops.face_attr[ops.neighbor < 0]))
        missing = (
            bdry - set(map(int, bc_temps)) - set(map(int, dirichlet_bcs))
            - set(diffuse_bcs) - set(specular_bcs)
        )
        if missing and require_bcs:
            raise ValueError(
                f"boundary attributes without isothermal BC: {sorted(missing)}"
            )
        bc_T = np.zeros((ne, ops.faces_per_elem))
        for attr, T in bc_temps.items():
            bc_T[ops.face_attr == int(attr)] = float(T)
        dvec = np.zeros((ne, ops.faces_per_elem, D))
        for attr, gval in dirichlet_bcs.items():
            sel = ops.face_attr == int(attr)
            dvec[sel] = float(gval) * ops.face_int[sel]

        # slab axis: largest non-periodic axis
        per_axis = np.array(
            [bool(ops.periodic[:, lat.face_minus[d]].any()) for d in range(dim)]
        )
        self.has_periodic = bool(ops.periodic.any())
        cand = [d for d in range(dim) if not per_axis[d]]
        if not cand:
            raise NotImplementedError("all axes periodic: no valid slab axis")
        a0 = int(max(cand, key=lambda d: dims[d]))
        self.a0 = a0
        plane = [d for d in range(dim) if d != a0]

        # ---- global sweep plan + lattice slab tables -----------------------
        dirs_np = quad.directions[:, :dim]
        plan = planner.build_plan(sweep_nbr, ops.normals, dirs_np)
        self.plan = plan
        G = plan.num_groups
        lt = lattice_ring_tables(lat, plan, dirs_np, major_axis=a0)
        if lt is None:
            raise NotImplementedError("lattice slab tables unavailable")
        tabs, axis_faces, shifts = lt  # (G, L, W), (G, dim), (dim,)
        Lg, W = tabs.shape[1], tabs.shape[2]
        self.W = W
        self.shift_vals = tuple(int(s) for s in shifts)
        n0 = int(dims[a0])
        if dim == 3:
            n2 = int(dims[plane[1]])
            s_w = np.arange(W) // n2 + np.arange(W) % n2
        else:
            n2 = 1
            s_w = np.arange(W)
        self._s_w = s_w.astype(np.int64)

        Km = max(len(d) for d in plan.dirs_of_group)
        Km = -(-Km // n_dir) * n_dir
        self.G, self.Km = G, Km
        self.Kl = Kl = Km // n_dir
        k0 = d_me * Kl
        ks = slice(k0, k0 + Kl)  # this rank's direction slots
        dirs_pad = np.full((G, Km), -1, dtype=np.int64)
        for g, d in enumerate(plan.dirs_of_group):
            dirs_pad[g, : len(d)] = d
        self.dirs_pad = dirs_pad
        dir_valid = dirs_pad >= 0
        dirs_safe = np.where(dir_valid, dirs_pad, 0)
        sgn_a0 = np.array(
            [1 if dirs_np[plan.dirs_of_group[g][0]][a0] > 0 else -1
             for g in range(G)]
        )
        self._g_plus = np.flatnonzero(sgn_a0 > 0)
        self._g_minus = np.flatnonzero(sgn_a0 < 0)

        # ---- class-batched folded transport factors (host, float64) -------
        # B = M^T A^-1 (the ring state is v = M^T u); the coupling of axis j
        # folded with M^-T: C_j M^-T
        rep = int(np.flatnonzero(cls == 0)[0])
        mass_r = ops.mass[rep]
        massT_r = mass_r.T
        invMT = np.linalg.inv(massT_r)
        self._invMT = invMT  # (D, D), uniform
        dk_all = dirs_np[dirs_safe]  # (G, Km, dim)
        fd = np.einsum("fd,gkd->gkf", ops.normals[rep], dk_all)
        G_k = -np.einsum("gkd,dij->gkij", dk_all, ops.stiff[rep]) + np.einsum(
            "gkf,fij->gkij", np.maximum(fd, 0.0), ops.face_mass[rep]
        )
        A = (mass_r[None, None, None]
             + vg_s[None, None, :, None, None] * G_k[:, :, None])
        b_cls = np.einsum("ij,gkbjl->gkbil", massT_r, np.linalg.inv(A))
        ccpl = _assembly.class_coupling(ops, cls)
        if ccpl is None:
            raise NotImplementedError(
                "per-element couplings on a single-class lattice (unexpected)"
            )
        ccplf = np.einsum("fij,jk->fik", ccpl[0], invMT)  # (nf, D, D)
        ccpl_ax = ccplf[axis_faces]  # (G, dim, D, D) axis-ordered inflow
        bcv = np.einsum("gkbij,gfjl,b->gfkbil", b_cls, ccpl_ax, vg_s)
        # K1's folded factor [B | -vg B C_0 | ...] over the axes
        bcat = np.concatenate([b_cls[:, None], -bcv], axis=1)
        bcat = np.moveaxis(bcat, 1, -2).reshape(G, Km, BS, D, -1)
        cin_gjk = np.minimum(
            np.einsum("gjd,gkd->gjk", ops.normals[rep][axis_faces], dk_all),
            0.0,
        )  # (G, dim, Km)

        # ---- slab partition along a0 ---------------------------------------
        base, rem = divmod(n0, P)
        n_p = np.array([base + (p < rem) for p in range(P)])
        if (n_p <= 0).any():
            raise ValueError(f"{P} slabs over n0={n0}: empty partition")
        o_p = np.concatenate([[0], np.cumsum(n_p)[:-1]])
        self.n_p, self.o_p = n_p, o_p
        Lrest = Lg - n0
        L = int(n_p.max()) + Lrest
        self.L = L
        to_plus = o_p
        to_minus = n0 - o_p - n_p

        owner_of_coord = np.zeros(n0, dtype=np.int64)
        for p in range(P):
            owner_of_coord[o_p[p]: o_p[p] + n_p[p]] = p
        owner = owner_of_coord[lat.coords[:, a0]]
        ne_loc = int(np.bincount(owner, minlength=P).max())
        self.ne_loc = ne_loc
        elems_p = np.full((P, ne_loc), -1, dtype=np.int64)
        loc_of_global = np.full(ne, -1, dtype=np.int64)
        for p in range(P):
            es = np.flatnonzero(owner == p)
            elems_p[p, : len(es)] = es
            loc_of_global[es] = np.arange(len(es))
        self.elems_p = elems_p

        lrow = np.arange(L)[:, None]
        own = np.stack([
            (lrow - s_w[None, :] >= 0) & (lrow - s_w[None, :] < n_p[p])
            for p in range(P)
        ])  # (P, L, W)
        # in-sweep inflow mask per (level, axis, slot): the upwind neighbour
        # along axis j lies inside the partition (i'_j > 0)
        ip_ax = np.zeros((L, dim, W), dtype=np.int64)
        ip_ax[:, a0] = lrow - s_w[None, :]
        if dim == 3:
            ip_ax[:, plane[0]] = (np.arange(W) // n2)[None, :]
            ip_ax[:, plane[1]] = (np.arange(W) % n2)[None, :]
        else:
            ip_ax[:, plane[0]] = np.arange(W)[None, :]
        cin_mask = (ip_ax > 0) & own[p_me][:, None, :]  # (L, dim, W)

        def g_off(p, g):
            return int(to_plus[p] if sgn_a0[g] > 0 else to_minus[p])

        tabs_loc = np.full((P, G, L, W), -1, dtype=np.int64)
        for p in range(P):
            lp = int(n_p[p]) + Lrest
            for g in range(G):
                to = g_off(p, g)
                tabs_loc[p, g, :lp] = np.where(own[p, :lp],
                                               tabs[g, to: to + lp], -1)
        self._tabs_loc = tabs_loc
        pos_loc = np.zeros((P, G, ne_loc), dtype=np.int64)
        perm_loc = np.zeros((G, L * W), dtype=np.int64)
        for p in range(P):
            for g in range(G):
                t = tabs_loc[p, g].reshape(-1)
                v = t >= 0
                pos_loc[p, g][loc_of_global[t[v]]] = np.flatnonzero(v)
                if p == p_me:
                    perm_loc[g][v] = loc_of_global[t[v]]
        valid_loc = tabs_loc[p_me] >= 0  # (G, L, W)

        # this partition's boundary (and Dirichlet) source slabs: sum over
        # faces of cin * bc_T * int_F phi (ref: src/PBTESolver.cpp:261-300)
        tl = tabs_loc[p_me].reshape(G, L * W)
        tl_safe = np.where(tl >= 0, tl, 0)
        fdot_full = np.einsum("fd,gkd->gkf", ops.normals[rep],
                              dk_all[:, ks])
        cin_full = np.minimum(fdot_full, 0.0)  # (G, Kl, nf)
        is_bnd = (ops.neighbor[tl_safe] < 0) & (tl >= 0)[:, :, None]
        bsrc = np.einsum("gkf,gpf,gpf,gpfi->gkip", cin_full, is_bnd,
                         bc_T[tl_safe], ops.face_int[tl_safe])  # (G,Kl,D,LW)
        bsrc = bsrc.reshape(G, Kl, D, L, W).transpose(3, 0, 1, 2, 4)
        dsrc = None
        if self.has_dirichlet:
            dsrc = np.einsum("gkf,gpf,gpfi->gkip", cin_full, is_bnd,
                             dvec[tl_safe])
            dsrc = dsrc.reshape(G, Kl, D, L, W).transpose(3, 0, 1, 2, 4)

        # K1's inflow coefficients (L, G, Kl, dim, W): the uniform value of
        # (group, axis, slot) times the in-sweep mask
        ring_cin = (cin_gjk[None, :, :, ks, None]
                    * cin_mask[:, None, :, None, :]).transpose(0, 1, 3, 2, 4)

        # halo tables: exit level per slot; the entry faces are interior iff
        # an upstream slab exists in the group's sweep order
        self._exit_lev = (n_p[p_me] - 1 + s_w).astype(np.int64)  # (W,)
        has_up = np.array([1.0 if g_off(p_me, g) > 0 else 0.0
                           for g in range(G)])

        # periodic wraps (plane axes only): static (level, slot) shifts of
        # the previous iterate, on the owned slots of the wrap set
        wraps = []
        if self.has_periodic:
            if per_axis[a0]:
                raise NotImplementedError(
                    "periodic along the slab axis is unsupported"
                )
            for j in range(dim):
                if not per_axis[j]:
                    continue
                nj = int(dims[j])
                if dim == 3 and j == plane[0]:
                    wshift, wmask = (nj - 1) * n2, np.arange(W) // n2 == 0
                elif dim == 2:
                    wshift, wmask = nj - 1, np.arange(W) == 0
                else:  # plane[1] (3D only)
                    wshift, wmask = nj - 1, np.arange(W) % n2 == 0
                lshift = nj - 1
                tl_, tw_ = np.nonzero(own[p_me] & wmask[None, :]
                                      & (lrow < L - lshift)
                                      & (np.arange(W)[None, :] < W - wshift))
                wraps.append((j, tl_, tw_, tl_ + lshift, tw_ + wshift))

        # ---- lagged reflective walls (legacy types 2/3) --------------------
        w_glob = quad.weights

        def face_tables(attrs):
            """This partition's faces of the attrs, padded to the largest
            partition's count; None when no boundary face carries them."""
            rows = np.argwhere(np.isin(ops.face_attr, attrs)
                               & (ops.neighbor < 0) & ops.face_valid)
            if len(rows) == 0:
                return None
            e_a, f_a = rows[:, 0], rows[:, 1]
            own_f = owner[e_a]
            Pf = max(int(np.bincount(own_f, minlength=P).max()), 1)
            sel = np.flatnonzero(own_f == p_me)
            idx = np.full(Pf, -1, dtype=np.int64)
            idx[: len(sel)] = sel
            vld = idx >= 0
            safe = np.where(vld, idx, 0)
            e_p, f_p = e_a[safe], f_a[safe]  # (Pf,)
            sdotn = np.einsum("gkd,qd->gkq", dk_all, ops.normals[e_p, f_p]) * (
                dir_valid[:, :, None] & vld[None, None, :])  # (G, Km, Pf)
            pos = pos_loc[p_me][:, np.clip(loc_of_global[e_p], 0, None)]
            return e_p, f_p, vld, sdotn, pos // W, pos % W  # pl, pw (G, Pf)

        refl = {}
        if self._dif_on:
            tbl = face_tables(diffuse_bcs)
            self._dif_on = tbl is not None
        if self._dif_on:
            e_p, f_p, vld, sdotn, pl, pw = tbl
            fint_p = ops.face_int[e_p, f_p] * vld[..., None]  # (Pf, D)
            cn = (w_glob[:, None] * np.maximum(
                -np.einsum("kd,qd->kq", dirs_np, ops.normals[e_p, f_p]), 0.0)
            ).sum(axis=0)  # (Pf,) incoming-hemisphere weight
            areaF = fint_p.sum(axis=-1)
            refl["dif"] = dict(
                pl=pl, pw=pw, vld=vld,
                fint=fint_p,
                fvec=np.einsum("qi,ij->qj", fint_p, invMT),
                cin=np.minimum(sdotn, 0.0)[:, ks],  # (G, Kl, Pf)
                wplus=(w_glob[dirs_safe][:, :, None]
                       * np.maximum(sdotn, 0.0))[:, ks],
                norm=1.0 / np.maximum(cn * areaF, 1e-300) * vld,
            )
        if self._spc_on:
            tbl = face_tables(specular_bcs)
            self._spc_on = tbl is not None
        if self._spc_on:
            e_p, f_p, vld, sdotn, pl, pw = tbl
            n_s = ops.normals[e_p, f_p]
            # every partition checks every specular face (the same raise on
            # each rank)
            rows_all = np.argwhere(np.isin(ops.face_attr, specular_bcs)
                                   & (ops.neighbor < 0) & ops.face_valid)
            n_all = ops.normals[rows_all[:, 0], rows_all[:, 1]]
            if (np.abs(np.abs(n_all).max(axis=-1) - 1.0) >= 1e-9).any():
                raise ValueError("specular faces must be axis-aligned")
            ax_p = np.argmax(np.abs(n_s), axis=-1)  # (Pf,)
            mirror = mirror_direction_map(
                quad, dim,
                axes=set(int(a) for a in np.unique(
                    np.argmax(np.abs(n_all), axis=-1))))
            g_of_dir, k_of_dir = planner.dir_slot_maps(dirs_pad)
            km_glob = mirror[ax_p[None, None, :], dirs_safe[:, :, None]]
            km_glob = np.where(
                dir_valid[:, :, None] & vld[None, None, :],
                km_glob, 0)  # (G, Km, Pf)
            fm_p = ops.face_mass[e_p, f_p] * vld[..., None, None]
            refl["spc"] = dict(
                pl=pl, pw=pw, vld=vld,
                fmv=np.einsum("qil,lj->qij", fm_p, invMT),
                cin=np.minimum(sdotn, 0.0)[:, ks],
                gk=(g_of_dir[km_glob] * Km + k_of_dir[km_glob])[:, ks],
            )

        # ---- the closure source's targets: entry rows, wrap rows, wall
        # faces; per group the distinct (level, slot) targets, padded to the
        # largest group's count (the xval rows)
        targets = [np.broadcast_to(s_w * W + np.arange(W), (G, W))]
        valids = [np.ones((G, W), dtype=bool)]
        for (_, tl_, tw_, _, _) in wraps:
            targets.append(np.broadcast_to(tl_ * W + tw_, (G, len(tl_))))
            valids.append(np.ones((G, len(tl_)), dtype=bool))
        for key in ("dif", "spc"):
            if key in refl:
                r = refl[key]
                targets.append(r["pl"] * W + r["pw"])
                valids.append(np.broadcast_to(r["vld"], r["pl"].shape))
        flat = np.concatenate(targets, axis=1)
        vflat = np.concatenate(valids, axis=1)
        uniq = [np.unique(flat[g][vflat[g]]) for g in range(G)]
        U = max(len(x) for x in uniq)
        xmap = np.full((G, L * W), -1, dtype=np.int32)
        uid = np.zeros(flat.shape, dtype=np.int64)
        for g in range(G):
            xmap[g, uniq[g]] = np.arange(len(uniq[g]), dtype=np.int32)
            # invalid (padded) faces add exact zeros at row 0
            uid[g] = np.where(vflat[g], np.searchsorted(uniq[g], flat[g]), 0)
        self._U = U
        offs = np.cumsum([0] + [t.shape[1] for t in targets])

        # ---- hull windows of the shard's tables (the single-device gate) --
        win = ring_windows(tabs_loc[p_me])
        self.win = (win if window_slots(win, _si.WINDOW_TILE)
                    < _si.WINDOW_MAX_SHARE * L * W else None)
        self.win_dev = (windows_on_device(self.win, L, W, device)
                        if self.win is not None and device.type == "cuda"
                        else None)

        # ---- this rank's tensors -------------------------------------------
        mw = macroscopic.macro_weights(quad, tables)
        mw_slots = np.where(dir_valid[..., None], mw[dirs_safe], 0.0)
        wvec = np.stack([
            inv_kn * heat_cap / (self.omega * self.dt_inv),  # src_w
            1.0 - inv_kn / self.dt_inv,  # relax_w
            vg_s * heat_cap / self.omega,  # vg * bc_w
            vg_s,
        ])

        def put(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   device=device).to(dt).contiguous()

        def iput(a):
            return put(a, torch.int64)

        ev = elems_p[p_me] >= 0
        basis_loc = ops.basis_int[np.where(ev, elems_p[p_me], 0)] * ev[:, None]
        c = dict(
            bsrc=put(bsrc),  # (L, G, Kl, D, W)
            cin=put(ring_cin),  # (L, G, Kl, dim, W)
            bcat=put(bcat[:, ks]),  # (G, Kl, BS, D, (1 + dim) D)
            macro_w=put(mw_slots[:, ks]),  # (G, Kl, BS)
            wvec=put(wvec),
            massT=put(massT_r),
            invMT=put(invMT),
            perm_loc=iput(perm_loc),  # (G, L W) local element per slot
            valid=put(valid_loc.transpose(1, 0, 2)),  # (L, G, W)
            pos_loc=iput(pos_loc[p_me]),  # (G, ne_loc)
            basis_int=put(basis_loc),
            elem_valid=put(ev),
            exit_lev=iput(self._exit_lev),
            w_idx=iput(np.arange(W)),
            ccpl_a0=put(ccpl_ax[:, a0]),  # (G, D, D)
            cin_a0=put(cin_gjk[:, a0, ks] * has_up[:, None]),  # (G, Kl)
            xmap=put(xmap.reshape(G, L, W).transpose(1, 0, 2), torch.int32),
            uid_entry=iput(uid[:, offs[0]:offs[1]]),
            **({"dsrc": put(dsrc)} if dsrc is not None else {}),
        )
        c["wraps"] = []
        for wi, (j, tl_, tw_, sl_, sw_) in enumerate(wraps):
            c["wraps"].append(dict(
                sl=iput(sl_), sw=iput(sw_),
                ccpl=put(ccpl_ax[:, j]),  # (G, D, D)
                cin=put(cin_gjk[:, j, ks]),  # (G, Kl)
                uid=iput(uid[:, offs[1 + wi]:offs[2 + wi]]),
            ))
        ri = 1 + len(wraps)
        for key in ("dif", "spc"):
            if key not in refl:
                continue
            r = refl[key]
            t = {k: (iput(v) if k in ("pl", "pw", "gk") else put(v))
                 for k, v in r.items() if k != "vld"}
            t["uid"] = iput(uid[:, offs[ri]:offs[ri + 1]])
            c[key] = t
            ri += 1
        self.consts = c
        self._g_plus_t = torch.as_tensor(self._g_plus, device=device)
        self._g_minus_t = torch.as_tensor(self._g_minus, device=device)
        self._gi = torch.arange(G, device=device)[:, None]
        # the sweep the step calls: K1 on CUDA tensors, its plain version on
        # CPU tensors (assign lattice_ring_sweep_ref to compare on the card)
        self.ring_sweep = lattice_ring_sweep

    # -- state -------------------------------------------------------------

    def initial_state(self):
        """This rank's zero state, Tc and Tv."""
        z = dict(dtype=self.dtype, device=self.device)
        return (torch.zeros((self.L, self.G, self.Kl, self.BS, self.D, self.W),
                            **z),
                torch.zeros((self.ne_loc, self.D), **z),
                torch.zeros((self.ne_loc,), **z))

    # -- one outer iteration -------------------------------------------------

    @exact_f32_products()
    def _closure_source(self, u):
        """The lagged closure source of this shard's sweep from the
        previous iterate u (collective: the halo's ppermute over ``space``
        and the walls' collectives over ``dir``)."""
        c, grid = self.consts, self.grid
        G, Kl, BS, D = self.G, self.Kl, self.BS, self.D
        vg = c["wvec"][3]
        sums = torch.zeros((G, self._U, Kl, BS, D), dtype=self.dtype,
                           device=self.device)

        def add(uid, con):
            """sums[g, uid[g, q]] += con[g, q], one collision-free layer
            of (g, q) pairs at a time."""
            rows = (self._gi * self._U + uid).reshape(-1)
            index_add_layered_(sums.view((-1, Kl, BS, D)), 0, rows,
                               con.reshape((-1, Kl, BS, D)),
                               self._closure_layers.layers(uid, rows))

        # halo: the exit layer goes downstream over space (one permute per
        # sweep sign of a0); ranks at the entry end receive zeros, which
        # their cin_a0 (has_up = 0) annihilates anyway
        ex = u[c["exit_lev"], :, :, :, :, c["w_idx"]]  # (W, G, Kl, BS, D)
        halo = torch.zeros_like(ex)
        Pn = self.P
        for gs, sh in ((self._g_plus_t, 1), (self._g_minus_t, -1)):
            if len(gs) == 0:
                continue
            perm = [(i, i + sh) for i in range(Pn) if 0 <= i + sh < Pn]
            halo[:, gs] = grid.ppermute(ex[:, gs].contiguous(), "space", perm)
        add(c["uid_entry"], -torch.einsum(
            "gij,gk,b,wgkbj->gwkbi", c["ccpl_a0"], c["cin_a0"], vg, halo))

        # plane-periodic wraps: the previous iterate at static offsets
        for wr in c["wraps"]:
            v_src = u[wr["sl"], :, :, :, :, wr["sw"]]  # (n, G, Kl, BS, D)
            add(wr["uid"], -torch.einsum(
                "gij,gk,b,ngkbj->gnkbi", wr["ccpl"], wr["cin"], vg, v_src))

        if "dif" in c:
            t = c["dif"]
            vb = u[t["pl"], self._gi, :, :, :, t["pw"]]  # (G, Pf, Kl, BS, D)
            flux = grid.psum(torch.einsum(
                "gkq,qj,gqkbj->bq", t["wplus"], t["fvec"], vb), "dir")
            u_in = flux * t["norm"][None]  # (BS, Pf)
            add(t["uid"], -torch.einsum(
                "gkq,b,bq,qi->gqkbi", t["cin"], vg, u_in, t["fint"]))
        if "spc" in c:
            t = c["spc"]
            vb = u[t["pl"], self._gi, :, :, :, t["pw"]]  # (G, Pf, Kl, BS, D)
            vb_all = grid.all_gather(vb.contiguous(), "dir", dim=2)
            vfl = vb_all.transpose(1, 2).reshape(
                (G * self.Km,) + tuple(vb.shape[1:2]) + (BS, D))
            p_idx = torch.arange(vb.shape[1], device=self.device)
            v_m = vfl[t["gk"], p_idx]  # (G, Kl, Pf, BS, D)
            add(t["uid"], -torch.einsum(
                "gkq,b,qij,gkqbj->gqkbi", t["cin"], vg, t["fmv"], v_m))
        return ClosureSource(c["xmap"], sums)

    @exact_f32_products()
    def step(self, u, Tc, Tv_prev):
        """One outer iteration on every rank (collective): returns this
        rank's (u, Tc, Tv) and the global residual, a 0-d tensor."""
        c, grid = self.consts, self.grid
        G, D, L, W = self.G, self.D, self.L, self.W
        xsrc = self._closure_source(u)
        tc_slab = (Tc.T[:, c["perm_loc"]].reshape(D, G, L, W)
                   .permute(2, 1, 0, 3) * c["valid"][:, :, None, :])
        ttc = torch.einsum("ij,lgjw->lgiw", c["massT"], tc_slab).contiguous()
        ys, ms = self.ring_sweep(
            u, ttc, c["bsrc"], c["cin"], c["bcat"], c["macro_w"], c["wvec"],
            shifts=self.shift_vals, dsrc=c.get("dsrc"), xsrc=xsrc,
            cast_bf16=False,
            win=self.win if self.win_dev is None else self.win_dev)
        partial = ms.sum(dim=1).permute(0, 2, 1, 3).reshape(G, D, L * W)
        pos = c["pos_loc"][:, None, :].expand(G, D, self.ne_loc)
        Tc_v = torch.gather(partial, 2, pos).sum(dim=0).T  # (ne_loc, D)
        Tc_v = grid.psum(Tc_v, "dir")
        Tc_new = Tc_v @ c["invMT"].T
        Tv_new = torch.einsum("ei,ei->e", Tc_new, c["basis_int"]) \
            * c["elem_valid"]
        scale = torch.clamp(grid.pmax(Tv_new.abs().max(), ("space", "dir")),
                            min=torch.finfo(Tv_new.dtype).tiny)
        a = Tv_new / scale
        b = Tv_prev / scale
        num = grid.psum(((a - b) ** 2).sum(), "space")
        den = grid.psum((a ** 2).sum(), "space")
        res = torch.sqrt(num) / torch.sqrt(den)
        return ys, Tc_new, Tv_new, res

    def grid_dot(self, x, y):
        """<x, y> over the global (u, Tc) tree: u is sharded over both
        axes, Tc replicated over ``dir`` (each value counts once)."""
        du = torch.dot(x[0].reshape(-1), y[0].reshape(-1))
        dt = torch.dot(x[1].reshape(-1), y[1].reshape(-1))
        return (self.grid.psum(du, ("dir", "space"))
                + self.grid.psum(dt, "space"))

    def solve(self, tol=1e-7, max_iter=101, state=None, verbose=True,
              check_every=1, callback=None, checkpoint_path=None,
              checkpoint_every=25, accelerate=None, cycle_hook=None,
              cycle_every=0):
        """The outer iteration (collective), as pbte_tpu's ``solve``; rank
        0 prints and writes the checkpoints."""
        return sharded_solve(self, tol, max_iter, state, verbose,
                             check_every, callback, checkpoint_path,
                             checkpoint_every, accelerate, cycle_hook,
                             cycle_every, "slab", SlabSolveResult)

    # -- global views (collective) ---------------------------------------------

    def gather_state(self, u=None, Tc=None, Tv=None):
        """The global state as pbte_tpu's slab solver holds it (numpy, on
        every rank): u ``(P, L, G, Km, D, BS, W)``, Tc ``(P, ne_loc, D)``,
        Tv ``(P, ne_loc)``; None for an argument not given."""
        grid = self.grid
        out = []
        if u is not None:
            ug = grid.all_gather(u.contiguous(), "dir", dim=2)
            ug = grid.all_gather(ug[None].contiguous(), "space", dim=0)
            out.append(_np(ug).swapaxes(4, 5))
        else:
            out.append(None)
        for t in (Tc, Tv):
            out.append(None if t is None else _np(
                grid.all_gather(t[None].contiguous(), "space", dim=0)))
        return tuple(out)

    def shard_state(self, u, Tc, Tv):
        """This rank's shard of a global numpy state in pbte_tpu's layout
        (``gather_state``'s inverse), as tensors on the solver's device."""
        p, ks = self.p, self._kslice()

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   device=self.device).to(self.dtype)

        return (put(np.asarray(u)[p, :, :, ks].swapaxes(3, 4)),
                put(np.asarray(Tc)[p]), put(np.asarray(Tv)[p]))

    def _kslice(self):
        k0 = self.grid.index("dir") * self.Kl
        return slice(k0, k0 + self.Kl)

    def gather_Tc(self, Tc) -> np.ndarray:
        """(ne, D) global field from every rank's Tc (collective)."""
        Tcg = self.gather_state(Tc=Tc)[1]
        out = np.zeros((self.ne, self.D), dtype=Tcg.dtype)
        for p in range(self.P):
            es = self.elems_p[p]
            m = es >= 0
            out[es[m]] = Tcg[p, m]
        return out

    @property
    def element_partition(self) -> np.ndarray:
        """(ne,) owning slab per element (for partitioned ParaView output)."""
        part = np.full(self.ne, -1, dtype=np.int32)
        for p in range(self.P):
            es = self.elems_p[p]
            part[es[es >= 0]] = p
        return part

    def u_by_direction(self, u) -> np.ndarray:
        """The sharded state -> (K, BS, ne, D) global physical coefficients
        (collective; the ring state is v = M^T u)."""
        ug = self.gather_state(u=u)[0]  # (P, L, G, Km, D, BS, W)
        out = np.zeros((self.K, self.BS, self.ne, self.D), dtype=ug.dtype)
        for p in range(self.P):
            for g in range(self.G):
                tab = self._tabs_loc[p, g]
                ls, ws = np.nonzero(tab >= 0)
                elems = tab[ls, ws]
                for k in range(self.Km):
                    d = self.dirs_pad[g, k]
                    if d < 0:
                        continue
                    vals = ug[p, ls, g, k, :, :, ws]  # (n, D, BS)
                    out[d, :, elems, :] = np.swapaxes(vals, 1, 2)
        return np.einsum("ij,kbej->kbei", self._invMT, out)

    def heat_flux(self, u):
        """Global Qc (dim, ne, D) and Qv (dim, ne) (collective, numpy)."""
        ud = self.u_by_direction(u)
        fw = macroscopic.flux_weights(self._quad, self._tables, self.dim)
        Qc = np.einsum("dkb,kbei->dei", fw, ud)
        Qv = np.einsum("dei,ei->de", Qc, self._ops_basis_int)
        return Qc, Qv

    # -- checkpoints (pbte_tpu's file layout) ----------------------------------

    def fingerprint(self) -> dict:
        """pbte_tpu's checkpoint fingerprint of its slab solver."""
        return dict(G=self.G, Km=self.Km, BS=self.BS, D=self.D, ne=self.ne,
                    K=self.K, dt_inv=self.dt_inv, ne_pad=self.ne,
                    cache_policy=0, use_pallas=0, nparts=self.P,
                    ne_max=self.ne_loc, state_kind=2)

    def save_checkpoint(self, path, u, Tc, Tv, iteration, residual):
        """Gather the state and write pbte_tpu's slab checkpoint from rank
        0 (collective)."""
        write_gathered(self, path, u, Tc, Tv, iteration, residual)

    def load_checkpoint(self, path):
        """((u, Tc, Tv), iteration, residual): this rank's slice of a slab
        checkpoint of either package."""
        from pbte_tpu_torch.io.checkpoint import read_npz

        data = read_npz(path, self.fingerprint())
        want = (self.P, self.L, self.G, self.Km, self.D, self.BS, self.W)
        if tuple(data["u"].shape) != want:
            raise ValueError(f"checkpoint u has shape {data['u'].shape}, "
                             f"solver expects {want}")
        return (self.shard_state(data["u"], data["Tc"], data["Tv"]),
                int(data["iteration"]), float(data["residual"]))


def sharded_solve(solver, tol, max_iter, state, verbose, check_every,
                  callback, checkpoint_path, checkpoint_every, accelerate,
                  cycle_hook, cycle_every, label, result):
    """The outer loop of the sharded solvers (plain or BiCGStab with the
    grid's inner product), on every rank; returns ``result(...)``."""
    verbose = verbose and solver.grid.rank == 0
    if cycle_hook and cycle_every > 0 and accelerate == "bicgstab":
        raise ValueError("cycle_hook is a plain-iteration cadence; the "
                         "Krylov outer loop has no outer iterates to "
                         "export (use accelerate='none' with --vtu-every)")
    if accelerate not in (None, "none", "bicgstab"):
        raise ValueError(f"unknown accelerate={accelerate!r}")
    if accelerate == "bicgstab":
        save_ckpt = None
        if checkpoint_path:
            zeros_tv = solver.initial_state()[2]

            def save_ckpt(u, Tc, nmv, res):
                solver.save_checkpoint(checkpoint_path, u, Tc, zeros_tv,
                                       nmv, res)

        u_f, Tc_f, Tv_f, tv_res, nmv = accel.bicgstab_outer(
            solver.step, solver.initial_state(), state, tol, max_iter,
            verbose=verbose, callback=callback, check_every=check_every,
            label=f"pbte_tpu_torch:{label}", save_ckpt=save_ckpt,
            ckpt_every=checkpoint_every, dot=solver.grid_dot)
        return result(u=u_f, Tc=Tc_f, Tv=Tv_f, residual=tv_res,
                      iterations=nmv, solver=solver)
    save_ckpt = None
    if checkpoint_path:
        def save_ckpt(u, Tc, Tv, it, res, res_dev):
            solver.save_checkpoint(checkpoint_path, u, Tc, Tv, it,
                                   float(res_dev))

    u, Tc, Tv, res, it = accel.plain_outer(
        solver.step, state if state is not None else solver.initial_state(),
        tol, max_iter, verbose=verbose, callback=callback,
        check_every=check_every, save_ckpt=save_ckpt,
        ckpt_every=checkpoint_every, cycle_hook=cycle_hook,
        cycle_every=cycle_every, label=f"pbte_tpu_torch:{label}")
    return result(u=u, Tc=Tc, Tv=Tv, residual=res, iterations=it,
                  solver=solver)


def write_gathered(solver, path, u, Tc, Tv, iteration, residual):
    """A sharded solver's checkpoint: the gathered global state in
    pbte_tpu's layout with its fingerprint, written by rank 0."""
    from pbte_tpu_torch.io.checkpoint import write_npz

    ug, Tcg, Tvg = solver.gather_state(u, Tc, Tv)
    if solver.grid.rank == 0:
        write_npz(path, dict(Tc=Tcg, Tv=Tvg, iteration=iteration,
                             residual=residual, u=ug), solver.fingerprint())
    solver.grid.barrier()


def _np(t):
    return t.detach().cpu().numpy()


@dataclasses.dataclass
class SlabSolveResult:
    u: torch.Tensor
    Tc: torch.Tensor
    Tv: torch.Tensor
    residual: float
    iterations: int
    solver: SlabLatticeSolver

    def Tc_global(self) -> np.ndarray:
        return self.solver.gather_Tc(self.Tc)

    def u_dirs(self) -> np.ndarray:
        return self.solver.u_by_direction(self.u)
