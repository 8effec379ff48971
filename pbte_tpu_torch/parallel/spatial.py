"""Spatially sharded solver: domain decomposition of a general mesh over a
grid of ranks.

Port of ``pbte_tpu/parallel/spatial.py::SpatialShardedSolver``, the
counterpart of the reference's ``DGSolver::PBTE_NonGraySMRT_MPI``:

- the mesh is cut into ``n_space`` partitions (``parallel.partition``:
  RCB, greedy, their FM refinements or the native multilevel partitioner);
  space rank p owns partition p, dir rank d a contiguous block of the Km
  direction slots of every group;
- within a partition the sweep is Gauss-Seidel over local wavefront levels
  (the native ``compute_levels`` on the partition's own upwind subgraph);
  values across partition interfaces are one outer iteration stale
  (block-Jacobi, the reference's once-per-iteration halo exchange). The
  halo goes neighbour to neighbour (``halo_mode="ppermute"``: one
  ``Grid.ppermute`` over ``space`` per partition-graph ring shift) or as
  pbte_tpu's legacy all-reduce of the whole interface buffer (``"psum"``);
- diffuse walls sum their outgoing flux over ``dir`` (``psum``), specular
  walls read the mirror slot from the boundary block gathered over ``dir``
  (``all_gather``), both from the previous iterate; Tc is a ``psum`` over
  ``dir``, the residual a reduction over ``space``.

pbte_tpu runs the local sweep as an XLA scan over levels per group; here it
is torch operations on the shard's tensors, one level of every group at a
time (the levels of different groups are independent): gathers of the
level's elements, the lagged temperature and old-state terms, the upwind
couplings face by face, the class-batched (or per-element) transport
factor, and a scatter of the solutions. The state of a rank is ``(G,
ne_max, Kl, BS, D)`` (element-major, so a level's gathers read whole
rows); ``gather_state`` and ``shard_state`` convert to and from pbte_tpu's
``(P, G, Km, BS, D, ne_max)``. Checkpoints keep pbte_tpu's file layout
(rank 0 writes the gathered state, every rank reads its slice).
``gather_Tc``, ``u_by_direction``, ``heat_flux``, ``gather_state`` and the
result's views are collective.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbte_tpu_torch.fem import assembly as _assembly
from pbte_tpu_torch.models import macroscopic
from pbte_tpu_torch.ops.scatter import LayerMemo, index_add_layered_
from pbte_tpu_torch.parallel import partition as part_mod
from pbte_tpu_torch.parallel.comm import Grid
from pbte_tpu_torch.parallel.slab import sharded_solve, write_gathered
from pbte_tpu_torch.solver.lattice_tables import mirror_direction_map
from pbte_tpu_torch.solver.source_iteration import (
    checked_device,
    exact_f32_products,
)
from pbte_tpu_torch.sweep import planner


class SpatialShardedSolver:
    """Domain-decomposed, ordinate-sharded solver over a ``dir`` x
    ``space`` grid; this rank's shard on ``device``."""

    def __init__(
        self,
        ops,
        quad,
        tables,
        bc_temps: dict,
        grid: Grid,  # axes ("dir", "space"), pbte_tpu's device_mesh
        dtype: torch.dtype = torch.float32,
        partition_method: str = "rcb",
        topo=None,  # MeshTopology (for the partitioner); required
        require_bcs: bool = True,
        dirichlet_bcs: dict | None = None,
        diffuse_bcs=None,
        specular_bcs=None,
        halo_mode: str = "ppermute",
        force_per_element_factors: bool = False,
        device="cuda",
    ):
        if topo is None:
            raise ValueError("SpatialShardedSolver requires the MeshTopology")
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        if halo_mode not in ("ppermute", "psum"):
            raise ValueError(f"unknown halo_mode: {halo_mode}")
        self.device = device = checked_device(device)
        self._wall_layers = LayerMemo()  # the wall maps' layers
        self.dtype = dtype
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        self.grid = grid
        n_dir = grid.n("dir")
        n_space = grid.n("space")
        p_me = grid.index("space")
        self.halo_mode = halo_mode

        self.ne = ops.num_elements
        self.D = D = ops.ndof
        self.nf = nf = ops.faces_per_elem
        self.dim = ops.dim
        self.K = quad.num_directions
        self.BS = BS = tables.num_branches * tables.num_spectral
        self.omega = quad.total_weight

        inv_kn = tables.flat("inv_kn").astype(np.float64)
        vg = tables.flat("vg").astype(np.float64)
        heat_cap = tables.flat("heat_cap").astype(np.float64)
        self.dt_inv = float(inv_kn.max())
        vg_s = vg / self.dt_inv

        self.has_periodic = bool(ops.periodic.any())
        dirichlet_bcs = dirichlet_bcs or {}
        self.has_dirichlet = bool(dirichlet_bcs)
        diffuse_bcs = sorted(int(a) for a in (diffuse_bcs or ()))
        specular_bcs = sorted(int(a) for a in (specular_bcs or ()))
        self._dif_on = bool(diffuse_bcs)
        self._spc_on = bool(specular_bcs)
        bdry_attrs = set(int(a) for a in np.unique(
            ops.face_attr[(ops.neighbor < 0) & ops.face_valid]))
        missing = (bdry_attrs - set(int(k) for k in bc_temps)
                   - set(int(k) for k in dirichlet_bcs)
                   - set(diffuse_bcs) - set(specular_bcs))
        if missing and require_bcs:
            raise ValueError(
                f"boundary attributes without isothermal BC: {sorted(missing)}"
            )
        bc_T_glob = np.zeros((self.ne, nf))
        for attr, T in bc_temps.items():
            bc_T_glob[ops.face_attr == int(attr)] = float(T)
        dvec_glob = np.zeros((self.ne, nf, D))
        for attr, gval in dirichlet_bcs.items():
            sel = ops.face_attr == int(attr)
            dvec_glob[sel] = float(gval) * ops.face_int[sel]

        # ---- global direction grouping (slot layout shared by all ranks) --
        plan = planner.build_plan(ops.sweep_neighbor, ops.normals,
                                  quad.directions)
        self.plan = plan
        G = plan.num_groups
        Km = max(len(d) for d in plan.dirs_of_group)
        Km = -(-Km // n_dir) * n_dir
        self.Kl = Kl = Km // n_dir
        k0 = grid.index("dir") * Kl
        ks = slice(k0, k0 + Kl)
        dirs_pad = np.full((G, Km), -1, dtype=np.int64)
        for g, d in enumerate(plan.dirs_of_group):
            dirs_pad[g, : len(d)] = d
        self.dirs_pad = dirs_pad
        self.G, self.Km = G, Km
        dir_valid = dirs_pad >= 0
        dirs_np = quad.directions[:, : self.dim]
        dirs_safe = np.where(dir_valid, dirs_pad, 0)
        rep_dirs = dirs_np[dirs_safe[:, 0]]

        # ---- spatial partition and this partition's local levels ----------
        pplan = part_mod.build_plan(topo, n_space, method=partition_method)
        self.pplan = pplan
        Pn, ne_max = pplan.nparts, pplan.ne_max
        self.ne_max = ne_max
        ni = max(pplan.num_interface, 1)
        self.ni = ni
        le = pplan.local_elems[p_me]
        nloc = int((le >= 0).sum())
        elems = le[:nloc]
        le_safe = np.where(le >= 0, le, 0)
        le_valid = le >= 0
        loc_nbr = pplan.nbr_local[p_me, :nloc]
        if self.has_periodic:
            # lagged couplings don't constrain the sweep order
            loc_nbr = np.where(ops.periodic[elems], -1, loc_nbr)
        levels = planner.compute_levels(loc_nbr, ops.normals[elems],
                                        rep_dirs)  # (G, nloc)
        # the level table's extents are the largest over the partitions (as
        # pbte_tpu's (P, G, L, W) table), so every rank runs as many levels
        L_max = W_max = 1
        for p in range(Pn):
            lv = levels if p == p_me else self._levels_of(p, pplan, ops,
                                                          rep_dirs)
            if lv.shape[1]:
                L_max = max(L_max, int(lv.max()) + 1)
                for g in range(G):
                    W_max = max(W_max, int(np.bincount(lv[g]).max()))
        levels_tab = np.full((G, L_max, W_max), -1, dtype=np.int64)
        for g in range(G):
            for lv_i in range(int(levels[g].max()) + 1 if nloc else 0):
                el = np.flatnonzero(levels[g] == lv_i)
                levels_tab[g, lv_i, : len(el)] = el
        self.L, self.W = L_max, W_max

        # ---- transport factors: class-batched on few geometry classes -----
        # (canonical face order collapses translated elements' classes; the
        # per-face tables below keep the raw order), else per element
        ops_c = _assembly.permute_faces(ops, _assembly.canonical_face_perm(ops))
        cls_c = _assembly.element_classes(ops_c)
        cls_raw = _assembly.element_classes(ops)
        if int(cls_c.max()) <= int(cls_raw.max()):
            cls_glob, cls_ops = cls_c, ops_c
        else:
            cls_glob, cls_ops = cls_raw, ops
        ncls = int(cls_glob.max()) + 1
        self._spatial_cls = None
        fdot_loc = np.einsum("efd,gkd->gkef", ops.normals[le_safe],
                             dirs_np[dirs_safe[:, ks]])  # (G, Kl, ne_max, nf)
        if ncls <= 64 and ncls * 4 <= self.ne and not force_per_element_factors:
            self._spatial_cls = cls_glob
            reps = np.array([int(np.flatnonzero(cls_glob == c)[0])
                             for c in range(ncls)])
            stiff_r = cls_ops.stiff[reps]
            fmass_r = cls_ops.face_mass[reps]
            mass_r = cls_ops.mass[reps]
            norm_r = cls_ops.normals[reps]
            a_fac = np.empty((G, Kl, BS, ncls, D, D), dtype=np_dtype)
            for g in range(G):
                dk = dirs_np[dirs_safe[g, ks]]
                fd = np.einsum("cfd,kd->ckf", norm_r, dk)
                G_k = -np.einsum("kd,cdij->ckij", dk, stiff_r) + np.einsum(
                    "ckf,cfij->ckij", np.maximum(fd, 0.0), fmass_r)
                A = (mass_r[:, None, None]
                     + vg_s[None, None, :, None, None] * G_k[:, :, None])
                a_fac[g] = np.linalg.inv(A).transpose(1, 2, 0, 3, 4)
            cls_loc = np.where(le_valid, cls_glob[le_safe], 0)
        else:
            # per-element A^-1 of this partition, (G, Kl, BS, ne_max, D, D)
            a_fac = np.empty((G, Kl, BS, ne_max, D, D), dtype=np_dtype)
            stiff_loc = ops.stiff[le_safe]
            fmass_loc = ops.face_mass[le_safe]
            mass_loc = ops.mass[le_safe]
            for g in range(G):
                G_g = -np.einsum("kd,edij->keij", dirs_np[dirs_safe[g, ks]],
                                 stiff_loc) + np.einsum(
                    "kef,efij->keij", np.maximum(fdot_loc[g], 0.0), fmass_loc)
                A_g = (mass_loc[None, None]
                       + vg_s[None, :, None, None, None] * G_g[:, None])
                a_fac[g] = np.linalg.inv(A_g)
            cls_loc = None

        # interface ownership: this partition's local index of each owned
        # interface element
        iface_src = np.full(ni, -1, dtype=np.int64)
        for idx, e in enumerate(pplan.interface):
            if pplan.part[e] == p_me:
                iface_src[idx] = pplan.local_of_global[e]

        # ---- neighbour-to-neighbour halo plan (one permute per ring shift)
        pair_slots = {}
        for q in range(Pn):
            used = np.unique(pplan.nbr_iface[q][pplan.nbr_iface[q] >= 0])
            for idx in used:
                psrc = int(pplan.part[int(pplan.interface[idx])])
                if psrc != q:
                    pair_slots.setdefault((psrc, q), []).append(int(idx))
        shifts = sorted({(q - p) % Pn for (p, q) in pair_slots}) or [0]
        Ms = max((len(v) for v in pair_slots.values()), default=1)
        halo_send = np.zeros((len(shifts), Ms), dtype=np.int64)
        halo_recv = np.full((len(shifts), Ms), ni, dtype=np.int64)
        for (p, q), slots in pair_slots.items():
            s_i = shifts.index((q - p) % Pn)
            slots = sorted(slots)
            if p == p_me:
                halo_send[s_i, : len(slots)] = [
                    int(pplan.local_of_global[pplan.interface[i]])
                    for i in slots]
            if q == p_me:
                halo_recv[s_i, : len(slots)] = slots
        self._halo_shifts = shifts
        self.halo_bytes_per_shard = (
            sum(len(v) for v in pair_slots.values()) / max(Pn, 1))

        # ---- lagged reflective walls (legacy types 2/3) --------------------
        w_glob = quad.weights

        def part_rows(attr_list):
            rows = np.argwhere(np.isin(ops.face_attr, attr_list)
                               & (ops.neighbor < 0) & ops.face_valid)
            per_part = [[] for _ in range(Pn)]
            for e, f in rows:
                per_part[int(pplan.part[e])].append((int(e), int(f)))
            return rows, per_part

        refl = {}
        if self._dif_on:
            rows_d, per_d = part_rows(diffuse_bcs)
            self._dif_on = len(rows_d) > 0
        if self._dif_on:
            Pd = max(1, max(len(s) for s in per_d))
            t = dict(pos=np.zeros(Pd, np.int64), fint=np.zeros((Pd, D)),
                     norm=np.zeros(Pd), cin=np.zeros((G, Km, Pd)),
                     wplus=np.zeros((G, Km, Pd)))
            for j, (e, f) in enumerate(per_d[p_me]):
                n = ops.normals[e, f]
                sdotn = np.einsum("gkd,d->gk", dirs_np[dirs_safe], n) * dir_valid
                cn = (w_glob * np.maximum(-dirs_np @ n, 0.0)).sum()
                t["pos"][j] = pplan.local_of_global[e]
                t["fint"][j] = ops.face_int[e, f]
                t["norm"][j] = 1.0 / max(cn * ops.face_int[e, f].sum(),
                                         1e-300)
                t["cin"][:, :, j] = np.minimum(sdotn, 0.0)
                t["wplus"][:, :, j] = (w_glob[dirs_safe] * dir_valid
                                       * np.maximum(sdotn, 0.0))
            t["cin"], t["wplus"] = t["cin"][:, ks], t["wplus"][:, ks]
            refl["dif"] = t
        if self._spc_on:
            rows_s, per_s = part_rows(specular_bcs)
            self._spc_on = len(rows_s) > 0
        if self._spc_on:
            n_all = ops.normals[rows_s[:, 0], rows_s[:, 1]]
            if np.abs(np.abs(n_all).max(axis=-1) - 1.0).max() > 1e-9:
                raise ValueError("specular faces must be axis-aligned")
            axes = set(int(a) for a in np.argmax(np.abs(n_all), axis=-1))
            mirror = mirror_direction_map(quad, self.dim, axes=axes)
            g_of_dir, k_of_dir = planner.dir_slot_maps(dirs_pad)
            Ps = max(1, max(len(s) for s in per_s))
            t = dict(pos=np.zeros(Ps, np.int64), fm=np.zeros((Ps, D, D)),
                     cin=np.zeros((G, Km, Ps)),
                     gk=np.zeros((G, Km, Ps), np.int64))
            for j, (e, f) in enumerate(per_s[p_me]):
                n = ops.normals[e, f]
                ax = int(np.argmax(np.abs(n)))
                sdotn = np.einsum("gkd,d->gk", dirs_np[dirs_safe], n) * dir_valid
                km_glob = np.where(dir_valid, mirror[ax, dirs_safe], 0)
                t["pos"][j] = pplan.local_of_global[e]
                t["fm"][j] = ops.face_mass[e, f]
                t["cin"][:, :, j] = np.minimum(sdotn, 0.0)
                t["gk"][:, :, j] = g_of_dir[km_glob] * Km + k_of_dir[km_glob]
            t["cin"], t["gk"] = t["cin"][:, ks], t["gk"][:, ks]
            refl["spc"] = t

        mw = macroscopic.macro_weights(quad, tables)
        mw_slots = np.where(dir_valid[..., None], mw[dirs_safe], 0.0)

        # ---- this rank's tensors -------------------------------------------
        def put(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   device=device).to(dt).contiguous()

        def iput(a):
            return put(a, torch.int64)

        ev = le_valid
        c = dict(
            massT=put(np.swapaxes(ops.mass[le_safe], -1, -2)
                      * ev[:, None, None]),  # (ne_max, D, D)
            face_int=put(ops.face_int[le_safe] * ev[:, None, None]),
            coupling=put(ops.coupling[le_safe] * ev[:, None, None, None]),
            nbr_local=iput(pplan.nbr_local[p_me]),  # (ne_max, nf)
            nbr_iface=iput(pplan.nbr_iface[p_me]),
            bc_T=put(bc_T_glob[le_safe] * ev[:, None]),  # (ne_max, nf)
            basis_int=put(ops.basis_int[le_safe] * ev[:, None]),
            elem_valid=put(ev),
            vg=put(vg_s),
            src_w=put(inv_kn * heat_cap / (self.omega * self.dt_inv)),
            relax_w=put(1.0 - inv_kn / self.dt_inv),
            bc_w=put(heat_cap / self.omega),
            macro_w=put(mw_slots[:, ks]),  # (G, Kl, BS)
            levels=iput(levels_tab),  # (G, L, W)
            cin=put(np.minimum(fdot_loc, 0.0)),  # (G, Kl, ne_max, nf)
            a_fac=put(a_fac),
            iface_src=iput(iface_src),
            halo_send=iput(halo_send),
            halo_recv=iput(halo_recv),
        )
        if cls_loc is not None:
            c["cls_loc"] = iput(cls_loc)
        if self.has_dirichlet:
            c["dvec"] = put(dvec_glob[le_safe] * ev[:, None, None])
        if self.has_periodic:
            c["per_loc"] = put(ops.periodic[le_safe] & ev[:, None],
                               torch.bool)
        for key, t in refl.items():
            c[key] = {k: (iput(v) if k in ("pos", "gk") else put(v))
                      for k, v in t.items()}
        self.consts = c
        self._gi = torch.arange(G, device=device)[:, None]
        # host references for the output views
        self._quad = quad
        self._tables = tables
        self._basis_int_glob = ops.basis_int.copy()
        self._mesh_data = topo.mesh
        self._order = ops.order

    @staticmethod
    def _levels_of(p, pplan, ops, rep_dirs):
        """Partition p's local levels (G, nloc_p): every rank computes
        every partition's, to agree on the level table's extents."""
        le = pplan.local_elems[p]
        nloc = int((le >= 0).sum())
        elems = le[:nloc]
        loc_nbr = pplan.nbr_local[p, :nloc]
        if ops.periodic.any():
            loc_nbr = np.where(ops.periodic[elems], -1, loc_nbr)
        return planner.compute_levels(loc_nbr, ops.normals[elems], rep_dirs)

    # -- state -------------------------------------------------------------

    def initial_state(self):
        """This rank's zero state ``(G, ne_max, Kl, BS, D)``, Tc and Tv."""
        z = dict(dtype=self.dtype, device=self.device)
        return (torch.zeros((self.G, self.ne_max, self.Kl, self.BS, self.D),
                            **z),
                torch.zeros((self.ne_max, self.D), **z),
                torch.zeros((self.ne_max,), **z))

    # -- one outer iteration -------------------------------------------------

    def _halo(self, u):
        """The lagged interface values (G, ni, Kl, BS, D) (collective over
        ``space``)."""
        c, grid = self.consts, self.grid
        if self.halo_mode == "psum":
            owned = c["iface_src"] >= 0
            src = torch.where(owned, c["iface_src"], 0)
            contrib = u[:, src] * owned[None, :, None, None, None]
            return grid.psum(contrib, "space")
        Pn = self.pplan.nparts
        halo = torch.zeros((self.G, self.ni + 1) + tuple(u.shape[2:]),
                           dtype=u.dtype, device=u.device)
        for s_i, shift in enumerate(self._halo_shifts):
            buf = u[:, c["halo_send"][s_i]].contiguous()  # (G, Ms, ...)
            recv = grid.ppermute(buf, "space",
                                 [(i, (i + shift) % Pn) for i in range(Pn)])
            halo[:, c["halo_recv"][s_i]] = recv  # row ni: dropped
        return halo[:, : self.ni]

    def _reflective(self, u):
        """The lagged wall terms (G, ne_max, Kl, BS, D) or None."""
        if not (self._dif_on or self._spc_on):
            return None
        c, grid = self.consts, self.grid
        vg = c["vg"]
        out = torch.zeros_like(u)
        if self._dif_on:
            t = c["dif"]
            u_d = u[:, t["pos"]]  # (G, Pd, Kl, BS, D)
            outf = grid.psum(torch.einsum("gkp,pi,gpkbi->bp", t["wplus"],
                                          t["fint"], u_d), "dir")
            u_in = outf * t["norm"][None, :]
            index_add_layered_(out, 1, t["pos"], -torch.einsum(
                "gkp,b,bp,pi->gpkbi", t["cin"], vg, u_in, t["fint"]),
                self._wall_layers.layers(t["pos"]))
        if self._spc_on:
            t = c["spc"]
            u_s = u[:, t["pos"]]  # (G, Ps, Kl, BS, D)
            u_all = grid.all_gather(u_s.contiguous(), "dir", dim=2)
            u_flat = u_all.transpose(1, 2).reshape(
                (self.G * self.Km,) + tuple(u_s.shape[1:2]) + tuple(
                    u_s.shape[3:]))  # (G Km, Ps, BS, D)
            p_idx = torch.arange(u_s.shape[1], device=u.device)
            u_m = u_flat[t["gk"], p_idx]  # (G, Kl, Ps, BS, D)
            index_add_layered_(out, 1, t["pos"], -torch.einsum(
                "gkp,b,pij,gkpbj->gpkbi", t["cin"], vg, t["fm"], u_m),
                self._wall_layers.layers(t["pos"]))
        return out

    @exact_f32_products()
    def step(self, u, Tc, Tv_prev):
        """One outer iteration on every rank (collective): returns this
        rank's (u, Tc, Tv) and the global residual, a 0-d tensor; u is not
        modified."""
        c, grid = self.consts, self.grid
        nf = self.nf
        gi = self._gi
        halo = self._halo(u)
        refl = self._reflective(u)
        u_prev = u
        u = u.clone()
        vg = c["vg"][None, None, :, None]
        src_w = c["src_w"][None, None, :, None]
        relax_w = c["relax_w"][None, None, :, None]
        bc_w = c["bc_w"][None, None, :, None]
        for lv in range(self.L):
            es_raw = c["levels"][:, lv]  # (G, W)
            valid = es_raw >= 0
            es = torch.where(valid, es_raw, 0)
            Mt = c["massT"][es]  # (G, W, D, D)
            t_tc = torch.einsum("gwij,gwj->gwi", Mt, Tc[es])
            t_old = torch.einsum("gwij,gwkbj->gwkbi", Mt, u[gi, es])
            rhs = (src_w * t_tc[:, :, None, None, :]
                   + relax_w * t_old)  # (G, W, Kl, BS, D)
            if refl is not None:
                rhs = rhs + refl[gi, es]
            for f in range(nf):
                nl = c["nbr_local"][es, f]  # (G, W)
                nif = c["nbr_iface"][es, f]
                is_b = (nl < 0) & (nif < 0)
                cin = c["cin"][gi, :, es, f]  # (G, W, Kl)
                nl_s = torch.where(nl >= 0, nl, 0)
                u_loc = u[gi, nl_s]
                if self.has_periodic:
                    # a local periodic partner: the previous outer iterate
                    u_loc = torch.where(
                        c["per_loc"][es, f][:, :, None, None, None],
                        u_prev[gi, nl_s], u_loc)
                u_rem = halo[gi, torch.where(nif >= 0, nif, 0)]
                u_nbr = torch.where((nl >= 0)[:, :, None, None, None],
                                    u_loc, u_rem)
                cu = torch.einsum("gwij,gwkbj->gwkbi", c["coupling"][es, f],
                                  u_nbr)
                bterm = (bc_w * c["bc_T"][es, f][:, :, None, None, None]
                         * c["face_int"][es, f][:, :, None, None, :])
                if self.has_dirichlet:
                    bterm = bterm + c["dvec"][es, f][:, :, None, None, :]
                term = torch.where(is_b[:, :, None, None, None], bterm, cu)
                rhs = rhs - vg * cin[:, :, :, None, None] * term
            if self._spatial_cls is not None:
                a_es = c["a_fac"][gi, :, :, c["cls_loc"][es]]
            else:
                a_es = c["a_fac"][gi, :, :, es]  # (G, W, Kl, BS, D, D)
            sol = torch.einsum("gwkbij,gwkbj->gwkbi", a_es, rhs)
            gsel, wsel = torch.nonzero(valid, as_tuple=True)
            u[gsel, es[gsel, wsel]] = sol[gsel, wsel]

        Tc_new = grid.psum(torch.einsum("gkb,gekbi->ei", c["macro_w"], u),
                           "dir")
        Tv_new = torch.einsum("ei,ei->e", Tc_new, c["basis_int"])
        Tv_new = Tv_new * c["elem_valid"]
        scale = torch.clamp(grid.pmax(Tv_new.abs().max(), ("space", "dir")),
                            min=torch.finfo(Tv_new.dtype).tiny)
        a = Tv_new / scale
        b = Tv_prev / scale
        num = grid.psum(((a - b) ** 2).sum(), "space")
        den = grid.psum((a ** 2).sum(), "space")
        res = torch.sqrt(num) / torch.sqrt(den)
        return u, Tc_new, Tv_new, res

    def grid_dot(self, x, y):
        """<x, y> over the global (u, Tc) tree: u sharded over both axes,
        Tc replicated over ``dir`` (each value counts once)."""
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
                             cycle_every, "spatial", SpatialSolveResult)

    # -- global views (collective) ---------------------------------------------

    def gather_state(self, u=None, Tc=None, Tv=None):
        """The global state as pbte_tpu's spatial solver holds it (numpy,
        on every rank): u ``(P, G, Km, BS, D, ne_max)``, Tc ``(P, ne_max,
        D)``, Tv ``(P, ne_max)``; None for an argument not given."""
        grid = self.grid
        out = []
        if u is not None:
            ug = grid.all_gather(u.contiguous(), "dir", dim=2)
            ug = grid.all_gather(ug[None].contiguous(), "space", dim=0)
            out.append(ug.permute(0, 1, 3, 4, 5, 2).cpu().numpy())
        else:
            out.append(None)
        for t in (Tc, Tv):
            out.append(None if t is None else grid.all_gather(
                t[None].contiguous(), "space", dim=0).cpu().numpy())
        return tuple(out)

    def shard_state(self, u, Tc, Tv):
        """This rank's shard of a global numpy state in pbte_tpu's layout
        (``gather_state``'s inverse), as tensors on the solver's device."""
        p = self.grid.index("space")
        k0 = self.grid.index("dir") * self.Kl

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   device=self.device).to(self.dtype)

        ub = np.asarray(u)[p, :, k0:k0 + self.Kl]  # (G, Kl, BS, D, ne_max)
        return (put(np.moveaxis(ub, -1, 1)), put(np.asarray(Tc)[p]),
                put(np.asarray(Tv)[p]))

    def gather_Tc(self, Tc) -> np.ndarray:
        """(ne, D) global field (collective)."""
        Tcg = self.gather_state(Tc=Tc)[1]
        out = np.zeros((self.ne, self.D), dtype=Tcg.dtype)
        for p in range(self.pplan.nparts):
            elems = self.pplan.local_elems[p]
            mask = elems >= 0
            out[elems[mask]] = Tcg[p, mask]
        return out

    def u_by_direction(self, u) -> np.ndarray:
        """(K, BS, ne, D) global, direction-major (collective)."""
        ug = self.gather_state(u=u)[0]  # (P, G, Km, BS, D, ne_max)
        out = np.zeros((self.K, self.BS, self.ne, self.D), dtype=ug.dtype)
        for p in range(self.pplan.nparts):
            elems = self.pplan.local_elems[p]
            mask = elems >= 0
            ge = elems[mask]
            for g in range(self.G):
                for k in range(self.Km):
                    d = self.dirs_pad[g, k]
                    if d >= 0:
                        out[d, :, ge, :] = ug[p, g, k][:, :, mask].transpose(
                            2, 0, 1)
        return out

    def heat_flux(self, u):
        """Global Qc (dim, ne, D) and Qv (dim, ne) (collective, numpy)."""
        ud = self.u_by_direction(u)
        fw = macroscopic.flux_weights(self._quad, self._tables, self.dim)
        Qc = np.einsum("dkb,kbei->dei", fw, ud)
        Qv = np.einsum("dei,ei->de", Qc, self._basis_int_glob)
        return Qc, Qv

    @property
    def element_partition(self) -> np.ndarray:
        """(ne,) owning partition per element (for ParaView pieces)."""
        return self.pplan.part

    def paraview_pieces(self, Tc, u=None):
        """Per-partition field blocks for ``io.vtu.write_pvtu`` /
        ``ParaViewCollection.save_pieces`` (collective: every rank gets
        every piece). Returns ``[(elem_ids, {"T": (ne_p, D)}, {"Q": (dim,
        ne_p, D)}), ...]`` ("Q" only when u is given)."""
        ug, Tcg, _ = self.gather_state(u, Tc)
        if ug is not None:
            fw = macroscopic.flux_weights(self._quad, self._tables, self.dim)
            valid = self.dirs_pad >= 0
            fw_pad = (fw[:, np.where(valid, self.dirs_pad, 0), :]
                      * valid[None, :, :, None])
        pieces = []
        for p in range(self.pplan.nparts):
            elems = self.pplan.local_elems[p]
            mask = elems >= 0
            vf = {}
            if ug is not None:
                Qc_p = np.einsum("dgkb,gkbie->die", fw_pad, ug[p])
                vf["Q"] = Qc_p[:, :, mask].transpose(0, 2, 1)
            pieces.append((elems[mask], {"T": Tcg[p, mask]}, vf))
        return pieces

    def write_paraview(self, Tc, u=None, name="pbte_fields",
                       root="output/vis", cycle=0, time=None, lod=None,
                       collection=None):
        """One .vtu piece per partition under data.pvtu and a .pvd
        collection (collective; rank 0 writes). Returns the .pvd path."""
        from pbte_tpu_torch.io.vtu import ParaViewCollection

        pieces = self.paraview_pieces(Tc, u)
        path = None
        if self.grid.rank == 0:
            if collection is None:
                collection = ParaViewCollection(
                    self._mesh_data, self._order, name=name, root=root,
                    lod=lod)
            path = collection.save_pieces(pieces, cycle=cycle, time=time)
        self.grid.barrier()
        return path

    # -- checkpoints (pbte_tpu's file layout) ----------------------------------

    def fingerprint(self) -> dict:
        """pbte_tpu's checkpoint fingerprint of its spatial solver."""
        return dict(G=self.G, Km=self.Km, BS=self.BS, D=self.D, ne=self.ne,
                    K=self.K, dt_inv=self.dt_inv, ne_pad=self.ne,
                    cache_policy=0, use_pallas=0,
                    nparts=self.pplan.nparts, ne_max=self.ne_max)

    def save_checkpoint(self, path, u, Tc, Tv, iteration, residual):
        """Gather the state and write pbte_tpu's spatial checkpoint from
        rank 0 (collective)."""
        write_gathered(self, path, u, Tc, Tv, iteration, residual)

    def load_checkpoint(self, path):
        from pbte_tpu_torch.io.checkpoint import read_npz

        data = read_npz(path, self.fingerprint())
        want = (self.pplan.nparts, self.G, self.Km, self.BS, self.D,
                self.ne_max)
        if tuple(data["u"].shape) != want:
            raise ValueError(f"checkpoint u has shape {data['u'].shape}, "
                             f"solver expects {want}")
        return (self.shard_state(data["u"], data["Tc"], data["Tv"]),
                int(data["iteration"]), float(data["residual"]))


@dataclasses.dataclass
class SpatialSolveResult:
    u: torch.Tensor
    Tc: torch.Tensor
    Tv: torch.Tensor
    residual: float
    iterations: int
    solver: SpatialShardedSolver

    def Tc_global(self) -> np.ndarray:
        return self.solver.gather_Tc(self.Tc)

    def u_dirs(self) -> np.ndarray:
        return self.solver.u_by_direction(self.u)
