"""Source-iteration PBTE solver on the lattice ring sweep (PyTorch + CUDA).

Port of ``pbte_tpu/solver/source_iteration.py::SourceIterationSolver``,
restricted to the path its Pallas kernel serves: a single-class Cartesian
box lattice swept by the shift-structured ring (no supercell merge, no
periodic or reflective closures, one device). The flagship (hex 16^3,
p=2, 64 directions x 40 bands, f32) takes this path.

Construction is numpy host math on the framework-free layers of
``pbte_tpu`` (mesh, FEM assembly, quadrature, material tables, sweep plan,
``_lattice_ring_tables``); the results become tensors on ``device`` in a
``consts`` dict. One outer step:

1. builds the lagged-temperature slab ``M^T Tc`` (one einsum);
2. runs ``ops.lattice_ring.lattice_ring_sweep`` once per Km bucket (the
   CUDA kernel for CUDA tensors, the plain version for CPU tensors);
3. regroups the per-level macroscopic partials into Tc through the
   ``pos_of_elem`` gather and ``M^-T``, then Tv;
4. computes the scale-invariant residual.

State layout: a tuple of per-bucket ``(L, Gb, Km_b, BS, D, W)`` slabs of
the mass-transformed state ``v = M^T u`` (band-major, as on the JAX
Pallas path), float32 or, with ``PBTE_RING_STATE_BF16=1``, bfloat16.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from pbte_tpu.fem import assembly
from pbte_tpu.solver.source_iteration import _lattice_ring_tables
from pbte_tpu.sweep import planner
from pbte_tpu_torch.models import macroscopic
from pbte_tpu_torch.ops.lattice_ring import lattice_ring_sweep

_RING_FAMILY = "ROADMAP.md queue 1, item 6 (the rest of the ring family)"
_SCAN_PATH = "ROADMAP.md queue 1, item 7 (scan path)"


class SourceIterationSolver:
    """Build once per (mesh, angles, material, bcs) problem; step on
    ``device``."""

    def __init__(
        self,
        ops,  # pbte_tpu.fem.assembly.ElementOps
        quad,  # pbte_tpu.angular.quadrature.AngularQuad
        tables,  # pbte_tpu.material.nongray_smrt.PhononTables
        bc_temps: dict,  # boundary attr -> temperature deviation
        dirichlet_bcs: dict | None = None,  # attr -> prescribed incoming
        dtype: torch.dtype = torch.float32,
        device="cpu",
        *,
        diffuse_bcs=None,
        specular_bcs=None,
    ):
        self.device = device = torch.device(device)
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        if dtype == torch.float64 and device.type != "cpu":
            raise NotImplementedError(
                "float64 runs on the CPU only, through the plain sweep; the "
                "CUDA kernel takes float32 or bfloat16 state"
            )
        if diffuse_bcs or specular_bcs:
            raise NotImplementedError(
                f"diffuse/specular reflective BCs: {_RING_FAMILY}"
            )
        if ops.periodic.any():
            raise NotImplementedError(f"periodic wraps: {_RING_FAMILY}")
        # the closure einsums are float32 references for the kernel: keep
        # TF32 (about three decimal digits) out of every product
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
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

        dirichlet_bcs = dirichlet_bcs or {}
        bdry_attrs = set(int(a) for a in np.unique(
            ops.face_attr[(ops.neighbor < 0) & ops.face_valid]
        ))
        missing = (
            bdry_attrs
            - set(int(k) for k in bc_temps)
            - set(int(k) for k in dirichlet_bcs)
        )
        if missing:
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
        lt = None if lat is None else _lattice_ring_tables(lat, plan, dirs_np)
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

        mw = macroscopic.macro_weights(quad, tables)  # (K, BS)
        mw_slots = np.where(dir_valid[..., None], mw[dirs_safe], 0.0)
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
                )
                for gs, km_b in self._ring_buckets
            ),
        )
        order = np.concatenate([gs for gs, _ in self._ring_buckets])
        inv_order = np.empty(G, dtype=np.int64)
        inv_order[order] = np.arange(G)
        self._inv_order = torch.as_tensor(inv_order, device=device)
        self._bucket_groups = tuple(
            torch.as_tensor(gs, device=device) for gs, _ in self._ring_buckets
        )
        # bf16 state (same opt-in as pbte_tpu): halves the state streams;
        # the product operands and the ring are then bf16 as well, and the
        # macroscopic partials stay f32
        self.state_bf16 = (
            dtype == torch.float32
            and os.environ.get("PBTE_RING_STATE_BF16", "") == "1"
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

    def step(self, u, Tc, Tv_prev):
        """One outer iteration: returns (u, Tc, Tv, residual), the residual
        a 0-d tensor on the device."""
        c = self.consts
        G, W, L, D = self.G, self.W, self.L, self.D
        tc_slab = (
            Tc.T[:, c["perm"]].reshape(D, G, L, W).permute(2, 1, 0, 3)
            * c["valid_slab"][:, :, None, :]
        )  # (L, G, D, W), padded slots zeroed (exact-zero fixed points)
        ttc_all = torch.einsum("ij,lgjw->lgiw", c["massT"], tc_slab)

        m_parts = []
        v_new = []
        for bi, cb in enumerate(c["buckets"]):
            ys, ms = self.ring_sweep(
                u[bi], ttc_all[:, self._bucket_groups[bi]].contiguous(),
                cb["bsrc0"], cb["cin"], cb["bcat"], cb["macro_w"], c["wvec"],
                shifts=self.shifts, dsrc=cb.get("dsrc0"),
                cast_bf16=self.state_bf16,
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

    def solve(self, tol: float = 1e-7, max_iter: int = 101, state=None,
              verbose: bool = True, callback=None, check_every: int = 1):
        """Outer source iteration (ref: src/PBTESolver.cpp:208-332). The
        residual is fetched to the host every ``check_every`` iterations."""
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
        return SolveResult(
            u=u, Tc=Tc, Tv=prev_Tv, residual=res, iterations=it, solver=self
        )

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


@dataclasses.dataclass
class SolveResult:
    u: tuple  # per-bucket (L, Gb, Km_b, BS, D, W) state slabs
    Tc: torch.Tensor  # (ne, D)
    Tv: torch.Tensor  # (ne,)
    residual: float
    iterations: int
    solver: SourceIterationSolver
