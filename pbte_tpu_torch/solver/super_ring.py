"""The supercell two-matmul lattice ring (PyTorch).

Port of ``pbte_tpu``'s ring on a supercell-merged mesh
(``pbte_tpu/solver/source_iteration.py``: the factor build of
``_factor_group``'s supercell branch, ``:1450-1500``, the unfolded class
coupling, ``:1520-1545``, and the two-matmul body of ``_step_ring``,
``:3128-3153`` with the shared tail ``:3171-3200`` and the closure
``:3285-3325``). ``SourceIterationSolver`` takes this path where a 6-tet
(3D) or 2-triangle (2D) split of a Cartesian lattice merges into super
elements of D' = gsz*D DOFs (``fem/supercell.py``): the macro mesh is a
single-class box lattice, swept in 2^dim octant groups of L levels of W
slots. pbte_tpu's body is XLA einsums (no Pallas kernel), and so is this
one: torch products (``bmm``, ``baddbmm``, ``matmul``), no kernel of its
own.

State layout: per Km bucket ``(L, Gb, Km_b, BS, W, D')`` of the
mass-transformed state v = M^T u, D' innermost, so that both products of a
level read the state where it lies:

- the neighbour coupling is one GEMM per group, ``(Km_b BS W, dim D') @
  (dim D', D')``, against the geometry-only couplings C_f M^-T of the dim
  inflow faces stacked (shared over directions, bands and slots);
- the factor apply is one ``bmm`` over the Gb Km_b BS (direction, band)
  pairs, ``(W, D') @ (D', D')``, against B^T = (M^T A^-1)^T.

The stacked coupling operand (the previous level shifted by each axis's
slab offset and scaled by -vg cin) is written into a level buffer whose
shifted-out slots stay zero; the rhs of a level is formed in place in a
state-sized buffer that holds ``src_w M^T Tc + relax_w v - vg bc_w bsrc``
for every level, and the factor apply writes the new level straight into
the new state, which the next level reads as its ring. No per-level copy
of the state is made. pbte_tpu's own layout, ``(L, Gb, Km_b, D', BS, W)``,
is what checkpoints hold (``to_pbte_layout``, ``from_pbte_layout``).

State dtypes. Float32 products run exactly (TF32 off,
``exact_f32_products``); float64 state runs in float64 throughout. With
``PBTE_RING_STATE_BF16=1`` a float32 solver stores the state in bfloat16,
as pbte_tpu's bf16-state ring does (its two-matmul body with bf16 staging,
``:3128-3153``): the coupling operand is written in bfloat16 (the bf16
ring times the f32 coefficient, rounded once) and multiplied with the
couplings rounded to bfloat16, the product accumulated in float32
(``baddbmm`` with ``out_dtype=torch.float32`` on the card, on the CPU the
same bf16 values in a float32 product); the rhs and the factor apply stay
float32, the macroscopic partials read the float32 solution, and the new
level is stored rounded to bfloat16. The step takes its mode from the
state's dtype, so a float32 copy of a bfloat16 state steps exactly. The
couplings are scaled by sigma and the operand by 1/sigma here, where
pbte_tpu rounds the unscaled operand and couplings: the bfloat16 roundings
fall on other products (sigma is a power of two, so the couplings' round
the same, the operand's do not).

Dir and band sharding (``dir_sharding``): a rank holds and sweeps its own
slots and bands of every bucket, ``(L, Gb, Km_b / n_dir, BS / n_band, W,
D')``, builds only their factors (the float64 build and its memory split
over the ranks) and their coefficients and weights; the couplings are
geometry and shared. The macroscopic partials are summed over the ranks
before ``M^-T`` (``parallel.comm.DirShard``), so Tc and Tv are the same on
every rank. The factor is built in float64 on the solver's device by
``supercell.block_triangular_factor``.
"""

from __future__ import annotations

import numpy as np
import torch

from pbte_tpu_torch import tracing
from pbte_tpu_torch.fem import assembly
from pbte_tpu_torch.fem import supercell as _supercell
from pbte_tpu_torch.models import macroscopic
from pbte_tpu_torch.solver.lattice_tables import (
    group_permuted,
    inflow_tables,
    slab_layout,
)

# bytes of the ring's device working set (three state-sized buffers: the
# state, the new state and the rhs, and the factors) above which
# sweep_mode="auto" does not merge and the fine mesh is scanned instead
# (80 GB card; pbte_tpu's 12e9 B super-state budget is a 16 GB-chip limit)
SUPER_BUDGET = 60e9


def super_ring_bytes(sc, K, BS, itemsize):
    """The ring's device working set in bytes for the supercell ``sc``, K
    directions and BS bands: three state-sized buffers (with a group's
    worth of slot padding per group, as pbte_tpu counts it) and the
    per-(direction, band) factors."""
    dims = np.sort(np.asarray(sc.lat_dims, dtype=np.int64))
    L = int(dims.sum()) - len(dims) + 1
    W = int(np.prod(dims[:-1]))
    state = (K + 2 ** len(dims)) * BS * sc.Dp * L * W
    return (3 * state + K * BS * sc.Dp * sc.Dp) * itemsize


def to_pbte_layout(ub: torch.Tensor) -> torch.Tensor:
    """A bucket's state (L, Gb, Km_b, BS, W, D') -> pbte_tpu's XLA-ring
    layout (L, Gb, Km_b, D', BS, W) (a view)."""
    return ub.permute(0, 1, 2, 5, 3, 4)


def from_pbte_layout(ub: torch.Tensor) -> torch.Tensor:
    """pbte_tpu's (L, Gb, Km_b, D', BS, W) -> this ring's (L, Gb, Km_b, BS,
    W, D'), contiguous."""
    return ub.permute(0, 1, 2, 4, 5, 3).contiguous()


def _couple(rhs, xcat, ccat):
    """rhs += xcat @ ccat, batched over groups, into the float32 (or
    float64) rhs in place. bfloat16 operands accumulate in float32: on the
    card in cuBLAS (``out_dtype``), on the CPU, which has no such product,
    as the same bfloat16 values multiplied in float32."""
    if xcat.dtype != torch.bfloat16:
        rhs.baddbmm_(xcat, ccat)
    elif rhs.is_cuda:
        torch.baddbmm(rhs, xcat, ccat, torch.float32, out=rhs)
    else:
        rhs.baddbmm_(xcat.float(), ccat.float())


class SuperRingSweep:
    """Constants and step of the supercell ring for one problem (built by
    ``SourceIterationSolver`` on the merged ``ops``; its attributes are the
    solver's)."""

    def __init__(self, sc, ops, quad, plan, dirs_pad, band, lt, slot_w, *,
                 bc_T, dtype, state_dtype, device, shard):
        """``sc`` the verified supercell and ``ops`` its merged operators;
        ``band`` the solver's (inv_kn, vg, heat_cap, dt_inv), padded to the
        band ranks; ``lt`` the lattice tables of the macro mesh
        (``lattice_ring_tables``); ``slot_w`` the (G, Km, BS) macroscopic
        and (G, Km, BS, dim) heat-flux slot weights; ``bc_T`` (ne, nf) the
        wall temperatures of the super faces; ``state_dtype`` the state's
        (bfloat16 for a float32 solver's bf16 state); ``shard`` this rank's
        ``parallel.comm.DirShard``."""
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        self.sc = sc
        self.dtype, self.state_dtype, self.device = dtype, state_dtype, device
        self.shard = shard
        self.ne = ne = ops.num_elements
        self.D = Dp = ops.ndof
        self.dim = dim = ops.dim
        self.K = quad.num_directions
        omega = quad.total_weight
        inv_kn, vg, heat_cap, dt_inv = band
        self.BS = BS = len(vg)
        bsl = shard.bsl
        self.G = G = plan.num_groups
        self.Km = Km = dirs_pad.shape[1]
        self.dirs_pad = dirs_pad
        dir_valid = dirs_pad >= 0
        dirs_np = quad.directions[:, :dim]
        dirs_safe = np.where(dir_valid, dirs_pad, 0)
        self.L = L = plan.max_levels
        lat_tabs, act_f, lat_shifts = lt
        self.shifts = tuple(int(s) for s in lat_shifts)
        self.W = W = lat_tabs.shape[2]
        self.ne_pad = L * W
        nf_act = dim

        # groups of equal slot count (rounded up to the dir ranks) run as
        # one bucket
        sizes = np.array([len(d) for d in plan.dirs_of_group])
        km_req = np.maximum(-(-sizes // shard.n_dir) * shard.n_dir, 1)
        self.buckets = [
            (np.flatnonzero(km_req == kv), int(kv))
            for kv in sorted({int(x) for x in km_req}, reverse=True)
        ]

        perm, pos_valid, perm_safe, pos_of_elem, nbr_pos = slab_layout(
            lat_tabs, ops.sweep_neighbor, act_f, self.shifts)
        self._perm = perm

        def gperm(a):
            return group_permuted(a, perm_safe, pos_valid, np_dtype)

        # ---- inflow coefficients and the wall source -----------------------
        _, _, cin_act, bsrc0 = inflow_tables(
            ops, dirs_np[dirs_safe], perm_safe, nbr_pos, act_f, gperm(bc_T),
            gperm(ops.face_int))
        vg_s = vg / dt_inv  # non-dimensionalized group velocity
        # -vg cin / sigma per (level, group, slot, face, band, slab slot):
        # the scale of each shifted neighbour slab in the coupling operand,
        # sigma (a power of two near max vg, folded into the couplings)
        # keeping the operand at the state's magnitude: the state v = M^T u
        # is ~1e-21 u on micron meshes, and -vg cin v would reach float32's
        # subnormals
        sigma = 2.0 ** np.round(np.log2(vg_s.max()))
        cvg = -(cin_act.reshape(G, nf_act, Km, L, W).transpose(3, 0, 2, 1, 4)
                [:, :, :, :, None, :] * (vg_s[bsl] / sigma)[:, None])
        bsrc0 = bsrc0.reshape(G, Km, Dp, L, W).transpose(3, 0, 1, 4, 2)

        # ---- factors (float64 on the device) and couplings -----------------
        # the ring carries v = M^T u: the apply factor is B = M^T A^-1 (A
        # block-triangular with the intra-cell couplings) and M^-T folds
        # into the neighbour couplings, which are geometry-only. Each rank
        # builds the factors of its own slots and bands alone.
        mass_r = ops.mass[0]
        massT_r = mass_r.T
        invMT_r = np.linalg.inv(massT_r)
        gsz, D = sc.gsz, sc.D
        massT_blocks = torch.as_tensor(np.stack(
            [massT_r[c * D:(c + 1) * D, c * D:(c + 1) * D]
             for c in range(gsz)]), device=device)
        mass_dev = torch.as_tensor(np.array(mass_r), device=device)
        vg_dev = torch.as_tensor(vg_s[bsl], device=device)
        facs = []
        with tracing.stage("pbte.setup.supercell_factor"):
            for gs, km_b in self.buckets:
                ks = shard.kss(km_b)
                fac_T = torch.empty((len(gs), km_b // shard.n_dir, shard.bl,
                                     Dp, Dp), dtype=dtype, device=device)
                for i, g in enumerate(gs):
                    dk = dirs_np[dirs_safe[g, ks]]  # (Km_b / n_dir, dim)
                    fd = np.einsum("fd,kd->kf", ops.normals[0], dk)
                    G_k = (-np.einsum("kd,dij->kij", dk, ops.stiff[0])
                           + np.einsum("kf,fij->kij", np.maximum(fd, 0.0),
                                       ops.face_mass[0])
                           + sc.gmat_internal(dk))
                    A = (mass_dev + vg_dev[None, :, None, None]
                         * torch.as_tensor(G_k, device=device)[:, None])
                    B = _supercell.block_triangular_factor(sc, A, dk,
                                                           massT_blocks)
                    fac_T[i] = B.transpose(-1, -2).to(dtype)
                    del A, B
                facs.append(fac_T)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        ccpl = assembly.class_coupling(ops, np.zeros(ne, dtype=np.int64))
        cc = np.einsum("fij,jk->fik", ccpl[0], invMT_r)[act_f]  # (G,nf,D',D')
        # stacked for the coupling GEMM: row (f, j), column i = sigma
        # cc[g, f, i, j]
        ccat = np.ascontiguousarray(
            cc.transpose(0, 1, 3, 2).reshape(G, nf_act * Dp, Dp)) * sigma

        mw_slots, fw_slots = slot_w

        def put(a, dt=dtype):
            return torch.tensor(np.asarray(a), device=device).to(dt)

        self._invMT_r = invMT_r
        self.consts = dict(
            perm=put(perm_safe, torch.int64),  # (G, ne_pad)
            valid=put(pos_valid.reshape(G, L, W).transpose(1, 0, 2)),
            massT_T=put(mass_r),  # (D', D'): tc @ M = (M^T tc) row-wise
            invMT_T=put(invMT_r.T),
            pos_of_elem=put(pos_of_elem, torch.int64),  # (G, ne)
            # this rank's bands
            src_w=put((inv_kn * heat_cap / (omega * dt_inv))[bsl]),
            relax_w=put((1.0 - inv_kn / dt_inv)[bsl]),
            neg_vg_bc_w=put((-vg_s * heat_cap / omega)[bsl]),
            super_basis=put(sc.basis_int_cells),  # (ncell, gsz, D)
            super_scat=put(sc.scatter_fine(), torch.int64),
            flux_w=put(fw_slots),  # (G, Km, BS, dim), every slot and band
            buckets=tuple(
                dict(
                    fac_T=fac,  # (Gb, Km_b, BS, D', D') = B^T, this rank's
                    ccat=put(ccat[gs]),  # (Gb, dim D', D')
                    # (L, Gb, Km_b, dim, BS, W)
                    cvg=put(cvg[:, gs][:, :, shard.kss(km_b)]),
                    # (L, Gb, Km_b, W, D')
                    bsrc0=put(bsrc0[:, gs][:, :, shard.kss(km_b)]),
                    macro_w=put(mw_slots[gs][:, shard.kss(km_b), bsl]),
                )
                for (gs, km_b), fac in zip(self.buckets, facs)
            ),
        )
        del facs
        order = np.concatenate([gs for gs, _ in self.buckets])
        inv_order = np.empty(G, dtype=np.int64)
        inv_order[order] = np.arange(G)
        self._inv_order = torch.as_tensor(inv_order, device=device)
        self._bucket_groups = tuple(
            torch.as_tensor(gs, device=device) for gs, _ in self.buckets)

    # -- state and step ------------------------------------------------------

    def initial_state(self):
        """Zero state (this rank's slots and bands), Tc and Tv."""
        sh = self.shard
        u = tuple(
            torch.zeros((self.L, len(gs), km_b // sh.n_dir, sh.bl, self.W,
                         self.D), dtype=self.state_dtype, device=self.device)
            for gs, km_b in self.buckets)
        z = dict(dtype=self.dtype, device=self.device)
        return (u, torch.zeros((self.ne, self.D), **z),
                torch.zeros((self.sc.ne_fine,), **z))

    def step(self, u, Tc, Tv_prev):
        """One outer iteration (the caller's state is not changed): (u, Tc,
        Tv, residual), Tv and the residual over the fine elements. A
        bfloat16 state runs the bf16 body (see the module docstring).
        Spans: ``pbte.step`` round the step, ``.sources``, ``.sweep`` (each
        bucket's) and ``.macroscopic`` round its parts (``tracing``)."""
        c = self.consts
        G, L, W, Dp = self.G, self.L, self.W, self.D
        with tracing.span("pbte.step"):
            with tracing.span("pbte.step.sources"):
                # lagged temperature M^T Tc on the slab, (L, G, W, D'), zero
                # at padded slots (exact-zero fixed points of the iteration)
                tc_slab = (Tc[c["perm"]].reshape(G, L, W, Dp).transpose(0, 1)
                           * c["valid"][..., None])
                ttc = torch.matmul(tc_slab, c["massT_T"])
            m_parts, v_new = [], []
            for bi, v in enumerate(u):
                with tracing.span("pbte.step.sweep"):
                    out, m = self._sweep_bucket(bi, v, ttc)
                v_new.append(out)
                m_parts.append(m)
            with tracing.span("pbte.step.macroscopic"):
                for bi, cb in enumerate(c["buckets"]):
                    if m_parts[bi] is None:
                        # macroscopic partials of every level: the
                        # band-weighted sum
                        Gb, Km_b, BS = v_new[bi].shape[1:4]
                        m_parts[bi] = torch.matmul(
                            cb["macro_w"].reshape(Gb, 1, Km_b * BS),
                            v_new[bi].view(L, Gb, Km_b * BS, W * Dp))
                m_cat = torch.cat([m.view(L, -1, W, Dp) for m in m_parts],
                                  dim=1)[:, self._inv_order]  # (L, G, W, D')
                partial = m_cat.transpose(0, 1).reshape(G, self.ne_pad, Dp)
                pos = c["pos_of_elem"][:, :, None].expand(G, self.ne, Dp)
                Tc_v = torch.gather(partial, 1, pos).sum(dim=0)  # (ne, D')
                Tc_v = self.shard.psum(Tc_v)  # every rank's slots and bands
                # v = M^T u => Tc = M^-T
                Tc_new = torch.matmul(Tc_v, c["invMT_T"])
                Tv_new = self.tv_from_tc(Tc_new)
                res = macroscopic.residual(Tv_new, Tv_prev)
        return tuple(v_new), Tc_new, Tv_new, res

    def _sweep_bucket(self, bi, v, ttc):
        """The level recurrence of bucket ``bi`` from its state ``v`` and
        the lagged temperature ``ttc``: (the new state, the macroscopic
        partials of the bf16 body, None in the exact body)."""
        c = self.consts
        cb = c["buckets"][bi]
        L, W, Dp = self.L, self.W, self.D
        band = (slice(None), None, None)  # the band axis of (BS, W, D')
        bf16 = v.dtype == torch.bfloat16
        Gb, Km_b, BS = v.shape[1:4]
        rows = Gb * Km_b * BS
        # rhs of every level but the neighbour term (in the solver's
        # dtype: a bf16 state is read exactly)
        rhs = torch.addcmul(
            ttc[:, self._bucket_groups[bi], None, None]
            * c["src_w"][band], v, c["relax_w"][band])
        rhs.addcmul_(cb["bsrc0"][:, :, :, None], c["neg_vg_bc_w"][band])
        out = torch.empty_like(v)
        # the coupling operand: per face the previous level shifted by
        # the axis offset, times -vg cin; shifted-out slots stay zero
        xcat = torch.zeros((Gb, Km_b, BS, W, len(self.shifts) * Dp),
                           dtype=v.dtype, device=v.device)
        fac = cb["fac_T"].view(rows, Dp, Dp)
        ccat = cb["ccat"].to(torch.bfloat16) if bf16 else cb["ccat"]
        m = None
        if bf16:  # the f32 solution of a level, and the partials
            sol = torch.empty((rows, W, Dp), dtype=rhs.dtype,
                              device=v.device)
            m = torch.empty((L, Gb, 1, W * Dp), dtype=rhs.dtype,
                            device=v.device)
            mw = cb["macro_w"].reshape(Gb, 1, Km_b * BS)
        for lv in range(L):
            if lv:
                ring = out[lv - 1]
                for f, s in enumerate(self.shifts):
                    torch.mul(
                        ring[:, :, :, :W - s],
                        cb["cvg"][lv, :, :, f, :, s:, None],
                        out=xcat[:, :, :, s:, f * Dp:(f + 1) * Dp])
                _couple(rhs[lv].view(Gb, -1, Dp),
                        xcat.view(Gb, Km_b * BS * W, -1), ccat)
            if not bf16:
                torch.bmm(rhs[lv].view(rows, W, Dp), fac,
                          out=out[lv].view(rows, W, Dp))
                continue
            torch.bmm(rhs[lv].view(rows, W, Dp), fac, out=sol)
            torch.bmm(mw, sol.view(Gb, Km_b * BS, W * Dp), out=m[lv])
            out[lv].view(rows, W, Dp).copy_(sol)
        return out, m

    # -- de-blocking and views -----------------------------------------------

    def _fine(self, blocks, lead=()):
        """(*lead, ncell gsz, ...) blocks in (cell, class) order -> the fine
        element order."""
        sc = self.sc
        out = torch.zeros(lead + (sc.ne_fine,) + blocks.shape[len(lead) + 1:],
                          dtype=blocks.dtype, device=blocks.device)
        out[(slice(None),) * len(lead) + (self.consts["super_scat"],)] = blocks
        return out

    def tv_from_tc(self, Tc):
        """Cell averages per fine element (ne_fine,): the reference's
        residual is over per-element averages (pbte_tpu's ``_tv_from_tc``)."""
        sc = self.sc
        tvc = torch.einsum("egi,egi->eg", Tc.reshape(sc.ncell, sc.gsz, sc.D),
                           self.consts["super_basis"])
        return self._fine(tvc.reshape(-1))

    def tc_fine(self, Tc):
        """(ncell, D') -> per fine element (ne_fine, D)."""
        sc = self.sc
        return self._fine(Tc.reshape(sc.ncell * sc.gsz, sc.D))

    def u_by_direction(self, u):
        """Direction-major physical coefficients per fine element (K, BS,
        ne_fine, D) (numpy) of a full state (every rank's slots and
        bands)."""
        host_dt = torch.float64 if self.dtype == torch.float64 else torch.float32
        us = np.zeros((self.G, self.Km, self.BS, self.D, self.ne_pad),
                      dtype=np.float64 if self.dtype == torch.float64
                      else np.float32)
        for bi, (gs, km_b) in enumerate(self.buckets):
            ub = u[bi].detach().to("cpu", host_dt).numpy()
            us[gs, :km_b] = ub.transpose(1, 2, 3, 5, 0, 4).reshape(
                len(gs), km_b, self.BS, self.D, self.ne_pad)
        out = np.zeros((self.K, self.BS, self.ne, self.D), dtype=us.dtype)
        for g in range(self.G):
            valid = self._perm[g] >= 0
            elems = self._perm[g][valid]
            for k in range(self.Km):
                d = self.dirs_pad[g, k]
                if d >= 0:
                    out[d, :, elems, :] = us[g, k][:, :, valid].transpose(
                        2, 0, 1)
        out = np.einsum("ij,kbej->kbei", self._invMT_r, out)  # v -> u
        sc = self.sc
        fine = np.zeros((self.K, self.BS, sc.ne_fine, sc.D), dtype=out.dtype)
        fine[:, :, sc.scatter_fine()] = out.reshape(
            self.K, self.BS, sc.ncell * sc.gsz, sc.D)
        return fine

    def heat_flux(self, u):
        """Qc (dim, ne_fine, D) and Qv (dim, ne_fine) per fine element, on
        the state's device, of a full state."""
        c = self.consts
        sc = self.sc
        G, Dp, dim = self.G, self.D, self.dim
        parts = []
        for bi, (gs, km_b) in enumerate(self.buckets):
            fw = c["flux_w"][self._bucket_groups[bi], :km_b]  # (Gb,Km,BS,dim)
            p = torch.einsum("gkbd,lgkbwi->gdlwi", fw, u[bi].to(self.dtype))
            parts.append(p.reshape(len(gs), dim, self.ne_pad, Dp))
        partial = torch.cat(parts)[self._inv_order]  # (G, dim, ne_pad, D')
        pos = c["pos_of_elem"][:, None, :, None].expand(G, dim, self.ne, Dp)
        Qc = torch.gather(partial, 2, pos).sum(dim=0)  # (dim, ne, D')
        Qc = torch.matmul(Qc, c["invMT_T"])  # v = M^T u
        Qcb = Qc.reshape(dim, sc.ncell, sc.gsz, sc.D)
        Qv = torch.einsum("degi,egi->deg", Qcb, c["super_basis"])
        return (self._fine(Qcb.reshape(dim, -1, sc.D), (dim,)),
                self._fine(Qv.reshape(dim, -1), (dim,)))
