"""The compact level-window scan sweep (PyTorch).

Port of the non-ring half of ``pbte_tpu/solver/source_iteration.py``: its
compact level layout (constructor, ``:895-941``), factor caches (``full``
per element or per geometry class, ``on-the-fly``, ``eigen`` with the
conditioning guard, ``:1375-1751``) and the scan step (``_step_impl``,
``:2235-2549``). ``SourceIterationSolver`` takes this path wherever
pbte_tpu's does: ``sweep_mode="scan"``, and ``"auto"`` on the meshes its
ring gates reject (small, simplex, unstructured and mixed meshes).

Layout. Each direction group g orders its elements by wavefront level,
level l occupying positions ``[offsets[g, l], offsets[g, l] + counts[g,
l])`` of ``perm[g]`` (length exactly ne). The state u is the physical
coefficients in that order, ``(G, Km, BS, D, ne)``, slot (g, k) holding
direction ``dirs_pad[g, k]`` (padded slots carry zero weight everywhere).

One outer step, all direction groups batched in every op (pbte_tpu's
``vmap``):

1. the rhs base, hoisted over all elements: ``src_w M^T Tc + relax_w M^T u
   - vg bc_w bsrc (- vg dsrc)``, plus the lagged periodic, diffuse and
   specular contributions of the previous iterate (scatter-adds);
2. for every level in order: the window of ``Ws`` positions at the
   (clamped) level offset, ``Ws`` the width of the level's segment
   (``pick_level_segments``); one neighbour gather and one coupling
   einsum over all faces; the factor apply; the masked write-back, which
   keeps every slot outside the level as it was;
3. the macroscopic closure (``macro_w``, the ``pos_of_elem`` gather), Tv
   and the residual.

Memory fallbacks, for the 80 GB card: the rhs is assembled per level
window when the two hoisted ``(G, Km, BS, D, ne)`` temporaries would pass
``HOIST_BUDGET``; the on-the-fly policy runs the groups one after the
other when its batched inverse would pass ``SEQ_BUDGET``; and the
class-batched full cache rebuilds each window's mass and coupling blocks
from per-class tensors (the class streams) when their group-replicated
copies would pass ``CLASS_OPS_BUDGET``. None has an argument or a switch.

Host math is float64 numpy; the constants go to ``device`` in the solver
dtype. Every window op is a torch op: pbte_tpu's scan reaches no Pallas
kernel (its level body is XLA einsums and gathers).

Dir and band sharding (``dir_sharding``, pbte_tpu's layout of its
``:2187-2196``): a rank holds ``(G, Km / n_dir, BS / n_band, D, ne)``,
its own slots and bands, and builds only their factors (every cache
policy) and their sources and weights; the eigen cache's conditioning
guard takes the largest estimate over the ranks, so every rank falls back
alike. The memory fallbacks are reckoned from the rank's share. The
macroscopic partials are summed over the ranks before Tc. A periodic
partner lies in the rank's own slot; the reflective walls gather every
rank's boundary values first (the diffuse wall sums over every slot and
band, the specular mirror slot may lie on another rank).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from pbte_tpu_torch import tracing
from pbte_tpu_torch.fem import assembly
from pbte_tpu_torch.models import macroscopic
from pbte_tpu_torch.ops.scatter import LayerMemo, scatter_add_layered_
from pbte_tpu_torch.solver.lattice_tables import mirror_direction_map
from pbte_tpu_torch.sweep import planner

# bytes of the two hoisted (G, Km, BS, D, ne) rhs temporaries above which
# the rhs is assembled per level window (80 GB card: the state, its copy,
# the factor cache and the window temporaries stay beside them)
HOIST_BUDGET = 16e9
# bytes of the on-the-fly policy's per-level working set (the (D, D) blocks
# of A, their inverse and the LU workspace over all groups) above which the
# groups run one after the other
SEQ_BUDGET = 24e9
# bytes of the group-replicated mass_t (G, D, D, ne) and coupling (G, nf, D,
# D, ne) streams above which the class-batched full cache takes them from
# (ncls, ...) class tensors instead, with a window-local rhs (pbte_tpu's
# PBTE_SCAN_CLASS_OPS streams; ~13 GB at its refined-tet growth shape, G=34,
# ne=48k, p=3; 0.14 GB at the legacy 5^3 tet shape)
CLASS_OPS_BUDGET = 8e9


def pick_level_segments(counts, max_segments=6):
    """Partition the level axis into <= max_segments contiguous segments,
    minimizing sum(len(seg) * max_width(seg)) — the columns actually touched
    per sweep. Exact DP; L is at most a few hundred. Returns [(l0, l1, Ws)]
    (pbte_tpu's ``_pick_level_segments``)."""
    L = counts.shape[1]
    maxw = counts.max(axis=0).astype(np.int64)  # width needed at each level
    INF = 1 << 60
    best = np.full((max_segments + 1, L + 1), INF, dtype=np.int64)
    cut = np.zeros((max_segments + 1, L + 1), dtype=np.int64)
    best[0, 0] = 0
    for m in range(1, max_segments + 1):
        for j in range(1, L + 1):
            mx = 0
            for i in range(j - 1, -1, -1):
                mx = max(mx, int(maxw[i]))
                cand = best[m - 1, i] + (j - i) * mx
                if cand < best[m, j]:
                    best[m, j] = cand
                    cut[m, j] = i
    m = int(np.argmin(best[:, L]))
    segs = []
    j = L
    for mm in range(m, 0, -1):
        i = int(cut[mm, j])
        segs.append((i, j, max(int(maxw[i:j].max()), 1)))
        j = i
    segs.reverse()
    return segs


def _eig_factors(C):
    """Eigen factors of C (..., D, D) = V diag(w) V^-1, and the Frobenius
    condition estimate of V (pbte_tpu's upper-bound flavour)."""
    w, V = np.linalg.eig(C)
    Vinv = np.linalg.inv(V)
    cond = float((np.linalg.norm(V, axis=(-2, -1))
                  * np.linalg.norm(Vinv, axis=(-2, -1))).max())
    return w, V, Vinv, cond


class ScanSweep:
    """Constants and step of the scan path for one problem (built by
    ``SourceIterationSolver``; its attributes are the solver's)."""

    def __init__(self, ops, quad, plan, dirs_pad, band, slot_w, *, bc_T,
                 dvec, diffuse_bcs, specular_bcs, cache_policy, cls_cache,
                 dtype, device, shard):
        """``band`` is the solver's (inv_kn, vg, heat_cap, dt_inv): three
        (BS,) tables and the pseudo time step's inverse; ``slot_w`` the
        (G, Km, BS) macroscopic and (G, Km, BS, dim) heat-flux slot
        weights; ``bc_T`` (ne, nf) the wall temperatures and ``dvec`` (ne,
        nf, D) the Dirichlet inflow, None without one; ``shard`` this
        rank's ``parallel.comm.DirShard``."""
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        itemsize = np.dtype(np_dtype).itemsize
        self.dtype, self.device = dtype, device
        self._closure_layers = LayerMemo()  # the closure maps' layers
        self.ne = ne = ops.num_elements
        self.D = D = ops.ndof
        self.nf = nf = ops.faces_per_elem
        self.dim = dim = ops.dim
        self.K = quad.num_directions
        omega = quad.total_weight
        inv_kn, vg, heat_cap, dt_inv = band
        self.BS = BS = len(vg)
        self.shard = shard
        self.has_periodic = bool(ops.periodic.any())
        self.has_dirichlet = dvec is not None

        self.G = G = plan.num_groups
        self.Km = Km = dirs_pad.shape[1]
        self.dirs_pad = dirs_pad
        dir_valid = dirs_pad >= 0
        dirs_np = quad.directions[:, :dim]
        dirs_safe = np.where(dir_valid, dirs_pad, 0)
        # this rank's slots and bands
        ks, bs = shard.kss(Km), shard.bsl
        self.Kl, self.Bl = Kl, Bl = Km // shard.n_dir, shard.bl
        dirs_l = dirs_safe[:, ks]

        # ---- compact level-ordered layout ----------------------------------
        self.L = L = plan.max_levels
        self.W = min(plan.max_width, ne)
        self.ne_pad = ne
        perm = np.empty((G, ne), dtype=np.int64)
        counts = np.zeros((G, L), dtype=np.int32)
        offsets = np.zeros((G, L), dtype=np.int32)
        for g in range(G):
            pos = 0
            for lv in range(L):
                row = plan.levels[g, lv]
                elems = row[row >= 0]
                counts[g, lv] = len(elems)
                offsets[g, lv] = pos
                perm[g, pos:pos + len(elems)] = elems
                pos += len(elems)
            assert pos == ne
        pos_of_elem = np.zeros((G, ne), dtype=np.int64)
        for g in range(G):
            pos_of_elem[g, perm[g]] = np.arange(ne)
        self._perm, self._offsets, self._counts = perm, offsets, counts
        self.segments = pick_level_segments(counts)

        # ---- geometry classes (factor caches per class) --------------------
        self._cls = None
        self.ncls = 0
        if cache_policy in ("eigen", "full"):
            cls = (cls_cache if cls_cache is not None
                   else assembly.element_classes(ops))
            ncls = int(cls.max()) + 1
            if ncls <= 64 and ncls * 4 <= ne:
                self._cls, self.ncls = cls, ncls
                self._cls_reps = np.array(
                    [int(np.flatnonzero(cls == c)[0]) for c in range(ncls)])

        # ---- lagged reflective walls --------------------------------------
        refl = reflective_tables(ops, quad, dirs_pad, pos_of_elem,
                                 diffuse_bcs, specular_bcs)
        self._dif_on, self._spc_on = "dif_fint" in refl, "spc_fm" in refl

        # ---- class-compressed operator streams (memory fallback) -----------
        # where every element of a class shares its mass and couplings
        # (verified); not with lagged closures, which scatter into the
        # hoisted rhs these streams drop
        self._scan_cls_ops = False
        if (self._cls is not None and cache_policy == "full"
                and not self.has_periodic
                and not refl
                and G * (1 + nf) * D * D * ne * itemsize
                > CLASS_OPS_BUDGET):
            cpl_cls = assembly.class_coupling(ops, self._cls)
            ok = cpl_cls is not None
            for arr in (ops.mass, ops.face_int) if ok else ():
                ref = arr[self._cls_reps][self._cls]
                scale = max(float(np.abs(arr).max()), 1e-300)
                if float(np.abs(arr - ref).max()) > 1e-10 * scale:
                    ok = False
                    break
            if ok:
                self._scan_cls_ops = True
                cls_cpl = cpl_cls  # (ncls, nf, D, D)

        # the rhs base is hoisted over all elements unless its two
        # (G, Km, BS, D, ne) temporaries pass the budget (the closures
        # scatter into it, so they force it; the class streams drop it)
        hoist_bytes = 2 * G * Kl * Bl * D * ne * itemsize
        self._hoist_rhs = (
            (self.has_periodic or self._dif_on or self._spc_on
             or hoist_bytes <= HOIST_BUDGET)
            and not self._scan_cls_ops
        )

        # ---- neighbour positions and lagged periodic wraps -----------------
        nbr_g = ops.sweep_neighbor[perm]  # (G, ne, nf)
        nbr_pos = np.where(
            nbr_g >= 0,
            np.take_along_axis(pos_of_elem, np.clip(nbr_g, 0, None)
                               .reshape(G, -1), axis=1).reshape(G, ne, nf),
            -1,
        )
        nbr_pos = np.swapaxes(nbr_pos, 1, 2)  # (G, nf, ne)
        fdot = np.einsum("gefd,gkd->gkfe", ops.normals[perm],
                         dirs_np[dirs_safe])  # (G, Km, nf, ne)
        is_b = nbr_pos < 0
        cin = np.minimum(fdot, 0.0)
        cin_bnd = np.where(is_b[:, None], cin, 0.0)
        cin_int = np.where(is_b[:, None], 0.0, cin)
        per = None
        if self.has_periodic:
            rows = []
            for g in range(G):
                # position-major, then face: pbte_tpu's loop order
                p, f = np.nonzero(ops.periodic[perm[g]])
                e = perm[g][p]
                rows.append((f, p, pos_of_elem[g, ops.neighbor[e, f]],
                             ops.coupling[e, f]))
            n_per = max(max(len(r[0]) for r in rows), 1)
            per = dict(face=np.zeros((G, n_per), dtype=np.int64),
                       pos=np.zeros((G, n_per), dtype=np.int64),
                       src=np.zeros((G, n_per), dtype=np.int64),
                       cpl=np.zeros((G, n_per, D, D)),
                       valid=np.zeros((G, n_per)))
            for g, (f, p, sp, cp) in enumerate(rows):
                n = len(f)
                per["face"][g, :n], per["pos"][g, :n] = f, p
                per["src"][g, :n], per["cpl"][g, :n] = sp, cp
                per["valid"][g, :n] = 1.0
            gi = np.arange(G)[:, None]
            per_cin = (np.minimum(fdot[gi, :, per["face"], per["pos"]], 0.0)
                       * per["valid"][:, :, None]).transpose(0, 2, 1)

        def gperm(a):
            """a (ne, ...) -> (G, ..., ne) in group order."""
            return np.moveaxis(a[perm], 1, -1)

        # ---- u-independent boundary sources (BS-free) ----------------------
        bsrc = np.einsum("gkfE,gfE,gfiE->gkiE", cin_bnd, gperm(bc_T),
                         gperm(ops.face_int), optimize=True)  # (G, Km, D, ne)
        dsrc = (np.einsum("gkfE,gfiE->gkiE", cin_bnd, gperm(dvec),
                          optimize=True) if self.has_dirichlet else None)

        # ---- transport factors (host, float64) ----------------------------
        vg_s = vg / dt_inv  # non-dimensionalized group velocity
        factors = None
        self.cache_policy = cache_policy
        if cache_policy == "eigen":
            factors = self._eigen_factors(ops, dirs_np, dirs_l, perm,
                                          np_dtype)
            if shard.grid is not None:  # every rank falls back alike
                self.cond_max = float(shard.grid.pmax(torch.tensor(
                    self.cond_max, dtype=torch.float64, device=device),
                    ("dir", "band")))
            cond_bound = 1e5 if np_dtype == np.float32 else 1e11
            if self.cond_max > cond_bound:
                fb = ("class-batched full" if self._cls is not None
                      else "on-the-fly")
                warnings.warn(
                    f"cache_policy='eigen': eigenvector condition estimate "
                    f"{self.cond_max:.1e} exceeds the safe bound "
                    f"{cond_bound:.0e} for {np.dtype(np_dtype)}; falling back "
                    f"to {fb} factors")
                if self._cls is not None:
                    self.cache_policy = "full"
                else:
                    self.cache_policy = "on-the-fly"
                    self.ncls = 0
                factors = None
        if self.cache_policy == "full" and self._cls is not None:
            factors = self._class_full_factors(ops, dirs_np, dirs_l, perm,
                                               vg_s[bs], np_dtype)
        elif self.cache_policy == "full":
            factors = self._elem_full_factors(ops, dirs_np, dirs_l, perm,
                                              fdot[:, ks], vg_s[bs], np_dtype)
        elif self.cache_policy == "on-the-fly":
            g_mat = np.empty((G, Kl, D, D, ne), dtype=np_dtype)
            for g in range(G):
                g_mat[g] = self._transport_g(ops, dirs_np[dirs_l[g]],
                                             perm[g], fdot[g, ks]).transpose(
                                                 0, 2, 3, 1)
            factors = {"g_mat": g_mat,
                       "mass": np.moveaxis(ops.mass[perm], 1, -1)}
        # the on-the-fly policy's batched inverse over all groups
        inv_ws = 3 * G * Kl * Bl * self.W * D * D * itemsize
        self._seq_groups = self.cache_policy == "on-the-fly" \
            and inv_ws > SEQ_BUDGET

        # the class at each group-ordered position
        cls_pos = self._cls[perm] if self._cls is not None else None

        # ---- device constants ----------------------------------------------
        def put(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   device=device).to(dt).contiguous()

        def iput(a):
            return put(a, torch.int64)

        mw_slots, fw_slots = slot_w
        # this rank's slots and bands, except where the views and the
        # diffuse wall read the full state (flux_w, dif_wplus)
        c = dict(
            perm=iput(perm),
            pos_of_elem=iput(pos_of_elem),
            basis_int_glob=put(ops.basis_int),
            macro_w=put(mw_slots[:, ks, bs]),  # (G, Km, BS)
            flux_w=put(fw_slots),  # (G, Km, BS, dim), every slot and band
            src_w=put((inv_kn * heat_cap / (omega * dt_inv))[bs]),
            relax_w=put((1.0 - inv_kn / dt_inv)[bs]),
            vg=put(vg_s[bs]),
            vg_bc_w=put((vg_s * (heat_cap / omega))[bs]),
            bsrc=put(bsrc[:, ks]),  # (G, Km, D, ne)
            cin_int=put(cin_int[:, ks]),  # (G, Km, nf, ne)
        )
        if dsrc is not None:
            c["dsrc"] = put(dsrc[:, ks])
        if self._scan_cls_ops:
            c["cls_massT"] = put(np.swapaxes(ops.mass[self._cls_reps], -1, -2))
            c["cls_cpl"] = put(cls_cpl)  # (ncls, nf, D, D)
        else:
            c["mass_t"] = put(gperm(np.swapaxes(ops.mass, -1, -2)))
            c["coupling"] = put(gperm(ops.coupling))  # (G, nf, D, D, ne)
        if per is not None:
            c.update(per_pos=iput(per["pos"]), per_src=iput(per["src"]),
                     per_cpl=put(per["cpl"]), per_cin=put(per_cin[:, ks]))
        for k, v in refl.items():
            if k in ("dif_cin", "spc_cin", "spc_gk"):
                v = v[:, ks]
            c[k] = iput(v) if k in ("dif_pos", "spc_pos", "spc_gk") else put(v)
        for k, v in (factors or {}).items():
            c[k] = put(v)
        if self._scan_cls_ops:
            c["cls_pos"] = iput(cls_pos)  # (G, ne)
        c["levels"] = level_tables(
            offsets, counts, nbr_pos, self.segments, cls_pos, self.ncls,
            self.cache_policy == "full", device)
        self.consts = c

    # -- host factor builds --------------------------------------------------

    @staticmethod
    def _transport_g(ops, dk, elems, fdot_g):
        """G_k = -sum_d s_d S_d + sum_f max(s.n_f, 0) Mf for the elements
        ``elems`` (in group order): (Km, n, D, D)."""
        return -np.einsum("kd,edij->keij", dk, ops.stiff[elems]) + np.einsum(
            "kfe,efij->keij", np.maximum(fdot_g, 0.0), ops.face_mass[elems])

    def _class_full_factors(self, ops, dirs_np, dirs_safe, perm, vg_s,
                            np_dtype):
        """A^-1 per (group, slot, band, class): ``a_cls`` (G, Km, BS, ncls,
        D, D), the exact-inverse class cache (pbte_tpu's
        ``_class_full_mats``), for the slots ``dirs_safe`` (G, Km) and the
        bands of ``vg_s``."""
        reps = self._cls_reps
        stiff_r, fmass_r = ops.stiff[reps], ops.face_mass[reps]
        mass_r, norm_r = ops.mass[reps], ops.normals[reps]
        a_cls = np.empty(dirs_safe.shape + (len(vg_s), self.ncls, self.D,
                                            self.D), dtype=np_dtype)
        for g in range(self.G):
            dk = dirs_np[dirs_safe[g]]
            fd = np.einsum("cfd,kd->kcf", norm_r, dk)
            G_k = -np.einsum("kd,cdij->kcij", dk, stiff_r) + np.einsum(
                "kcf,cfij->kcij", np.maximum(fd, 0.0), fmass_r)
            A_g = (mass_r[None, None]
                   + vg_s[None, :, None, None, None] * G_k[:, None])
            a_cls[g] = np.linalg.inv(A_g)  # (Km, BS, ncls, D, D)
        return {"a_cls": a_cls}

    def _elem_full_factors(self, ops, dirs_np, dirs_safe, perm, fdot, vg_s,
                           np_dtype):
        """A^-1 per element: ``a_inv`` (G, Km, BS, D, D, ne), the full
        cache, for the slots ``dirs_safe`` (G, Km) and the bands of
        ``vg_s``."""
        a_inv = np.empty(dirs_safe.shape + (len(vg_s), self.D, self.D,
                                            self.ne), dtype=np_dtype)
        for g in range(self.G):
            G_g = self._transport_g(ops, dirs_np[dirs_safe[g]], perm[g],
                                    fdot[g])
            A_g = (ops.mass[perm[g]][None, None]
                   + vg_s[None, :, None, None, None] * G_g[:, None])
            a_inv[g] = np.moveaxis(np.linalg.inv(A_g), 2, -1)
        return {"a_inv": a_inv}

    def _eigen_factors(self, ops, dirs_np, dirs_safe, perm, np_dtype):
        """A(vg) = M (I + vg C), C = M^-1 G = V diag(lam) V^-1, so
        A^-1(vg) = V diag(1/(1 + vg lam)) V^-1 M^-1: band-independent
        factors, split into real and imaginary parts. Per class (with the
        classes' one-hot) or per element, for the slots ``dirs_safe`` (G,
        Km); sets ``cond_max``."""
        (G, Km), D = dirs_safe.shape, self.D
        cond_max = 0.0
        if self._cls is not None:
            reps = self._cls_reps
            n = self.ncls
            stiff_r, fmass_r = ops.stiff[reps], ops.face_mass[reps]
            Minv = np.linalg.inv(ops.mass[reps])
            norm_r = ops.normals[reps]
        else:
            n = self.ne
        P = np.empty((G, Km, 2, D, D, n), dtype=np_dtype)
        Qm = np.empty((G, Km, 2, D, D, n), dtype=np_dtype)
        lam = np.empty((G, Km, 2, D, n), dtype=np_dtype)
        for g in range(G):
            if self._cls is None:
                Minv = np.linalg.inv(ops.mass[perm[g]])
                fd_g = np.einsum("efd,kd->kfe", ops.normals[perm[g]],
                                 dirs_np[dirs_safe[g]])
            for k in range(Km):
                dk = dirs_np[dirs_safe[g, k]]
                if self._cls is not None:
                    fd = np.einsum("cfd,d->cf", norm_r, dk)
                    G_k = -np.einsum("d,cdij->cij", dk, stiff_r) + np.einsum(
                        "cf,cfij->cij", np.maximum(fd, 0.0), fmass_r)
                else:
                    G_k = -np.einsum("d,edij->eij", dk,
                                     ops.stiff[perm[g]]) + np.einsum(
                        "fe,efij->eij", np.maximum(fd_g[k], 0.0),
                        ops.face_mass[perm[g]])
                w, V, Vinv, cond = _eig_factors(Minv @ G_k)
                cond_max = max(cond_max, cond)
                Q_c = Vinv @ Minv
                P[g, k, 0] = V.real.transpose(1, 2, 0)
                P[g, k, 1] = V.imag.transpose(1, 2, 0)
                Qm[g, k, 0] = Q_c.real.transpose(1, 2, 0)
                Qm[g, k, 1] = Q_c.imag.transpose(1, 2, 0)
                lam[g, k, 0] = w.real.T
                lam[g, k, 1] = w.imag.T
        self.cond_max = cond_max
        return {"eig_P": P, "eig_Q": Qm, "eig_lam": lam}

    # -- state and step ------------------------------------------------------

    def initial_state(self):
        """Zero state (this rank's slots and bands), Tc and Tv."""
        z = dict(dtype=self.dtype, device=self.device)
        return (torch.zeros((self.G, self.Kl, self.Bl, self.D, self.ne), **z),
                torch.zeros((self.ne, self.D), **z),
                torch.zeros((self.ne,), **z))

    def step(self, u, Tc, Tv_prev):
        """One outer iteration on the scan state (the caller's u is not
        changed): (u, Tc, Tv, residual). Spans as ``SourceIterationSolver.
        step``'s (``tracing``)."""
        c = self.consts
        G = self.G
        with tracing.span("pbte.step"):
            with tracing.span("pbte.step.sources"):
                TcT_g = Tc.T[:, c["perm"]].transpose(0, 1)  # (G, D, ne)
                if self._scan_cls_ops:
                    mt = c["cls_massT"][c["cls_pos"]]  # (G, ne, D, D)
                    t_tc = torch.einsum("geij,gje->gie", mt, TcT_g)
                else:
                    t_tc = torch.einsum("gije,gje->gie", c["mass_t"], TcT_g)
                rhs_base = None
                if self._hoist_rhs:
                    t_old = torch.einsum("gije,gkbje->gkbie", c["mass_t"], u)
                    rhs_base = self._rhs(t_tc[:, None, None], t_old,
                                         c["bsrc"], c.get("dsrc"))
                    self._add_closures(u, rhs_base)
                u_new = u.clone()
            if self._seq_groups:
                for g in range(G):
                    sl = slice(g, g + 1)
                    with tracing.span("pbte.step.sweep"):
                        self._sweep(u_new[sl], t_tc[sl], None if rhs_base
                                    is None else rhs_base[sl], sl)
            else:
                with tracing.span("pbte.step.sweep"):
                    self._sweep(u_new, t_tc, rhs_base, slice(None))
            with tracing.span("pbte.step.macroscopic"):
                partial = torch.einsum("gkb,gkbie->gie", c["macro_w"], u_new)
                pos = c["pos_of_elem"][:, None, :].expand(G, self.D, self.ne)
                Tc_new = torch.gather(partial, 2, pos).sum(dim=0).T  # (ne, D)
                Tc_new = self.shard.psum(Tc_new)  # every rank's slots, bands
                Tv_new = macroscopic.compute_tv(Tc_new, c["basis_int_glob"])
                res = macroscopic.residual(Tv_new, Tv_prev)
        return u_new, Tc_new, Tv_new, res

    def _rhs(self, t_tc, t_old, bsrc, dsrc):
        """src_w t_tc + relax_w t_old - vg bc_w bsrc (- vg dsrc); t_tc
        broadcasts over (Km, BS), bsrc and dsrc over BS."""
        c = self.consts
        b = (slice(None), None, None)  # band axis of (BS, D, W)
        rhs = (c["src_w"][b] * t_tc + c["relax_w"][b] * t_old
               - c["vg_bc_w"][b] * bsrc[:, :, None])
        if dsrc is not None:
            rhs = rhs - c["vg"][b] * dsrc[:, :, None]
        return rhs

    def _add_closures(self, u, rhs_base):
        """Lagged periodic, diffuse and specular contributions of the
        previous iterate u (this rank's slots and bands), scattered into the
        hoisted rhs base. The reflective walls read every rank's boundary
        values (gathered)."""
        c = self.consts
        sh = self.shard
        b = (slice(None), None, None)

        def gather(a, pos):
            """a (G, Km, BS, D, ne) at per-group positions (G, P)."""
            return a.gather(-1, pos[:, None, None, None, :].expand(
                a.shape[:-1] + pos.shape[1:]))

        def add_at(pos, val):
            """rhs_base[g, ..., pos[g, p]] += val[g, ..., p], one
            collision-free layer of columns p at a time."""
            scatter_add_layered_(rhs_base, pos, val,
                                 self._closure_layers.layers(pos))

        if self.has_periodic:
            contrib = torch.einsum("gpij,gkp,gkbjp->gkbip", c["per_cpl"],
                                   c["per_cin"], gather(u, c["per_src"]))
            add_at(c["per_pos"], -c["vg"][b] * contrib)
        if self._dif_on:
            # every slot's and band's outgoing flux (G, Km, BS, D, P)
            u_b = sh.gather(gather(u, c["dif_pos"]), 1, 2)
            out_flux = torch.einsum("gkp,pi,gkbip->bp", c["dif_wplus"],
                                    c["dif_fint"], u_b)
            u_in = out_flux[sh.bsl] * c["dif_norm"][None, :]  # (BS, P)
            add_at(c["dif_pos"], -torch.einsum(
                "gkp,b,bp,pi->gkbip", c["dif_cin"], c["vg"], u_in,
                c["dif_fint"]))
        if self._spc_on:
            # every slot's and band's values at the wall, (G Km, P, BS, D):
            # the mirror slot spc_gk may lie in any group and on any rank
            u_b = sh.gather(gather(u, c["spc_pos"]), 1, 2)
            u_b = u_b[:, :, sh.bsl].permute(0, 1, 4, 2, 3).flatten(0, 1)
            p_idx = torch.arange(u_b.shape[1], device=u.device)
            u_m = u_b[c["spc_gk"], p_idx]  # (G, Km, P, BS, D)
            add_at(c["spc_pos"], -torch.einsum(
                "gkp,b,pij,gkpbj->gkbip", c["spc_cin"], c["vg"],
                c["spc_fm"], u_m))

    def _sweep(self, u, t_tc, rhs_base, gs):
        """The level recurrence of the groups ``gs`` (a slice) over u in
        place (u, t_tc and rhs_base already cut to those groups)."""
        c = self.consts
        Gb, Km, BS, D = u.shape[:4]
        nf = self.nf
        b = (slice(None), None, None)
        for lvl in c["levels"]:
            idx = lvl["idx"][gs]  # (Gb, Ws)
            Ws = idx.shape[1]

            def win(a):
                """a (Gb, ..., ne) -> its level window (Gb, ..., Ws)."""
                ix = idx.view((Gb,) + (1,) * (a.dim() - 2) + (Ws,))
                return a.gather(-1, ix.expand(a.shape[:-1] + (Ws,)))

            u_e = win(u)  # (Gb, Km, BS, D, Ws)
            if rhs_base is not None:
                rhs = win(rhs_base)
            else:
                # window-local rhs (no hoisted (G, Km, BS, D, ne) temporaries)
                if self._scan_cls_ops:
                    mt_w = c["cls_massT"][lvl["cls_w"][gs]]  # (Gb, Ws, D, D)
                    t_old = torch.einsum("gwij,gkbjw->gkbiw", mt_w, u_e)
                else:
                    t_old = torch.einsum("gijw,gkbjw->gkbiw",
                                         win(c["mass_t"][gs]), u_e)
                rhs = self._rhs(win(t_tc)[:, None, None], t_old,
                                win(c["bsrc"][gs]),
                                None if "dsrc" not in c else win(c["dsrc"][gs]))
            # all faces at once: one neighbour gather, one coupling einsum
            ns = lvl["nsafe"][gs]  # (Gb, nf * Ws)
            u_nbr = u.gather(-1, ns[:, None, None, None, :].expand(
                Gb, Km, BS, D, nf * Ws)).view(Gb, Km, BS, D, nf, Ws)
            if self._scan_cls_ops:
                cpl_w = c["cls_cpl"][lvl["cls_w"][gs]].permute(0, 2, 3, 4, 1)
            else:
                cpl_w = win(c["coupling"][gs])  # (Gb, nf, D, D, Ws)
            u_in = u_nbr * win(c["cin_int"][gs])[:, :, None, None]
            interior = torch.einsum("gfijw,gkbjfw->gkbiw", cpl_w, u_in)
            rhs = rhs - c["vg"][b] * interior
            sol = self._apply(rhs, lvl, gs, win)
            mine = lvl["mine"][gs][:, None, None, None, :]
            sol = torch.where(mine, sol, u_e)
            u.scatter_(-1, idx[:, None, None, None, :].expand(
                Gb, Km, BS, D, Ws), sol)

    def _apply(self, rhs, lvl, gs, win):
        """The transport factor of the level window applied to rhs
        (Gb, Km, BS, D, Ws)."""
        c = self.consts
        policy = self.cache_policy
        if policy == "eigen":
            if self._cls is not None:
                def pick(a):  # class factors at the window's classes
                    cw = lvl["cls_w"][gs]
                    ix = cw.view((cw.shape[0],) + (1,) * (a.dim() - 2)
                                 + (cw.shape[1],))
                    return a.gather(-1, ix.expand(a.shape[:-1]
                                                  + (cw.shape[1],)))
            else:
                pick = win
            P, Q, lam = (pick(c[k][gs]) for k in ("eig_P", "eig_Q",
                                                   "eig_lam"))
            t_re = torch.einsum("gkijw,gkbjw->gkbiw", Q[:, :, 0], rhs)
            t_im = torch.einsum("gkijw,gkbjw->gkbiw", Q[:, :, 1], rhs)
            vgb = c["vg"][(slice(None), None, None)]
            d_re = 1.0 + vgb * lam[:, :, None, 0]
            d_im = vgb * lam[:, :, None, 1]
            inv_mag = 1.0 / (d_re * d_re + d_im * d_im)
            s_re = (t_re * d_re + t_im * d_im) * inv_mag
            s_im = (t_im * d_re - t_re * d_im) * inv_mag
            return (torch.einsum("gkijw,gkbjw->gkbiw", P[:, :, 0], s_re)
                    - torch.einsum("gkijw,gkbjw->gkbiw", P[:, :, 1], s_im))
        if policy == "full" and self._cls is not None:
            # class cache: the window's columns sorted by class, one
            # (D, D) @ (D, nmax) product per (group, slot, band, class)
            Gb, Km, BS, D, Ws = rhs.shape
            srt = lvl["sort_idx"][gs]  # (Gb, ncls * nmax)
            n_c = self.ncls
            r_s = rhs.gather(-1, srt[:, None, None, None, :].expand(
                Gb, Km, BS, D, srt.shape[1]))
            r_s = r_s.view(Gb, Km, BS, D, n_c, -1).transpose(3, 4)
            s_s = torch.matmul(c["a_cls"][gs], r_s)  # (Gb,Km,BS,ncls,D,nm)
            s_s = s_s.transpose(3, 4).reshape(Gb, Km, BS, D, -1)
            back = lvl["unsort_idx"][gs]  # (Gb, Ws)
            return s_s.gather(-1, back[:, None, None, None, :].expand(
                Gb, Km, BS, D, Ws))
        if policy == "full":
            return torch.einsum("gkbijw,gkbjw->gkbiw",
                                win(c["a_inv"][gs]), rhs)
        # on-the-fly: invert the level's (Km, BS, Ws) blocks
        m_w = win(c["mass"][gs]).permute(0, 3, 1, 2)  # (Gb, Ws, D, D)
        g_w = win(c["g_mat"][gs]).permute(0, 1, 4, 2, 3)  # (Gb,Km,Ws,D,D)
        A = (m_w[:, None, None]
             + c["vg"][None, None, :, None, None, None] * g_w[:, :, None])
        a_inv = torch.linalg.inv(A)  # (Gb, Km, BS, Ws, D, D)
        return torch.einsum("gkbwij,gkbjw->gkbiw", a_inv, rhs)

    # -- views ---------------------------------------------------------------

    def u_by_direction(self, u):
        """Slot-major group-ordered u (every rank's slots and bands) ->
        direction-major (K, BS, ne, D) (numpy)."""
        u = u.detach().cpu().numpy()
        out = np.zeros((self.K, self.BS, self.ne, self.D), dtype=u.dtype)
        for g in range(self.G):
            elems = self._perm[g]
            for k in range(self.Km):
                d = self.dirs_pad[g, k]
                if d >= 0:
                    out[d, :, elems, :] = u[g, k].transpose(2, 0, 1)
        return out

    def heat_flux(self, u):
        """Qc (dim, ne, D) and Qv (dim, ne) of the scan state (every rank's
        slots and bands)."""
        c = self.consts
        partial = torch.einsum("gkbd,gkbie->gdie", c["flux_w"], u)
        pos = c["pos_of_elem"][:, None, None, :].expand(
            self.G, self.dim, self.D, self.ne)
        Qc = torch.gather(partial, 3, pos).sum(dim=0).transpose(1, 2)
        Qv = torch.einsum("dei,ei->de", Qc, c["basis_int_glob"])
        return Qc, Qv


def reflective_tables(ops, quad, dirs_pad, pos_of_elem, diffuse_bcs,
                      specular_bcs):
    """Lagged diffuse and specular walls (pbte_tpu's constructor,
    ``source_iteration.py:1060-1133``), numpy tables over the wall faces,
    empty without them. Diffuse: ``dif_pos`` (G, P_d) the group position of
    each face's element, ``dif_fint`` (P_d, D), ``dif_cin`` and ``dif_wplus``
    (G, Km, P_d), ``dif_norm`` (P_d,). Specular: ``spc_pos`` (G, P_s),
    ``spc_fm`` (P_s, D, D) the face mass, ``spc_cin`` (G, Km, P_s) and
    ``spc_gk`` (G, Km, P_s) the flat (group, slot) of the mirror direction
    (whose value at the wall is read at its group's ``spc_pos``)."""
    dim = ops.dim
    Km = dirs_pad.shape[1]
    dir_valid = dirs_pad >= 0
    dirs_safe = np.where(dir_valid, dirs_pad, 0)
    dirs_np = quad.directions[:, :dim]
    w_glob = quad.weights
    bnd = (ops.neighbor < 0) & ops.face_valid
    out = {}
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
        out.update(
            dif_pos=pos_of_elem[:, d_e],
            dif_fint=ops.face_int[d_e, d_f],
            dif_cin=np.minimum(sdotn_g, 0.0),
            dif_wplus=(w_glob[dirs_safe][..., None] * dir_valid[..., None]
                       * np.maximum(sdotn_g, 0.0)),
            dif_norm=1.0 / np.maximum(cn * area, 1e-300),
        )
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
        out.update(
            spc_pos=pos_of_elem[:, s_e],
            spc_fm=ops.face_mass[s_e, s_f],
            spc_cin=np.minimum(sdotn_g, 0.0),
            spc_gk=g_of_dir[km_glob] * Km + k_of_dir[km_glob],
        )
    return out


def level_tables(offsets, counts, nbr_pos, segments, cls_pos, ncls,
                 class_sort, device):
    """Per level, on ``device``: the window's positions ``idx`` (G, Ws) at
    the clamped level offset, ``mine`` (G, Ws) the level's own columns,
    ``nsafe`` (G, nf * Ws) the neighbour positions (boundary -> 0, masked
    by the inflow coefficients); with classes (``cls_pos`` (G, ne) the
    class at each position) ``cls_w`` (G, Ws), and with ``class_sort`` the
    window grouped by class (``_class_sort``)."""
    G, nf, ne = nbr_pos.shape
    levels = []
    for (l0, l1, Ws) in segments:
        iota = np.arange(Ws)
        for lv in range(l0, l1):
            off, cnt = offsets[:, lv], counts[:, lv]
            offc = np.minimum(off, ne - Ws)
            shift = off - offc
            idx = offc[:, None] + iota[None, :]
            npos = np.take_along_axis(
                nbr_pos, np.broadcast_to(idx[:, None, :], (G, nf, Ws)),
                axis=2)
            lvl = dict(
                idx=torch.as_tensor(idx, dtype=torch.int64),
                mine=torch.as_tensor((iota >= shift[:, None])
                                     & (iota < (shift + cnt)[:, None])),
                nsafe=torch.as_tensor(np.where(npos < 0, 0, npos)
                                      .reshape(G, -1), dtype=torch.int64))
            if cls_pos is not None:
                cw = np.take_along_axis(cls_pos, idx, axis=1)
                lvl["cls_w"] = torch.as_tensor(cw, dtype=torch.int64)
                if class_sort:
                    lvl.update({k: torch.as_tensor(v) for k, v in
                                _class_sort(cw, ncls).items()})
            levels.append({k: v.to(device) for k, v in lvl.items()})
    return tuple(levels)


def _class_sort(cls_w, ncls):
    """Window columns grouped by class: ``sort_idx`` (G, ncls * nmax), the
    window column of the r-th member of class c at c * nmax + r (padding
    reads column 0), and ``unsort_idx`` (G, Ws), the inverse."""
    G, Ws = cls_w.shape
    nmax = max(int(np.bincount(cls_w[g], minlength=ncls).max())
               for g in range(G))
    sort_idx = np.zeros((G, ncls * nmax), dtype=np.int64)
    unsort_idx = np.zeros((G, Ws), dtype=np.int64)
    for g in range(G):
        for c in range(ncls):
            cols = np.flatnonzero(cls_w[g] == c)
            sort_idx[g, c * nmax:c * nmax + len(cols)] = cols
            unsort_idx[g, cols] = c * nmax + np.arange(len(cols))
    return dict(sort_idx=sort_idx, unsort_idx=unsort_idx)
