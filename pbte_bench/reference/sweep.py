"""Plain reference of one outer step of the phonon BTE source iteration.

Plain PyTorch in float64, written from the numpy oracle of the upstream
serial solver (``PBTE_NonGraySMRT``: upwind DG in space, discrete ordinates,
non-gray single-mode relaxation) and independent of the program under test:
it takes the element operators, angles and phonon tables of this folder's
frozen host layers and works out everything else itself (upwind levels,
directional operators, wall sources, block solves).

State: physical coefficients ``u`` of shape (K, BS, ne, D), the lagged
temperature ``Tc`` (ne, D). One step, for every direction k and band b and
every element e once all its upwind neighbours are done::

    A u_e = src_w M^T Tc_e + relax_w M^T u_e(old) + sum_inflow faces
            vg |s.n| (C_f u_nbr(new)  or  C/Omega T_wall int_F phi)
    A = dt_inv M + vg (-s.S + sum_f max(s.n, 0) F_f)

with ``dt_inv`` the largest inverse Knudsen number, ``src_w = inv_kn
C/Omega`` and ``relax_w = dt_inv - inv_kn``. ``relax=False`` gives the
fixed-point map without the pseudo-time relaxation (``dt_inv`` replaced
by ``inv_kn``, no ``u(old)`` term): a converged solution ``Tc`` satisfies
``Tc = sweep(Tc)`` under it. Then ``Tc = sum_{k,b} macro_w u``, ``Tv =
sum_i Tc basis_int`` and the residual ``||Tv - Tv_prev|| / ||Tv||``.

Elements are swept in upwind levels, every direction's level l in one
batch, blocks of at most ``BLOCK_BYTES`` of systems at a time.
"""

from __future__ import annotations

import numpy as np
import torch

# bytes of the batched (D, D) systems of one block of a level
BLOCK_BYTES = 1 << 30


def upwind_levels(neighbor, fdot):
    """(K, ne) level of each element per direction: 0 without an upwind
    neighbour, else one more than its upwind neighbours' largest. Raises on
    a cycle."""
    K, ne, nf = fdot.shape
    inflow = (fdot < 0.0) & (neighbor[None] >= 0)  # (K, ne, nf)
    nbr = np.where(neighbor >= 0, neighbor, 0)
    level = np.zeros((K, ne), dtype=np.int64)
    kk = np.arange(K)[:, None, None]
    for _ in range(ne + 1):
        up = np.where(inflow, level[kk, nbr[None]], -1).max(axis=-1) + 1
        if np.array_equal(up, level):
            return level
        level = up
    raise ValueError("the upwind graph of a direction has a cycle")


class PlainStep:
    """The reference's step for one problem: ``ops``, ``quad`` and
    ``tables`` of the frozen host layers, ``bc_temps`` the isothermal walls
    (boundary attribute -> temperature deviation)."""

    def __init__(self, ops, quad, tables, bc_temps, device="cpu"):
        dev = self.device = torch.device(device)
        f64 = dict(dtype=torch.float64, device=dev)
        ne, D, nf, dim = ops.num_elements, ops.ndof, ops.faces_per_elem, ops.dim
        self.ne, self.D, self.nf = ne, D, nf
        dirs = quad.directions[:, :dim]
        self.K = K = len(dirs)
        inv_kn = tables.flat("inv_kn").astype(np.float64)
        vg = tables.flat("vg").astype(np.float64)
        heat_cap = tables.flat("heat_cap").astype(np.float64)
        self.BS = len(inv_kn)
        omega = float(quad.weights.sum())
        dt_inv = float(inv_kn.max())
        fdot = np.einsum("efd,kd->kef", ops.normals, dirs)  # (K, ne, nf)
        bdry = ops.neighbor < 0
        missing = set(np.unique(ops.face_attr[bdry]).tolist()) - set(
            int(a) for a in bc_temps)
        if missing:
            raise ValueError(f"walls without a temperature: {sorted(missing)}")
        bc_T = np.zeros((ne, nf))
        for attr, T in bc_temps.items():
            bc_T[(ops.face_attr == int(attr)) & bdry] = float(T)
        # wall source per (direction, element): sum over inflow boundary
        # faces of |s.n| T_wall int_F phi (times vg C / Omega per band)
        w_in = np.where(bdry[None], np.maximum(-fdot, 0.0), 0.0) * bc_T[None]
        wall = np.einsum("kef,efi->kei", w_in, ops.face_int)
        level = upwind_levels(ops.neighbor, fdot)

        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), **f64)  # noqa: E731
        self.mass = t(ops.mass)
        self.coupling = t(ops.coupling)
        self.basis_int = t(ops.basis_int)
        self.neighbor = torch.as_tensor(ops.neighbor, device=dev)
        # transport operator per (direction, element): -s.S + sum max(s.n,0) F
        self.transport = t(
            -np.einsum("kd,edij->keij", dirs, ops.stiff)
            + np.einsum("kef,efij->keij", np.maximum(fdot, 0.0),
                        ops.face_mass))
        self.cin = t(np.maximum(-fdot, 0.0) * (ops.neighbor[None] >= 0))
        self.wall = t(wall)
        self.vg = t(vg)
        self.inv_kn = t(inv_kn)
        self.dt_inv = dt_inv
        self.src_w = t(inv_kn * heat_cap / omega)
        self.wall_w = t(vg * heat_cap / omega)
        self.macro_w = t(np.outer(quad.weights, inv_kn * tables.flat("dw"))
                         / tables.heat_cap_v)
        # (k, e) pairs of each level, blocks of at most BLOCK_BYTES
        per = max(1, BLOCK_BYTES // (self.BS * D * D * 8 * 3))
        self.blocks = []
        ks, es = np.nonzero(level >= 0)
        order = np.argsort(level[ks, es], kind="stable")
        ks, es, lv = ks[order], es[order], level[ks, es][order]
        for l in np.unique(lv):
            sel = np.nonzero(lv == l)[0]
            for a in range(0, len(sel), per):
                s = sel[a:a + per]
                self.blocks.append((torch.as_tensor(ks[s], device=dev),
                                    torch.as_tensor(es[s], device=dev)))

    def zero_state(self):
        z = dict(dtype=torch.float64, device=self.device)
        return (torch.zeros((self.K, self.BS, self.ne, self.D), **z),
                torch.zeros((self.ne, self.D), **z),
                torch.zeros((self.ne,), **z))

    @torch.no_grad()
    def sweep(self, u, Tc, relax=True):
        """New physical coefficients (K, BS, ne, D) from the previous
        ``u`` (read only with ``relax``) and the lagged ``Tc``."""
        mtc = torch.einsum("eji,ej->ei", self.mass, Tc)  # M^T Tc
        diag = self.dt_inv if relax else self.inv_kn[None, :, None, None]
        u_new = torch.zeros((self.K, self.BS, self.ne, self.D),
                            dtype=torch.float64, device=self.device)
        vg = self.vg[None, :, None]
        for ks, es in self.blocks:
            rhs = (self.src_w[None, :, None] * mtc[es][:, None]
                   + self.wall_w[None, :, None] * self.wall[ks, es][:, None])
            if relax:
                rel = (self.dt_inv - self.inv_kn)[None, :, None]
                rhs = rhs + rel * torch.einsum(
                    "pji,pbj->pbi", self.mass[es], u[ks, :, es])
            for f in range(self.nf):
                c = self.cin[ks, es, f]  # (P,)
                on = torch.nonzero(c > 0).squeeze(1)
                if on.numel() == 0:
                    continue
                k_on, e_on = ks[on], es[on]
                nb = self.neighbor[e_on, f]
                rhs[on] += (c[on][:, None, None] * vg) * torch.einsum(
                    "pij,pbj->pbi", self.coupling[e_on, f], u_new[k_on, :, nb])
            A = (diag * self.mass[es][:, None]
                 + self.vg[None, :, None, None] * self.transport[ks, es][:, None])
            u_new[ks, :, es] = torch.linalg.solve(A, rhs.unsqueeze(-1)).squeeze(-1)
        return u_new

    def closure(self, u):
        """(Tc, Tv) of physical coefficients u."""
        Tc = torch.einsum("kb,kbei->ei", self.macro_w, u)
        return Tc, torch.einsum("ei,ei->e", Tc, self.basis_int)

    def step(self, u, Tc, Tv_prev):
        """One relaxed outer step: (u, Tc, Tv, residual)."""
        u = self.sweep(u, Tc)
        Tc, Tv = self.closure(u)
        return u, Tc, Tv, residual(Tv, Tv_prev)

    def unrelaxed_map(self, Tc):
        """Tc' of the unrelaxed map at ``Tc``: a converged solution has
        Tc' = Tc."""
        return self.closure(self.sweep(None, Tc, relax=False))[0]


def residual(Tv, Tv_prev):
    """||Tv - Tv_prev|| / ||Tv||, both scaled by max |Tv| first."""
    s = Tv.abs().max().clamp(min=torch.finfo(Tv.dtype).tiny)
    return float(torch.linalg.vector_norm((Tv - Tv_prev) / s)
                 / torch.linalg.vector_norm(Tv / s))
