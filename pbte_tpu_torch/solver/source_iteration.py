"""Source-iteration PBTE solver (PyTorch + CUDA).

Port of ``pbte_tpu/solver/source_iteration.py::SourceIterationSolver`` on
one device, with four of its sweeps:

- the shift-structured lattice ring on a Cartesian box lattice (no
  supercell merge): on a single-class lattice the path of its Pallas
  kernel, K1, plus the lagged closures its XLA ring ``_step_ring`` runs on
  the same lattice (periodic wraps, diffuse and specular walls; the
  flagship, hex 16^3, p=2, 64 directions x 40 bands, f32, takes it); on a
  lattice of several geometry classes, or of per-element couplings, its
  XLA ring's multi-class branch as torch products
  (``solver/lattice_multi.py``);
- the general ring, its XLA ring's one-hot branch off the box lattice, as
  torch products (``solver/one_hot_ring.py``): triangles, tets and other
  meshes whose levels are wide, with the same closures;
- the compact level-window scan (``solver/scan.py``) for every other mesh
  pbte_tpu scans: tri, quad, tet, hex and mixed meshes, small meshes,
  meshes read from gmsh or MFEM files, under the ``full``, ``on-the-fly``
  and ``eigen`` factor caches;
- the supercell two-matmul ring (``solver/super_ring.py``) on a 6-tet
  (3D) or 2-triangle (2D) split of a Cartesian lattice, merged into block
  super elements (``fem/supercell.py``): the reference's legacy production
  tet mesh takes it.

``sweep_mode="auto"`` resolves as pbte_tpu's structural gates do, less its
TPU memory budgets: faces are canonicalised at ne >= 512; a detected
simplex-lattice split goes to the supercell ring (``supercell="auto"``,
without Dirichlet, reflective or periodic walls and axis-grazing
directions), a lattice of at most 8 geometry classes to the lattice ring,
a general mesh of at most 8 classes, upwind level gaps of at most 4 and
levels of at least 64 elements to the general ring; the rest is scanned.
``use_lattice=False`` (pbte_tpu's keyword) sweeps a box lattice on the
general ring too, and then merges no supercell (the supercell ring is a
lattice ring here). Two memory fallbacks for the 80 GB card stand in for
pbte_tpu's TPU budgets: past ``super_ring.SUPER_BUDGET`` bytes of its
working set ``auto`` does not merge, and the fine mesh is scanned; past
``one_hot_ring.GENERAL_BUDGET`` ``auto`` scans a mesh it would sweep on
the general ring (pbte_tpu's 700e6-byte one-hot and 4.5e9-byte state
budgets; with no one-hot tables here, its refusal of a forced ring past
2e9 one-hot bytes has no counterpart). ``sweep_mode="ring"`` merges and
rings regardless, as pbte_tpu's forced ring does. The rest of this
docstring is the lattice ring's.

``matmul_precision`` (constructor) and ``polish_precision`` (``solve``)
are pbte_tpu's tiers of the TPU's matrix unit, whose default truncates f32
operands to bf16; there a value other than None or "default" also turns
its Pallas kernel off. Here every float32 product is exact already (K1 as
3xTF32, every torch product with TF32 off: ``exact_f32_products``), so
each value runs the same path, K1 included, and gives the same result; an
unknown value raises ValueError.

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
   CUDA kernel for CUDA tensors, the plain version for CPU tensors), on
   a multi-class lattice ``lattice_multi.multi_class_sweep``, off the
   lattice ``one_hot_ring.one_hot_sweep``;
4. regroups the per-level macroscopic partials into Tc through the
   ``pos_of_elem`` gather and ``M^-T``, then Tv;
5. computes the scale-invariant residual.

State layout: a tuple of per-bucket ``(L, Gb, Km_b, BS, D, W)`` slabs of
the mass-transformed state ``v = M^T u`` (band-major, as on the JAX
Pallas path), float32 or, with ``PBTE_RING_STATE_BF16=1``, bfloat16 (on
the supercell ring too; the scan and the general ring keep float32, as
pbte_tpu's do), or float64 (``dtype=torch.float64``, on the CPU or the
GPU: every operand, the sweep's sums, Tc, Tv and the residual are then
float64).

``solve(accelerate="bicgstab")`` solves the same fixed point by BiCGStab
over the affine step (``solver/accel.py``), in far fewer steps with
float64 state; ``solve(accelerate="compensated")`` iterates it with the
state carried as a compensated sum of two trees (``accel.
compensated_outer``).

Dir and band sharding (pbte_tpu's ``dir_sharding``, there a
``NamedSharding`` of the Km slot axis and optionally the band axis, which
GSPMD partitions): here ``dir_sharding`` is a ``parallel.comm.Grid`` of
``dir`` (x ``band``) ranks, on every sweep ``sweep_mode`` resolves to.
Each rank holds and sweeps its own slots and bands
(``parallel.comm.DirShard``): of every bucket on the rings, ``(L, Gb,
Km_b / n_dir, BS / n_band, D, W)`` (K1 runs on it on a single-class
lattice; the supercell ring's is ``(L, Gb, Km_b / n_dir, BS / n_band, W,
D')``), and ``(G, Km / n_dir, BS / n_band, D, ne)`` on the scan; it builds
or uploads only their operators. Km (each bucket's) rounds up to a
multiple of ``n_dir`` and BS to a multiple of ``n_band`` (padded bands
carry zero tables, exact zero fixed points), as in pbte_tpu. The
macroscopic partials are all-reduced over the grid before Tc (the sum
GSPMD inserts for pbte_tpu); Tc, Tv and the residual are then the same on
every rank. The closures read the boundary values of every rank's shard
(``all_gather``); BiCGStab's inner product sums the shards. The views,
checkpoints and ``convert`` gather (``gather_buckets``) or shard
(``shard_buckets``) the state, whatever the sweep.

Hull windows (pbte_tpu's default on the flagship, its ``_step_ring_win``).
The slab pads every level to the full plane of W slots; the constructor
computes each level's hull ``[lo_l, hi_l)`` of valid slots once
(``lattice_tables.ring_windows``) and every sweep runs each level on its
window alone. The gate is pbte_tpu's: windows are taken when, rounded out
to the kernel's 16-slot tiles, they keep under 95% of the L W slots
(``WINDOW_MAX_SHARE``); the multi-class ring runs the full slab. pbte_tpu
re-lays its windowed state out in segments and therefore windows only
problems without lagged closures; here the state keeps the full-slab
layout, and the closures' ``(level, slot)`` gathers and ``xmap`` address
valid elements, which lie inside the windows, so the same windows serve
closure problems too. Slots outside a window are padding (exact-zero fixed
points), so the results with and without windows are equal bit for bit.

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
from pbte_tpu_torch.fem import supercell as supercell_mod
from pbte_tpu_torch.models import macroscopic
from pbte_tpu_torch.ops.lattice_ring import (
    ClosureSource,
    lattice_ring_sweep,
    windows_on_device,
)
from pbte_tpu_torch.ops.scatter import LayerMemo, index_add_layered_
from pbte_tpu_torch.parallel.comm import DirShard
from pbte_tpu_torch.solver import lattice_multi, one_hot_ring, scan, super_ring
from pbte_tpu_torch.solver.accel import tree_dot as accel_tree_dot
from pbte_tpu_torch.solver.lattice_tables import (
    active_faces,
    group_permuted,
    inflow_tables,
    lattice_ring_tables,
    ring_windows,
    slab_layout,
    slab_positions,
    window_slots,
)
from pbte_tpu_torch.sweep import planner

# the reflective-wall consts, global (the gather crosses buckets)
REFL_KEYS = ("dif_fint", "dif_cin", "dif_wplus", "dif_norm", "dif_fvec",
             "spc_cin", "spc_gk", "spc_fmv")
# windows are rounded out to the kernel's m-tiles of this many slots, and
# taken when they keep under this share of the slab (pbte_tpu's gate)
WINDOW_TILE = 16
WINDOW_MAX_SHARE = 0.95
# pbte_tpu's matmul precision tiers (its TPU MXU passes); "selective" is
# for matmul_precision only
POLISH_PRECISIONS = (None, "default", "high", "highest")
MATMUL_PRECISIONS = POLISH_PRECISIONS + ("selective",)


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
        sweep_mode: str = "auto",  # "auto" | "scan" | "ring"
        use_lattice: bool = True,  # the shift-structured ring on Cartesian
        # box lattices; False sweeps them on the general ring (and merges
        # no supercell), so both rings stay testable on one mesh
        cache_policy: str = "full",  # the scan path's factor cache: "full"
        # | "on-the-fly" (alias "per-iteration") | "eigen"
        supercell: str = "auto",  # "auto" | "on" | "off": merge simplex
        # lattice macro cells (6-tet / 2-tri splits) into block super
        # elements and ring-sweep the macro lattice (solver/super_ring.py).
        # "auto" engages for ne >= 512 when detection verifies the structure
        # and the ring's working set fits super_ring.SUPER_BUDGET; "on"
        # forces the attempt on any size; "off" keeps the fine-mesh paths
        matmul_precision: str | None = None,  # pbte_tpu's MXU tiers: None,
        # "default", "high", "highest" or "selective"; every one runs the
        # exact float32 products below (see the module docstring)
        dir_sharding=None,  # a parallel.comm.Grid of "dir" (x "band")
        # ranks: this rank's shard of the slots (and bands); see the module
        # docstring
    ):
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        if cache_policy == "per-iteration":
            cache_policy = "on-the-fly"
        if cache_policy not in ("full", "on-the-fly", "eigen"):
            raise ValueError(f"unknown cache_policy: {cache_policy}")
        if sweep_mode not in ("auto", "scan", "ring"):
            raise ValueError(f"unknown sweep_mode: {sweep_mode}")
        if supercell not in ("auto", "on", "off"):
            raise ValueError(f"unknown supercell={supercell!r}")
        if matmul_precision not in MATMUL_PRECISIONS:
            raise ValueError(f"unknown matmul_precision={matmul_precision!r}"
                             f"; one of {MATMUL_PRECISIONS}")
        self.matmul_precision = matmul_precision
        self.cache_policy = cache_policy
        # bf16 state (same opt-in as pbte_tpu): halves the state streams;
        # the product operands and the ring are then bf16 as well, and the
        # macroscopic partials stay f32 (the lattice and supercell rings;
        # the scan and the general ring keep exact-dtype state, as
        # pbte_tpu's do)
        self.state_bf16 = False
        want_bf16 = os.environ.get("PBTE_RING_STATE_BF16", "") == "1"
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
        self.dt_inv = dt_inv = float(inv_kn.max())
        # dir/band sharding: the slot and band shards of this rank; the band
        # axis pads to a multiple of its ranks with zero tables
        self.dir_sharding = dir_sharding
        self.BS_orig = BS
        if dir_sharding is not None:
            n_band = dir_sharding.n("band")
            bpad = -(-BS // n_band) * n_band - BS
            if bpad:
                inv_kn, vg, heat_cap = (np.concatenate([a, np.zeros(bpad)])
                                        for a in (inv_kn, vg, heat_cap))
                self.BS = BS = BS + bpad
        self._shard = shard = DirShard(dir_sharding, BS)
        n_dir = shard.n_dir
        bsl = shard.bsl

        # ---- canonical face ordering: collapses the geometry-class count
        # of translation-invariant meshes (hex 6 -> 1). Gated to ne >= 512
        # and the ring-capable modes exactly as pbte_tpu is, so small
        # meshes and the scan mode keep their face order (and classes).
        # The canonical order is classified before it is copied (the copy
        # of the face tensors is made only where it wins).
        cls = None
        if sweep_mode in ("auto", "ring") and ne >= 512:
            cls0 = assembly.element_classes(ops, merge=False)
            face_perm = assembly.canonical_face_perm(ops)
            cls1 = assembly.element_classes(ops, perm=face_perm)
            if cls1.max() < cls0.max():
                ops, cls = assembly.permute_faces(ops, face_perm), cls1
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

        # ---- supercell merge: a detected 6-tet (3D) or 2-triangle (2D) split
        # of a Cartesian lattice becomes a box lattice of block super
        # elements, ring-swept by solver/super_ring.py (pbte_tpu's gate,
        # less its 16 GB-chip budget: this package's is SUPER_BUDGET)
        if supercell == "on" and cls is None:
            # forced on small meshes: canonicalise and classify here (the
            # ne >= 512 gate above skipped it)
            ops = assembly.permute_faces(
                ops, assembly.canonical_face_perm(ops))
            cls = assembly.element_classes(ops)
        self._super = None
        if (supercell != "off" and use_lattice
                and sweep_mode in ("auto", "ring")
                and not dirichlet_bcs
                and not (diffuse_bcs or specular_bcs)
                and not ops.periodic.any()
                and float(np.abs(quad.directions[:, :dim]).min()) > 1e-14):
            sc = None
            if cls is not None and 2 <= int(cls.max()) + 1 <= 8:
                sc = supercell_mod.detect(ops, cls)
            if sc is not None and supercell_mod.verify_acyclic(
                    sc, quad.directions):
                itemsize = np.dtype(np_dtype).itemsize
                if sweep_mode == "ring" or super_ring.super_ring_bytes(
                        sc, self.K, BS, itemsize) <= super_ring.SUPER_BUDGET:
                    self._super = sc
                    ops = sc.super_ops
                    self.ne = ne = ops.num_elements
                    self.D = D = ops.ndof
                    cls = np.zeros(ne, dtype=np.int64)
        # fine-element count of Tv and the residual (the reference's
        # residual is over per-element cell averages)
        self.ne_tv = self._super.ne_fine if self._super else ne

        # ---- sweep plan, slot-major (G, Km) layout, Km buckets -------------
        sweep_nbr = ops.sweep_neighbor
        self.plan = plan = planner.build_plan(sweep_nbr, ops.normals,
                                              quad.directions)
        self.G = G = plan.num_groups
        sizes = np.array([len(d) for d in plan.dirs_of_group])
        self.Km = Km = -(-int(sizes.max()) // n_dir) * n_dir
        dirs_pad = np.full((G, Km), -1, dtype=np.int64)
        for g, d in enumerate(plan.dirs_of_group):
            dirs_pad[g, : len(d)] = d
        self.dirs_pad = dirs_pad  # slot (g, k) -> global direction or -1
        dir_valid = dirs_pad >= 0
        dirs_np = quad.directions[:, :dim]
        dirs_safe = np.where(dir_valid, dirs_pad, 0)
        self.L = L = plan.max_levels

        # macroscopic and heat-flux weights per slot; padded bands weigh zero
        mw_slots, fw_slots = macroscopic.slot_weights(quad, tables, dirs_pad,
                                                      dim)
        if BS > self.BS_orig:
            mw_slots = np.pad(mw_slots, ((0, 0), (0, 0),
                                         (0, BS - self.BS_orig)))
            fw_slots = np.pad(fw_slots, ((0, 0), (0, 0),
                                         (0, BS - self.BS_orig), (0, 0)))

        nf = ops.faces_per_elem
        bc_T = np.zeros((ne, nf))
        for attr, T in bc_temps.items():
            bc_T[ops.face_attr == int(attr)] = float(T)
        dvec = np.zeros((ne, nf, D))
        for attr, gval in dirichlet_bcs.items():
            sel = ops.face_attr == int(attr)
            dvec[sel] = float(gval) * ops.face_int[sel]

        # ---- path resolution: pbte_tpu's ring decision, less its TPU
        # memory budgets. The ring takes Cartesian box lattices of at most
        # 8 geometry classes (the lattice ring: K1 on a single class, the
        # multi-class torch ring otherwise) and general meshes of at most 8
        # classes, small upwind gap and wide levels (the general ring,
        # solver/one_hot_ring.py) whose working set fits
        # one_hot_ring.GENERAL_BUDGET; everything else is the scan.
        self.sweep_mode = "scan"
        self._sweep = self._scan = None
        self._closure_layers = LayerMemo()  # the closure maps' layers
        lt = None
        if self._super is not None:
            lat = planner.detect_lattice(sweep_nbr, ops.normals)
            lt = (None if lat is None
                  else lattice_ring_tables(lat, plan, dirs_np))
            if lt is None:
                raise ValueError(
                    "supercell merge engaged but the ring sweep was rejected "
                    "(axis-grazing quadrature direction or leveling "
                    "mismatch); pass supercell='off' to use the fine-mesh "
                    "scan path")
            self.state_bf16 = want_bf16
            self._check_bf16()
            self.state_dtype = torch.bfloat16 if want_bf16 else dtype
            self.sweep_mode = "ring"
            self._sweep = sw = super_ring.SuperRingSweep(
                self._super, ops, quad, plan, dirs_pad,
                (inv_kn, vg, heat_cap, dt_inv), lt, (mw_slots, fw_slots),
                bc_T=bc_T, dtype=dtype, state_dtype=self.state_dtype,
                device=device, shard=shard)
            self._ring_buckets = sw.buckets
            self.W, self.ne_pad, self.consts = sw.W, sw.ne_pad, sw.consts
            self.shifts, self._perm = sw.shifts, sw._perm
            self.win = None  # the full (L, W) slab
            self.has_periodic = self._dif_on = self._spc_on = False
            return
        if sweep_mode in ("auto", "ring"):
            if cls is None:
                cls = assembly.element_classes(ops)
            ncls = int(cls.max()) + 1
            lat = (planner.detect_lattice(sweep_nbr, ops.normals)
                   if use_lattice else None)
            lt = (None if lat is None
                  else lattice_ring_tables(lat, plan, dirs_np))
            if lt is not None:
                ring = ncls <= 8 or sweep_mode == "ring"
            else:
                W_g = min(plan.max_width, ne)
                itemsize = np.dtype(np_dtype).itemsize
                ring = sweep_mode == "ring" or (
                    ncls <= 8 and W_g >= 64
                    and _upwind_gap(plan, sweep_nbr, ne) <= 4
                    and one_hot_ring.ring_bytes(
                        int(sizes.sum()) + G, BS, self.D, L, W_g, G, Km,
                        ops.faces_per_elem, ncls, itemsize)
                    <= one_hot_ring.GENERAL_BUDGET)
            if ring:
                self.sweep_mode = "ring"
        if self.sweep_mode == "scan":
            self._sweep = self._scan = scan.ScanSweep(
                ops, quad, plan, dirs_pad, (inv_kn, vg, heat_cap, dt_inv),
                (mw_slots, fw_slots), bc_T=bc_T,
                dvec=dvec if dirichlet_bcs else None,
                diffuse_bcs=diffuse_bcs, specular_bcs=specular_bcs,
                cache_policy=cache_policy, cls_cache=cls, dtype=dtype,
                device=device, shard=shard)
            sv = self._scan
            self.cache_policy = sv.cache_policy  # after the eigen guard
            self.W, self.ne_pad, self.consts = sv.W, sv.ne_pad, sv.consts
            self._perm = sv._perm
            self.win = None  # the lattice ring's hull windows
            self.has_periodic = sv.has_periodic
            self._dif_on, self._spc_on = sv._dif_on, sv._spc_on
            self.state_dtype = dtype
            return
        # the general ring (pbte_tpu's one-hot ring) off the box lattice;
        # bf16 state is the lattice ring's alone, as in pbte_tpu
        self._general = lt is None
        self.state_bf16 = not self._general and want_bf16
        self._check_bf16()

        # groups of equal slot count run as one bucket with exactly that
        # many slots (flagship octants: [10]*4 and [6]*4)
        km_req = np.maximum(-(-sizes // n_dir) * n_dir, 1)
        self._ring_buckets = [
            (np.flatnonzero(km_req == kv), int(kv))
            for kv in sorted({int(x) for x in km_req}, reverse=True)
        ]

        # ---- K1 takes a single-class lattice with a class coupling; other
        # lattices (several geometry classes, or couplings that differ
        # within the class) take the multi-class torch ring, general meshes
        # the general ring
        ncls = int(cls.max()) + 1
        self._multi = None  # the multi-class ring's per-bucket operands
        if self._general:
            ccpl = None
            self.shifts = ()
            slab_tab = plan.levels  # (G, L, W): the plan's levels, padded
        else:
            slab_tab, act_f, lat_shifts = lt
            ccpl = assembly.class_coupling(ops, cls) if ncls == 1 else None
            self.shifts = tuple(int(s) for s in lat_shifts)
        self.W = W = slab_tab.shape[2]
        # per-level hull windows (L, 2), or None where they save too little
        # (the torch rings run the full slab)
        win = None if self._general else ring_windows(slab_tab)
        self.win = (win if ccpl is not None and window_slots(win, WINDOW_TILE)
                    < WINDOW_MAX_SHARE * L * W else None)
        # on a GPU the sweeps take the windows as a tensor, uploaded once
        self.win_dev = (
            windows_on_device(self.win, L, W, device)
            if self.win is not None and device.type == "cuda" else None
        )
        self.ne_pad = L * W

        # ---- padded (L, W) slab layout per group, and the inflow faces:
        # the lattice's axis faces, or on the general ring the faces each
        # group ever reads an upwind neighbour through (pbte_tpu's active
        # faces)
        if self._general:
            perm, pos_valid, perm_safe, pos_of_elem, nbr_pos = (
                slab_positions(slab_tab, sweep_nbr))
            act_f, act_valid = active_faces(ops, perm_safe, dirs_np[dirs_safe],
                                            dir_valid)
        else:
            perm, pos_valid, perm_safe, pos_of_elem, nbr_pos = slab_layout(
                slab_tab, sweep_nbr, act_f, self.shifts)
        nf_act = act_f.shape[1]
        self._perm = perm

        def gperm(a):
            return group_permuted(a, perm_safe, pos_valid, np_dtype)

        # ---- inflow coefficients and boundary sources ----------------------
        # (periodic faces have no upwind neighbour in the sweep and no
        # temperature: their inflow arrives lagged through xsrc)
        fdot, cin_bnd, cin_act, bsrc0 = inflow_tables(
            ops, dirs_np[dirs_safe], perm_safe, nbr_pos, act_f, gperm(bc_T),
            gperm(ops.face_int))
        # kernel layout (L, G, Km, nf_act, W)
        ring_cin = cin_act.reshape(G, nf_act, Km, L, W).transpose(3, 0, 2, 1, 4)
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
        a_cls, massT_r, invMT_r = lattice_multi.class_factors(
            ops, cls, dirs_np, dirs_safe, vg_s, np_dtype)
        # per-element M^-T for the closure and the u views
        self._ring_invMT = invMT_r[cls]  # (ne, D, D) f64
        if ccpl is not None:
            ccpl_G = np.einsum("fij,jk->fik", ccpl[0], invMT_r[0]).astype(
                np_dtype
            )[act_f]  # (G, nf_act, D, D)
            # folded + concatenated factor: sol = [B | -vg B C_0 | ...] @ xcat
            a64 = a_cls[:, 0].astype(np.float64)
            bcv = np.einsum(
                "gkbij,gfjl,b->gfkbil", a64, ccpl_G.astype(np.float64), vg_s
            )  # (G, nf_act, Km, BS, D, D)
            bcat = np.concatenate([a64[:, None], -bcv], axis=1)
            bcat = np.moveaxis(bcat, 1, -2).reshape(G, Km, BS, D, -1)
        elif not self._general:
            cpl, q_of = lattice_multi.coupling_classes(ops, cls, invMT_r)
        else:
            # the coupling classes where they determine the couplings, else
            # the per-element couplings (pbte_tpu's cpl_slab)
            try:
                couplings = lattice_multi.coupling_classes(ops, cls, invMT_r)
            except NotImplementedError:
                nbr_cls = cls[np.clip(ops.neighbor, 0, None)]
                couplings = np.einsum("efij,efjk->efik", ops.coupling,
                                      invMT_r[nbr_cls])

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

        kss = shard.kss

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
            # (D, D) the single geometry class's M^T, or (ncls, D, D)
            massT=put(massT_r[0] if ccpl is not None else massT_r),
            wvec=put(wvec[:, bsl]),  # this rank's bands under dir_sharding
            pos_of_elem=iput(pos_of_elem),  # (G, ne)
            ring_invMT=put(self._ring_invMT),  # (ne, D, D)
            basis_int_glob=put(ops.basis_int),  # (ne, D)
            flux_w=put(fw_slots),  # (G, Km, BS, dim)
            **{k: (iput(v) if k == "spc_gk" else put(v))
               for k, v in (refl or {}).items() if k in REFL_KEYS},
            buckets=tuple(
                dict(
                    **(
                        dict(bcat=put(bcat[gs][:, kss(km_b), bsl]),
                             cin=put(ring_cin[:, gs][:, :, kss(km_b)]))
                        if ccpl is not None else {}
                    ),
                    # the general ring's factors, reads and couplings
                    **(
                        one_hot_ring.bucket_tables(
                            gs, km_b, a_cls, cls, couplings, perm_safe,
                            pos_valid, nbr_pos, act_f, act_valid, cin_act, L,
                            W, put, iput, ks=kss(km_b), bs=bsl)
                        if self._general else {}
                    ),
                    bsrc0=put(ring_bsrc0[:, gs, kss(km_b)]),
                    macro_w=put(mw_slots[gs][:, kss(km_b), bsl]),
                    **(
                        {"dsrc0": put(ring_dsrc0[:, gs, kss(km_b)])}
                        if ring_dsrc0 is not None else {}
                    ),
                    # periodic wraps stay inside a group: per-bucket tables
                    **(
                        dict(
                            per_cpl=put(per["cpl"][gs]),  # (Gb, P, D, D)
                            per_cin=put(per["cin"][gs][:, kss(km_b)]),
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
        if ccpl is None and not self._general:
            self._multi = tuple(
                lattice_multi.bucket_tables(
                    gs, km_b, a_cls, cls, cpl, q_of, perm_safe, pos_valid,
                    act_f, ring_cin, L, W, np_dtype, put, iput, ks=kss(km_b),
                    bs=bsl)
                for gs, km_b in self._ring_buckets)
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
        self._vg_all = put(vg_s)  # every band's (the wall closures)
        # the sweep the step calls on a single-class lattice; the wrapper
        # launches the CUDA kernel for CUDA tensors (assign
        # lattice_ring_sweep_ref to compare with the plain version on the
        # same device)
        self.ring_sweep = lattice_ring_sweep

    def _check_bf16(self):
        if self.state_bf16 and self.dtype == torch.float64:
            raise ValueError("PBTE_RING_STATE_BF16=1 rounds float32 state to "
                             "bfloat16; unset it for float64 state")

    # -- state -------------------------------------------------------------

    def initial_state(self):
        """Zero state, Tc and Tv (ref: PBTESolver::CreateInitialCoefficients):
        per-bucket slabs on the ring (this rank's shard under
        ``dir_sharding``), one (G, Km, BS, D, ne) tensor on the scan."""
        if self._sweep is not None:
            return self._sweep.initial_state()
        u = tuple(
            torch.zeros(
                (self.L, len(gs), km_b // self._shard.n_dir, self._shard.bl,
                 self.D, self.W),
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
        steps a float32 copy of it exactly: the polish of ``solve``). The
        scan path leaves its input state as it was."""
        if self._sweep is not None:
            return self._sweep.step(u, Tc, Tv_prev)
        c = self.consts
        G, W, L, D = self.G, self.W, self.L, self.D
        tc_slab = (
            Tc.T[:, c["perm"]].reshape(D, G, L, W).permute(2, 1, 0, 3)
            * c["valid_slab"][:, :, None, :]
        )  # (L, G, D, W), padded slots zeroed (exact-zero fixed points)
        if c["massT"].dim() == 2:  # K1's single geometry class
            ttc_all = torch.einsum("ij,lgjw->lgiw", c["massT"], tc_slab)
        xsrc = self._closure_sources(u)

        m_parts = []
        v_new = []
        for bi, cb in enumerate(c["buckets"]):
            groups = self._bucket_groups[bi]
            if self._general:
                ys, ms = one_hot_ring.one_hot_sweep(
                    u[bi], lattice_multi.class_ttc(c["massT"], cb["cls_oh"],
                                                   tc_slab[:, groups]),
                    cb["bsrc0"], cb, cb["macro_w"], c["wvec"],
                    dsrc=cb.get("dsrc0"), xsrc=xsrc[bi])
            elif self._multi is not None:
                mb = self._multi[bi]
                ys, ms = lattice_multi.multi_class_sweep(
                    u[bi], lattice_multi.class_ttc(c["massT"], mb.cls_oh,
                                                   tc_slab[:, groups]),
                    cb["bsrc0"], mb, cb["macro_w"], c["wvec"],
                    shifts=self.shifts, dsrc=cb.get("dsrc0"), xsrc=xsrc[bi])
            else:
                ys, ms = self.ring_sweep(
                    u[bi], ttc_all[:, groups].contiguous(), cb["bsrc0"],
                    cb["cin"], cb["bcat"], cb["macro_w"], c["wvec"],
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
        Tc_v = self._shard.psum(Tc_v)  # every rank's slots and bands
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
        vg = c["wvec"][3]  # (BS,) non-dimensional group velocity (the
        # rank's bands under dir_sharding)
        # contributions add up per closure element (corner elements have
        # several closure faces) in a (Gb, U, Km_b, BS, D) buffer that the
        # sweep reads through the bucket's slot map xmap
        sums = [
            torch.zeros((len(gs), n_u, km_b // self._shard.n_dir,
                         self._shard.bl, self.D), dtype=acc,
                         device=self.device)
            for (gs, km_b), n_u in zip(self._ring_buckets, self._closure_u)
        ]

        def add(bi, uid, con):
            """sums[bi][g, uid[g, p]] += con[g, p], one collision-free
            layer of (g, p) pairs at a time."""
            n_u = sums[bi].shape[1]
            rows = (self._bucket_gi[bi] * n_u + uid).reshape(-1)
            index_add_layered_(
                sums[bi].view((-1,) + sums[bi].shape[2:]), 0, rows,
                con.reshape((-1,) + con.shape[2:]),
                self._closure_layers.layers(uid, rows))

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
                vb = self._shard.gather(vb, 2, 3)  # every rank's slots, bands
                if km_b < self.Km:
                    vb = torch.nn.functional.pad(
                        vb, (0, 0, 0, 0, 0, self.Km - km_b))
                parts.append(vb)
            v_bnd = torch.cat(parts)[self._inv_order]  # (G, P, Km, BS, D)
            pd = self._refl_Pd
            vg = self._vg_all
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
                    refl_con[self._bucket_groups[bi]][
                        :, :, self._shard.kss(km_b), self._shard.bsl])
        return tuple(ClosureSource(cb["xmap"], sm)
                     for cb, sm in zip(c["buckets"], sums))

    def solve(self, tol: float = 1e-7, max_iter: int = 101, state=None,
              verbose: bool = True, callback=None, check_every: int = 1,
              checkpoint_path: str | None = None, checkpoint_every: int = 25,
              accelerate: str | None = None, cycle_hook=None,
              cycle_every: int = 0, polish_iters: int = 0,
              polish_precision: str | None = "highest",
              polish_extrapolate: bool = False):
        """Outer source iteration (ref: src/PBTESolver.cpp:208-332). The
        residual is fetched to the host every ``check_every`` iterations.

        ``cycle_hook(it, u, Tc, Tv)`` is called with the live device state
        every ``cycle_every`` iterations (a field-output cadence).

        ``polish_iters`` exact steps follow the loop: the state slabs are
        cast to the solver dtype (float32 after a bfloat16-state solve) and
        stepped without operand rounding, which contracts the bias of the
        rounded fixed point by the iteration's rate per step; the result
        then carries exact-dtype slabs. ``polish_precision`` is pbte_tpu's
        matmul tier of those steps (None, "default", "high" or "highest";
        another value raises): every tier runs the same exact steps here
        (see the module docstring). ``polish_extrapolate`` adds two
        exact steps, estimates the slowest mode's ratio r from their
        successive Tc differences d1, d2 and jumps to the limit of its
        geometric tail, x2 + d2 r / (1 - r) (Aitken), as pbte_tpu does.

        ``accelerate="bicgstab"`` solves the same fixed point as the linear
        system (I - A) x = b by BiCGStab, one plain step per matvec
        (``accel.bicgstab_outer``; float32 or float64 state, float64 for
        deep tolerances): ``tol`` is then the linear relative residual, the
        result carries the Tv residual of a final plain step, and
        ``iterations`` counts step applications. ``"compensated"`` runs the
        plain fixed point with the state carried as the unevaluated sum of
        two trees (``accel.compensated_outer``): two step applications an
        iteration, ``iterations`` counting them, the residual read every
        ``check_every`` iterations; bfloat16 state raises ValueError.
        ``None`` or ``"none"`` is the plain loop.

        ``checkpoint_path`` writes a resumable ``.npz`` every
        ``checkpoint_every`` iterations (``io.checkpoint``, pbte_tpu's
        fields; BiCGStab writes its iterate every ``checkpoint_every``
        Krylov iterations); ``io.checkpoint.load_checkpoint`` gives the
        ``state`` to resume from."""
        if accelerate not in (None, "none", "bicgstab", "compensated"):
            raise ValueError(f"unknown accelerate={accelerate!r}")
        if polish_precision not in POLISH_PRECISIONS:
            raise ValueError(f"unknown polish_precision={polish_precision!r}"
                             f"; one of {POLISH_PRECISIONS}")
        if accelerate == "compensated":
            return self._solve_compensated(tol, max_iter, state, verbose,
                                           callback, check_every)
        if accelerate == "bicgstab":
            return self._solve_bicgstab(tol, max_iter, state, verbose,
                                        callback, check_every,
                                        checkpoint_path, checkpoint_every)
        from pbte_tpu_torch.solver import accel

        save_ckpt = None
        if checkpoint_path:
            from pbte_tpu_torch.io.checkpoint import save_checkpoint

            def save_ckpt(u, Tc, Tv, it, res, res_dev):
                save_checkpoint(checkpoint_path, self, u, Tc, Tv, it,
                                res if np.isfinite(res) else float(res_dev))

        u, Tc, prev_Tv, res, it = accel.plain_outer(
            self.step, state if state is not None else self.initial_state(),
            tol, max_iter, verbose=verbose, callback=callback,
            check_every=check_every, save_ckpt=save_ckpt,
            ckpt_every=checkpoint_every, cycle_hook=cycle_hook,
            cycle_every=cycle_every)
        if polish_iters > 0:
            u = _smap(lambda x: x.to(self.dtype), u)
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
                u = _smap(lambda a2, a1: a2 + fac * (a2 - a1), u2, u1)
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
                        check_every, checkpoint_path, checkpoint_every):
        """BiCGStab on (I - A) x = b, one matvec = one plain step
        (accel.bicgstab_outer); ``iterations`` counts step applications so
        they compare with the plain loop."""
        from pbte_tpu_torch.solver import accel

        if self.state_bf16:
            raise ValueError(
                "accelerate='bicgstab' needs exact-dtype state recurrences; "
                "unset PBTE_RING_STATE_BF16"
            )
        save_ckpt = None
        if checkpoint_path:
            from pbte_tpu_torch.io.checkpoint import accel_ckpt_saver

            save_ckpt = accel_ckpt_saver(
                checkpoint_path, self,
                torch.zeros((self.ne_tv,), dtype=self.dtype,
                            device=self.device))
        u_f, Tc_f, Tv_f, tv_res, nmv = accel.bicgstab_outer(
            self.step, self.initial_state(), state, tol, max_iter,
            verbose=verbose, callback=callback, check_every=check_every,
            save_ckpt=save_ckpt, ckpt_every=checkpoint_every,
            label="pbte_tpu_torch",
            **({} if self.dir_sharding is None else {"dot": self._grid_dot}),
        )
        return SolveResult(u=u_f, Tc=Tc_f, Tv=Tv_f, residual=tv_res,
                           iterations=nmv, solver=self)

    def _solve_compensated(self, tol, max_iter, state, verbose, callback,
                           check_every):
        """The plain fixed point with the state carried as a compensated
        sum (accel.compensated_outer), two step applications an iteration;
        ``iterations`` counts step applications."""
        from pbte_tpu_torch.solver import accel

        if self.state_bf16:
            raise ValueError(
                "accelerate='compensated' needs exact-dtype state; unset "
                "PBTE_RING_STATE_BF16")
        u_f, Tc_f, Tv_f, tv_res, nst = accel.compensated_outer(
            self.step, self.initial_state(), state, tol, max_iter,
            verbose=verbose, callback=callback, check_every=check_every)
        return SolveResult(u=u_f, Tc=Tc_f, Tv=Tv_f, residual=tv_res,
                           iterations=nst, solver=self)

    def _grid_dot(self, x, y):
        """<x, y> over the dir-sharded (u, Tc) tree: the state's shards
        sum over the grid, Tc is the same on every rank (counted once)."""
        du = accel_tree_dot(x[0], y[0])
        return self._shard.psum(du) + torch.dot(x[1].reshape(-1),
                                                y[1].reshape(-1))

    def gather_buckets(self, u):
        """The full state from every rank's shard under ``dir_sharding``
        (collective; the state itself without it): per bucket on the rings
        (slots on axis 2, bands on axis 3, the supercell's too), the one
        ``(G, Km, BS, D, ne)`` tensor on the scan (axes 1 and 2)."""
        if self.dir_sharding is None:
            return u
        if not isinstance(u, tuple):
            return self._shard.gather(u, 1, 2)
        return tuple(self._shard.gather(b, 2, 3) for b in u)

    def shard_buckets(self, u):
        """This rank's shard of a full state (``gather_buckets``'
        inverse)."""
        sh = self._shard
        if self.dir_sharding is None:
            return u
        if not isinstance(u, tuple):
            return u[:, sh.kss(self.Km), sh.bsl].contiguous()
        return tuple(b[:, :, sh.kss(km_b), sh.bsl].contiguous()
                     for b, (_, km_b) in zip(u, self._ring_buckets))

    # -- views ----------------------------------------------------------------

    def _ring_u_standard(self, u):
        """Bucketed ring state -> standard (G, Km, BS, D, ne_pad) numpy
        (collective under ``dir_sharding``)."""
        u = self.gather_buckets(u)
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
        """Map the state to direction-major physical coefficients
        (K, BS, ne, D) (numpy; collective under ``dir_sharding``, without
        its band padding)."""
        if self._sweep is not None:
            full = self._sweep.u_by_direction(self.gather_buckets(u))
            return full[:, : self.BS_orig]
        us = self._ring_u_standard(u)[:, :, : self.BS_orig]
        out = np.zeros((self.K, us.shape[2], self.ne, self.D), dtype=us.dtype)
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
        """Per-(fine-)element temperature coefficients (ne, D): the identity,
        except on the supercell ring, where the (ncell, gsz D) blocks are
        de-blocked to (ne_fine, D)."""
        if self._super is None:
            return Tc
        return self._sweep.tc_fine(Tc)

    @exact_f32_products()
    def heat_flux(self, u):
        """Heat-flux coefficients Qc (dim, ne, D) and cell integrals Qv
        (dim, ne) of the state, on its device."""
        u = self.gather_buckets(u)
        if self._sweep is not None:
            return self._sweep.heat_flux(u)
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


def _smap(fn, *states):
    """fn over a state's tensors: the ring's per-bucket tuple or the scan's
    single tensor."""
    if isinstance(states[0], tuple):
        return tuple(fn(*parts) for parts in zip(*states))
    return fn(*states)


def _upwind_gap(plan, sweep_nbr, ne):
    """The largest level gap H between an element and an upwind neighbour,
    over all groups (pbte_tpu's one-hot ring gate, H <= 4)."""
    G, L = plan.num_groups, plan.max_levels
    lev_of = np.zeros((G, ne), dtype=np.int32)
    for g in range(G):
        for lv in range(L):
            row = plan.levels[g, lv]
            lev_of[g, row[row >= 0]] = lv
    nbr_s = np.where(sweep_nbr >= 0, sweep_nbr, 0)
    gaps = lev_of[:, :, None] - lev_of[:, nbr_s]  # (G, ne, nf)
    gaps = np.where(sweep_nbr[None] >= 0, gaps, 0)
    return max(1, int(gaps.max()))


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
    """Lagged diffuse and specular walls on the ring: the scan's tables
    (``scan.reflective_tables``) with the element's M^-T folded in, as the
    ring carries v = M^T u. Returns None without reflective faces, else
    numpy tables: diffuse ``dif_fint`` (P_d, D), ``dif_cin`` and
    ``dif_wplus`` (G, Km, P_d), ``dif_norm`` (P_d,) and ``dif_fvec`` (P_d,
    D) = fint M^-T; specular ``spc_cin`` (G, Km, P_s), ``spc_gk`` (G, Km,
    P_s) the flat (group, slot) of the mirror direction and ``spc_fmv``
    (P_s, D, D) = face mass M^-T; the (level, slot) scatter pairs ``pl``,
    ``pw`` (G, P_d + P_s), diffuse rows first; and P_d."""
    t = scan.reflective_tables(ops, quad, dirs_pad, pos_of_elem, diffuse_bcs,
                               specular_bcs)
    if not t:
        return None
    bnd = (ops.neighbor < 0) & ops.face_valid
    out, pos = {}, []
    if "dif_fint" in t:
        d_e = np.argwhere(np.isin(ops.face_attr, diffuse_bcs) & bnd)[:, 0]
        out.update({k: t[k] for k in ("dif_fint", "dif_cin", "dif_wplus",
                                      "dif_norm")})
        out["dif_fvec"] = np.einsum("pi,pij->pj", t["dif_fint"], invMT[d_e])
        pos.append(t["dif_pos"])
    if "spc_fm" in t:
        s_e = np.argwhere(np.isin(ops.face_attr, specular_bcs) & bnd)[:, 0]
        out.update(spc_cin=t["spc_cin"], spc_gk=t["spc_gk"],
                   spc_fmv=np.einsum("pil,plj->pij", t["spc_fm"],
                                     invMT[s_e]))
        pos.append(t["spc_pos"])
    pos = np.concatenate(pos, axis=1)
    out["pl"], out["pw"] = pos // W, pos % W
    out["Pd"] = t["dif_pos"].shape[1] if "dif_pos" in t else 0
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
