"""Lattice ring sweep: plain PyTorch version and the CUDA kernel's wrapper.

Port of ``pbte_tpu/ops/lattice_ring.py::lattice_ring_sweep`` (a Pallas TPU
kernel). One call runs one outer-iteration sweep of one Km bucket of the
single-class Cartesian-lattice source iteration: for every (group, slot)
the L wavefront levels run in order, each level solving all bands against
the previous level's solution slab (the "ring") shifted by the static
lattice offsets. Arguments and results keep the JAX wrapper's layouts.

``lattice_ring_sweep`` takes the plain version for CPU tensors and launches
a hand-written kernel for CUDA tensors; it never falls back from one to the
other. ``launch_plan`` picks the kernel from the shape alone: the one-CTA
kernel (``csrc/lattice_ring.cu``, a CTA holds a whole level, D in
``KERNEL_D`` and W <= 256) or the tiled kernel
(``csrc/lattice_ring_tiled.cu``, a level in C tiles of Wt slab columns, one
CTA a tile, for D = 64 and for W > 256, any W). Each comes in three state
types: float32
(exact operands), bfloat16 (bf16 operands and ring, f32 sums) and float64
(float64 operands and sums).

Hull windows. The slab pads every level to the full plane of W slots, but a
level's elements lie in a narrower hull. With ``win``, an ``(L, 2)`` integer
array of per-level windows ``[lo_l, hi_l)`` (host data, static per problem
like ``shifts``; for the kernel, ``windows_on_device`` checks and uploads
it once and the sweep takes the tensor it returns), a sweep computes level l on the columns of its window
alone. The contract: ``0 <= lo_l <= hi_l <= W`` (checked, raises); and every
slot outside a window is padding, that is ``v``, ``ttc``, ``bsrc``,
``dsrc`` and ``cin`` are zero there and ``xmap`` is -1 there (not checked
at run time). Padded slots are exact-zero fixed points of the recurrence,
so under the contract the windowed results equal the full-slab results bit
for bit: ``ys`` and ``ms`` are exact zeros outside the windows, and a ring
read that lands outside the previous level's window reads zero.

Reproducibility. The kernels sum the bands of ``ms`` in band order (a chain
of level flags between the bands' CTAs, ``csrc/lattice_ring_common.cuh``),
never by float atomics: one input gives one ``ys`` and one ``ms`` bit for
bit, from launch to launch. The one-CTA kernel chains ``CHAIN_BANDS``
bands at a time, each chain into a partial of its own, and the wrapper
adds the ``ms_parts`` partials in order; the tiled kernel chains every
band. Each launch takes a zeroed int32 scratch (``scratch_numel``: its
CTAs' tickets and the chains' flags).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from pbte_tpu_torch import tracing
from pbte_tpu_torch.ops import _build

# element DOF counts of the one-CTA kernels (csrc/lattice_ring.cu: quad
# p = 1-3, hex p = 1, 2) and of the tiled kernels
# (csrc/lattice_ring_tiled.cu: also hex p = 3)
KERNEL_D = (4, 8, 9, 16, 27)
TILED_D = (4, 8, 9, 16, 27, 64)
# the one-CTA kernels hold a level of W <= 256 slots (16-row tiles over 8
# consumer warps)
KERNEL_MAX_W = 256
KERNEL_MAX_FACES = 3
_SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on Hopper
# static shared memory of the one-CTA kernels (the CTA's ticket), beside
# the dynamic carve-up of kernel_smem_bytes
_ONE_CTA_STATIC_SMEM = 16
# bands a chain of the one-CTA kernels' band sum (kChainBands of
# csrc/lattice_ring.cu)
CHAIN_BANDS = 8
# the widest tile of the tiled kernel (TGeo::WT_MAX of
# csrc/lattice_ring_tiled.cu): its 8 consumer warps own 16-row m-tiles (2 a
# warp; 1 at D = 64 and at D = 27 in float64, where the factor or the
# float64 tiles fill shared memory), D = 64 splitting its 8 n-tiles over 2
# warps (float32) or 4 (float64)
TILED_WT_MAX = 256
_TILED_WT_MAX = {(64, torch.float32): 64, (64, torch.bfloat16): 128,
                 (64, torch.float64): 32, (27, torch.float64): 128}


def f64_tile_stride(W):
    """Row stride, in doubles, of the float64 kernel's tiles: W rounded to
    16-row m-tiles plus 4, which is 4 mod 16, so the 16 lanes of a
    half-warp's 8-byte A-fragment read (rows gq + 8h, tile rows tq + 4s)
    fall on 16 distinct 8-byte bank pairs."""
    return -(-W // 16) * 16 + 4


def kernel_smem_bytes(D, W, nf, state, L):
    """Dynamic shared memory of one kernel launch for state of type
    ``state``, as csrc/lattice_ring.cu carves it. float32 and bfloat16
    (``Smem``): the factor block in mma fragment order, two f32 solution
    tiles and two f32 rhs tiles (row stride padded to 32k + 8 words), two
    tiles of shifted inflow coefficients and the L levels' windows. float64
    (``SmemF64``): the factor in m16n8k4 B-fragment order (each face block
    padded to 4-deep k-steps, D to 8-column n-tiles), one solution tile and
    two rhs tiles (row stride W rounded to 16 plus 4 doubles), two tiles of
    shifted inflow coefficients and the windows."""
    def a16(n):
        return -(-n // 16) * 16

    if state == torch.float64:
        kt_face = -(-D // 4)
        nt = -(-D // 8)
        wc = -(-W // 16) * 16
        return (a16(8 * (1 + nf) * kt_face * nt * 32)
                + 3 * a16(8 * D * f64_tile_stride(W)) + 2 * a16(8 * nf * wc)
                + a16(8 * L))
    if state not in (torch.float32, torch.bfloat16):
        raise ValueError(f"no kernel for {state} state")
    cast_bf16 = state == torch.bfloat16
    kstep = 16 if cast_bf16 else 8
    kt_face = -(-D // kstep)
    nt = -(-D // 8)
    wp = -(-W // 32) * 32 + 8
    wc = -(-W // 16) * 16
    return (a16((1 + nf) * kt_face * nt * 32 * (8 if cast_bf16 else 16))
            + 4 * a16(4 * D * wp) + 2 * a16(4 * nf * wc) + a16(8 * L))


def tiled_wt_max(D, state):
    """The widest tile of the tiled kernel for D and the state type."""
    return _TILED_WT_MAX.get((D, state), TILED_WT_MAX)


def tiled_row_stride(Wt, state):
    """Row stride of the tiled kernel's tiles: 32k + 8 words in float32 and
    bfloat16 state (the tiles are float32), 16k + 4 doubles in float64."""
    if state == torch.float64:
        return f64_tile_stride(Wt)
    return -(-Wt // 32) * 32 + 8


def tiled_halo_blocks(shifts, Wt, C, row_stride):
    """Tiles of shared memory one set of the tiled kernel's halo takes
    (``halo_layout`` of csrc/lattice_ring_tiled.cu): face f reads min(s_f,
    Wt) columns of the lower tiles; the faces sit side by side in rows of
    ``row_stride``, each at a column that is a multiple of 4, a new block of
    D rows where the next does not fit; a launch of one tile needs none."""
    blocks, col, placed = 0, 0, False
    for s in shifts:
        hw = min(int(s), Wt) if C > 1 else 0
        if hw <= 0:
            continue
        if col + hw > row_stride:
            blocks, col = blocks + 1, 0
        col = -(-(col + hw) // 4) * 4
        placed = True
    return blocks + 1 if placed else 0


def tiled_smem_bytes(D, Wt, nf, state, halo_blocks):
    """Dynamic shared memory of one CTA of the tiled kernel
    (csrc/lattice_ring_tiled.cu, ``SmemTiled``) holding Wt slab columns:
    the factor block in mma fragment order (8 bytes a lane and fragment in
    every state type: float32 keeps b0, b1 unsplit), two solution tiles,
    two rhs tiles, ``tiled_halo_buffers`` sets of ``halo_blocks`` halo
    tiles (``tiled_row_stride``), two tiles of shifted inflow coefficients
    and 16 bytes for the CTA's ticket."""
    return _tiled_layout(D, Wt, nf, state, halo_blocks)[0]


def tiled_halo_buffers(D, Wt, nf, state, halo_blocks):
    """Sets of halo tiles the tiled kernel keeps: two (by level parity, so
    level l's halo loads while level l multiplies) where they fit one CTA's
    shared memory, else one."""
    return _tiled_layout(D, Wt, nf, state, halo_blocks)[1]


def _tiled_layout(D, Wt, nf, state, halo_blocks):
    """(bytes, halo buffers) of ``SmemTiled``."""
    def a16(n):
        return -(-n // 16) * 16

    if state == torch.float64:
        esize, kstep = 8, 4
    elif state in (torch.float32, torch.bfloat16):
        esize, kstep = 4, 16 if state == torch.bfloat16 else 8
    else:
        raise ValueError(f"no kernel for {state} state")
    kt_face = -(-D // kstep)
    nt = -(-D // 8)
    tile = a16(esize * D * tiled_row_stride(Wt, state))
    halo = a16((1 + nf) * kt_face * nt * 32 * 8) + 4 * tile
    rest = 2 * a16(esize * nf * -(-Wt // 16) * 16) + 16
    hb = (2 if halo_blocks and halo + 2 * halo_blocks * tile + rest
          <= _SMEM_LIMIT else 1)
    return halo + hb * halo_blocks * tile + rest, hb


class LaunchPlan(NamedTuple):
    """How K1 runs a bucket: ``variant`` "persistent" (one CTA of
    csrc/lattice_ring.cu per (group, slot, band), holding the whole level)
    or "tiled" (``C`` tiles of ``Wt`` slab columns per (group, slot, band),
    one CTA of csrc/lattice_ring_tiled.cu each); ``smem`` bytes of shared
    memory per CTA."""

    variant: str
    Wt: int
    C: int
    smem: int


def launch_plan(D, W, nf, state, L, shifts):
    """The launch plan of a sweep from its shape alone: the one-CTA kernel
    where it is built for D and the level fits one CTA, else the tiled
    kernel with the widest tile ``tiled_wt_max`` allows, C = ceil(W / Wt)
    tiles and Wt then evened out over them (a multiple of 16). Where the
    halo of the lattice ``shifts`` (one per face) does not fit one CTA
    beside the tiles, the tile narrows by 16 columns until it does; at 16
    columns every shape fits. Raises ValueError for a D no kernel is built
    for."""
    if D in KERNEL_D and W <= KERNEL_MAX_W:
        smem = kernel_smem_bytes(D, W, nf, state, L)
        if smem + _ONE_CTA_STATIC_SMEM <= _SMEM_LIMIT:
            return LaunchPlan("persistent", W, 1, smem)
    if D not in TILED_D:
        raise ValueError(
            f"the CUDA kernels are built for D in {TILED_D}, got {D}")
    if len(shifts) != nf:
        raise ValueError(f"{len(shifts)} shifts for {nf} faces")
    for wt_max in range(tiled_wt_max(D, state), 0, -16):
        C = -(-W // wt_max)
        Wt = -(-(-(-W // C)) // 16) * 16
        nh = tiled_halo_blocks(shifts, Wt, C, tiled_row_stride(Wt, state))
        smem = tiled_smem_bytes(D, Wt, nf, state, nh)
        if smem <= _SMEM_LIMIT:
            return LaunchPlan("tiled", Wt, C, smem)
    raise ValueError(f"no column tile of D={D} fits one CTA ({state})")


def tiled_scratch_numel(Gb, Km, BS, C):
    """int32 entries of the tiled kernel's scratch: the ticket counter, one
    ys level flag per (group, slot, band, tile), then the band chain's ms
    level flag per (group, slot, band, tile) (``pbte_lattice_ring_scratch_
    numel`` of csrc/lattice_ring_tiled.cu)."""
    return 1 + 2 * Gb * Km * BS * C


def scratch_numel(plan, Gb, Km, BS):
    """int32 entries of a launch's scratch under ``plan``: the one-CTA
    kernel's ticket counter and the band chain's level flag per (group,
    slot, band) (``pbte_lattice_ring_scratch_numel`` of
    csrc/lattice_ring.cu), or ``tiled_scratch_numel``."""
    if plan.variant == "tiled":
        return tiled_scratch_numel(Gb, Km, BS, plan.C)
    return 1 + Gb * Km * BS


def ms_parts(plan, BS):
    """Partials of ms a launch under ``plan`` writes: one a chain of
    CHAIN_BANDS bands in the one-CTA kernel (``pbte_lattice_ring_ms_parts``
    of csrc/lattice_ring.cu), one in the tiled kernel."""
    return 1 if plan.variant == "tiled" else -(-BS // CHAIN_BANDS)


class ClosureSource(NamedTuple):
    """A sweep's lagged closure source, sparse over the slab: slot
    (l, g, w) adds ``xval[g, xmap[l, g, w]]`` to its rhs where
    ``xmap[l, g, w] >= 0``.

    ``xmap``: ``(L, Gb, W)`` integer (int32 for the CUDA kernel), each
    entry in [-1, U); the kernel does not bounds-check it.
    ``xval``: ``(Gb, U, Km, BS, D)``, float32 (float64 with float64 state).
    """

    xmap: torch.Tensor
    xval: torch.Tensor


def _check_win(win, L, W):
    """``win`` as an (L, 2) int32 numpy array, or None; raises on windows
    outside ``0 <= lo <= hi <= W``. A tensor is read back to the host (the
    plain version and the bounds take the kernel's uploaded windows too)."""
    if win is None:
        return None
    if isinstance(win, torch.Tensor):
        win = win.cpu()
    win = np.ascontiguousarray(win, dtype=np.int32)
    if win.shape != (L, 2):
        raise ValueError(f"win has shape {win.shape}, want {(L, 2)}")
    if not ((0 <= win[:, 0]) & (win[:, 0] <= win[:, 1])
            & (win[:, 1] <= W)).all():
        raise ValueError(f"windows must keep 0 <= lo <= hi <= W={W}, got "
                         f"{win.tolist()}")
    return win


def _check_shapes(v, ttc, bsrc, cin, bcat, macro_w, wvec, shifts, dsrc,
                  xsrc):
    if v.dim() != 6:
        raise ValueError(f"v must be (L, Gb, Km, BS, D, W), got {tuple(v.shape)}")
    L, Gb, Km, BS, D, W = v.shape
    nf = len(shifts)
    J = (1 + nf) * D
    want = {
        "ttc": (ttc, (L, Gb, D, W)),
        "bsrc": (bsrc, (L, Gb, Km, D, W)),
        "cin": (cin, (L, Gb, Km, nf, W)),
        "bcat": (bcat, (Gb, Km, BS, D, J)),
        "macro_w": (macro_w, (Gb, Km, BS)),
        "wvec": (wvec, (4, BS)),
    }
    if dsrc is not None:
        want["dsrc"] = (dsrc, (L, Gb, Km, D, W))
    if xsrc is not None:
        if xsrc.xmap.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"xmap must be an index tensor, got "
                             f"{xsrc.xmap.dtype}")
        if xsrc.xval.dim() != 5 or xsrc.xval.shape[1] < 1:
            raise ValueError(f"xval must be (Gb, U >= 1, Km, BS, D), got "
                             f"{tuple(xsrc.xval.shape)}")
        want["xmap"] = (xsrc.xmap, (L, Gb, W))
        want["xval"] = (xsrc.xval, (Gb, xsrc.xval.shape[1], Km, BS, D))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    for s in shifts:
        if not 0 <= int(s) < W:
            raise ValueError(f"lattice shift {s} outside [0, W={W})")


# NVIDIA H100 SXM data-sheet peaks (dense): HBM bytes/s, and the product's
# flop/s by state type: bf16 on the tensor cores; f32 as 3xTF32, three TF32
# products per f32 product (faster than the 67 TFLOP/s of exact f32 FMAs);
# f64 on the FP64 tensor cores (67 TFLOP/s; the FP64 FMAs peak at 34)
H100_BYTES_PER_S = 3.35e12
H100_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12,
              torch.float64: 67e12}


def sweep_cost(v, nf, dsrc=None, xsrc=None, win=None):
    """(bytes, flop) one sweep must move and compute: every input read once
    (v, ttc, bsrc, cin, bcat, macro_w, wvec, and dsrc, xmap, xval where
    given) and every output written once (ys like v, the ms partials);
    2 D J flop per (slot, group, slot k, band). Each operand counts at its
    element size: the kernel's operands and ms are float64 with float64
    state and float32 otherwise, xmap is int32, dsrc and xval count as
    given. With ``win`` every operand that has a level axis, and the flop,
    count the slots inside the windows only (the work that is asked for,
    whatever implements it)."""
    L, Gb, Km, BS, D, W = v.shape
    J = (1 + nf) * D
    win = _check_win(win, L, W)
    # (level, slot) pairs of the slab that the sweep computes
    LW = L * W if win is None else int((win[:, 1] - win[:, 0]).sum())
    n_state = LW * Gb * Km * BS * D
    n_ops = (LW * Gb * D + LW * Gb * Km * D + LW * Gb * Km * nf
             + Gb * Km * BS * D * J + Gb * Km * BS + 4 * BS
             + Gb * Km * LW * D)
    op_size = 8 if v.dtype == torch.float64 else 4
    nbytes = 2 * n_state * v.element_size() + op_size * n_ops
    if dsrc is not None:
        nbytes += LW * Gb * Km * D * dsrc.element_size()
    if xsrc is not None:
        nbytes += LW * Gb * 4 + xsrc.xval.numel() * xsrc.xval.element_size()
    return nbytes, 2 * LW * Gb * Km * BS * D * J


def sweep_bound_ms(v, nf, dsrc=None, xsrc=None, win=None):
    """The least time an H100 could take for one sweep: the larger of its
    bytes over the memory rate and its flop over the product's peak for
    the state type. Returns (ms, "bytes" or "operations")."""
    nbytes, flop = sweep_cost(v, nf, dsrc, xsrc, win)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flop / H100_FLOPS[v.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lattice_ring_sweep_ref(v, ttc, bsrc, cin, bcat, macro_w, wvec, *,
                           shifts, dsrc=None, xsrc=None, cast_bf16=True,
                           win=None, ring_in=None):
    """Plain PyTorch lattice ring sweep (a loop over levels).

    Args:
      v: previous state, ``(L, Gb, Km, BS, D, W)`` (mass-transformed).
      ttc: lagged-temperature slab after M^T, ``(L, Gb, D, W)``.
      bsrc: boundary-source slab, ``(L, Gb, Km, D, W)``.
      cin: inflow coefficients, ``(L, Gb, Km, nf, W)``.
      bcat: folded transport factors ``[B | -vg B C_f]``,
        ``(Gb, Km, BS, D, J)`` with ``J = (1 + nf) * D``.
      macro_w: macroscopic reduction weights, ``(Gb, Km, BS)``.
      wvec: ``(4, BS)`` rows ``[src_w, relax_w, vg*bc_w, vg]``.
      shifts: per-face lane shifts of the lattice (sequence of int).
      dsrc: optional Dirichlet source slab, ``(L, Gb, Km, D, W)``.
      xsrc: optional ``ClosureSource``, the lagged closure source (periodic
        wraps, diffuse and specular walls) added to the rhs of the slots
        it maps. It cannot fold into ``v``: ``relax_w`` is exactly 0 on the
        band with the largest inverse Knudsen number.
      cast_bf16: round the product operands (rhs, neighbour terms, bcat)
        and the ring to bfloat16 and accumulate in float32, as the TPU
        kernel does; False keeps every operand in the state dtype.
      win: optional ``(L, 2)`` integer host array of per-level hull windows
        ``[lo_l, hi_l)``: level l is computed on those columns alone, the
        ring of level l - 1 reads zero outside that level's window, and
        ``ys`` and ``ms`` are exact zeros outside the windows. See the
        module docstring for the contract; None runs the full slab.
      ring_in: optional ``(L, Gb, Km, BS, D, W)`` solutions (another run's
        ``ys``) that level l reads as its ring in place of this run's level
        l - 1: each level then starts from the same ring as that run, so a
        rounding that went the other way at one level is not carried into
        the next (a per-level comparison of the kernel in bf16).

    Returns:
      ``(ys, ms)``: the new state, shaped and typed like ``v``, and the
      per-slot macroscopic partials ``(Gb, Km, L, D, W)``, float32 for
      float32 or bfloat16 state (float64 for float64 state).
    """
    _check_shapes(v, ttc, bsrc, cin, bcat, macro_w, wvec, shifts, dsrc, xsrc)
    L, Gb, Km, BS, D, W = v.shape
    win = _check_win(win, L, W)
    dtype = v.dtype
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    op = torch.bfloat16 if cast_bf16 else dtype
    w_src, w_rel, w_bcv, w_dir = (wvec[i][:, None, None] for i in range(4))
    if xsrc is not None:
        gi = torch.arange(Gb, device=v.device)[:, None]
        xval = xsrc.xval.to(acc)
        none = torch.zeros((), dtype=acc, device=v.device)
    # rounded operands in the accumulation type: a product of two bf16
    # values is exact in f32, so this is a bf16 x bf16 -> f32 product
    bmat = bcat.to(op).to(acc)
    mw = macro_w.to(acc)[..., None, None]  # (Gb, Km, BS, 1, 1)
    # the previous level's solution over the full plane, zero outside its
    # window
    ring = torch.zeros((Gb, Km, BS, D, W), dtype=op, device=v.device)
    if win is None:
        ys = torch.empty_like(v)
        ms = torch.empty((Gb, Km, L, D, W), dtype=acc, device=v.device)
    else:
        ys = torch.zeros_like(v)
        ms = torch.zeros((Gb, Km, L, D, W), dtype=acc, device=v.device)
    for l in range(L):
        if ring_in is not None and l > 0:
            ring = ring_in[l - 1].to(op)
        lo, hi = (0, W) if win is None else (int(win[l, 0]), int(win[l, 1]))
        if lo == hi:
            ring = torch.zeros_like(ring)
            continue
        rhs = (
            w_src * ttc[l, ..., lo:hi][:, None, None]
            + w_rel * v[l, ..., lo:hi]
            - w_bcv * bsrc[l, ..., lo:hi][:, :, None]
        )  # (Gb, Km, BS, D, hi - lo)
        if dsrc is not None:
            rhs = rhs - w_dir * dsrc[l, ..., lo:hi][:, :, None]
        if xsrc is not None:
            m = xsrc.xmap[l, :, lo:hi].long()  # (Gb, hi - lo)
            add = xval[gi, m.clamp(min=0)]  # (Gb, hi - lo, Km, BS, D)
            add = torch.where((m >= 0)[:, :, None, None, None], add, none)
            rhs = rhs + add.permute(0, 2, 3, 4, 1)
        parts = [rhs.to(op)]
        for fi, s in enumerate(shifts):
            s = int(s)
            # out[..., w] = ring[..., w - s] for w in [lo, hi), zero where
            # w < s
            yf = torch.zeros_like(rhs, dtype=op)
            a = max(lo, s)
            if a < hi:
                yf[..., a - lo:] = ring[..., a - s: hi - s]
            cf = cin[l, :, :, fi, lo:hi].to(op)  # (Gb, Km, hi - lo)
            parts.append(yf * cf[:, :, None, None, :])
        xcat = torch.cat(parts, dim=3).to(acc)  # (Gb, Km, BS, J, hi - lo)
        if win is not None:
            # the product runs at the full width on a zero-filled operand:
            # a library's product may sum in another order at another
            # width, and each column must be summed as in the full slab
            # for the two to agree bit for bit
            full = torch.zeros(xcat.shape[:-1] + (W,), dtype=acc,
                               device=v.device)
            full[..., lo:hi] = xcat
            xcat = full
        # (Gb, Km, BS, D, hi - lo)
        sol = torch.matmul(bmat, xcat)[..., lo:hi]
        ys[l, ..., lo:hi] = sol.to(dtype)
        if win is None:
            ring = sol.to(op)
        else:
            ring = torch.zeros_like(ring)
            ring[..., lo:hi] = sol.to(op)
        ms[:, :, l, :, lo:hi] = (sol * mw).sum(dim=2)
    return ys, ms


def _kernel_args_ok(v, tensors, cast_bf16, shifts):
    """Raise on anything the CUDA kernels do not take (``tensors`` may
    hold ``win``, the windows on the device as (L, 2) int32): float32 or
    bfloat16 state with float32 operands, or float64 state with float64
    operands, no mix; a shape ``launch_plan`` takes. Returns its plan."""
    L, Gb, Km, BS, D, W = v.shape
    ok = ((torch.bfloat16,) if cast_bf16
          else (torch.float32, torch.float64))
    if v.dtype not in ok:
        raise ValueError(
            f"the CUDA kernels take float32 or float64 state with "
            f"cast_bf16=False and bfloat16 state with cast_bf16=True, got "
            f"{v.dtype} with cast_bf16={cast_bf16}"
        )
    op = torch.float64 if v.dtype == torch.float64 else torch.float32
    for name, t in tensors.items():
        if t.device != v.device:
            raise ValueError(f"{name} is on {t.device}, v on {v.device}")
        if name in ("xmap", "win"):
            if t.dtype != torch.int32:
                raise ValueError(f"{name} must be int32, got {t.dtype}")
        elif name != "v" and t.dtype != op:
            raise ValueError(f"{name} must be {op} with {v.dtype} state, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= len(shifts) <= KERNEL_MAX_FACES:
        raise ValueError(f"the CUDA kernel takes 1-3 faces, got {len(shifts)}")
    return launch_plan(D, W, len(shifts), v.dtype, L, shifts)


def windows_on_device(win, L, W, device):
    """Host windows, checked as ``_check_win`` does, as the ``(L, 2)`` int32
    tensor on ``device`` that the kernel reads. A caller that launches many
    sweeps of one problem uploads once and passes the tensor as ``win``."""
    return torch.from_numpy(_check_win(win, L, W)).to(device)


def _launch(v, ttc, bsrc, cin, bcat, macro_w, wvec, shifts, dsrc, xsrc,
            cast_bf16, lib=None, win=None):
    tensors = dict(v=v, ttc=ttc, bsrc=bsrc, cin=cin, bcat=bcat,
                   macro_w=macro_w, wvec=wvec)
    if dsrc is not None:
        tensors["dsrc"] = dsrc
    if xsrc is not None:
        tensors.update(xmap=xsrc.xmap, xval=xsrc.xval)
    L, Gb, Km, BS, D, W = v.shape
    if win is not None:
        if not isinstance(win, torch.Tensor):  # host windows: one upload
            win = windows_on_device(win, L, W, v.device)
        elif tuple(win.shape) != (L, 2):
            raise ValueError(f"win has shape {tuple(win.shape)}, want "
                             f"{(L, 2)}")
        tensors["win"] = win
    plan = _kernel_args_ok(v, tensors, cast_bf16, shifts)
    f64 = v.dtype == torch.float64
    lib = lib or _lib("lattice_ring_tiled" if plan.variant == "tiled"
                      else "lattice_ring")
    # the kernel writes every slot of ys and of its ms partials (zeros
    # outside the windows; a design from before the band chain adds ms into
    # zeros)
    ys = torch.empty_like(v)
    # (the library's count: a design may chain every band)
    parts = (lib.pbte_lattice_ring_ms_parts(BS)
             if hasattr(lib, "pbte_lattice_ring_ms_parts") else 1)
    ms = (torch.empty if lib.band_chain else torch.zeros)(
        (parts, Gb, Km, L, D, W),
        dtype=torch.float64 if f64 else torch.float32, device=v.device)
    s = [int(x) for x in shifts] + [0] * (KERNEL_MAX_FACES - len(shifts))
    # the CTAs' ticket counter and the level flags, zero at the launch
    scratch = torch.zeros(scratch_numel(plan, Gb, Km, BS), dtype=torch.int32,
                          device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        ptrs = [win.data_ptr() if win is not None else None, ys.data_ptr(),
                ms.data_ptr()]
        if not getattr(lib, "takes_win", True):
            if win is not None or f64:
                raise ValueError("this build's entry point takes no windows "
                                 "and no float64 state")
            del ptrs[0]
        args = (
            D, v.data_ptr(), ttc.data_ptr(), bsrc.data_ptr(),
            cin.data_ptr(), bcat.data_ptr(), macro_w.data_ptr(),
            wvec.data_ptr(), dsrc.data_ptr() if dsrc is not None else None,
            xsrc.xmap.data_ptr() if xsrc is not None else None,
            xsrc.xval.data_ptr() if xsrc is not None else None,
            xsrc.xval.shape[1] if xsrc is not None else 0,
            *ptrs, L, Gb, Km, BS, W, len(shifts), *s,
        )
        if plan.variant == "tiled" or lib.band_chain:
            # the scratch after ys and ms
            n = len(ptrs) + 12
            args = (*args[:n], scratch.data_ptr(), scratch.numel(), *args[n:])
        if plan.variant == "tiled":
            mode = 2 if f64 else int(cast_bf16)
            err = lib.pbte_lattice_ring_sweep_tiled(mode, *args, plan.Wt,
                                                    plan.C, stream)
        elif f64:
            err = lib.pbte_lattice_ring_sweep_f64(*args, stream)
        else:
            err = lib.pbte_lattice_ring_sweep(int(cast_bf16), *args, stream)
    if err != 0:
        msg = lib.pbte_cuda_error_string(err).decode()
        raise RuntimeError(f"lattice_ring kernel launch failed "
                           f"({plan.variant}): {msg} ({err})")
    tracing.count(f"k1.launches.{plan.variant}.{_STATE_NAMES[v.dtype]}")
    # the chains' partials in order (a reduction of fixed order)
    return ys, ms[0] if parts == 1 else ms.sum(dim=0)


def _lib(name="lattice_ring", takes_win=True):
    """The kernel library built as ``name`` (see _build.load), its entry
    points typed: the one-CTA kernels (``csrc/lattice_ring.cu``, or an
    earlier design of it) or the tiled kernels (``lattice_ring_tiled``).
    ``takes_win=False`` types the entry points of a source from before the
    window argument (bench_k1 times such a design against the full slab):
    no ``win`` pointer, and no L in the shared-memory size. ``band_chain``
    says whether the source sums ms in band order and writes every slot
    (it exports ``pbte_lattice_ring_scratch_numel``; the one-CTA entry
    points then take the scratch) or adds ms by atomics into zeros (a
    design from before it)."""
    lib = _build.load(name).lib
    lib.takes_win = takes_win
    lib.band_chain = hasattr(lib, "pbte_lattice_ring_scratch_numel")
    p, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    lib.pbte_cuda_error_string.argtypes = [i]
    lib.pbte_cuda_error_string.restype = ctypes.c_char_p
    if hasattr(lib, "pbte_lattice_ring_sweep_tiled"):
        # mode, D, 10 input pointers, U, the win, ys, ms and scratch
        # pointers, the scratch's length, then L, Gb, Km, BS, W, nf, three
        # shifts, Wt and C, then the stream
        lib.pbte_lattice_ring_sweep_tiled.argtypes = (
            [i, i] + [p] * 10 + [i] + [p] * 4 + [ctypes.c_longlong]
            + [i] * 11 + [p])
        lib.pbte_lattice_ring_sweep_tiled.restype = i
        # mode, D, Wt, C, nf and three shifts
        lib.pbte_lattice_ring_tiled_smem_bytes.argtypes = [i] * 8
        lib.pbte_lattice_ring_tiled_smem_bytes.restype = ctypes.c_longlong
        lib.pbte_lattice_ring_tiled_wt_max.argtypes = [i, i]
        lib.pbte_lattice_ring_tiled_wt_max.restype = i
        if lib.band_chain:  # Gb, Km, BS, C
            lib.pbte_lattice_ring_scratch_numel.argtypes = [i] * 4
            lib.pbte_lattice_ring_scratch_numel.restype = ll
        return lib
    # 10 input pointers (through xmap, xval), U, the win, ys and ms
    # pointers (the band chain's: then the scratch pointer and its length),
    # then L, Gb, Km, BS, W, nf and three shifts, then the stream
    scratch = [p, ll] if lib.band_chain else []
    lib.pbte_lattice_ring_sweep.argtypes = (
        [i, i] + [p] * 10 + [i] + [p] * (2 + takes_win) + scratch + [i] * 9
        + [p])
    lib.pbte_lattice_ring_sweep.restype = i
    lib.pbte_lattice_ring_smem_bytes.argtypes = [i] * (4 + takes_win)
    lib.pbte_lattice_ring_smem_bytes.restype = ll
    if lib.band_chain:  # Gb, Km, BS
        lib.pbte_lattice_ring_scratch_numel.argtypes = [i] * 3
        lib.pbte_lattice_ring_scratch_numel.restype = ll
    if hasattr(lib, "pbte_lattice_ring_ms_parts"):  # BS
        lib.pbte_lattice_ring_ms_parts.argtypes = [i]
        lib.pbte_lattice_ring_ms_parts.restype = i
    if hasattr(lib, "pbte_lattice_ring_sweep_f64"):  # not in older designs
        lib.pbte_lattice_ring_sweep_f64.argtypes = (
            [i] + [p] * 10 + [i] + [p] * 3 + scratch + [i] * 9 + [p])
        lib.pbte_lattice_ring_sweep_f64.restype = i
        lib.pbte_lattice_ring_smem_bytes_f64.argtypes = [i] * 4
        lib.pbte_lattice_ring_smem_bytes_f64.restype = ll
    return lib


def lattice_ring_sweep(v, ttc, bsrc, cin, bcat, macro_w, wvec, *, shifts,
                       dsrc=None, xsrc=None, cast_bf16=True, win=None):
    """One lattice ring sweep of one Km bucket (see lattice_ring_sweep_ref
    for arguments and results).

    CPU tensors run the plain PyTorch version. CUDA tensors launch a CUDA
    kernel on the current stream, or raise if none takes them: the one-CTA
    kernel where the level fits one CTA, else the tiled kernel
    (``launch_plan`` decides from the shape alone; float64 state: the
    float64 instantiations). Each launch adds one to the counter
    ``k1.launches.<variant>.<state>`` (``tracing``; variant "persistent" or
    "tiled", state "f32", "bf16" or "f64")."""
    _check_shapes(v, ttc, bsrc, cin, bcat, macro_w, wvec, shifts, dsrc, xsrc)
    if v.device.type == "cpu":
        return lattice_ring_sweep_ref(
            v, ttc, bsrc, cin, bcat, macro_w, wvec, shifts=shifts, dsrc=dsrc,
            xsrc=xsrc, cast_bf16=cast_bf16, win=win,
        )
    if v.device.type != "cuda":
        raise ValueError(f"no lattice ring sweep for device {v.device}")
    return _launch(v, ttc, bsrc, cin, bcat, macro_w, wvec, shifts, dsrc, xsrc,
                   cast_bf16, win=win)


_STATE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float64: "f64"}

