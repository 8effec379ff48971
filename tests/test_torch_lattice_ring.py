"""K1, the lattice ring sweep: pbte_tpu_torch's plain PyTorch version
against pbte_tpu's Pallas kernel run by the Pallas interpreter on the CPU,
on the same random inputs. The CUDA kernel itself runs only on a GPU and is
held against the plain version there by chip_smoke.py."""

import functools
import math
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pbte_tpu.ops.lattice_ring import lattice_ring_sweep as jax_sweep
from pbte_tpu_torch import tracing
from pbte_tpu_torch.ops import lattice_ring as tlr

SHIFTS = (0, 4, 1)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _inputs(dt, seed=0, dirichlet=False, L=7, Gb=2, Km=3, BS=4, D=8, W=16):
    """Random sweep inputs of O(1) size; bcat/J keeps the recurrence
    contracting like the physical factors."""
    rng = np.random.default_rng(seed)
    nf = len(SHIFTS)
    J = (1 + nf) * D

    def r(*s):
        return rng.standard_normal(s).astype(dt)

    d = dict(
        v=r(L, Gb, Km, BS, D, W), ttc=r(L, Gb, D, W), bsrc=r(L, Gb, Km, D, W),
        cin=-np.abs(r(L, Gb, Km, nf, W)), bcat=r(Gb, Km, BS, D, J) / J,
        macro_w=np.abs(r(Gb, Km, BS)), wvec=r(4, BS),
    )
    if dirichlet:
        d["dsrc"] = r(L, Gb, Km, D, W)
    return d


def _run_jax(d, cast_bf16, bf16_state=False):
    a = {k: jnp.asarray(v) for k, v in d.items()}
    if bf16_state:
        a["v"] = a["v"].astype(jnp.bfloat16)
    ys, ms = jax_sweep(
        a["v"], a["ttc"], a["bsrc"], a["cin"], a["bcat"], a["macro_w"],
        a["wvec"], shifts=SHIFTS, dsrc=a.get("dsrc"), cast_bf16=cast_bf16,
        interpret=True,
    )
    return np.asarray(ys.astype(jnp.float32) if bf16_state else ys), np.asarray(ms)


def _run_torch(d, cast_bf16, bf16_state=False, fn=tlr.lattice_ring_sweep):
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    if bf16_state:
        t["v"] = t["v"].to(torch.bfloat16)
    ys, ms = fn(
        t["v"], t["ttc"], t["bsrc"], t["cin"], t["bcat"], t["macro_w"],
        t["wvec"], shifts=SHIFTS, dsrc=t.get("dsrc"), cast_bf16=cast_bf16,
    )
    return ys, ms


def _numpy_sweep(d):
    """Independent float64 loop over levels, slots and bands."""
    v, ttc, bsrc, cin, bcat = d["v"], d["ttc"], d["bsrc"], d["cin"], d["bcat"]
    mw, wv, dsrc = d["macro_w"], d["wvec"], d.get("dsrc")
    L, Gb, Km, BS, D, W = v.shape
    ys = np.zeros_like(v)
    ms = np.zeros((Gb, Km, L, D, W))
    for g in range(Gb):
        for k in range(Km):
            for b in range(BS):
                ring = np.zeros((D, W))
                for l in range(L):
                    rhs = (wv[0, b] * ttc[l, g] + wv[1, b] * v[l, g, k, b]
                           - wv[2, b] * bsrc[l, g, k])
                    if dsrc is not None:
                        rhs = rhs - wv[3, b] * dsrc[l, g, k]
                    cols = [rhs]
                    for f, s in enumerate(SHIFTS):
                        nb = np.zeros((D, W))
                        nb[:, s:] = ring[:, : W - s]
                        cols.append(nb * cin[l, g, k, f])
                    ring = bcat[g, k, b] @ np.concatenate(cols)
                    ys[l, g, k, b] = ring
                    ms[g, k, l] += mw[g, k, b] * ring
    return ys, ms


@pytest.mark.parametrize("dirichlet", [False, True])
def test_f64_plain_matches_float64_loop(dirichlet):
    """The plain version in float64 is the exact algorithm: it matches an
    independent float64 loop to roundoff."""
    d = _inputs(np.float64, seed=3, dirichlet=dirichlet)
    ys, ms = _run_torch(d, cast_bf16=False)
    assert ys.dtype == torch.float64 and ms.dtype == torch.float64
    ys_n, ms_n = _numpy_sweep(d)
    np.testing.assert_allclose(ys.numpy(), ys_n, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(ms.numpy(), ms_n, rtol=1e-12, atol=1e-14)


def test_f64_plain_vs_pallas_interpret():
    """Against the Pallas kernel in float64: the kernel's dot takes
    preferred_element_type=float32 (pbte_tpu/ops/lattice_ring.py:145-149),
    so its float64 mode accumulates each level in float32 — hence the f32
    tolerance here; the float64 algorithm is held at 1e-12 by the test
    above and, end to end, by test_torch_solver.py."""
    d = _inputs(np.float64, seed=0)
    ys_j, ms_j = _run_jax(d, cast_bf16=False)
    ys, ms = _run_torch(d, cast_bf16=False)
    np.testing.assert_allclose(ys.numpy(), ys_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ms.numpy(), ms_j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dirichlet", [False, True])
def test_f32_plain_vs_pallas_interpret(dirichlet):
    """Exact f32 operands (cast_bf16=False, the CPU mode of the JAX
    solver): both sides differ only in f32 summation order."""
    d = _inputs(np.float32, seed=1, dirichlet=dirichlet)
    ys_j, ms_j = _run_jax(d, cast_bf16=False)
    ys, ms = _run_torch(d, cast_bf16=False)
    assert ys.dtype == torch.float32 and ms.dtype == torch.float32
    np.testing.assert_allclose(ys.numpy(), ys_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ms.numpy(), ms_j, rtol=1e-5, atol=1e-6)


def test_bf16_state_plain_vs_pallas_interpret():
    """bf16 state with bf16 product operands and f32 accumulation, as the
    TPU kernel runs it. The rounded operands' products are exact in f32,
    so both sides round the same f32 sums: ys agree to 2 bf16 ulps
    (measured: bit for bit at this seed) and the f32 ms partials to rtol
    1e-4, atol 1e-5 (measured: within rtol 1e-5, atol 1e-6); the margin is
    for a sum next to a bf16 rounding boundary that rounds the other way
    on one side and carries into the next levels."""
    d = _inputs(np.float32, seed=2)
    ys_j, ms_j = _run_jax(d, cast_bf16=True, bf16_state=True)
    ys, ms = _run_torch(d, cast_bf16=True, bf16_state=True)
    assert ys.dtype == torch.bfloat16 and ms.dtype == torch.float32
    ys = ys.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ys_j), 1e-30))) - 7)
    assert np.all(np.abs(ys - ys_j) <= 2 * ulp)
    np.testing.assert_allclose(ms.numpy(), ms_j, rtol=1e-4, atol=1e-5)


def test_wrapper_takes_plain_version_on_cpu():
    """CPU tensors go to the plain version and do not count as kernel
    launches."""
    d = _inputs(np.float32, seed=4)
    before = tracing.report()["counts"]
    ys, ms = _run_torch(d, cast_bf16=False)
    ys_r, ms_r = _run_torch(d, cast_bf16=False, fn=tlr.lattice_ring_sweep_ref)
    assert tracing.report()["counts"] == before
    assert torch.equal(ys, ys_r) and torch.equal(ms, ms_r)


def test_wrapper_rejects_bad_shapes():
    d = _inputs(np.float32, seed=5)
    d["bsrc"] = d["bsrc"][:, :, :1]
    with pytest.raises(ValueError, match="bsrc"):
        _run_torch(d, cast_bf16=False)


@pytest.mark.parametrize("case", [
    "f32_state_with_cast", "bf16_state_exact", "f64_state", "f64_consts",
    "noncontiguous", "d_not_built", "too_wide", "four_faces",
])
def test_kernel_argument_checks(case):
    """What the CUDA kernel does not take raises before any launch (the
    checks are host code, so they run here on CPU tensors); a level past
    the 16 CTAs of the earlier cluster kernel (too_wide) now gets a plan
    within one CTA's shared memory."""
    L, Gb, Km, BS, D, W = 2, 1, 1, 2, 8, 16
    v = torch.zeros((L, Gb, Km, BS, D, W))
    ttc = torch.zeros((L, Gb, D, W))
    cast, shifts = False, SHIFTS
    if case == "f32_state_with_cast":
        cast = True
    elif case == "bf16_state_exact":
        v = v.to(torch.bfloat16)
    elif case == "f64_state":
        v = v.double()
    elif case == "f64_consts":
        ttc = ttc.double()
    elif case == "noncontiguous":
        ttc = torch.zeros((L, Gb, W, D)).transpose(2, 3)
    elif case == "d_not_built":
        v = torch.zeros((L, Gb, Km, BS, 5, W))
    elif case == "too_wide":
        # f32 at D = 64, W = 1537: 17 of the cluster kernel's 96-column
        # CTAs, one past its ceiling
        v = torch.zeros((L, Gb, Km, BS, 64, 1537), device="meta")
        plan = tlr._kernel_args_ok(v, dict(v=v), cast, shifts)
        assert plan.variant == "tiled" and plan.smem <= 232448
        assert (plan.C - 1) * plan.Wt < 1537 <= plan.C * plan.Wt
        return
    elif case == "four_faces":
        shifts = (0, 1, 2, 3)
    with pytest.raises(ValueError):
        tlr._kernel_args_ok(v, dict(v=v, ttc=ttc), cast, shifts)


def test_kernel_arguments_of_the_flagship_pass():
    """The flagship's bucket shapes (D=27, W=256, three faces) are taken in
    all three state types."""
    v = torch.zeros((46, 4, 10, 40, 27, 256), device="meta")
    for dt, cast in ((torch.float32, False), (torch.bfloat16, True),
                     (torch.float64, False)):
        vv = v.to(dt)
        tlr._kernel_args_ok(vv, dict(v=vv), cast, (0, 16, 1))


def test_kernel_takes_float64_state_with_float64_operands():
    """float64 state goes to the float64 kernel with float64 operands (and
    int32 xmap and windows) at the flagship's bucket-0 shape, on CPU
    tensors; any mix of types, or cast mode, raises."""
    L, Gb, Km, BS, D, W = 46, 4, 10, 40, 27, 256
    f64 = dict(dtype=torch.float64)
    t = dict(
        v=torch.zeros((L, Gb, Km, BS, D, W), **f64),
        ttc=torch.zeros((L, Gb, D, W), **f64),
        bsrc=torch.zeros((L, Gb, Km, D, W), **f64),
        cin=torch.zeros((L, Gb, Km, 3, W), **f64),
        bcat=torch.zeros((Gb, Km, BS, D, 4 * D), **f64),
        macro_w=torch.zeros((Gb, Km, BS), **f64),
        wvec=torch.zeros((4, BS), **f64),
        dsrc=torch.zeros((L, Gb, Km, D, W), **f64),
        xmap=torch.zeros((L, Gb, W), dtype=torch.int32),
        xval=torch.zeros((Gb, 3, Km, BS, D), **f64),
        win=torch.zeros((L, 2), dtype=torch.int32),
    )
    shifts = (0, 16, 1)
    tlr._kernel_args_ok(t["v"], t, False, shifts)
    with pytest.raises(ValueError, match="cast_bf16"):
        tlr._kernel_args_ok(t["v"], t, True, shifts)
    for name, dt in (("ttc", torch.float32), ("bcat", torch.float32),
                     ("xval", torch.float32), ("xmap", torch.int64),
                     ("win", torch.int64)):
        bad = dict(t, **{name: t[name].to(dt)})
        with pytest.raises(ValueError, match=name):
            tlr._kernel_args_ok(t["v"], bad, False, shifts)
    v32 = t["v"].float()
    with pytest.raises(ValueError, match="ttc"):  # f32 state, f64 operands
        tlr._kernel_args_ok(v32, dict(t, v=v32), False, shifts)


def test_wrapper_rejects_other_devices():
    d = _inputs(np.float32, seed=6)
    t = {k: torch.from_numpy(v).to("meta") for k, v in d.items()}
    with pytest.raises(ValueError, match="device"):
        tlr.lattice_ring_sweep(
            t["v"], t["ttc"], t["bsrc"], t["cin"], t["bcat"], t["macro_w"],
            t["wvec"], shifts=SHIFTS, cast_bf16=False,
        )


@pytest.mark.parametrize("dtype,nbytes,bound_ms", [
    (torch.float32, 4200939392, 1.25401175880597),
    (torch.bfloat16, 2166046592, 0.646581072238806),
    (torch.float64, 8401878784, 2.50802351761194),
])
def test_flagship_bucket_bound(dtype, nbytes, bound_ms):
    """The bound chip_smoke.py reports for the flagship's bucket 0 (46
    levels, 4 groups x 10 slots x 40 bands, D=27, W=256, three faces): its
    bytes (every input read once, every output written once; float64 state
    reads float64 operands and writes float64 ms partials) over 3.35 TB/s,
    above its 1.1e11 flop over the tensor-core peak (3xTF32 at 495/3
    TFLOP/s for f32 state, bf16 at 989 TFLOP/s, FP64 at 67 TFLOP/s)."""
    v = torch.zeros((46, 4, 10, 40, 27, 256), dtype=dtype, device="meta")
    got_bytes, flop = tlr.sweep_cost(v, 3)
    assert got_bytes == nbytes and flop == 2 * 46 * 4 * 10 * 40 * 27 * 108 * 256
    ms, by = tlr.sweep_bound_ms(v, 3)
    assert by == "bytes"
    np.testing.assert_allclose(ms, bound_ms, rtol=1e-12)
    assert flop / tlr.H100_FLOPS[dtype] * 1e3 < ms


@pytest.mark.parametrize("cast", [False, True, "f64"])
def test_kernel_shared_memory_fits_one_cta(cast):
    """The kernel's carve-up at the flagship's widths fits one CTA on
    Hopper (f32 and bf16: four tiles at a row stride of 264 words; f64: the
    factor in m16n8k4 fragment order, one solution tile and two rhs tiles
    at a row stride of 260 doubles, one CTA per SM), and grows with W."""
    state = {False: torch.float32, True: torch.bfloat16,
             "f64": torch.float64}[cast]
    smem = tlr.kernel_smem_bytes(27, 256, 3, state, 46)
    assert smem <= tlr._SMEM_LIMIT
    if state == torch.float64:
        # factor: 4 faces x 7 k-steps x 4 n-tiles x 32 lanes x 1 double
        assert smem == (4 * 7 * 4 * 32 * 8 + 3 * 27 * 260 * 8
                        + 2 * 3 * 256 * 8 + 46 * 8) == 209808
        assert 2 * smem > 228 * 1024  # one CTA per SM
    else:
        assert smem == ((8192 if cast else 32768) + 4 * 27 * 264 * 4
                        + 2 * 3 * 256 * 4 + 46 * 8)
    assert tlr.kernel_smem_bytes(27, 64, 3, state, 46) < smem
    with pytest.raises(ValueError, match="no kernel"):
        tlr.kernel_smem_bytes(27, 256, 3, torch.float16, 46)


def _f64_smem_of_c_struct(D, W, nf, L):
    """SmemF64 of csrc/lattice_ring.cu written out: the factor (1 + nf)
    faces x KT_FACE 4-deep k-steps x NT n-tiles x 32 lanes x 1 double,
    then one solution and two rhs tiles (D rows of the padded stride), two
    cin tiles (nf rows of W rounded to 16) and L int2 windows, each block
    rounded up to 16 bytes."""
    def a16(n):
        return (n + 15) // 16 * 16

    kt_face, nt = (D + 3) // 4, (D + 7) // 8
    wp = (W + 15) // 16 * 16 + 4
    wc = (W + 15) // 16 * 16
    offs = [a16((1 + nf) * kt_face * nt * 32 * 8)]  # the solution tile
    offs.append(offs[-1] + a16(8 * D * wp))  # the rhs tiles
    offs.append(offs[-1] + 2 * a16(8 * D * wp))  # the cin tiles
    offs.append(offs[-1] + 2 * a16(8 * nf * wc))  # the windows
    return offs[-1] + a16(8 * L)


@pytest.mark.parametrize("D", [4, 8, 9, 16, 27])
@pytest.mark.parametrize("W", [64, 256])
@pytest.mark.parametrize("nf", [1, 3])
def test_f64_kernel_shared_memory(D, W, nf):
    """The wrapper's float64 carve-up equals the C struct's, fits one CTA
    on Hopper at every width the kernel takes, and grows with W and L by
    the tiles' and the windows' bytes."""
    f64 = torch.float64
    smem = tlr.kernel_smem_bytes(D, W, nf, f64, 46)
    assert smem == _f64_smem_of_c_struct(D, W, nf, 46)
    assert smem % 16 == 0
    assert tlr.kernel_smem_bytes(D, 256, 3, f64, 46) <= tlr._SMEM_LIMIT
    assert tlr.kernel_smem_bytes(D, W, nf, f64, 48) - smem == 2 * 8
    assert (tlr.kernel_smem_bytes(D, W + 16, nf, f64, 46) - smem
            == 3 * 8 * D * 16 + 2 * 8 * nf * 16)
    # the last level of padding columns still fits: the stride covers the
    # m-tiles a consumer warp reads
    assert tlr.f64_tile_stride(W) >= -(-W // 16) * 16


@pytest.mark.parametrize("W", [16, 25, 64, 100, 256])
def test_f64_tile_stride_reads_free_of_bank_conflicts(W):
    """A half-warp's 8-byte A-fragment read (lane 4 gq + tq reads column
    gq of an m-tile in tile row tq) falls on 16 distinct 8-byte bank pairs
    at the f64 stride; a stride of 8 mod 16 doubles would put two lanes on
    each pair (two wavefronts where one will do)."""
    def pairs(stride, half):
        lanes = range(16 * half, 16 * half + 16)
        return {((ln & 3) * stride + (ln >> 2)) % 16 for ln in lanes}

    wp = tlr.f64_tile_stride(W)
    assert wp % 16 == 4 and wp >= W
    for half in (0, 1):
        assert len(pairs(wp, half)) == 16
        assert len(pairs(wp + 4, half)) == 8


# ---- hull windows ---------------------------------------------------------

WIN_SHAPES = {  # W, shifts: three faces, D = 8
    "w16": (16, (0, 4, 1)),
    "w25": (25, (0, 5, 1)),
    "w36": (36, (0, 6, 1)),
}


def _windowed_inputs(dt, seed, W, shifts, dirichlet=False, closure=False,
                     L=7, Gb=2, Km=3, BS=4, D=8, U=5):
    """Random sweep inputs that keep the windows' contract: random windows
    (some empty, some one slot wide), v, ttc, bsrc, dsrc and cin zero and
    xmap -1 outside them, and cin zero where the upwind neighbour lies
    outside the previous level's window. Returns (tensors, xsrc, win)."""
    rng = np.random.default_rng(seed)
    nf = len(shifts)
    J = (1 + nf) * D
    lo = rng.integers(0, W // 2, L)
    hi = np.minimum(lo + rng.integers(0, W, L), W)
    hi[1] = lo[1]  # an empty window
    hi[2] = lo[2] + 1  # one slot
    win = np.stack([lo, hi], axis=1).astype(np.int32)
    inside = np.zeros((L, W), dtype=bool)
    for l in range(L):
        inside[l, lo[l]:hi[l]] = True
    upwind = np.zeros((L, nf, W), dtype=bool)  # neighbour is in a window
    for f, s in enumerate(shifts):
        upwind[1:, f, s:] = inside[:-1, : W - s]

    def r(*s):
        return rng.standard_normal(s).astype(dt)

    d = dict(
        v=r(L, Gb, Km, BS, D, W) * inside[:, None, None, None, None],
        ttc=r(L, Gb, D, W) * inside[:, None, None],
        bsrc=r(L, Gb, Km, D, W) * inside[:, None, None, None],
        cin=-np.abs(r(L, Gb, Km, nf, W)) * (
            inside[:, None, :] & upwind)[:, None, None],
        bcat=r(Gb, Km, BS, D, J) / J, macro_w=np.abs(r(Gb, Km, BS)),
        wvec=r(4, BS),
    )
    if dirichlet:
        d["dsrc"] = r(L, Gb, Km, D, W) * inside[:, None, None, None]
    t = {k: torch.from_numpy(np.ascontiguousarray(a.astype(dt)))
         for k, a in d.items()}
    xsrc = None
    if closure:
        xmap = np.where((rng.random((L, Gb, W)) < 0.4) & inside[:, None],
                        rng.integers(0, U, (L, Gb, W)), -1).astype(np.int32)
        xsrc = tlr.ClosureSource(torch.from_numpy(xmap),
                                 torch.from_numpy(r(Gb, U, Km, BS, D)))
    return t, xsrc, win


def _sweep_win(t, xsrc, shifts, cast, win, fn=tlr.lattice_ring_sweep_ref):
    return fn(t["v"], t["ttc"], t["bsrc"], t["cin"], t["bcat"], t["macro_w"],
              t["wvec"], shifts=shifts, dsrc=t.get("dsrc"), xsrc=xsrc,
              cast_bf16=cast, win=win)


@pytest.mark.parametrize("shape", list(WIN_SHAPES))
@pytest.mark.parametrize("extra", ["none", "dsrc", "xsrc"])
@pytest.mark.parametrize("mode", ["f32", "f64", "bf16"])
def test_windowed_plain_equals_full_slab(mode, extra, shape):
    """Under the windows' contract the windowed plain version equals the
    full-slab plain version bit for bit (padded slots are exact-zero fixed
    points), in every state type, with a Dirichlet source and with a
    closure source; ys and ms are exact zeros outside the windows."""
    W, shifts = WIN_SHAPES[shape]
    dt = np.float64 if mode == "f64" else np.float32
    t, xsrc, win = _windowed_inputs(dt, seed=11, W=W, shifts=shifts,
                                    dirichlet=extra == "dsrc",
                                    closure=extra == "xsrc")
    cast = mode == "bf16"
    if cast:
        t["v"] = t["v"].to(torch.bfloat16)
    ys_f, ms_f = _sweep_win(t, xsrc, shifts, cast, None)
    ys_w, ms_w = _sweep_win(t, xsrc, shifts, cast, win)
    assert ys_w.dtype == ys_f.dtype and ms_w.dtype == ms_f.dtype
    assert torch.equal(ys_w, ys_f) and torch.equal(ms_w, ms_f)
    assert ys_f.abs().max() > 0
    for l, (lo, hi) in enumerate(win):
        for a in (ys_w[l], ms_w[:, :, l]):
            assert not a[..., :lo].any() and not a[..., hi:].any()
    # the wrapper passes the windows on to the plain version on the CPU
    ys_c, ms_c = _sweep_win(t, xsrc, shifts, cast, win,
                            fn=tlr.lattice_ring_sweep)
    assert torch.equal(ys_c, ys_w) and torch.equal(ms_c, ms_w)


def test_windows_ignore_what_lies_outside():
    """Level l is computed on its window alone: values outside the windows
    (a breach of the contract) change nothing in the windowed result."""
    W, shifts = WIN_SHAPES["w16"]
    t, _, win = _windowed_inputs(np.float32, seed=12, W=W, shifts=shifts)
    want = _sweep_win(t, None, shifts, False, win)
    rng = np.random.default_rng(0)
    dirty = dict(t)
    for key in ("v", "ttc", "bsrc"):
        noise = torch.from_numpy(rng.standard_normal(t[key].shape)
                                 .astype(np.float32))
        dirty[key] = torch.where(t[key] == 0, noise, t[key])
    got = _sweep_win(dirty, None, shifts, False, win)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    full = _sweep_win(dirty, None, shifts, False, None)
    assert not torch.equal(full[0], want[0])


def test_full_windows_change_nothing():
    """win=None is the full slab, and windows [0, W) on every level give
    the same bits."""
    d = _inputs(np.float32, seed=13, dirichlet=True)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    L, W = d["v"].shape[0], d["v"].shape[-1]
    none = _sweep_win(t, None, SHIFTS, False, None)
    full = _sweep_win(t, None, SHIFTS, False, [[0, W]] * L)
    assert torch.equal(none[0], full[0]) and torch.equal(none[1], full[1])


@pytest.mark.parametrize("case", ["lo_above_hi", "hi_above_w", "negative",
                                  "shape"])
def test_window_contract_violations_raise(case):
    d = _inputs(np.float32, seed=14)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    L, W = d["v"].shape[0], d["v"].shape[-1]
    win = np.tile(np.array([[2, 9]], dtype=np.int32), (L, 1))
    if case == "lo_above_hi":
        win[3] = (9, 2)
    elif case == "hi_above_w":
        win[0] = (0, W + 1)
    elif case == "negative":
        win[1] = (-1, 4)
    else:
        win = win[:-1]
    for fn in (tlr.lattice_ring_sweep, tlr.lattice_ring_sweep_ref):
        with pytest.raises(ValueError, match="win"):
            _sweep_win(t, None, SHIFTS, False, win, fn=fn)
    with pytest.raises(ValueError, match="win"):
        tlr.sweep_cost(t["v"], 3, win=win)


def test_kernel_takes_int32_windows():
    """The CUDA kernel's argument checks take the windows as an int32
    tensor and refuse another type; its shared memory holds L windows."""
    v = torch.zeros((2, 1, 1, 2, 8, 16))
    tlr._kernel_args_ok(v, dict(v=v, win=torch.zeros((2, 2),
                                                     dtype=torch.int32)),
                        False, SHIFTS)
    with pytest.raises(ValueError, match="win"):
        tlr._kernel_args_ok(v, dict(v=v, win=torch.zeros((2, 2),
                                                         dtype=torch.int64)),
                            False, SHIFTS)
    for state in (torch.float32, torch.float64):
        assert (tlr.kernel_smem_bytes(27, 256, 3, state, 46)
                == tlr.kernel_smem_bytes(27, 256, 3, state, 0) + 46 * 8)
    with pytest.raises(TypeError):  # L is not optional: the windows take room
        tlr.kernel_smem_bytes(27, 256, 3, torch.float32)


def test_windows_on_device_checks_and_uploads():
    """The tensor a caller hands the kernel in place of host windows: the
    checked windows as (L, 2) int32 on the device asked for."""
    t = tlr.windows_on_device([[0, 4], [2, 16], [5, 5]], 3, 16, "cpu")
    assert t.dtype == torch.int32 and t.tolist() == [[0, 4], [2, 16], [5, 5]]
    tlr._kernel_args_ok(torch.zeros((3, 1, 1, 2, 8, 16)),
                        dict(win=t), False, SHIFTS)
    for bad in ([[0, 17]] * 3, [[4, 2]] * 3, [[0, 4]] * 2):
        with pytest.raises(ValueError, match="win"):
            tlr.windows_on_device(bad, 3, 16, "cpu")
    # the plain version and the bounds take that tensor as they take the list
    v = torch.zeros((3, 1, 1, 2, 8, 16))
    assert (tlr.sweep_cost(v, 3, win=t)
            == tlr.sweep_cost(v, 3, win=[[0, 4], [2, 16], [5, 5]]))
    assert tlr.sweep_cost(v, 3, win=t) < tlr.sweep_cost(v, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_sweep_cost_counts_window_slots(dtype):
    """Full windows cost what no windows cost; the flagship's windows
    (7,246 of 11,776 slots) cut every level-indexed operand and the flop in
    that ratio and leave the factors (bcat, macro_w, wvec) whole, so no
    bound counts a slot outside a window."""
    L, Gb, Km, BS, D, W = 46, 4, 10, 40, 27, 256
    v = torch.zeros((L, Gb, Km, BS, D, W), dtype=dtype, device="meta")
    dsrc = torch.zeros((L, Gb, Km, D, W), device="meta")
    xsrc = tlr.ClosureSource(
        torch.zeros((L, Gb, W), dtype=torch.int32, device="meta"),
        torch.zeros((Gb, 7, Km, BS, D), device="meta"))
    for kw in (dict(), dict(dsrc=dsrc), dict(xsrc=xsrc)):
        assert (tlr.sweep_cost(v, 3, win=[[0, W]] * L, **kw)
                == tlr.sweep_cost(v, 3, **kw))
        assert (tlr.sweep_bound_ms(v, 3, win=[[0, W]] * L, **kw)
                == tlr.sweep_bound_ms(v, 3, **kw))
    # the 16^3 lattice's hulls: 1, 17, ..., 241 slots, then 242 ... 256
    i = np.arange(16)
    lo = np.concatenate([np.zeros(16, int), i[1:], 16 * i[1:] + 15])
    hi = np.concatenate([16 * i + 1, 241 + i[1:], np.full(15, 256)])
    win = np.stack([lo, hi], axis=1)
    slots = int((hi - lo).sum())
    assert win.shape == (L, 2) and slots == 7246
    op = 8 if dtype == torch.float64 else 4  # the kernel's operand size
    fixed = op * (Gb * Km * BS * D * 4 * D + Gb * Km * BS + 4 * BS)
    nbytes, flop = tlr.sweep_cost(v, 3)
    nbytes_w, flop_w = tlr.sweep_cost(v, 3, win=win)
    assert flop_w * L * W == flop * slots
    assert (nbytes_w - fixed) * L * W == (nbytes - fixed) * slots
    ms_w, by = tlr.sweep_bound_ms(v, 3, win=win)
    assert by == "bytes" and ms_w < tlr.sweep_bound_ms(v, 3)[0]
    if dtype == torch.float64:  # the f64 kernel's windowed bounds
        assert (nbytes_w, flop_w) == (5184201664, 67613875200)
        np.testing.assert_allclose(ms_w, 1.5475228847761193, rtol=1e-12)
        v1 = torch.zeros((L, Gb, 6, BS, D, W), dtype=dtype, device="meta")
        assert tlr.sweep_cost(v1, 3, win=win)[0] == 3113025728
        np.testing.assert_allclose(tlr.sweep_bound_ms(v1, 3, win=win)[0],
                                   0.9292614113432835, rtol=1e-12)


def test_sweep_cost_counts_operands_by_element_size():
    """dsrc and xval count at their own element size; the kernel's other
    operands and ms at 8 bytes with float64 state, 4 otherwise."""
    L, Gb, Km, BS, D, W = 3, 2, 2, 4, 8, 16
    for dt, op in ((torch.float32, 4), (torch.float64, 8)):
        v = torch.zeros((L, Gb, Km, BS, D, W), dtype=dt)
        dsrc = torch.zeros((L, Gb, Km, D, W), dtype=dt)
        xsrc = tlr.ClosureSource(torch.zeros((L, Gb, W), dtype=torch.int32),
                                 torch.zeros((Gb, 5, Km, BS, D), dtype=dt))
        base = tlr.sweep_cost(v, 3)[0]
        assert base == 2 * v.numel() * op + op * (
            L * W * Gb * D + L * W * Gb * Km * D + L * W * Gb * Km * 3
            + Gb * Km * BS * D * 4 * D + Gb * Km * BS + 4 * BS
            + Gb * Km * L * W * D)
        assert tlr.sweep_cost(v, 3, dsrc=dsrc)[0] == base + dsrc.numel() * op
        assert tlr.sweep_cost(v, 3, xsrc=xsrc)[0] == (
            base + L * Gb * W * 4 + xsrc.xval.numel() * op)


# ---- launch plans: which K1 kernel takes a lattice -------------------------

def _lattice(case):
    """(solver on the CPU, element DOF count) of a lattice the ring takes,
    from the port's constructor. The slab (L, groups, Km buckets, W, shifts)
    does not depend on the order, so the p >= 2 hex lattices of 4,096 and
    more elements are built at p = 1 (their assembly at p = 3 takes about a
    minute) and given D = (p + 1)^3."""
    from pbte_tpu_torch.problem import WALL_BCS, SQUARE_BCS, unit_cube, \
        unit_square
    from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

    kind, dims, order = LATTICES[case]
    build_order = order if np.prod(dims) < 4000 else 1
    if kind == "quad":
        prob, bcs = unit_square(*dims, order=order, azimuth=8, nspec=1), \
            SQUARE_BCS
    else:
        prob, bcs = unit_cube(*dims, order=build_order, polar=2, azimuth=4,
                              nspec=1), WALL_BCS
    s = SourceIterationSolver(*prob, bcs, device="cpu")
    assert s.sweep_mode == "ring" and s._multi is None
    D = (order + 1) ** (2 if kind == "quad" else 3)
    assert build_order != order or s.D == D
    return s, D


# name: (kind, dims, order), W in the comment. The first five are the
# ring lattices of ROADMAP.md section 3's fault record (of them the CUDA
# kernel took hex 8^3 p=2 alone before its cluster kernel); then hex
# 17x17x4 (W = 17 x 4, the product of its two shorter axes), W > 256 and
# p = 3 at the flagship's width
LATTICES = {
    "quad_32x32_p2": ("quad", (32, 32), 2),  # D 9, W 32
    "quad_64x64_p1": ("quad", (64, 64), 1),  # D 4, W 64
    "hex_8x8x8_p3": ("hex", (8, 8, 8), 3),  # D 64, W 64
    "hex_20x20x20_p1": ("hex", (20, 20, 20), 1),  # D 8, W 400
    "hex_8x8x8_p2": ("hex", (8, 8, 8), 2),  # D 27, W 64
    "hex_17x17x4_p2": ("hex", (17, 17, 4), 2),  # D 27, W 68
    "hex_17x17x17_p2": ("hex", (17, 17, 17), 2),  # D 27, W 289
    "hex_24x24x24_p1": ("hex", (24, 24, 24), 1),  # D 8, W 576
    "hex_16x16x16_p3": ("hex", (16, 16, 16), 3),  # D 64, W 256
}


@functools.lru_cache(maxsize=None)
def _slab(case):
    """(L, W, shifts, BS, D, [(groups, Km) per bucket]) of ``_lattice``'s
    solver: what the launch plans read (cached, one build per lattice)."""
    s, D = _lattice(case)
    return (s.L, s.W, tuple(int(x) for x in s.shifts), s.BS, D,
            tuple((len(gs), km) for gs, km in s._ring_buckets))


@pytest.mark.parametrize("case", list(LATTICES))
def test_every_ring_lattice_gets_a_launch_plan(case):
    """Every Km bucket of a lattice the ring takes passes the kernels'
    argument checks in all three state types and gets a launch plan: the
    one-CTA kernel where it is built for D and the level fits one CTA
    (the flagship's shapes), else the tiled kernel, with Wt a multiple of
    16 no wider than the kernel's widest tile, C = ceil(W / Wt) tiles and
    at most 232,448 B of shared memory a CTA."""
    L, W, shifts, BS, D, buckets = _slab(case)
    for gb, km in buckets:
        for dt, cast in ((torch.float32, False), (torch.bfloat16, True),
                         (torch.float64, False)):
            v = torch.zeros((L, gb, km, BS, D, W), dtype=dt, device="meta")
            plan = tlr._kernel_args_ok(v, dict(v=v), cast, shifts)
            assert plan == tlr.launch_plan(D, W, len(shifts), dt, L, shifts)
            assert plan.smem <= tlr._SMEM_LIMIT
            if D in tlr.KERNEL_D and W <= tlr.KERNEL_MAX_W:
                assert plan == (
                    "persistent", W, 1,
                    tlr.kernel_smem_bytes(D, W, len(shifts), dt, L))
            else:
                assert plan.variant == "tiled" and plan.Wt % 16 == 0
                assert plan.Wt <= tlr.tiled_wt_max(D, dt)
                assert (plan.C - 1) * plan.Wt < W <= plan.C * plan.Wt
                nh = tlr.tiled_halo_blocks(shifts, plan.Wt, plan.C,
                                           tlr.tiled_row_stride(plan.Wt, dt))
                assert plan.smem == tlr.tiled_smem_bytes(
                    D, plan.Wt, len(shifts), dt, nh)


def _tiled_smem_of_c_struct(D, Wt, nf, state, nh):
    """SmemTiled of csrc/lattice_ring_tiled.cu written out: the factor
    (1 + nf) faces x KT_FACE k-steps x NT n-tiles x 32 lanes x 8 bytes, two
    solution and two rhs tiles (D rows of the padded stride), two sets of
    nh halo tiles where they fit 232,448 B (else one), two inflow tiles (nf
    rows of Wt rounded to 16) and a 16-byte ticket, each block rounded up
    to 16 bytes."""
    def a16(n):
        return (n + 15) // 16 * 16

    esize, kstep = {torch.float32: (4, 8), torch.bfloat16: (4, 16),
                    torch.float64: (8, 4)}[state]
    wp = ((Wt + 15) // 16 * 16 + 4 if state == torch.float64
          else (Wt + 31) // 32 * 32 + 8)
    kt_face, nt = -(-D // kstep), -(-D // 8)
    tile = a16(esize * D * wp)
    halo = a16((1 + nf) * kt_face * nt * 32 * 8) + 4 * tile
    rest = 2 * a16(esize * nf * ((Wt + 15) // 16 * 16)) + 16
    hb = 2 if nh and halo + 2 * nh * tile + rest <= 232448 else 1
    return halo + hb * nh * tile + rest


@pytest.mark.parametrize("state", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("D", [4, 8, 9, 16, 27, 64])
def test_tiled_kernel_shared_memory(state, D):
    """The wrapper's carve-up of the tiled kernel equals the C struct's at
    every width it may pick and halo size, and the widest tile the plan
    picks fits one CTA: f32 at D = 64 holds 64 columns (its widest tile)
    with the halo of the lattice's shifts in two buffers."""
    for Wt in (16, 48, 96, 128, 256):
        for nf in (2, 3):
            for nh in (0, 1, 2):
                assert (tlr.tiled_smem_bytes(D, Wt, nf, state, nh)
                        == _tiled_smem_of_c_struct(D, Wt, nf, state, nh))
    plan = tlr.launch_plan(D, 700, 3, state, 46, (699, 699, 699))
    assert plan.variant == "tiled" and plan.smem <= tlr._SMEM_LIMIT
    if (D, state) == (64, torch.float32):
        assert tlr.launch_plan(D, 256, 3, state, 46, (0, 16, 1))[
            :3] == ("tiled", 64, 4)
        assert tlr.tiled_halo_buffers(D, 64, 3, state, 1) == 2


def test_launch_plan_bounds():
    """The flagship keeps the one-CTA kernel in every state type; D = 64
    takes the tiled kernel at any W; W = 769 at D = 64 in f64, past the 16
    CTAs of 48 columns of the cluster kernel this replaces, gets a plan
    within 232,448 B of shared memory; an unbuilt D raises."""
    for dt in (torch.float32, torch.bfloat16, torch.float64):
        assert tlr.launch_plan(27, 256, 3, dt, 46,
                               (0, 16, 1)).variant == "persistent"
        assert tlr.launch_plan(64, 16, 3, dt, 10, (0, 4, 1)).variant == \
            "tiled"
        assert tlr.launch_plan(27, 257, 3, dt, 46,
                               (0, 16, 1)).variant == "tiled"
    for W in (768, 769):
        plan = tlr.launch_plan(64, W, 3, torch.float64, 46, (W - 1,) * 3)
        assert plan.variant == "tiled" and plan.smem <= 232448
        assert (plan.C - 1) * plan.Wt < W <= plan.C * plan.Wt
    with pytest.raises(ValueError, match="built for D"):
        tlr.launch_plan(125, 64, 3, torch.float32, 10, (0, 8, 1))


@pytest.mark.parametrize("state", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("D", list(tlr.TILED_D))
def test_launch_plan_takes_every_width(state, D):
    """launch_plan never raises for W up to 20,000 at any D the tiled kernel
    is built for, in every state type, with the most halo any shifts need
    (W - 1 on every face), a quad lattice's (0, 1) or a square hex slab's
    (0, 1, sqrt W): the tiles cover W exactly, Wt a multiple of 16 no wider
    than the kernel takes, within one CTA's shared memory."""
    for W in range(1, 20001):
        n = max(math.isqrt(W), 1) % W
        for nf, shifts in ((3, (W - 1,) * 3), (2, (0, min(1, W - 1))),
                           (3, (0, min(1, W - 1), n))):
            plan = tlr.launch_plan(D, W, nf, state, 10, shifts)
            assert plan.smem <= tlr._SMEM_LIMIT
            if plan.variant == "tiled":
                assert plan.Wt % 16 == 0
                assert plan.Wt <= tlr.tiled_wt_max(D, state)
                assert (plan.C - 1) * plan.Wt < W <= plan.C * plan.Wt


def _check_tile_dependences(D, W, shifts, state):
    """Plain-Python mirror of the tiled kernel's ring reads: tile t (slab
    columns c0 = t Wt ... c0 + Wl) at level l reads level l - 1 at column
    q = c0 + c - s_f for each face f, where q >= 0 (left of the slab the
    inflow coefficient is zero). The kernel takes c >= s_f from its own
    solution tile and c < s_f from halo column c of face f (min(s_f, Wt)
    of them), and waits on tiles max(c0 - s_max, 0) // Wt ... t - 1. No
    read lands above the tile's own columns or below tile t -
    ceil(s_max / Wt); every halo read is of a tile it waited on; the halo
    fits its blocks. Returns the plan."""
    plan = tlr.launch_plan(D, W, len(shifts), state, 10, shifts)
    assert plan.smem <= tlr._SMEM_LIMIT
    if plan.variant != "tiled":
        return plan
    Wt, C = plan.Wt, plan.C
    s_max = max(shifts)
    reach = -(-s_max // Wt)
    wp = tlr.tiled_row_stride(Wt, state)
    nh = tlr.tiled_halo_blocks(shifts, Wt, C, wp)
    assert (nh > 0) == (C > 1 and s_max > 0)
    for t in range(C):
        c0 = t * Wt
        Wl = min(Wt, W - c0)
        t_lo = max(c0 - s_max, 0) // Wt
        assert t - t_lo <= reach
        c = np.arange(Wl)
        for sf in shifts:
            q = c0 + c - sf
            on = q >= 0
            tq = q[on] // Wt
            assert ((t - reach <= tq) & (tq <= t)).all()
            own = c[on] >= sf
            assert (tq[own] == t).all() and (c[on][own] - sf < Wl).all()
            halo = ~own
            assert (c[on][halo] < min(sf, Wt)).all()
            assert ((t_lo <= tq[halo]) & (tq[halo] < t)).all()
    return plan


@pytest.mark.parametrize("case", list(LATTICES))
def test_tile_dependences_of_every_ring_lattice(case):
    """The tile dependences (``_check_tile_dependences``) of every lattice
    of test_every_ring_lattice_gets_a_launch_plan, in all three types."""
    L, W, shifts, BS, D, buckets = _slab(case)
    for dt in (torch.float32, torch.bfloat16, torch.float64):
        _check_tile_dependences(D, W, shifts, dt)


# ROADMAP.md section 3's fault record: lattices pbte_tpu solves on its
# ring that the earlier cluster kernel refused (hex n^3: W = n^2, shifts
# (0, 1, n))
PAST_THE_CEILING = {
    "hex_28_p3_f64": (64, 784, (0, 1, 28), torch.float64),
    "hex_40_p3_f32": (64, 1600, (0, 1, 40), torch.float32),
    "hex_65_p1_f32": (8, 4225, (0, 1, 65), torch.float32),
    "hex_60_p3_bf16": (64, 3600, (0, 1, 60), torch.bfloat16),
}


@pytest.mark.parametrize("case", list(PAST_THE_CEILING))
def test_fault_table_shapes_get_tiled_plans(case):
    """The four shapes of the fault record get a tiled plan of more than 16
    tiles within one CTA's shared memory, and their tile dependences hold
    (``_check_tile_dependences``)."""
    D, W, shifts, state = PAST_THE_CEILING[case]
    plan = _check_tile_dependences(D, W, shifts, state)
    assert plan.variant == "tiled" and plan.C > 16



def test_tiled_factor_split_error_bound():
    """The tiled kernel splits the float32 factor (and every A operand) into
    TF32 hi and lo at each use by truncation (``split_tf32`` of
    csrc/lattice_ring_common.cuh: mask the low 13 bits of x, then of x -
    hi); mirrored here on the bits, hi + lo is within 2^-20 of x, relative,
    the bound the source states, on random values from 2^-100 up (some
    with the mantissa's top bits set, some with every dropped bit set),
    and x - hi is exact in float32."""
    src = (pathlib.Path(tlr.__file__).resolve().parents[1] / "csrc"
           / "lattice_ring_common.cuh").read_text()
    body = src[src.index("void split_tf32("):]
    body = body[:body.index("}")]
    assert body.count("& 0xffffe000u") == 2 and "0x1000" not in body
    assert "2^-20 |x|" in src

    rng = np.random.default_rng(7)
    bits = rng.integers(0x0d800000, 0x7f000000, 200_000, dtype=np.uint32)
    bits[:1000] |= np.uint32(0x007fe000)  # mantissa's top 10 bits set
    bits[1000:2000] |= np.uint32(0x00001fff)  # every dropped bit set
    x = bits.view(np.float32) * np.where(rng.random(bits.size) < 0.5, -1,
                                         1).astype(np.float32)
    mask = np.uint32(0xffffe000)
    hi = (x.view(np.uint32) & mask).view(np.float32)
    r = x - hi
    lo = (r.view(np.uint32) & mask).view(np.float32)
    x64 = x.astype(np.float64)
    assert np.array_equal(r.astype(np.float64), x64 - hi.astype(np.float64))
    err = np.abs(x64 - hi.astype(np.float64) - lo.astype(np.float64))
    assert (err <= np.abs(x64) * 2.0 ** -20).all()
