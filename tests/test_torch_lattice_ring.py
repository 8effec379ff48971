"""K1, the lattice ring sweep: pbte_tpu_torch's plain PyTorch version
against pbte_tpu's Pallas kernel run by the Pallas interpreter on the CPU,
on the same random inputs. The CUDA kernel itself runs only on a GPU and is
held against the plain version there by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pbte_tpu.ops.lattice_ring import lattice_ring_sweep as jax_sweep
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
    before = tlr.lattice_ring_sweep.launches
    ys, ms = _run_torch(d, cast_bf16=False)
    ys_r, ms_r = _run_torch(d, cast_bf16=False, fn=tlr.lattice_ring_sweep_ref)
    assert tlr.lattice_ring_sweep.launches == before
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
    checks are host code, so they run here on CPU tensors)."""
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
        v = torch.zeros((L, Gb, Km, BS, D, 512))
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
    transposed factor and one ring tile, small enough for two CTAs per SM),
    and grows with W."""
    state = {False: torch.float32, True: torch.bfloat16,
             "f64": torch.float64}[cast]
    smem = tlr.kernel_smem_bytes(27, 256, 3, state, 46)
    assert smem <= tlr._SMEM_LIMIT
    if state == torch.float64:
        assert smem == 108 * 28 * 8 + 27 * 256 * 8 + 46 * 8 == 79856
        assert 2 * smem <= 228 * 1024
    else:
        assert smem == ((8192 if cast else 32768) + 4 * 27 * 264 * 4
                        + 2 * 3 * 256 * 4 + 46 * 8)
    assert tlr.kernel_smem_bytes(27, 64, 3, state, 46) < smem
    with pytest.raises(ValueError, match="no kernel"):
        tlr.kernel_smem_bytes(27, 256, 3, torch.float16, 46)


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
