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
    both state modes."""
    v = torch.zeros((46, 4, 10, 40, 27, 256), device="meta")
    for dt, cast in ((torch.float32, False), (torch.bfloat16, True)):
        vv = v.to(dt)
        tlr._kernel_args_ok(vv, dict(v=vv), cast, (0, 16, 1))


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
])
def test_flagship_bucket_bound(dtype, nbytes, bound_ms):
    """The bound chip_smoke.py reports for the flagship's bucket 0 (46
    levels, 4 groups x 10 slots x 40 bands, D=27, W=256, three faces): its
    bytes (every input read once, every output written once) over
    3.35 TB/s, above its 1.1e11 flop over the tensor-core peak (3xTF32 at
    495/3 TFLOP/s for f32 state, bf16 at 989 TFLOP/s)."""
    v = torch.zeros((46, 4, 10, 40, 27, 256), dtype=dtype, device="meta")
    got_bytes, flop = tlr.sweep_cost(v, 3)
    assert got_bytes == nbytes and flop == 2 * 46 * 4 * 10 * 40 * 27 * 108 * 256
    ms, by = tlr.sweep_bound_ms(v, 3)
    assert by == "bytes"
    np.testing.assert_allclose(ms, bound_ms, rtol=1e-12)
    assert flop / tlr.H100_FLOPS[dtype] * 1e3 < ms


@pytest.mark.parametrize("cast", [False, True])
def test_kernel_shared_memory_fits_one_cta(cast):
    """The kernel's carve-up at the flagship's widths fits one CTA on
    Hopper (tiles at a row stride of 264 words), and grows with W."""
    smem = tlr.kernel_smem_bytes(27, 256, 3, cast)
    assert smem <= tlr._SMEM_LIMIT
    assert smem == (8192 if cast else 32768) + 4 * 27 * 264 * 4 + 2 * 3 * 256 * 4
    assert tlr.kernel_smem_bytes(27, 64, 3, cast) < smem
