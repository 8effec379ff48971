"""pbte_tpu_torch's solver/accel.py and solve(accelerate=...) against
pbte_tpu's, on the CPU.

Every case runs both packages on the same numpy inputs: the tree helpers on
seeded trees; the three Krylov / fixed-point drivers on a seeded synthetic
affine map (nonnormal, shaped like a small (u-tuple, Tc) state), evaluated
by one numpy function for both, so the drivers are all that differs; the
float64 solver (pbte_tpu's XLA ring against the port's plain sweep) through
``solve(accelerate="bicgstab")``; and iterative refinement.

Tolerances. The drivers' matvec is (I - A) v = v - (F(v) - F(0)): F(v) is
rounded at the scale of F(0), so a linear relative residual rho carries a
relative rounding of ~1e-16 / rho, which BiCGStab carries on. The synthetic
cases therefore stop above 1e-4 (or stagnate above it), where the two
packages agree to 1e-10 relative in every residual they report, the
iterate and the step count; measured agreement is stated per test.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_golden
from pbte_tpu import mesh as pmesh
from pbte_tpu.fem import assembly as passembly
from pbte_tpu.solver import accel as jaccel
from pbte_tpu.solver.source_iteration import SourceIterationSolver as JaxSolver
from pbte_tpu_torch import mesh as tmesh
from pbte_tpu_torch.fem import assembly as tassembly
from pbte_tpu_torch.problem import WALL_BCS, unit_cube
from pbte_tpu_torch.solver import accel
from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

# ---- the synthetic affine map ----------------------------------------------

U_SHAPES = ((2, 3, 4), (2, 2, 4))  # two "buckets"
TC_SHAPE = (5, 3)  # (ne, D)
N = sum(int(np.prod(s)) for s in U_SHAPES) + int(np.prod(TC_SHAPE))


def _affine_map(seed, rho=0.5, nonnormal=0.3, b_scale=1.0, shift=0.0):
    """F(z) = A z + b (+ shift e where z != 0) over the flattened state:
    A = rho Q + N with Q a seeded orthogonal matrix and N strictly upper
    triangular (nonnormal). ``shift`` > 0 adds a constant e of norm
    shift |b| everywhere but at the origin, a deterministic non-affine term
    on which BiCGStab settles at a floor and its stagnation guard stops
    it."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    a = rho * q + np.triu(rng.standard_normal((N, N)), 1) * nonnormal / N**.5
    b = rng.standard_normal(N) * b_scale
    e = rng.standard_normal(N)
    e *= shift * np.linalg.norm(b) / np.linalg.norm(e)
    return a, b, e


def _split(z):
    out, o = [], 0
    for s in U_SHAPES:
        m = int(np.prod(s))
        out.append(z[o:o + m].reshape(s))
        o += m
    return tuple(out), z[o:].reshape(TC_SHAPE)


def _np_step(fmap, u, Tc, Tv):
    """One step of the map on numpy leaves: (u', Tc', Tv', residual), with
    Tv the row sums of Tc."""
    a, b, e = fmap
    z = np.concatenate([np.asarray(l, dtype=np.float64).reshape(-1)
                        for l in (*u, Tc)])
    z2 = a @ z + b + e * bool(np.any(z != 0))
    u2, Tc2 = _split(z2)
    Tv2 = Tc2.sum(axis=1)
    res = np.linalg.norm(Tv2 - np.asarray(Tv)) / np.linalg.norm(Tv2)
    return u2, Tc2, Tv2, res


def _jax_step(fmap):
    def step(u, Tc, Tv):
        u2, Tc2, Tv2, res = _np_step(fmap, u, Tc, Tv)
        return (tuple(jnp.asarray(x) for x in u2), jnp.asarray(Tc2),
                jnp.asarray(Tv2), jnp.asarray(res))
    return step


def _torch_step(fmap):
    def step(u, Tc, Tv):
        u2, Tc2, Tv2, res = _np_step(fmap, [l.numpy() for l in u],
                                     Tc.numpy(), Tv.numpy())
        return (tuple(torch.from_numpy(x.copy()) for x in u2),
                torch.from_numpy(Tc2.copy()), torch.from_numpy(Tv2),
                torch.tensor(res))
    return step


def _jax_zero():
    return (tuple(jnp.zeros(s) for s in U_SHAPES), jnp.zeros(TC_SHAPE),
            jnp.zeros(TC_SHAPE[0]))


def _torch_zero():
    z = dict(dtype=torch.float64)
    return (tuple(torch.zeros(s, **z) for s in U_SHAPES),
            torch.zeros(TC_SHAPE, **z), torch.zeros(TC_SHAPE[0], **z))


def _flat(tree):
    return np.concatenate([np.asarray(l, dtype=np.float64).reshape(-1)
                           for l in accel._leaves(tree)])


def _assert_rel(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"{what}: {err:.3e} > {tol}"


SYN_RTOL = 1e-10


def _warm_state(fmap, steps=3):
    u, Tc = _split(np.zeros(N))
    for _ in range(steps):
        u, Tc, _, _ = _np_step(fmap, u, Tc, np.zeros(TC_SHAPE[0]))
    return u, Tc


# (map keywords, tol, max_iter, check_every, warm start, callback nmv
# sequence when the case pins one); measured agreement of the residuals /
# iterate: converge 4.8e-12 / 1.1e-15, breakdown 3.1e-16 / 1.2e-16,
# stagnation 4.9e-15 / 3.8e-16, cap 6.0e-14 / 1.7e-16, warm 1.8e-12 /
# 1.7e-16
BICGSTAB_CASES = {
    "converge": (dict(seed=1), 1e-4, 400, 2, False, None),
    # b at 1e-151: rho = <rhat, r> ~ |b|^2 falls below 1e-300 (every value
    # stays a normal number), so each read restarts the recurrence at x:
    # reads at 3, 6, 9 (one restart matvec each) instead of 3, 5, 7
    "breakdown": (dict(seed=2, b_scale=1e-151), 1e-6, 11, 2, False,
                  [3, 6, 9]),
    # the shifted map settles at relres ~0.079 and the guard stops it
    "stagnation": (dict(seed=5, shift=0.2), 1e-12, 400, 2, False, None),
    "cap": (dict(seed=1), 0.0, 13, 2, False, [3, 5, 7, 9, 11]),
    "warm": (dict(seed=1), 1e-4, 400, 2, True, None),
}


@pytest.mark.parametrize("case", list(BICGSTAB_CASES))
def test_bicgstab_outer_follows_jax(case):
    """bicgstab_outer through both packages on the synthetic map: the same
    callback sequence (nmv, relres), iterate x, Tc, Tv residual and step
    count, at 1e-10 relative."""
    kw, tol, max_iter, check_every, warm, nmvs = BICGSTAB_CASES[case]
    fmap = _affine_map(**kw)
    seen_j, seen_t = [], []
    state_j = state_t = None
    if warm:
        u, Tc = _warm_state(fmap)
        state_j = (tuple(jnp.asarray(x) for x in u), jnp.asarray(Tc), None)
        state_t = (tuple(torch.from_numpy(x.copy()) for x in u),
                   torch.from_numpy(Tc.copy()), None)
    rj = jaccel.bicgstab_outer(
        _jax_step(fmap), _jax_zero(), state_j, tol, max_iter, verbose=False,
        callback=lambda n, r: seen_j.append((n, r)), check_every=check_every)
    rt = accel.bicgstab_outer(
        _torch_step(fmap), _torch_zero(), state_t, tol, max_iter,
        verbose=False, callback=lambda n, r: seen_t.append((n, r)),
        check_every=check_every)
    assert [n for n, _ in seen_t] == [n for n, _ in seen_j]
    if nmvs is not None:
        assert [n for n, _ in seen_t] == nmvs
    _assert_rel([r for _, r in seen_t], [r for _, r in seen_j], SYN_RTOL,
                "relres")
    for got, want in zip(seen_t, seen_j):  # every read, each to its own
        assert abs(got[1] - want[1]) <= SYN_RTOL * want[1]
    assert rt[4] == rj[4] <= max_iter
    _assert_rel(_flat(rt[:2]), _flat(rj[:2]), SYN_RTOL, "x")
    _assert_rel(rt[2].numpy(), rj[2], SYN_RTOL, "Tv")
    assert abs(rt[3] - rj[3]) <= SYN_RTOL * rj[3]
    if case == "stagnation":
        assert seen_t[-1][1] > 1e-2 and rt[4] < max_iter - 4
    if case == "converge":
        assert seen_t[-1][1] < tol


# (stale reads, nmv, last gain or restart, last gain) -> the guard's action:
# the synthetic floor above (pbte_tpu stops there too); the float64
# flagship's plateau near relres 1e-3 (the last gain at matvec 201, read
# every 20 matvecs), where pbte_tpu stopped; three reads after the restart;
# six (a second restart); six after that, now as long as the solve before
# it; the same without a restart; too few reads; too short a span
STALL_CASES = {
    "floor": ((6, 75, 15, 15), "stop"),
    "flagship_plateau": ((6, 321, 201, 201), "plateau"),
    "after_restart": ((3, 381, 321, 201), None),
    "plateau_again": ((6, 381, 321, 201), "plateau"),
    "restarted_plateau": ((6, 442, 381, 201), "stop"),
    "long_plateau": ((6, 402, 201, 201), "stop"),
    "few_reads": ((5, 1000, 11, 11), None),
    "short_span": ((6, 70, 11, 11), None),
}


@pytest.mark.parametrize("case", list(STALL_CASES))
def test_stall_action(case):
    args, want = STALL_CASES[case]
    assert accel.stall_action(*args) == want


# seeded maps on which a stop at every stall (pbte_tpu's guard) ends the
# solve on a plateau far above tol, and the port's restarts reach tol
# (measured: seed 7 stops at relres 0.51 after 125 step applications and
# the port reaches 1e-10 in 306; seed 8 0.075 after 179, the port 358)
PLATEAU_SEEDS = (7, 8)


@pytest.mark.parametrize("seed", PLATEAU_SEEDS)
def test_bicgstab_restarts_a_plateau(seed, monkeypatch, capsys):
    """The port's guard restarts the recurrence where pbte_tpu's stops, and
    the solve goes on to tol; both read the same residuals until then."""
    fmap = _affine_map(seed=seed, rho=0.99, nonnormal=1.0)

    def run():
        seen = []
        r = accel.bicgstab_outer(
            _torch_step(fmap), _torch_zero(), None, 1e-10, 1500,
            callback=lambda n, x: seen.append((n, x)), check_every=2)
        return r, seen, capsys.readouterr().out

    r_port, seen_port, out = run()
    own = accel.stall_action
    monkeypatch.setattr(accel, "stall_action",
                        lambda *a: "stop" if own(*a) else None)
    r_stop, seen_stop, _ = run()
    assert seen_stop[-1][1] > 1e-2 and r_stop[4] < 200
    assert "bicgstab restart (plateau)" in out
    assert seen_port[-1][1] < 1e-10 and r_port[4] < 400
    assert seen_port[:len(seen_stop)] == seen_stop


def _defect(fmap, seed=5):
    """A seeded right-hand side d shaped like the state, as both packages'
    trees."""
    d = np.random.default_rng(seed).standard_normal(N)
    u, Tc = _split(d)
    return ((tuple(jnp.asarray(x) for x in u), jnp.asarray(Tc)),
            (tuple(torch.from_numpy(x.copy()) for x in u),
             torch.from_numpy(Tc.copy())))


# measured agreement of e / relres: plain 0 / 0 (the same bits), consumed
# d the same, krylov 8.4e-16 / 6.6e-12, krylov stagnation 8.1e-14 /
# 4.6e-13, krylov cap 6.7e-16 / 3.3e-13
CORRECTION_CASES = {
    "plain": ("plain", dict(seed=1), 1e-4, 400, False),
    "plain_consume_d": ("plain", dict(seed=1), 1e-4, 400, True),
    "krylov": ("krylov", dict(seed=1), 1e-4, 400, False),
    "krylov_consume_d": ("krylov", dict(seed=1), 1e-4, 400, True),
    "krylov_stagnation": ("krylov", dict(seed=5, shift=0.2), 1e-12, 400,
                          False),
    "krylov_cap": ("krylov", dict(seed=1), 0.0, 13, False),
}


@pytest.mark.parametrize("case", list(CORRECTION_CASES))
def test_correction_solves_follow_jax(case):
    """correction_outer and correction_bicgstab through both packages on the
    synthetic map and a seeded defect: the same e, step count and final
    relative residual (1e-10 relative); consume_d=True leaves the port's d
    without its storage."""
    inner, kw, tol, max_iter, consume = CORRECTION_CASES[case]
    fmap = _affine_map(**kw)
    d_j, d_t = _defect(fmap)
    fj = jaccel.correction_bicgstab if inner == "krylov" else \
        jaccel.correction_outer
    ft = accel.correction_bicgstab if inner == "krylov" else \
        accel.correction_outer
    opts = dict(tol=tol, max_iter=max_iter, verbose=False, check_every=3,
                consume_d=consume)
    ej, nj, relj = fj(_jax_step(fmap), _jax_zero(), d_j, **opts)
    et, nt, relt = ft(_torch_step(fmap), _torch_zero(), d_t, **opts)
    assert nt == nj <= max_iter
    _assert_rel(_flat(et), _flat(ej), SYN_RTOL, "e")
    assert abs(relt - relj) <= SYN_RTOL * relj
    if consume and inner == "krylov":
        assert all(l.numel() == 0 for l in accel._leaves(d_t))
    if tol > 0 and not case.endswith("stagnation"):
        assert relt < tol


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_tree_dot_and_comb_match_jax(dtype):
    """tree_dot (bf16 leaves summed in f32) and tree_comb against pbte_tpu's
    on a seeded (u-tuple, Tc) tree; tolerances are each type's rounding of
    a sum of 55 terms."""
    rng = np.random.default_rng(3)
    trees = [tuple(rng.standard_normal(s) for s in (*U_SHAPES, TC_SHAPE))
             for _ in range(3)]
    jt = [(tuple(jnp.asarray(x, dtype=getattr(jnp, dtype)) for x in t[:2]),
           jnp.asarray(t[2], dtype=getattr(jnp, dtype))) for t in trees]
    tt = [(tuple(torch.from_numpy(x).to(getattr(torch, dtype))
                 for x in t[:2]),
           torch.from_numpy(t[2]).to(getattr(torch, dtype))) for t in trees]
    rtol = {"float64": 1e-13, "float32": 1e-5, "bfloat16": 1e-5}[dtype]
    dj = float(jaccel.tree_dot(jt[0], jt[1]))
    dt = accel.tree_dot(tt[0], tt[1])
    assert dt.dtype == (torch.float32 if dtype == "bfloat16"
                        else getattr(torch, dtype))
    np.testing.assert_allclose(float(dt), dj, rtol=rtol)
    coeffs = (1.0, -0.75, 2.5)
    cj = jaccel.tree_comb(list(zip(coeffs, jt)))
    ct = accel.tree_comb(list(zip(coeffs, tt)))
    assert [l.dtype for l in accel._leaves(ct)] == [getattr(torch, dtype)] * 3
    # bf16: each side rounds every product and sum to bf16, XLA possibly
    # after fusing them: one bf16 ulp of the largest entry (2^-7 relative)
    tol = {"float64": 1e-15, "float32": 1e-6, "bfloat16": 2.0 ** -7}[dtype]
    _assert_rel(_flat([l.float() for l in accel._leaves(ct)]),
                _flat([np.asarray(l, np.float32) for l in
                       jax.tree_util.tree_leaves(cj)]), tol, "tree_comb")


# ---- the solver -------------------------------------------------------------

SIZE = dict(nx=8, ny=8, nz=8, order=1, polar=2, azimuth=4, nspec=2)
DIRICHLET = dict(bc_temps={a: -0.5 for a in range(1, 6)},
                 dirichlet_bcs={6: 0.25})
# tests/test_accel.py:157-170's walls on the port's hex 8^3
REFLECTIVE = dict(bc_temps={2: -0.5, 3: -0.5, 5: 0.5}, diffuse_bcs=[1],
                  specular_bcs=[4, 6])
WALLS = {"isothermal": dict(bc_temps=WALL_BCS), "dirichlet": DIRICHLET,
         "reflective": REFLECTIVE}


def _solvers(walls, dtype=64, scale=1e-6):
    """pbte_tpu's XLA ring and the port's plain sweep on the same hex 8^3
    problem (each from its own package's host layers), at ``scale``
    metres per unit."""
    kw = dict(WALLS[walls])
    bcs = kw.pop("bc_temps")
    jprob = torch_golden.jax_unit_cube(**SIZE)
    tprob = unit_cube(**SIZE)
    if scale != 1e-6:
        jm = pmesh.make_cartesian_3d(8, 8, 8, "hex").scaled(scale)
        jprob = (passembly.assemble(pmesh.connect(jm), order=1,
                                    face_mode="consistent"), *jprob[1:])
        tm = tmesh.make_cartesian_3d(8, 8, 8, "hex").scaled(scale)
        tprob = (tassembly.assemble(tmesh.connect(tm), order=1,
                                    face_mode="consistent"), *tprob[1:])
    old = os.environ.get("PBTE_RING_BF16")
    os.environ["PBTE_RING_BF16"] = "0"  # pbte_tpu's f32 ring: exact operands
    try:
        js = JaxSolver(*jprob, bcs, dtype=jnp.float64 if dtype == 64
                       else jnp.float32, sweep_mode="ring", use_pallas="off",
                       **kw)
    finally:
        if old is None:
            del os.environ["PBTE_RING_BF16"]
        else:
            os.environ["PBTE_RING_BF16"] = old
    ts = SourceIterationSolver(*tprob, bcs, dtype=torch.float64 if dtype == 64
                               else torch.float32, device="cpu", **kw)
    assert js.sweep_mode == "ring" and js._ring_lattice
    return js, ts


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread: the float32 Krylov recurrence of refined_solve follows
    the order of torch's sums, which depends on the thread count."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def _flush_denormals():
    """f32 subnormals flushed as XLA's CPU backend flushes them (see
    tests/test_torch_solver.py::_cpu_float_env)."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.mark.parametrize("walls", list(WALLS))
def test_solve_bicgstab_matches_jax(walls):
    """solve(accelerate="bicgstab", tol=0, max_iter=18) in float64: the
    port's plain sweep against pbte_tpu's XLA ring, in Tc, the state (both
    packages' _ring_u_standard), Tv, the Tv residual and the step count.
    Measured agreement (Tc / state / residual): isothermal 2.0e-14 /
    7.8e-14 / 3.5e-14, Dirichlet 6.3e-12 / 1.9e-11 / 3.3e-11, diffuse +
    specular 3.0e-15 / 3.6e-14 / 9.3e-15. At a cap of 24 the isothermal
    walls differ by 9.5e-8 / 2.8e-7: from ~19 steps on the recurrence sits
    on a plateau where the summation order's rounding grows ~1e3-fold every
    two steps."""
    js, ts = _solvers(walls)
    opts = dict(tol=0, max_iter=18, verbose=False, accelerate="bicgstab")
    rj, rt = js.solve(**opts), ts.solve(**opts)
    assert rt.iterations == rj.iterations == 17
    tol = 1e-10
    Tcj = np.asarray(rj.Tc)
    np.testing.assert_allclose(rt.Tc.numpy(), Tcj, rtol=tol,
                               atol=tol * np.abs(Tcj).max())
    uj = js._ring_u_standard(rj.u)
    np.testing.assert_allclose(ts._ring_u_standard(rt.u), uj, rtol=tol,
                               atol=tol * np.abs(uj).max())
    Tvj = np.asarray(rj.Tv)
    np.testing.assert_allclose(rt.Tv.numpy(), Tvj, rtol=tol,
                               atol=tol * np.abs(Tvj).max())
    np.testing.assert_allclose(rt.residual, rj.residual, rtol=1e-8)


def test_bicgstab_converges_to_the_plain_fixed_point():
    """A converged case on the hex 8^3 lattice at 0.5 um (tests/test_accel.py
    :32-45 at a scale whose plain solve takes 420 steps, not 1130): the
    accelerated Tc within 1e-7 of max of pbte_tpu's accelerated Tc and of
    the port's plain fixed point, in under a third of its steps."""
    js, ts = _solvers("isothermal", scale=5e-7)
    opts = dict(tol=1e-10, max_iter=3000, verbose=False, check_every=10)
    acc_t = ts.solve(accelerate="bicgstab", **opts)
    acc_j = js.solve(accelerate="bicgstab", **opts)
    plain = ts.solve(**opts)
    assert plain.residual < 1e-10 and acc_t.residual < 1e-9
    assert acc_t.iterations * 3 < plain.iterations, (acc_t.iterations,
                                                     plain.iterations)
    Tp = plain.Tc.numpy()
    for other in (Tp, np.asarray(acc_j.Tc)):
        np.testing.assert_allclose(acc_t.Tc.numpy(), other, rtol=0,
                                   atol=1e-7 * np.abs(Tp).max())


@pytest.fixture(scope="module")
def refine_problem():
    """Both packages' f32 and f64 solvers of the hex 8^3 lattice at 0.5 um
    (isothermal walls), and the f64 fixed point (pbte_tpu's accelerated
    solve to a linear relative residual of 1e-12)."""
    js32, ts32 = _solvers("isothermal", dtype=32, scale=5e-7)
    js64, ts64 = _solvers("isothermal", scale=5e-7)
    truth = np.asarray(js64.solve(tol=1e-12, max_iter=3000, verbose=False,
                                  accelerate="bicgstab").Tc)
    return js32, ts32, js64, ts64, truth


# inner solver: (check_every, the largest ratio of the two packages'
# correction step counts). The plain fixed point takes the same steps in
# both (201, measured); BiCGStab in float32 follows each package's own
# rounding, down to the order of torch's sums: 49 steps on one thread, 81
# on eight, pbte_tpu 57, all to the inner tolerance
REFINE_INNER = {"plain": (10, 1.0), "krylov": (2, 2.0)}


@pytest.mark.parametrize("inner", list(REFINE_INNER))
def test_refined_solve_matches_jax(inner, refine_problem, _flush_denormals):
    """refined_solve: the port's f32 solver with the port's f64 step against
    pbte_tpu's (its f32 XLA ring with exact operands, its f64 step), base
    solve to 1e-6, inner tolerance 1e-4. Measured (plain / krylov): error
    against the f64 fixed point 2.0e-9 / 1.8e-9 of max (pbte_tpu 2.0e-9 /
    7.7e-10; the base solve's 3.0e-5 / 3.7e-5), refined Tc of the two
    packages within 1.8e-11 / 2.0e-9 of max, defect norms within 0.34% /
    0.27%."""
    js32, ts32, js64, ts64, truth = refine_problem
    check_every, steps_ratio = REFINE_INNER[inner]
    opts = dict(tol=1e-6, max_iter=2000, inner_tol=1e-4,
                inner_max_iter=2000, verbose=False, check_every=check_every,
                inner=inner)
    oj = jaccel.refined_solve(js32, js64.step, **opts)
    ot = accel.refined_solve(ts32, ts64.step, **opts)
    assert ot["Tc_refined"].dtype == torch.float64
    assert [u.dtype for u in ot["u_refined"]] == [torch.float64] * len(
        ot["u_refined"])
    Tc_t = ot["Tc_refined"].numpy()
    scale = np.abs(truth).max()
    err_t = np.abs(Tc_t - truth).max() / scale
    err_j = np.abs(oj["Tc_refined"] - truth).max() / scale
    base = np.abs(ot["base_result"].Tc.double().numpy() - truth).max() / scale
    assert err_t < 1e-8 and err_t < 1e-3 * base
    assert err_t < 3 * err_j + 1e-9
    np.testing.assert_allclose(Tc_t, oj["Tc_refined"], rtol=0,
                               atol=1e-8 * scale)
    np.testing.assert_allclose(ot["defect_norm"], oj["defect_norm"],
                               rtol=1e-2)
    n_t, n_j = ot["correction_steps"], oj["correction_steps"]
    assert max(n_t, n_j) <= steps_ratio * min(n_t, n_j)
    assert ot["correction_relres"] < opts["inner_tol"]


# ---- the compensated iteration ---------------------------------------------

# (map keywords, tol, max_iter, check_every, warm start): stopped below tol
# at a read, run to the cap with a read there, warm-started
COMPENSATED_CASES = {
    "converge": (dict(seed=1), 1e-9, 400, 3, False),
    "cap": (dict(seed=3), 0.0, 7, 2, False),
    "warm": (dict(seed=1), 1e-9, 400, 5, True),
}


@pytest.mark.parametrize("case", list(COMPENSATED_CASES))
def test_compensated_outer_follows_jax(case):
    """compensated_outer through both packages on the synthetic map: the
    same reads (iteration, residual), value part, Tv, final residual and
    step applications. Each TwoSum is exact, so the two agree to the
    rounding of the numpy step they share (measured: equal)."""
    kw, tol, max_iter, check_every, warm = COMPENSATED_CASES[case]
    fmap = _affine_map(**kw)
    seen_j, seen_t = [], []
    state_j = state_t = None
    if warm:
        u, Tc = _warm_state(fmap)
        state_j = (tuple(jnp.asarray(x) for x in u), jnp.asarray(Tc), None)
        state_t = (tuple(torch.from_numpy(x.copy()) for x in u),
                   torch.from_numpy(Tc.copy()), None)
    rj = jaccel.compensated_outer(
        _jax_step(fmap), _jax_zero(), state_j, tol, max_iter, verbose=False,
        callback=lambda n, r: seen_j.append((n, r)), check_every=check_every)
    rt = accel.compensated_outer(
        _torch_step(fmap), _torch_zero(), state_t, tol, max_iter,
        verbose=False, callback=lambda n, r: seen_t.append((n, r)),
        check_every=check_every)
    assert [n for n, _ in seen_t] == [n for n, _ in seen_j]
    for got, want in zip(seen_t, seen_j):
        assert abs(got[1] - want[1]) <= SYN_RTOL * want[1]
    assert rt[4] == rj[4] == 1 + 2 * seen_t[-1][0]
    _assert_rel(_flat(rt[:2]), _flat(rj[:2]), SYN_RTOL, "x")
    _assert_rel(rt[2].numpy(), rj[2], SYN_RTOL, "Tv")
    assert abs(rt[3] - rj[3]) <= SYN_RTOL * rj[3]
    if case == "cap":
        assert [n for n, _ in seen_t] == [2, 4, 6, 7]
    else:
        assert seen_t[-1][1] < tol <= seen_t[-2][1]


def test_two_sum_is_exact():
    """two_sum's pair holds a + b exactly: s is the rounded sum, and e what
    the rounding dropped (checked in float64 against exact rationals)."""
    from fractions import Fraction

    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.standard_normal(64) * 10.0 ** rng.integers(
        -8, 8, 64))
    b = torch.from_numpy(rng.standard_normal(64) * 10.0 ** rng.integers(
        -8, 8, 64))
    (s,), (e,) = accel.two_sum((a,), (b,))
    assert torch.equal(s, a + b)
    for x, y, ss, ee in zip(a.tolist(), b.tolist(), s.tolist(), e.tolist()):
        assert Fraction(ss) + Fraction(ee) == Fraction(x) + Fraction(y)


@pytest.mark.parametrize("walls", list(WALLS))
def test_solve_compensated_matches_jax(walls):
    """solve(accelerate="compensated") in float64: the port's plain sweep
    against pbte_tpu's XLA ring (its compensated_outer over _step_plain),
    10 iterations with the residual read every 4: Tc, Tv and the state
    within 1e-12 of max, the residual, and the same step applications
    (21)."""
    js, ts = _solvers(walls)
    opts = dict(tol=0, max_iter=10, verbose=False, check_every=4,
                accelerate="compensated")
    rj, rt = js.solve(**opts), ts.solve(**opts)
    assert rt.iterations == rj.iterations == 21
    tol = 1e-12
    for got, want in ((rt.Tc.numpy(), np.asarray(rj.Tc)),
                      (rt.Tv.numpy(), np.asarray(rj.Tv)),
                      (ts._ring_u_standard(rt.u),
                       js._ring_u_standard(rj.u))):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max())
    np.testing.assert_allclose(rt.residual, rj.residual, rtol=1e-8)


# tests/test_accel.py's walls and problem (hex n^3 p=1 at a micron, 2 x 4
# directions, 2 x 2 bands)
BCS3 = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}


def _port_problem(nx):
    return unit_cube(nx, nx, nx, order=1, polar=2, azimuth=4, nspec=2)


def test_compensated_matches_plain_fixed_point_f64():
    """pbte_tpu's property (tests/test_accel.py:181) on the port: in float64
    the compensated solve reaches the plain fixed point (1e-9 of max)."""
    s = SourceIterationSolver(*_port_problem(4), BCS3, dtype=torch.float64,
                              device="cpu", sweep_mode="ring",
                              supercell="off")
    opts = dict(tol=1e-11, max_iter=2000, verbose=False, check_every=10)
    r_plain = s.solve(**opts)
    r_comp = s.solve(accelerate="compensated", **opts)
    assert r_comp.residual < 1e-10
    Tp = r_plain.Tc.numpy()
    np.testing.assert_allclose(r_comp.Tc.numpy(), Tp, rtol=0,
                               atol=1e-9 * np.abs(Tp).max())


def test_compensated_f32_floor_equals_plain_floor():
    """pbte_tpu's refutation (tests/test_accel.py:197) on the port: in
    float32 (exact products) the compensated state reaches the plain
    iteration's floor against the float64 fixed point, within 20%. The
    float64 point is BiCGStab's to 1e-12 (1.0e-10 of max from the plain
    solve's, 191 steps against 1,400) and the float32 solves stop at 1,200
    iterations, where both sit on the floor already: measured 1.912e-6 at
    1,200 and at pbte_tpu's 3,000 (2.37e-6 at 800), the two equal."""
    prob = _port_problem(6)
    kw = dict(device="cpu", sweep_mode="ring", supercell="off")
    s64 = SourceIterationSolver(*prob, BCS3, dtype=torch.float64, **kw)
    truth = s64.solve(tol=1e-12, max_iter=4000, verbose=False, check_every=2,
                      accelerate="bicgstab").Tc.numpy()
    s32 = SourceIterationSolver(*prob, BCS3, dtype=torch.float32, **kw)
    opts = dict(tol=0, max_iter=1200, verbose=False, check_every=100)
    r_plain = s32.solve(**opts)
    r_comp = s32.solve(accelerate="compensated", **opts)
    scale = np.linalg.norm(truth)
    b_plain = np.linalg.norm(r_plain.Tc.double().numpy() - truth) / scale
    b_comp = np.linalg.norm(r_comp.Tc.double().numpy() - truth) / scale
    assert b_plain < 5e-6 and b_comp < 5e-6, (b_comp, b_plain)
    assert abs(b_comp - b_plain) < 0.2 * b_plain, (b_comp, b_plain)


# ---- refusals ---------------------------------------------------------------

def test_accelerate_refusals(monkeypatch, tmp_path):
    """bf16 state with bicgstab or "compensated" (as pbte_tpu refuses it),
    an unknown value and float64 with PBTE_RING_STATE_BF16=1 are refused; a
    checkpoint with or without acceleration is written."""
    prob = unit_cube(**SIZE)
    ts = SourceIterationSolver(*prob, WALL_BCS, dtype=torch.float64,
                               device="cpu")
    with pytest.raises(ValueError, match="unknown accelerate"):
        ts.solve(max_iter=3, verbose=False, accelerate="gmres")
    for acc in (None, "bicgstab"):  # checkpoints are taken (item 9)
        path = str(tmp_path / f"{acc}.npz")
        ts.solve(max_iter=6, verbose=False, accelerate=acc,
                 checkpoint_path=path, checkpoint_every=1)
        assert os.path.exists(path)
    r = ts.solve(tol=0, max_iter=3, verbose=False, accelerate="none")
    assert r.iterations == 3
    monkeypatch.setenv("PBTE_RING_STATE_BF16", "1")
    with pytest.raises(ValueError, match="PBTE_RING_STATE_BF16"):
        SourceIterationSolver(*prob, WALL_BCS, dtype=torch.float64,
                              device="cpu")
    tb = SourceIterationSolver(*prob, WALL_BCS, device="cpu")
    assert tb.state_bf16
    for acc in ("bicgstab", "compensated"):
        with pytest.raises(ValueError, match="exact-dtype"):
            tb.solve(max_iter=6, verbose=False, accelerate=acc)


# ---- the accelerated golden -------------------------------------------------

def test_accel_golden_file_is_current():
    """Regenerating the accelerated golden from pbte_tpu reproduces it."""
    for path, build in torch_golden.ACCEL_GOLDENS.items():
        fresh = build()
        with np.load(path) as d:
            assert sorted(d.files) == sorted(fresh), path.name
            for key in d.files:
                np.testing.assert_allclose(fresh[key], d[key], rtol=1e-9,
                                           err_msg=f"{path.name}: {key}")


def test_port_matches_accel_golden_on_cpu():
    """The port's f64 accelerated solve on the CPU against the committed
    golden (chip_smoke.py repeats it on a GPU through the f64 kernel):
    Tc and Tv within 1e-10 of max, the residual and the step count."""
    with np.load(torch_golden.PATH_ACCEL) as d:
        params = {k: int(d[k]) for k in torch_golden.ACCEL_PARAMS}
        bcs = dict(zip(d["bc_attrs"].tolist(), d["bc_temps"].tolist()))
        ref = {k: d[k] for k in ("Tc", "Tv", "residual", "iterations")}
        max_iter = int(d["max_iter"])
    ts = SourceIterationSolver(*unit_cube(**params), bcs,
                               dtype=torch.float64, device="cpu")
    r = ts.solve(tol=0, max_iter=max_iter, verbose=False,
                 accelerate="bicgstab")
    assert r.iterations == int(ref["iterations"])
    for got, key in ((r.Tc, "Tc"), (r.Tv, "Tv")):
        np.testing.assert_allclose(got.numpy(), ref[key], rtol=0,
                                   atol=1e-10 * np.abs(ref[key]).max())
    np.testing.assert_allclose(r.residual, float(ref["residual"]), rtol=1e-8)
