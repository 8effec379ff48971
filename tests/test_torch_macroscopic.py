"""pbte_tpu_torch.models.macroscopic against pbte_tpu.models.macroscopic:
the same numpy inputs through the JAX functions and their PyTorch ports."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pbte_tpu.models import macroscopic as jmac
from pbte_tpu_torch.models import macroscopic as tmac

# f64: both sides are one contraction of the same numbers, only the
# summation order differs; f32: a few ulps of the reduction
RTOL = {np.float64: 1e-12, np.float32: 1e-6}
TORCH = {np.float64: torch.float64, np.float32: torch.float32}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _inputs(dt, seed=0, tv_scale=1.0):
    rng = np.random.default_rng(seed)
    K, BS, ne, D = 6, 4, 20, 8
    u = rng.standard_normal((K, BS, ne, D)).astype(dt)
    w = rng.random((K, BS)).astype(dt)
    basis = rng.random((ne, D)).astype(dt)
    tv = (tv_scale * rng.standard_normal(ne)).astype(dt)
    tv_prev = (tv_scale * rng.standard_normal(ne)).astype(dt)
    return u, w, basis, tv, tv_prev


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_compute_tc_tv(dt):
    u, w, basis, _, _ = _inputs(dt)
    tc_j = np.array(jmac.compute_tc(jnp.asarray(u), jnp.asarray(w)))
    tc_t = tmac.compute_tc(torch.from_numpy(u), torch.from_numpy(w))
    assert tc_t.dtype == TORCH[dt]
    np.testing.assert_allclose(tc_t.numpy(), tc_j, rtol=RTOL[dt],
                               atol=RTOL[dt] * np.abs(tc_j).max())
    tv_j = np.asarray(jmac.compute_tv(jnp.asarray(tc_j), jnp.asarray(basis)))
    tv_t = tmac.compute_tv(torch.from_numpy(tc_j), torch.from_numpy(basis))
    np.testing.assert_allclose(tv_t.numpy(), tv_j, rtol=RTOL[dt],
                               atol=RTOL[dt] * np.abs(tv_j).max())


@pytest.mark.parametrize("dt,scale", [
    (np.float64, 1.0),
    (np.float32, 1.0),
    # micron-scale 3D cell integrals: squaring them underflows float32
    # unless the residual pre-scales by max|Tv|
    (np.float32, 1e-22),
])
def test_residual(dt, scale):
    _, _, _, tv, tv_prev = _inputs(dt, seed=1, tv_scale=scale)
    r_j = float(jmac.residual(jnp.asarray(tv), jnp.asarray(tv_prev)))
    r_t = tmac.residual(torch.from_numpy(tv), torch.from_numpy(tv_prev))
    assert r_t.dtype == TORCH[dt]
    assert np.isfinite(r_j) and r_j > 0.1
    np.testing.assert_allclose(float(r_t), r_j, rtol=RTOL[dt])


def test_residual_zero_tv_is_finite_like_jax():
    """An all-zero Tv (the initial state) hits the tiny clamp on both
    sides: 0/0 gives nan in both, not an exception."""
    z = np.zeros(5, np.float32)
    r_j = float(jmac.residual(jnp.asarray(z), jnp.asarray(z)))
    r_t = float(tmac.residual(torch.from_numpy(z), torch.from_numpy(z)))
    assert np.isnan(r_j) and np.isnan(r_t)


def test_weights_are_pbte_tpu_host_math():
    """The port's own copies of the weight functions give pbte_tpu's
    numbers bit for bit on pbte_tpu's quadrature and tables (the port's
    own quadrature and tables: tests/test_torch_host_layers.py)."""
    from pbte_tpu.angular import quadrature as ang
    from pbte_tpu.material import nongray_smrt as mat

    assert tmac.macro_weights is not jmac.macro_weights
    quad = ang.build(ang.AngularOptions(dimension=3, polar_points=2,
                                        azimuth_points=8))
    tables = mat.build_tables(mat.SILICON, num_spectral=3)
    np.testing.assert_array_equal(tmac.macro_weights(quad, tables),
                                  jmac.macro_weights(quad, tables))
    for dim in (2, 3):
        np.testing.assert_array_equal(tmac.flux_weights(quad, tables, dim),
                                      jmac.flux_weights(quad, tables, dim))
