"""The legacy solid-angle patterns of Control.yaml configurations.

This package's own copy of ``pbte_tpu/angular/legacy_patterns.py``
(``SolidAngle(dim, npole, nazim, pattern)`` of the legacy code). Both
patterns return an ``AngularQuad`` with directions pole-major.

Pattern 1 (octant-symmetric Gauss product):
- 2D: Gauss on phi in [0, pi/2] reflected into the 4 quadrants
  (nazim % 4 == 0); the pole axis replicates npole times with unit polar
  weight.
- 3D: Gauss on mu = cos(theta) in [-1, 0] mirrored to the upper hemisphere
  (npole % 2 == 0) x the reflected azimuth set; weight w_mu * w_phi.

Pattern 2 (hemisphere-split Gauss):
- 2D: Gauss on phi in [0, pi] plus [pi, 2pi], the second half reversed.
- 3D: Gauss on theta in [0, pi] (weight with the sin(theta) Jacobian) x
  the split azimuth.

Neither pattern renormalizes the total weight (the legacy code does not).
"""

from __future__ import annotations

import numpy as np

from pbte_tpu_torch.angular.quadrature import AngularQuad, gauss_legendre_rule


def _reflected_azimuth(nazim: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gauss on [0, pi/2] reflected into 4 quadrants -> cos, sin, w (nazim,)."""
    if nazim % 4 != 0:
        raise ValueError("pattern 1 requires nazim % 4 == 0")
    n4 = nazim // 4
    phi, w = gauss_legendre_rule(n4, 0.0, np.pi / 2.0)
    c, s = np.cos(phi), np.sin(phi)
    cos_phi = np.concatenate([c, -c[::-1], -c, c[::-1]])
    sin_phi = np.concatenate([s, s[::-1], -s, -s[::-1]])
    w_phi = np.concatenate([w, w[::-1], w, w[::-1]])
    return cos_phi, sin_phi, w_phi


def build_legacy(dim: int, npole: int, nazim: int, pattern: int) -> AngularQuad:
    if dim not in (2, 3) or pattern not in (1, 2):
        raise ValueError("wrong parameters for solid angle discretization")

    if pattern == 1:
        if dim == 2:
            cos_phi, sin_phi, w_phi = _reflected_azimuth(nazim)
            dirs = np.stack([cos_phi, sin_phi, np.zeros(nazim)], axis=-1)
            dirs = np.tile(dirs, (npole, 1))
            weights = np.tile(w_phi, npole)
            polar = np.full(npole * nazim, np.pi / 2)
            azim = np.tile(np.arctan2(sin_phi, cos_phi) % (2 * np.pi), npole)
            pol_nodes = np.full(npole, np.pi / 2)
            pol_w = np.ones(npole)
            az_nodes = np.arctan2(sin_phi, cos_phi) % (2 * np.pi)
            az_w = w_phi
        else:
            if npole % 2 != 0 or nazim % 4 != 0:
                raise ValueError("pattern 1 requires npole % 2 == 0 and nazim % 4 == 0")
            n2 = npole // 2
            mu, w_mu = gauss_legendre_rule(n2, -1.0, 0.0)
            cos_theta = np.concatenate([-mu, mu[::-1]])
            w_theta = np.concatenate([w_mu, w_mu[::-1]])
            sin_theta = np.sqrt(1.0 - cos_theta**2)
            cos_phi, sin_phi, w_phi = _reflected_azimuth(nazim)

            dirs = np.stack(
                [
                    np.outer(sin_theta, cos_phi).reshape(-1),
                    np.outer(sin_theta, sin_phi).reshape(-1),
                    np.repeat(cos_theta, nazim),
                ],
                axis=-1,
            )
            weights = np.outer(w_theta, w_phi).reshape(-1)
            polar = np.repeat(np.arccos(cos_theta), nazim)
            azim = np.tile(np.arctan2(sin_phi, cos_phi) % (2 * np.pi), npole)
            pol_nodes = np.arccos(cos_theta)
            pol_w = w_theta
            az_nodes = np.arctan2(sin_phi, cos_phi) % (2 * np.pi)
            az_w = w_phi
    else:  # pattern 2
        if nazim % 2 != 0:
            raise ValueError("pattern 2 requires nazim % 2 == 0")
        n2 = nazim // 2
        phi1, w1 = gauss_legendre_rule(n2, 0.0, np.pi)
        phi2, w2 = gauss_legendre_rule(n2, np.pi, 2.0 * np.pi)
        if dim == 2:
            # legacy reverses the second half in 2D only
            phi = np.concatenate([phi1, phi2[::-1]])
            w_phi = np.concatenate([w1, w2[::-1]])
            dirs = np.stack([np.cos(phi), np.sin(phi), np.zeros(nazim)], axis=-1)
            dirs = np.tile(dirs, (npole, 1))
            weights = np.tile(w_phi, npole)
            polar = np.full(npole * nazim, np.pi / 2)
            azim = np.tile(phi, npole)
            pol_nodes = np.full(npole, np.pi / 2)
            pol_w = np.ones(npole)
            az_nodes, az_w = phi, w_phi
        else:
            phi = np.concatenate([phi1, phi2])
            w_phi = np.concatenate([w1, w2])
            theta, w_theta = gauss_legendre_rule(npole, 0.0, np.pi)
            st, ct = np.sin(theta), np.cos(theta)
            dirs = np.stack(
                [
                    np.outer(st, np.cos(phi)).reshape(-1),
                    np.outer(st, np.sin(phi)).reshape(-1),
                    np.repeat(ct, nazim),
                ],
                axis=-1,
            )
            weights = np.outer(st * w_theta, w_phi).reshape(-1)
            polar = np.repeat(theta, nazim)
            azim = np.tile(phi, npole)
            pol_nodes, pol_w = theta, w_theta
            az_nodes, az_w = phi, w_phi

    return AngularQuad(
        dimension=dim,
        polar=polar,
        azimuth=azim,
        weights=weights,
        directions=dirs,
        polar_nodes=pol_nodes,
        polar_weights=pol_w,
        azimuth_nodes=az_nodes,
        azimuth_weights=az_w,
    )
