"""Golden Tc of pbte_tpu's Pallas lattice-ring path, for the CUDA port.

``build()`` runs pbte_tpu's SourceIterationSolver with ``use_pallas="on"``
(the Pallas kernel under the Pallas interpreter on the CPU, f32, exact
operands) on a hex 8^3, p=2, 8-direction, nspec=2 problem with the flagship
walls, 5 outer steps from the zero state. ``python tests/torch_golden.py``
writes the result to ``tests/data/torch_port_golden.npz``;
tests/test_torch_solver.py regenerates it and checks it against the
committed file, and chip_smoke.py holds pbte_tpu_torch's CUDA kernel path
on a GPU to it.
"""

from __future__ import annotations

import pathlib

import numpy as np

PATH = pathlib.Path(__file__).resolve().parent / "data" / "torch_port_golden.npz"
PARAMS = dict(nx=8, ny=8, nz=8, order=2, polar=2, azimuth=4, nspec=2)
STEPS = 5


def build() -> dict:
    import jax.numpy as jnp

    from pbte_tpu.solver.source_iteration import SourceIterationSolver
    from pbte_tpu_torch.problem import WALL_BCS, unit_cube

    s = SourceIterationSolver(*unit_cube(**PARAMS), WALL_BCS,
                              dtype=jnp.float32, use_pallas="on")
    if not (s._use_pallas_ring and s._pallas_interpret):
        raise RuntimeError("the golden must come from the Pallas kernel path")
    u, Tc, Tv = s.initial_state()
    tcs, res = [], []
    for _ in range(STEPS):
        u, Tc, Tv, r = s.step(u, Tc, Tv)
        tcs.append(np.asarray(Tc))
        res.append(float(r))
    attrs = sorted(WALL_BCS)
    return dict(
        **{k: np.int64(v) for k, v in PARAMS.items()},
        steps=np.int64(STEPS),
        bc_attrs=np.array(attrs, dtype=np.int64),
        bc_temps=np.array([WALL_BCS[a] for a in attrs]),
        Tc=np.stack(tcs),  # (steps, ne, D) f32, Tc after each step
        residual=np.array(res),
    )


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import jax

    # the test environment's settings (tests/conftest.py)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    PATH.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(PATH, **build())
    print(f"wrote {PATH}")
