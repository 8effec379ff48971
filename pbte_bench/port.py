"""The system under test, reached through its normal entry points: the
port's host layers build the problem, ``SourceIterationSolver`` with its
defaults picks the sweep as it would for a user."""

from __future__ import annotations

import os
import time
from types import SimpleNamespace

import torch

from pbte_bench import problem

# state types of the traffic files -> (solver dtype, bf16 state switch)
STATES = {"float32": (torch.float32, False), "bfloat16": (torch.float32, True),
          "float64": (torch.float64, False)}


def layers():
    """The program's host layers, under the names ``problem.build`` takes."""
    from pbte_tpu_torch import mesh
    from pbte_tpu_torch.angular import quadrature as angular
    from pbte_tpu_torch.fem import assembly
    from pbte_tpu_torch.material import nongray_smrt as material

    return SimpleNamespace(builtins=mesh, core=mesh, assembly=assembly,
                           angular=angular, material=material)


def state_of(run):
    """The run's state type: the traffic's, or its control's."""
    t = run.traffic
    return t["control"]["state"] if run.control else t["state"]


def build_solver(run):
    """Assemble the problem (its seconds to ``run.spans``) and construct
    the solver on the run's device."""
    from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

    t0 = time.perf_counter()
    ops, quad, tables = problem.build(run.config, layers())
    run.spans["setup.assembly_s"] = time.perf_counter() - t0
    state = state_of(run)
    run.results["state"] = state
    dtype, bf16 = STATES[state]
    saved = os.environ.get("PBTE_RING_STATE_BF16")
    os.environ["PBTE_RING_STATE_BF16"] = "1" if bf16 else "0"
    try:
        solver = SourceIterationSolver(ops, quad, tables,
                                       bc_temps=dict(run.walls), dtype=dtype,
                                       device=run.device)
    finally:
        if saved is None:
            os.environ.pop("PBTE_RING_STATE_BF16")
        else:
            os.environ["PBTE_RING_STATE_BF16"] = saved
    run.results["dof_per_step"] = problem.dof_per_step(ops, quad, tables)
    if run.fault is not None:
        run.fault(solver)
    return solver
