"""The comparisons that decide ``correct``, on the plain reference.

Everything here is plain PyTorch and NumPy and the frozen host layers of
this folder: no module of the program is imported, and nothing the
program made is taken but the outputs under judgement (Tc, Tv and the
residual it reported).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from pbte_bench import problem
from pbte_bench.reference import (angular, fem_assembly, material,
                                  mesh_builtins, mesh_core)
from pbte_bench.reference.sweep import PlainStep


def layers():
    """The frozen host layers, under the names ``problem.build`` takes."""
    return SimpleNamespace(builtins=mesh_builtins, core=mesh_core,
                           assembly=fem_assembly, angular=angular,
                           material=material)


def plain_step(config, walls, device):
    """The reference's step for ``config`` with these walls, in float64 on
    ``device``."""
    ops, quad, tables = problem.build(config, layers())
    return PlainStep(ops, quad, tables, walls, device)


def rel_gap(prog, ref):
    """max |prog - ref| / max |ref| (nan where ``prog`` is not finite)."""
    prog = torch.as_tensor(prog).to(ref.device, torch.float64)
    if prog.shape != ref.shape:
        raise ValueError(f"shape {tuple(prog.shape)} against the "
                         f"reference's {tuple(ref.shape)}")
    return float((prog - ref).abs().max() / ref.abs().max())


def steps_gaps(plain, readings):
    """The program's first steps from the zero state, ``readings`` a list
    of (Tc per fine element, Tv, residual), against as many reference
    steps: the largest gap of Tc and of Tv over the steps (relative to the
    reference's largest value) and of the residual (relative to the
    reference's), from the second step (the first reads 1 on both sides)."""
    u, Tc, Tv = plain.zero_state()
    tc = tv = res = 0.0
    for i, (tc_p, tv_p, res_p) in enumerate(readings):
        u, Tc, Tv, r = plain.step(u, Tc, Tv)
        tc = max(tc, rel_gap(tc_p, Tc))
        tv = max(tv, rel_gap(tv_p, Tv))
        if i:
            res = max(res, abs(float(res_p) - r) / r)
    return {"tc_gap": tc, "tv_gap": tv, "res_gap": res}


def follow_gaps(plain, follow):
    """One program step from a state of its own against the reference's
    step from the same state. ``follow`` is (u, Tc, Tv) in, u as physical
    coefficients (K, BS, ne, D), and (Tc, Tv) out; the gaps of Tc and Tv
    relative to the reference's largest value. (The residual is left out:
    near convergence it is a difference at the state's rounding.)"""
    u, Tc, Tv, tc_p, tv_p = follow
    dev = plain.device
    u = torch.as_tensor(u).to(dev, torch.float64)
    _, Tc, Tv, _ = plain.step(u, Tc.to(dev, torch.float64),
                              Tv.to(dev, torch.float64))
    return {"follow_tc_gap": rel_gap(tc_p, Tc),
            "follow_tv_gap": rel_gap(tv_p, Tv)}


def fixed_point_gap(plain, Tc_prog):
    """How far a solution ``Tc_prog`` (per fine element) is from the fixed
    point: max |G(Tc) - Tc| / max |G(Tc)|, G the unrelaxed source
    iteration map of the reference."""
    Tc = torch.as_tensor(Tc_prog).to(plain.device, torch.float64)
    return rel_gap(Tc, plain.unrelaxed_map(Tc))
