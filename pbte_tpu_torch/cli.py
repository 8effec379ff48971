"""Command-line interface: pbte_tpu's ``python -m pbte_tpu.cli`` on PyTorch.

Usage (the flags, defaults, configs, prints and output files of
``pbte_tpu/cli.py``, which mirrors the reference's ``pbte_demo``):

    python -m pbte_tpu_torch.cli [-m MESH] [-c CONFIG] [-o ORDER] [-r REFINE]
                                 [--tol TOL] [--max-iter N] [--dtype f32|f64]
                                 [--face-mode mfem-parity|consistent]
                                 [--cache-policy full|per-iteration]
                                 [--platform default|cpu] [--out DIR] [--vtu]

Pipeline: load the config and the mesh (file or builtin), scale it by
reference_length, refine, assemble, build the angular quadrature and the
phonon tables (writing the golden-format logs), solve with
``SourceIterationSolver``, dump Tc, the coefficients and the element
integrals, write the 2D temperature slice, the 3D plane and line slices
and the ParaView output.

Where it differs from pbte_tpu's CLI:

- ``--platform default`` solves on the GPU and exits non-zero without one
  (it never falls back to the CPU); ``--platform cpu`` solves on the CPU.
- ``--profile DIR`` runs the solve under ``torch.profiler`` (CPU and, on
  the GPU, CUDA activity) and writes a Chrome trace into DIR, and beside
  it ``pbte_tpu_torch_spans.json``, the program's spans, set-up stages and
  counters (``tracing.report()``).
- ``-p DIRxSPACE`` runs the domain-decomposed solvers over
  ``torch.distributed``: start the ranks with ``torchrun --nproc-per-node
  N`` (N = DIR * SPACE; the environment rendezvous), each rank on its own
  GPU over NCCL where the host has N of them, else over gloo (on one shared
  card, or ``--platform cpu``). As in pbte_tpu, the slab-lattice solver
  takes a class-uniform box lattice and the spatially sharded solver every
  other mesh; a world size other than N exits with pbte_tpu's "needs N
  devices" message. Rank 0 prints and writes every file; the fields are
  gathered, so the dumps equal the serial run's layout, and ``--vtu``
  writes one ``.vtu`` piece per partition under a ``.pvtu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="pbte_tpu_torch", description=__doc__)
    ap.add_argument("-m", "--mesh", default="", help="mesh file or builtin name")
    ap.add_argument("-c", "--config", default="config/config.yaml")
    ap.add_argument("-o", "--order", type=int, default=1)
    ap.add_argument("-r", "--refine", type=int, default=0)
    # angle overrides, negative/empty = use config
    ap.add_argument("-ad", "--angle-dim", type=int, default=-1,
                    help="angular dimension override: 2 (in-plane) or 3")
    ap.add_argument("-ap", "--polar-pts", type=int, default=-1,
                    help="polar point count override")
    ap.add_argument("-az", "--azimuth-pts", type=int, default=-1,
                    help="azimuth point count override")
    ap.add_argument("-aps", "--polar-scheme", default="",
                    choices=["", "gauss", "uniform"],
                    help="polar scheme override")
    ap.add_argument("-aas", "--azimuth-scheme", default="",
                    choices=["", "gauss", "uniform"],
                    help="azimuth scheme override")
    ap.add_argument("--tol", type=float, default=None)
    ap.add_argument("--max-iter", type=int, default=None)
    ap.add_argument("--dtype", choices=["f32", "f64"], default="f64")
    ap.add_argument("--face-mode", choices=["mfem-parity", "consistent"],
                    default="mfem-parity")
    ap.add_argument("--cache-policy",
                    choices=["full", "on-the-fly", "per-iteration", "eigen"],
                    default="full")
    ap.add_argument("--sweep-mode", choices=["auto", "scan", "ring"],
                    default="auto",
                    help="'ring' = the ring sweep: the lattice ring on "
                         "Cartesian box lattices, and off the lattice the "
                         "general ring, which reads each upwind neighbour "
                         "from the levels already solved (auto takes it on "
                         "meshes of at most 8 element classes, upwind level "
                         "gaps of at most 4 and levels of at least 64 "
                         "elements); 'scan' = the compact level-window scan")
    ap.add_argument("--polish-extrapolate", action="store_true",
                    help="after --polish, Aitken-extrapolate the slow "
                         "mode's geometric tail (2 extra exact steps)")
    ap.add_argument("--polish", type=int, default=0, metavar="N",
                    help="after convergence, run N exact-precision "
                         "iterations from the converged state")
    ap.add_argument("--matmul-precision",
                    choices=["default", "high", "highest", "selective"],
                    default="default",
                    help="pbte_tpu's matrix-unit tiers; every one runs the "
                         "same exact float32 products here")
    ap.add_argument("--slice-z", type=float, default=None,
                    help="3D only: sample a z=SLICE_Z plane of T and Q, with "
                         "SLICE_Z in units of reference_length")
    ap.add_argument("--line-slice", nargs=3, type=float, default=None,
                    metavar=("AXIS", "C1", "C2"),
                    help="3D only: sample T and Q along axis AXIS (0/1/2) at "
                         "fixed other coords C1 C2 in units of "
                         "reference_length")
    ap.add_argument("--diffuse", default="",
                    help="comma-separated boundary attrs with DIFFUSE walls "
                         "(legacy BC type 2; lagged)")
    ap.add_argument("--specular", default="",
                    help="comma-separated boundary attrs with SPECULAR walls "
                         "(legacy BC type 3; lagged; axis-aligned faces + "
                         "mirror-symmetric quadrature)")
    ap.add_argument("--periodic", default="",
                    help="comma-separated axes (e.g. '0' or '0,1') to make "
                         "periodic by matching opposite boundary vertices; "
                         "gmsh meshes with $Periodic records pair "
                         "automatically")
    ap.add_argument("--platform", choices=["default", "cpu"], default="default",
                    help="'default' solves on the GPU (and fails without "
                         "one); 'cpu' on the CPU")
    ap.add_argument("--out", default="output")
    ap.add_argument("--vtu", action="store_true", help="write ParaView VTU output")
    ap.add_argument("--vtu-every", type=int, default=0, metavar="N",
                    help="write a ParaView time-series collection (.pvd + "
                         "cycle directories) every N outer iterations")
    ap.add_argument("--no-dumps", action="store_true",
                    help="skip golden-format log dumps")
    ap.add_argument("--check-every", type=int, default=1)
    ap.add_argument("--accelerate", choices=["none", "bicgstab"],
                    default="none",
                    help="Krylov-accelerate the outer iteration: 'bicgstab' "
                         "solves the same fixed point as a linear system "
                         "with one plain step per matvec")
    ap.add_argument("--checkpoint", default="",
                    help="checkpoint file path (npz); written every "
                         "--checkpoint-every iterations during the solve")
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true",
                    help="resume the solve from --checkpoint if it exists")
    ap.add_argument("--profile", default="",
                    help="write a torch.profiler Chrome trace of the solve "
                         "and the program's spans and counters into this "
                         "directory")
    ap.add_argument("-p", "--parallel", default="",
                    help="the domain-decomposed solver over a DIRxSPACE "
                         "grid of ranks (start them with torchrun "
                         "--nproc-per-node DIR*SPACE)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    n_dir = n_space = 1
    if args.parallel:
        try:
            n_dir, n_space = (int(x) for x in args.parallel.lower().split("x"))
        except ValueError:
            raise SystemExit(
                f"--parallel expects DIRxSPACE (e.g. 2x4), got "
                f"{args.parallel!r}")
        from pbte_tpu_torch.parallel.comm import env_rank

        rank, world, local_rank = env_rank()
        if world != n_dir * n_space:
            raise SystemExit(
                f"--parallel {args.parallel} needs {n_dir * n_space} devices, "
                f"found {world} (start the ranks with torchrun "
                f"--nproc-per-node {n_dir * n_space})")
    if args.accelerate != "none":
        # Krylov recurrences need exact-dtype state; override the bf16
        # state-storage flag before the solver is constructed
        os.environ["PBTE_RING_STATE_BF16"] = "0"

    import numpy as np
    import torch

    from pbte_tpu_torch import mesh as pmesh
    from pbte_tpu_torch import tracing
    from pbte_tpu_torch.angular import quadrature as ang
    from pbte_tpu_torch.config import RunConfig, load_run_config
    from pbte_tpu_torch.fem import assembly
    from pbte_tpu_torch.io import writers
    from pbte_tpu_torch.io.slice import write_2d_slice
    from pbte_tpu_torch.material import nongray_smrt
    from pbte_tpu_torch.mesh.summary import write_summary
    from pbte_tpu_torch.solver.source_iteration import (
        SourceIterationSolver,
        checked_device,
    )
    from pbte_tpu_torch.sweep import planner

    def _stage_s(stage):
        """Host seconds of the set-up stage ``pbte.setup.<stage>`` so far
        (``tracing``)."""
        return tracing.report()["stages"].get(f"pbte.setup.{stage}",
                                              {}).get("host_s", 0.0)

    # the card unless the CPU is asked for; without a GPU stop here, before
    # any file is written
    try:
        device = checked_device("cpu" if args.platform == "cpu" else "cuda")
    except RuntimeError as e:
        raise SystemExit(f"[pbte_tpu_torch] {e}")
    grid = None
    lead = True  # the rank that prints and writes
    if args.parallel:
        from pbte_tpu_torch.parallel.comm import Grid, init_process_group

        if (device.type == "cuda"
                and torch.cuda.device_count() >= n_dir * n_space):
            device = torch.device("cuda", local_rank)  # NCCL, a card a rank
            torch.cuda.set_device(device)
        init_process_group(n_dir * n_space, rank, device=device)
        grid = Grid(dir=n_dir, space=n_space)
        lead = grid.rank == 0
        if not lead:
            sys.stdout = open(os.devnull, "w")  # rank 0 speaks

    def host(t):
        if isinstance(t, np.ndarray):
            return t
        return t.detach().cpu().numpy()

    if os.path.exists(args.config):
        rc = load_run_config(args.config)
    else:
        rc = RunConfig()
        print(f"[pbte_tpu_torch] config {args.config} not found; using "
              "defaults")
    # CLI angle overrides take precedence over the YAML block (negative /
    # empty = keep config); applied before the BC defaulting below, which
    # keys off the angular dimension
    ang_over = {}
    if args.angle_dim > 0:
        ang_over["dimension"] = args.angle_dim
    if args.polar_pts > 0:
        ang_over["polar_points"] = args.polar_pts
    if args.azimuth_pts > 0:
        ang_over["azimuth_points"] = args.azimuth_pts
    if args.polar_scheme:
        ang_over["polar_scheme"] = args.polar_scheme
    if args.azimuth_scheme:
        ang_over["azimuth_scheme"] = args.azimuth_scheme
    if ang_over:
        rc.angles = dataclasses.replace(rc.angles, **ang_over)
    if not rc.bc_temps:
        # default isothermal BCs for builtin Cartesian meshes: top boundary
        # hot (+0.5), all others cold (-0.5), the reference demo's setup
        hot = 3 if rc.angles.dimension == 2 else 6
        nattr = 4 if rc.angles.dimension == 2 else 6
        rc.bc_temps = {a: (0.5 if a == hot else -0.5)
                       for a in range(1, nattr + 1)}
        print(f"[pbte_tpu_torch] no boundary_conditions configured; using "
              f"defaults {rc.bc_temps}")
    if args.mesh:
        rc.mesh_spec = args.mesh
    if args.diffuse:
        attrs = [int(x) for x in args.diffuse.split(",")]
        rc.diffuse_attrs = sorted(set(rc.diffuse_attrs) | set(attrs))
        for a in attrs:
            rc.bc_temps.pop(a, None)  # the flag overrides a default/iso BC
    if args.specular:
        attrs = [int(x) for x in args.specular.split(",")]
        rc.specular_attrs = sorted(set(rc.specular_attrs) | set(attrs))
        for a in attrs:
            rc.bc_temps.pop(a, None)
    rc.order = args.order
    rc.refine = args.refine
    if args.tol is not None:
        rc.tolerance = args.tol
    if args.max_iter is not None:
        rc.max_iter = args.max_iter
    rc.output_dir = args.out

    log_dir = os.path.join(rc.output_dir, "log")
    if lead:
        os.makedirs(log_dir, exist_ok=True)

    m = pmesh.load_mesh(rc.mesh_spec)
    m = m.scaled(rc.material.ref_len)
    m = pmesh.uniform_refine(m, rc.refine)
    if args.periodic:
        axes = [int(x) for x in args.periodic.split(",")]
        m = pmesh.make_periodic(m, axes)
    topo = pmesh.connect(m)
    n_per = int(topo.elem_face_periodic.sum())
    if (rc.periodic_attrs or args.periodic) and n_per == 0:
        raise SystemExit(
            "[pbte_tpu_torch] periodic boundaries requested but no face "
            "pairs matched (mesh lacks $Periodic records; try --periodic "
            "AXES)"
        )
    print(f"[pbte_tpu_torch] mesh: {m.geom} dim={m.dim} ne={m.num_elements} "
          f"nv={m.num_vertices}"
          + (f" periodic_faces={n_per}" if n_per else "")
          + f" (connect {_stage_s('connect'):.1f}s)")

    ops = assembly.assemble(topo, order=rc.order, face_mode=args.face_mode)
    print(f"[pbte_tpu_torch] assembled p={rc.order} D={ops.ndof} "
          f"faces/elem={ops.faces_per_elem} (assemble "
          f"{_stage_s('assemble'):.1f}s, face traces "
          f"{_stage_s('face_trace'):.1f}s)")

    quad = ang.build(rc.angles)
    tables = nongray_smrt.build_tables(rc.material, num_spectral=rc.n_spectral)
    print(f"[pbte_tpu_torch] angles: K={quad.num_directions} total_weight="
          f"{quad.total_weight:.6g}; bands: {tables.num_branches}x"
          f"{tables.num_spectral}; HeatCapV={tables.heat_cap_v:.6g} "
          f"(angles {_stage_s('angles'):.1f}s, tables "
          f"{_stage_s('tables'):.1f}s)")

    if not args.no_dumps and lead:
        mesh_name = os.path.splitext(os.path.basename(str(rc.mesh_spec)))[0]
        scheme_p = rc.angles.polar_scheme
        scheme_a = rc.angles.azimuth_scheme
        tag = (f"dim{rc.angles.dimension}_np{rc.angles.polar_points}_{scheme_p}"
               f"_na{rc.angles.azimuth_points}_{scheme_a}")
        write_summary(topo, rc.order, ops.ndof * m.num_elements,
                      os.path.join(log_dir,
                                   f"mesh_{mesh_name}_p{rc.order}_dim{m.dim}.txt"))
        ang.write_quadrature(quad, os.path.join(log_dir, f"angles_{tag}.txt"))
        planner.write_sweep_orders(quad, topo,
                                   os.path.join(log_dir, f"sweep_{tag}.txt"))
        nongray_smrt.write_tables(tables,
                                  os.path.join(log_dir, "phonon_properties.txt"))

    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    bc_kw = dict(dirichlet_bcs=rc.dirichlet_bcs or None,
                 diffuse_bcs=rc.diffuse_attrs or None,
                 specular_bcs=rc.specular_attrs or None)
    if grid is not None:
        from pbte_tpu_torch.parallel.slab import SlabLatticeSolver
        from pbte_tpu_torch.parallel.spatial import SpatialShardedSolver

        if args.cache_policy != "full" or args.matmul_precision != "default":
            print("[pbte_tpu_torch] WARNING: --cache-policy/--matmul-precision "
                  "are not supported by the --parallel solver (it always "
                  "builds the full A^-1 cache at default precision); "
                  "ignoring")
        # the slab-lattice ring decomposition (K1 in each shard); general
        # meshes take the spatially sharded solver
        try:
            solver = SlabLatticeSolver(ops, quad, tables, rc.bc_temps, grid,
                                       dtype=dtype, device=device, **bc_kw)
            print(f"[pbte_tpu_torch] slab-lattice solver: grid (dir={n_dir}, "
                  f"space={n_space}), slabs={solver.P} along axis "
                  f"{solver.a0}, W={solver.W} L={solver.L} on {device} "
                  f"(solver {_stage_s('solver'):.1f}s)")
        except NotImplementedError as e:
            solver = SpatialShardedSolver(ops, quad, tables, rc.bc_temps,
                                          grid, dtype=dtype, topo=topo,
                                          device=device, **bc_kw)
            print(f"[pbte_tpu_torch] parallel solver (general mesh: {e}): "
                  f"grid (dir={n_dir}, space={n_space}), "
                  f"partitions={solver.pplan.nparts} "
                  f"interface={solver.pplan.num_interface} "
                  f"edge_cut={solver.pplan.edge_cut()} "
                  f"load_balance={solver.pplan.load_balance():.2f} "
                  f"on {device} (solver {_stage_s('solver'):.1f}s)")
    else:
        solver = SourceIterationSolver(
            ops, quad, tables, rc.bc_temps, dtype=dtype, device=device,
            sweep_mode=args.sweep_mode,
            cache_policy=args.cache_policy,
            matmul_precision=(None if args.matmul_precision == "default"
                              else args.matmul_precision),
            **bc_kw,
        )
        print(f"[pbte_tpu_torch] solver[{solver.sweep_mode}]: "
              f"groups={solver.plan.num_groups} "
              f"levels<={solver.plan.max_levels} "
              f"width<={solver.plan.max_width} "
              f"padding={solver.plan.padding_ratio():.1%} "
              f"slab={solver.L}x{solver.W} on {device} "
              f"(solver {_stage_s('solver'):.1f}s)")

    state = None
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        from pbte_tpu_torch.io.checkpoint import load_checkpoint

        state, ck_it, ck_res = load_checkpoint(args.checkpoint, solver)
        print(f"[pbte_tpu_torch] resumed from {args.checkpoint} "
              f"(iteration {ck_it}, residual {ck_res:.3e})")

    history = []
    solve_kw = dict(
        tol=rc.tolerance, max_iter=rc.max_iter, state=state,
        check_every=args.check_every,
        callback=lambda it, r: history.append((it, r)),
        checkpoint_path=args.checkpoint or None,
        checkpoint_every=args.checkpoint_every,
    )
    if args.accelerate != "none":
        solve_kw["accelerate"] = args.accelerate
    if args.polish > 0:
        solve_kw["polish_iters"] = args.polish
        solve_kw["polish_extrapolate"] = args.polish_extrapolate
    pv_coll = None
    if args.vtu_every > 0:
        from pbte_tpu_torch.io.vtu import ParaViewCollection

        # parallel runs write one .vtu piece per partition under each
        # cycle's .pvtu
        pv_coll = ParaViewCollection(
            m, rc.order, name="pbte_fields",
            root=os.path.join(rc.output_dir, "vis"),
            part=solver.element_partition if grid is not None else None,
        )

        def _cycle_hook(it, u_c, Tc_c, Tv_c):
            Qc_c = host(solver.heat_flux(u_c)[0])
            Tc_c = (solver.gather_Tc(Tc_c) if grid is not None
                    else host(solver.Tc_fine(Tc_c)))
            if lead:
                pv_coll.save({"T": Tc_c}, {"Q": Qc_c}, cycle=it)

        solve_kw["cycle_hook"] = _cycle_hook
        solve_kw["cycle_every"] = args.vtu_every
    t1 = time.time()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            res = solver.solve(**solve_kw)
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "pbte_tpu_torch_trace.json")
        prof.export_chrome_trace(trace)
        print(f"[pbte_tpu_torch] profiler trace written to {trace}")
        spans = os.path.join(args.profile, "pbte_tpu_torch_spans.json")
        with open(spans, "w") as f:
            json.dump(tracing.report(), f, indent=1, sort_keys=True)
        print(f"[pbte_tpu_torch] spans and counters written to {spans}")
    else:
        res = solver.solve(**solve_kw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_solve = time.time() - t1
    dof_swept = (res.iterations * solver.K * solver.BS
                 * m.num_elements * ops.ndof)
    print(f"[pbte_tpu_torch] done: {res.iterations} iters, residual "
          f"{res.residual:.3e}, {t_solve:.2f}s, "
          f"{dof_swept / max(t_solve, 1e-9):.3e} element-ordinate DOF/s")

    # step-residual history (the legacy PBTE_NonGraySMRT_step_resisual.txt,
    # its typo kept)
    hist_dir = os.path.join(rc.output_dir, f"{m.dim}D/log")
    if lead:
        os.makedirs(hist_dir, exist_ok=True)
        with open(os.path.join(hist_dir,
                               "PBTE_NonGraySMRT_step_resisual.txt"),
                  "w") as f:
            for it, r in history:
                f.write(f"{it} {r}\n")

    # the outputs do not depend on -p: the sharded fields are gathered
    # (collective: every rank takes part)
    Tc_out = (res.Tc_global() if grid is not None
              else host(solver.Tc_fine(res.Tc)))
    if not args.no_dumps:
        u_dirs = res.u_dirs()
        if lead:
            writers.write_temperature(Tc_out,
                                      os.path.join(log_dir, "Tc_all.txt"))
            writers.write_coefficients(u_dirs, quad, tables.num_branches,
                                       os.path.join(log_dir, "coeff_all.txt"))
            writers.write_element_integrals(
                ops, os.path.join(log_dir, "integrals_all.txt"))
    need_q = ((m.dim == 3 and (args.slice_z is not None
                               or args.line_slice is not None))
              or pv_coll is not None or args.vtu)
    Qc = host(solver.heat_flux(res.u)[0]) if need_q else None
    if not lead:
        import torch.distributed as dist

        dist.destroy_process_group()
        return 0
    if m.dim == 2:
        write_2d_slice(m, rc.order, Tc_out,
                       os.path.join(rc.output_dir, "2D/results/T_slice.txt"),
                       100, 100)
        print(f"[pbte_tpu_torch] 2D temperature slice written to "
              f"{rc.output_dir}/2D/results/T_slice.txt")
    if m.dim != 3 and (args.slice_z is not None or args.line_slice is not None):
        print("[pbte_tpu_torch] WARNING: --slice-z/--line-slice are 3D-only; "
              f"ignored for this {m.dim}D mesh")
    if m.dim == 3 and (args.slice_z is not None or args.line_slice is not None):
        from pbte_tpu_torch.io.slice import write_3d_line_slice, write_3d_slice

        res_dir = os.path.join(rc.output_dir, "3D/results")
        # slice coordinates are in units of reference_length (the legacy
        # code's z = 0.4 * L_REF); the mesh itself is in metres
        scale = rc.material.ref_len
        if args.slice_z is not None:
            path = os.path.join(res_dir, "T_slice_z.txt")
            write_3d_slice(m, rc.order, Tc_out, Qc, args.slice_z * scale,
                           path)
            print(f"[pbte_tpu_torch] 3D plane slice written to {path}")
        if args.line_slice is not None:
            axis, c1, c2 = args.line_slice
            path = os.path.join(res_dir, "T_line.txt")
            write_3d_line_slice(m, rc.order, Tc_out, Qc, int(axis),
                                c1 * scale, c2 * scale, path)
            print(f"[pbte_tpu_torch] 3D line slice written to {path}")
    if pv_coll is not None:
        pvd = pv_coll.save({"T": Tc_out}, {"Q": Qc}, cycle=res.iterations)
        print(f"[pbte_tpu_torch] ParaView collection written to {pvd}")
    if args.vtu:
        if grid is not None:
            from pbte_tpu_torch.io.vtu import write_pvtu

            part = solver.element_partition
            pieces = [(ids, {"T": Tc_out[ids]}, {"Q": Qc[:, ids]})
                      for p in range(int(part.max()) + 1)
                      for ids in (np.flatnonzero(part == p),)]
            write_pvtu(m, rc.order, pieces,
                       os.path.join(rc.output_dir, "vis/pbte_fields"))
        else:
            from pbte_tpu_torch.io.vtu import write_vtu

            write_vtu(m, rc.order, {"T": Tc_out}, {"Q": Qc},
                      os.path.join(rc.output_dir, "vis/pbte_fields"))
        print(f"[pbte_tpu_torch] ParaView output written to "
              f"{rc.output_dir}/vis/")
    if grid is not None and grid.size > 1:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
