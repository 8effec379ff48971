"""GPU smoke run of pbte_tpu_torch: build the CUDA kernels, hold each to its
plain PyTorch version at the shapes its path gives it, run the flagship
source iteration (isothermal walls, diffuse walls, bf16 state, and in
float64 through the BiCGStab-accelerated solve) and the copy probe through
them, run the legacy production tet shape through the scan path and the
supercell ring, run the lattices of K1's tiled kernel, a 2D quad lattice
and a graded lattice, check the results against the pbte_tpu goldens, and
run the command-line interface at the flagship's width and as a subprocess,
the general ring, and the sharded solvers on ranks sharing the card.

Usage (from the root of a checkout, on a machine with one CUDA GPU):

    python3 chip_smoke.py

Phases (a failing phase raises and the script exits non-zero):

1. versions, the device and its power limit (no GPU: exit 1);
2. nvcc builds of pbte_tpu_torch/csrc/lattice_ring.cu (K1's one-CTA
   kernels), csrc/lattice_ring_tiled.cu (K1's tiled kernels) and
   csrc/dma_copy.cu (K2, K3), concurrently, with the ptxas register /
   shared-memory reports of every kernel, and the registers and spill of
   each float64 one-CTA K1 instantiation and of each tiled K1
   instantiation on lines of their own (a tiled one that spills fails the
   phase);
3. K1 vs plain version at the flagship's two Km-bucket shapes, with the
   solver's real operators and seeded random state, for f32 state, bf16
   state, f64 state (the float64 kernel, with the operators in float64), a
   Dirichlet source and a random sparse lagged closure source:
   errors, CUDA-event times, and each launch's bound (the larger of its
   bytes over 3.35 TB/s and its flop over the tensor-core peak of its
   state type) with the share of it the kernel reaches. Then the same with
   the flagship's hull windows (the solver's default), the random inputs
   zeroed outside the windows as the windows' contract asks: the windowed
   kernel is held to the windowed plain version at the same tolerances and
   to the full-slab kernel on the same inputs (ys and ms bit for bit: the
   band sum of ms runs in band order), timed in turns with it, and
   both bounds are printed (full slab; in-window slots only); the
   wrapper's shared-memory sizes against the library's, in all three types.
   Then the same kernel-vs-plain cases (each state type, full slab and
   windowed, with the launch plan on the line) at four shapes no earlier
   phase gives K1: hex 16^3 p=3 (D = 64, the p3_f32 row's lattice: the
   tiled kernel; its factor and boundary source seeded random, its
   inflow coefficients and windows the lattice's own), the p=3 golden's
   lattice (hex 17x17x4, W = 68, the same way), the wide hex 24^3 p=2
   (W = 576, flagship angles and bands: the tiled kernel, the last Km
   bucket) and quad 64^2 p=2 (D = 9, two faces: the one-CTA kernel); and
   at four shapes past the 16 CTAs a level of the earlier cluster kernel
   (``BEYOND_CEILING``: D = 64 at W = 784 f64, 1600 f32 and 3600 bf16,
   D = 8 at W = 4225 f32, each in its state type, with bench_k1's
   synthetic operands at a small L, Gb, Km and BS, full slab and with
   windows that grow and shrink across tile boundaries); every case
   launches the kernel twice more on its inputs (phase 16 (a));
4. the copy probe (python -m pbte_tpu_torch.bench_dma): every K2 and K3
   configuration held bit-exact (torch.equal) to its input at small and
   ragged totals (one vector, a block less 16 bytes, a block plus 16 bytes,
   fewer blocks than CTAs, many blocks and a ragged end), then at 512 MB
   f32 to its input and to the plain copy, then the probe's sweep (each row
   timed in turns with the plain copy) with the launch counts read around
   it; GB/s, the kernel/plain rate ratios, and K1's bucket-0 bytes/s as a
   share of the best copy rate;
5. the flagship (hex 16^3, p=2, 64 directions x 40 bands, f32), with hull
   windows as the solver takes them by default: setup, 2 warm-up + 30 timed
   steps, ms/step, element-ordinate DOF/s, peak memory, residuals, kernel
   launches; then 3 steps through the kernel and through the plain version
   from one state; then ``solve(accelerate="compensated")``, 4 iterations
   (the state carried as a compensated sum of two trees, two step
   applications an iteration and a residual step every 2) with its K1
   launches (a count of calls of K1's plain version must stay 0) and Tc
   against as many plain steps' (``COMPENSATED_RTOL`` of max);
6. the same flagship as a film: x faces isothermal, the other four diffuse
   (the lagged closure through K1's xsrc), measured as phase 5; then the
   flagship with bf16 state (PBTE_RING_STATE_BF16=1), the same way;
7. the golden Tc of pbte_tpu's Pallas path (tests/data/torch_port_golden.npz)
   and of its XLA ring with periodic, diffuse and specular walls
   (tests/data/torch_port_golden_closures.npz) against the port on the GPU,
   the float64 BiCGStab golden of its XLA ring
   (tests/data/torch_port_golden_accel.npz) against the port's float64
   kernel path, and the golden of its f32 scan path on a 3^3 6-tet cube
   with diffuse walls (tests/data/torch_port_golden_scan.npz) against the
   port's scan on the GPU, and the golden of its f32 supercell ring on a
   3x2x2 6-tet box at p=2 (tests/data/torch_port_golden_super.npz) against
   the port's supercell ring on the GPU;
8. the f64 flagship (the f32 solvers freed first, so the peak is its own):
   set-up, 2 + 30 timed steps and 3 steps kernel vs plain as phase 5; then
   solve(accelerate="bicgstab", tol=1e-8) with its K1 launches (2 per step
   application: nothing fell back to the plain version), wall time, linear
   relres, Tv residual and peak memory, and the same solve once more from
   the zero state (phase 16 (b)); the plain f64 solve to the same Tv
   residual, its steps, seconds and Tc against the accelerated one; and
   refined_solve with the f32 flagship solver as the base and the f64
   solver's step as the defect step: the defect before and after one round,
   the correction steps, and the bound ||d(x_ref)|| / (1 - rho) with rho
   the plain solve's rate over its last steps;
9. the reference's legacy production tet shape through the scan path
   (``problem.tet_cube(**LEGACY_TET)``: the 5^3 6-tet cuboid, p=3, 16x24
   = 384 directions, 2x20 bands, f32, ``sweep_mode="scan"`` with the
   class-batched full factor cache): set-up, 2 warm-up + 10 timed steps,
   ms/step, element-ordinate DOF/s, peak memory; from torch.profiler over
   2 more steps the CUDA launches per step, the device's busy share (its
   kernel time over the wall time of those same steps) and the top kernels
   and ops by device time (a profiler that sees no device activity fails
   the phase); then 3 steps in f32 against 3 in f64 from the zero state,
   and 3 f32 steps with the class streams (``scan.CLASS_OPS_BUDGET``, a
   memory fallback this shape does not reach) forced, against the f32
   steps. The scan path runs as torch ops (pbte_tpu's scan reaches no
   Pallas kernel), so no kernel of the kernels line launches in it;
10. the same legacy tet shape with the solver's defaults (phase 9's scan
   solver freed first, so the peak is the ring's own), asserted to resolve
   to the supercell ring (G = 8, D' = 120, L = 13, W = 25): set-up with the
   factor build's seconds on a line of their own, 2 warm-up + 10 timed
   steps, ms/step, element-ordinate DOF/s, peak memory; launches per step,
   busy share and top kernels and ops from torch.profiler over 2 more
   steps; and 3 f32 steps from the zero state against phase 9's 3 f32 scan
   steps (iterate-exact paths, held at 2e-6 of max), then 3 float64 steps
   against phase 9's float64 scan steps (1e-11 of max); between them, the
   same shape with ``PBTE_RING_STATE_BF16=1``, asserted to take the
   supercell ring with bf16 state: set-up, 2 warm-up steps, 10 steps in
   turns with the f32 ring (each step timed by CUDA events), ms/step of
   both, its own peak memory, torch.profiler's launches and top ops over 2
   steps, 3 steps from the zero state against the f32 ring's 3 (3e-3 of
   max) and finite, falling residuals. The ring is torch products
   (pbte_tpu's supercell body reaches no Pallas kernel): no kernel of the
   kernels line launches in it, and the phase fails if K1 does;
11. the lattices no earlier phase solves: the wide hex 24^3 p=2 with the
   flagship's angles and bands (13,824 elements, W = 576) in f32
   (``wide_f32``), bf16 and f64 state, and quad 64^2 p=2 (16 azimuths, 40
   bands), each with set-up, 2 + 10 timed steps, ms/step, DOF/s, peak
   memory and K1's launches by variant (the tiled kernel for the wide
   lattice, the one-CTA kernel for the quads; a count of calls of K1's
   plain version must stay 0); then the graded hex 16^3 p=2 (x spacing
   alternating 1 : 2, two geometry classes) on the multi-class torch ring,
   timed the same way (no K1 launch), and its 3 f32 and 3 f64 steps from
   the zero state against the same problem's scan (2e-6 and 1e-11 of
   max, as phase 10 against phase 9);
12. the command-line interface (``pbte_tpu_torch.cli``): its ``main()`` in
   this process with a YAML config of the flagship's walls, angles and
   bands, ``-m unit-cube-hex -r 2 -o 2 --face-mode consistent --no-dumps``
   (the builtin 4^3 refined to 16^3), 200 steps, the residual every 10, in
   f32 and in f64 (the CLI's default): K1's launches by variant around
   each run (the one-CTA kernel once a Km bucket a step, twice at the
   flagship; a count of calls of its plain version must stay 0), the solver line (G = 8, L = 46, W = 256),
   the set-up seconds by stage, the CLI's DOF/s beside phase 5's, and the
   residual history against the library's solve of the same problem
   (``problem.unit_cube(**FLAGSHIP)``, elements in lattice order: 2e-5 of
   max in f32, 1e-12 in f64); then ``python -m pbte_tpu_torch.cli`` as a
   subprocess at hex 8^3 p=1 (``-r 1``) from scratch directories: with
   dumps, slices and VTU on the card against ``--platform cpu`` (host logs
   byte-equal, fields within 1e-12 of max), checkpoint and resume (6 + 4
   against 10 steps, 1e-12 of max), ``--accelerate bicgstab`` to 1e-9,
   ``--profile`` (its trace must name a K1 kernel) and ``-p 2x2`` under
   ``torchrun --standalone --nproc-per-node 4`` (four gloo ranks sharing
   the card: the slab-lattice solver, the serial run's files); these four
   subprocess checks run side by side;
13. the general ring (pbte_tpu's one-hot ring, off the box lattice; torch
   products, no kernel of the kernels line: K1's count must stay 0): (a)
   ``python -m pbte_tpu_torch.cli -c config/config.yaml -r 7 --no-dumps``
   (its ``main()`` in this process; 32,768 triangles, 24 directions, 2 x
   20 bands) with ``--face-mode consistent`` (the config's mfem-parity
   faces make the refined iteration diverge, in pbte_tpu too), 20 steps in
   f32 and f64: the solver line must say ``solver[ring]``, its Tc (taken
   from the solve's result) is held against the port's scan of the same
   problem and steps (2e-6 of max in f32, 1e-11 in f64), and both ms/step
   are printed; (b) the 6-tet cube 8^3 at p = 1 (upwind level gap H = 2)
   with a Dirichlet wall and with a diffuse wall, f64, ``auto`` asserted to
   take the general ring, against the scan at 1e-11 of max; (c) the 6-tet
   cube 12^3 with a diffuse wall, where pbte_tpu's one-hot budget scans and
   the port rings: the ring against the scan in f32 and f64 (2e-6, 1e-11)
   with both ms/step;
14. the domain-decomposed solvers over torch.distributed (four ranks spawned
   on this card, joined over gloo: NCCL takes one card a rank; the native
   sweep planner and multilevel partitioner must have built): (a) the
   slab-lattice solver on a 2 x 2 (dir x space) grid at the flagship
   (f32): 3 steps through K1 against 3 through its plain version (Tc at
   phase 3's F32_RTOL of max), then 2 + SHARD_TIMED_STEPS timed steps with
   each rank's K1 launches (a rank with none fails), ms/step, the halo's
   bytes a rank sends and the lagged closure source's ms per step (the
   exit-layer ppermute through the host and the entry-row source), and
   each rank's peak memory; (b) the slab solver on one rank (a 1 x 1
   grid), 5 flagship steps against SourceIterationSolver's (2e-6 of max);
   (c) the slab 2 x 2 and the single-device solver at hex 8^3 p=2 (16
   directions, 8 bands), f64, each solved by BiCGStab to 1e-10 (1e-7 of
   max); (d) the spatially sharded solver 2 x 2 on the 3^3 6-tet
   cube, f64, against the lagged-interface oracle with its partition
   (1e-12 of max), and on the 12^3 6-tet cube, 10 timed steps (Tc finite,
   the residual falling); (e) SourceIterationSolver's dir sharding over
   the grid's 2 dir ranks (each space rank a replica), 3 flagship steps
   against the single-device solver's (2e-6 of max); (f), on two ranks,
   ``dir_sharding`` off K1's lattice ring (``SHARD_PATHS``): the legacy tet
   shape's supercell ring over dir = 2 and over band = 2, the default
   config at -r 7 (consistent faces) on the general ring over band = 2,
   the graded hex 16^3 on the multi-class ring over dir = 2 and the 6-tet
   cube 12^3 with phase 13's diffuse walls on the scan over dir = 2: each
   rank builds its shard from the problem the earlier phase built, 3 f32
   steps from the zero state against the single-device solver's 3 (phases
   10 and 11's; the general ring's and the scan's run before the ranks
   take the card) at 2e-6 of max, each rank's ms/step and peak memory,
   the path asserted and K1's count 0 (2 warm-up steps first: with one,
   the first case's steps ran 1.6x slower). Ranks sharing one card
   time-slice it: these numbers are correctness and the halo's cost, not
   scaling;
15. the lattice of ``bench_torch.py --p3-wide``'s row, hex 28^3 p=3 (2 x 8
   directions, 2 x 4 bands, float64 state; 21,952 elements, D = 64, W =
   784): a process of its own, started before phase 2, assembles it and
   builds its solver on the card while phases 2-14 run (minutes of host
   set-up), logging its host memory by stage (``bench_torch.stage_logger``)
   and the set-up seconds, and is stopped past
   ``bench_torch.P3_WIDE_HOST_LIMIT_GB`` of host memory; at this phase it
   runs 2 + 3 steps through K1's tiled f64 kernel (launches by variant:
   two buckets a step; a count of calls of K1's plain version must stay
   0; Tc finite of shape (ne, D), the residual falling), then holds one
   more step's sweep of every bucket against ``lattice_ring_sweep_ref`` on
   the same device and inputs (phase 3's F64_RTOL of max, ys and ms);
16. reproducibility (its checks run inside the phases that build the
   solvers; this phase sums them up and fails where one failed): (a) every
   K1 case of phase 3 (the flagship's buckets, p=3 16^3, the p=3 golden's
   lattice, wide, quad D=9, the shapes past the old ceiling; f32, bf16,
   f64; full slab and windowed) launched REPEAT_LAUNCHES times on the same
   inputs, ys and ms torch.equal to the first launch's; (b) phase 8's f64
   BiCGStab solve run twice from the zero state: the same step
   applications, the same relres at every read (==), Tc bit-equal; (c)
   REPRO_STEPS steps from the zero state twice, Tc and the residuals
   bit-equal, on every path with a scatter or a K1 launch: the flagship
   (f32, diffuse walls, bf16 state, f64), the closures golden's hex 8^3
   (periodic, diffuse and specular walls), the scan golden's tets and the
   legacy tet cut to REPRO_TET's bands with diffuse walls (the scan), the
   supercell ring, phase 11's lattices (K1's tiled kernel in three types,
   the quad D=9, the graded multi-class ring), the general ring at -r
   REPRO_GENERAL_REFINE and on the 12^3 tets with diffuse walls (and their
   scan), and on phase 14's gloo ranks the slab 2 x 2 at the flagship and
   the spatial solver with diffuse and specular walls; (d) each of (c)'s
   paths once more under torch.use_deterministic_algorithms(True,
   warn_only=True) (the process's setting restored after): a warning that
   names an operation without a deterministic form fails the phase, and
   so does a non-finite Tc (the audit fills new tensors with NaN, so a read
   of unwritten memory, such as a slot of ms K1 left unwritten, shows);
   torch's note that a cuBLAS product wants CUBLAS_WORKSPACE_CONFIG is
   recorded apart (cuBLAS gives the same bits on one stream, and the
   repeated runs hold the products to that).

The line before the last is the card's name and power limit, the one before
it {"kernels": [...]}, the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

from pbte_tpu_torch import tracing

WARMUP_STEPS = 2
TIMED_STEPS = 30
TIMED_LAUNCHES = 10
# phase 16: K1 launches a case on the same inputs (each held bit for bit to
# the first), and the steps from the zero state a path runs twice (Tc and
# the residuals bit for bit) and once more under the determinism audit
REPEAT_LAUNCHES = 2
REPRO_STEPS = 3
DMA_TOTAL_MB = 512
DMA_REPS = 20
XSRC_ROWS = 1024  # closure rows of the random K1 closure source
# kernel vs plain on the same card: f32 sums in another order (FMA chains
# in the kernel, cuBLAS in the plain version; ms by the band chain in band
# order), so errors are stated relative to the largest value
F32_RTOL = 1e-5
# bf16 state: the ring and the state are rounded to bf16 every level, so a
# sum that lands on the other side of a rounding boundary moves one ulp and
# the recurrence carries it on
BF16_ULPS = 2
BF16_MS_RTOL = 1e-3
GOLDEN_RTOL = 2e-5
# f64 state, kernel vs plain: both sum in float64 in another order
F64_RTOL = 1e-12
# the f64 BiCGStab golden: pbte_tpu's XLA ring and the kernel sum in another
# order, and the recurrence carries that on (1e-14 between pbte_tpu and the
# port on the CPU at this cap)
ACCEL_GOLDEN_RTOL = 1e-9
ACCEL_TOL = 1e-8  # linear relative residual of the f64 flagship solve
ACCEL_MAX_ITER = 1500
# the residual is read every 20 BiCGStab iterations. At the flagship the
# f64 relres can plateau near 1e-3 for 40 to over 120 step applications
# (measured on an H100 while K1 summed ms by atomics, whose order moved the
# plateaus from run to run): the guard restarts the recurrence there
# (accel.stall_action), where pbte_tpu's stopped it
ACCEL_CHECK_EVERY = 20
# the plain f64 solve to the accelerated solve's Tv residual: it contracts
# by ~0.9925 a step at the flagship, so ~2100 steps (1500 reached 6.2e-8 of
# the 7.6e-10 asked for, measured on an H100)
PLAIN_MAX_ITER = 3000
ACCEL_PEAK_LIMIT = 75e9  # bytes of device memory the f64 solve may reach
# the accelerated and the plain f64 solve to the same Tv residual
ACCEL_TC_RTOL = 1e-5
REFINE_GAIN = 100.0  # least fall of the f64 defect in one refinement round
TET_TIMED_STEPS = 10
TET_PROFILED_STEPS = 2
TET_COMPARE_STEPS = 3
# the legacy tet shape, 3 f32 steps against 3 f64 steps from the zero
# state: 3.1e-7 of max measured on the CPU at the 3^3 cube with the same
# angles, bands and order; held at pbte_tpu's f32 tolerance
TET_F32_F64_RTOL = 2e-5
# the class streams against the per-element streams, 3 f32 steps each:
# the same products in another order (1e-13 of max in f64 on the CPU)
TET_CLASS_STREAMS_RTOL = 2e-5
# the supercell ring against the scan, 3 f32 steps each from the zero state
# (iterate-exact paths: f32 roundoff; the scan's f32 against f64 gap at the
# same shape was 2.59e-7 of max on an H100)
TET_SUPER_RTOL = 2e-6
# the same in float64: the paths sum in another order (1e-15 of max on the
# CPU at 3 steps)
TET_SUPER_F64_RTOL = 1e-11
# the supercell ring with bf16 state against its f32 steps, 3 from the zero
# state: the coupling operand, the couplings and the state rounded to bf16
# (2.9e-4 to 9.3e-4 of max on the CPU, tests/test_torch_supercell.py)
TET_SUPER_BF16_RTOL = 3e-3
# the lattices of the tiled kernel (bench_k1's P3_LATTICE and WIDE) and the
# one-CTA kernel's D = 9: a 2D quad lattice at p = 2 (two faces; 16
# azimuths), and the graded flagship (the multi-class torch ring)
QUAD = dict(nx=64, ny=64, order=2, azimuth=16, nspec=20)
GRADED = dict(n=16, order=2, polar=4, azimuth=16, nspec=20)
# phase 11's timed steps, and its graded ring against its scan (as phase
# 10 against phase 9)
NEW_TIMED_STEPS = 10
GRADED_RTOL = 2e-6
GRADED_F64_RTOL = 1e-11
# phase 12, the CLI: the flagship through python -m pbte_tpu_torch.cli's
# main() (config file, -m unit-cube-hex -r 2, --no-dumps) for CLI_ITERS
# steps, its residual read every CLI_CHECK_EVERY, against the library's
# solve of problem.unit_cube(**FLAGSHIP). The two lattices hold the same
# elements in another order (refinement order against lattice order): the
# ring's slabs are the same, the Tc gathers and the residual's sums add in
# another order. f32: pbte_tpu's f32 kernel tolerance (relative to the
# history's largest value; 1.6e-7 measured on the CPU at hex 8^3 p=2);
# f64: 1e-12 (1.7e-15 measured there)
CLI_ITERS = 200
CLI_CHECK_EVERY = 10
CLI_F32_RTOL = 2e-5
CLI_F64_RTOL = 1e-12
# the entry point as a subprocess at hex 8^3 p=1, f64 (the CLI's default):
# on the card against --platform cpu (K1 against its plain version, whose
# f64 sums differ in order, ms by atomics: 5.8e-16 of max in phase 3), and
# a resumed run against a straight one on the card (the same, run to run)
CLI_BASE = ["-m", "unit-cube-hex", "-r", "1", "-o", "1", "--face-mode",
            "consistent", "-ad", "3", "-ap", "2", "-az", "4", "--tol", "0"]
CLI_SMALL = CLI_BASE + ["--slice-z", "0.4", "--line-slice", "2", "0.5",
                        "0.5", "--vtu"]
CLI_CARD_RTOL = 1e-12
CLI_RESUME_RTOL = 1e-12
CLI_SUBPROCESS_TIMEOUT = 300
# phase 13, the general ring: the default config at -r 7 through the CLI,
# GENERAL_STEPS steps against the port's scan of the same problem (as
# phases 10 and 11 against their scans), and 6-tet cubes of GENERAL_TET's
# angles and bands for GENERAL_TET_STEPS steps
GENERAL_REFINE = 7
GENERAL_STEPS = 20
GENERAL_RTOL = {"f32": 2e-6, "f64": 1e-11}
GENERAL_TET = dict(order=1, polar=2, azimuth=4, nspec=20)
GENERAL_TET_STEPS = 5
# phase 16 (c): the legacy tet shape on the scan cut to 2 x 2 bands with
# diffuse walls, the general ring on the default config at -r 6 (the
# coarsest refinement that takes it: -r 5's levels are 32 wide, below
# pbte_tpu's 64, and scan), and the
# spatial solver on phase 14's small 6-tet cube with diffuse and specular
# walls (the walls of tests/test_torch_parallel.py's reflective cases)
REPRO_TET = dict(nspec=2)
REPRO_TET_DIFFUSE = (2, 4)
REPRO_GENERAL_REFINE = 6
REPRO_SPATIAL_WALLS = dict(bc_temps={5: -0.5, 3: 0.5},
                           diffuse_bcs=[1, 2], specular_bcs=[4, 6])
# phase 14, the sharded solvers on four ranks sharing the card
SHARD_TIMED_STEPS = 20
SHARD_TIMEOUT = 600  # seconds for the ranks' spawn, set-up included
SHARD_1x1_RTOL = 2e-6  # slab 1 x 1 and dir sharding against one device
SHARD_ACCEL_RTOL = 1e-7  # slab BiCGStab against the single device's
SHARD_ORACLE_RTOL = 1e-12
# (f): dir and band sharding off K1's lattice ring, on two ranks: (name,
# the refs key of its problem, its grid, the path it must take)
SHARD_PATHS = (
    ("legacy tet supercell dir=2", "tet", dict(dir=2), "supercell"),
    ("legacy tet supercell band=2", "tet", dict(band=2), "supercell"),
    (f"general ring -r {GENERAL_REFINE} band=2", "general", dict(band=2),
     "general"),
    ("graded 16^3 multi-class ring dir=2", "graded", dict(dir=2), "multi"),
    ("tet 12^3 diffuse scan dir=2", "scan", dict(dir=2), "scan"),
)
SHARD_PATH_STEPS = 3
SHARD_CONFIG = dict(
    device="cuda", flagship=None,  # FLAGSHIP, filled in by main
    # (c): 16 directions x 8 bands (the flagship's 64 x 40 took 37 s of
    # the phase's 122 on an H100: 413 step applications on four ranks)
    accel=dict(nx=8, ny=8, nz=8, order=2, polar=2, azimuth=8, nspec=4),
    tet_small=dict(n=3, order=1, polar=2, azimuth=4, nspec=2),
    tet_timed=dict(n=12, order=1, polar=2, azimuth=4, nspec=2),
    timed_steps=SHARD_TIMED_STEPS)


# phase 5's compensated solve: iterations, residual cadence, and Tc against
# the plain iteration's after as many steps
COMPENSATED_ITERS = 4
COMPENSATED_CHECK_EVERY = 2
COMPENSATED_RTOL = 2e-5
# phase 15: bench_torch.py's p3_wide_f64 lattice (its P3_WIDE at 7/4 of the
# flagship's 16 per axis), its timed steps, the seconds this phase waits
# for its set-up and for its steps, and the BLAS threads of its process
# (the earlier phases keep the other cores); its process may take
# bench_torch.P3_WIDE_HOST_LIMIT_GB of host memory
P3_WIDE = dict(nx=28, ny=28, nz=28, order=3, polar=2, azimuth=8, nspec=4)
P3_WIDE_STEPS = 3
P3_WIDE_SETUP_TIMEOUT = 1000
P3_WIDE_RUN_TIMEOUT = 300
P3_WIDE_THREADS = 2

_T0 = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def mark(what):
    """A line with the seconds since the script started, at each phase."""
    log(f"[smoke] t={time.perf_counter() - _T0:.1f} s: {what}")


def rel_err(got, ref):
    """max|got - ref| / max|ref|, and max|got - ref| (in float64 where
    either is float64)."""
    dt = (torch.float64 if torch.float64 in (got.dtype, ref.dtype)
          else torch.float32)
    d = (got.to(dt) - ref.to(dt)).abs().max().item()
    return d / max(ref.to(dt).abs().max().item(), 1e-300), d


def k1_launches(state=None, variant=None):
    """K1 launches since the registry's last reset (the counters
    ``k1.launches.<variant>.<state>`` of ``tracing``), of one state type
    and one variant where given."""
    n = 0
    for key, c in tracing.report()["counts"].items():
        part = key.split(".")
        if (part[:2] == ["k1", "launches"] and variant in (None, part[2])
                and state in (None, part[3])):
            n += c
    return n


def k1_by_variant():
    return {v: k1_launches(variant=v) for v in ("persistent", "tiled")}


def k1_by_state():
    return {st: k1_launches(state=st) for st in ("f32", "bf16", "f64")}


def stage_s(name):
    """Host seconds of the set-up stage ``name`` since the registry's last
    reset (0 where it did not run)."""
    return tracing.report()["stages"].get(name, {}).get("host_s", 0.0)


def bf16_ulp_of_max(ref):
    m = ref.float().abs().max().item()
    return 2.0 ** (np.floor(np.log2(m)) - 7)


# phase 16's records, one a path: REPRO_STEPS steps twice and under the
# audit (repro_check), and the f64 BiCGStab solve twice (phase 8)
REPRO = []
# torch's note that a cuBLAS product is not covered by the audit unless
# CUBLAS_WORKSPACE_CONFIG is set: cuBLAS gives the same bits on one stream
# (its "results reproducibility" section), and the port runs on one stream
# a process; phase 16 records the note and holds the products to the
# repeated runs' bit-equality instead
CUBLAS_NOTE = "CUBLAS_WORKSPACE_CONFIG"


def deterministic_audit(fn):
    """fn() under torch.use_deterministic_algorithms(True, warn_only=True)
    (torch then warns at each operation it has no deterministic form of,
    and fills new tensors with NaN, so a read of unwritten memory shows),
    the process's setting restored after. Returns (fn's result, the
    distinct warnings about determinism, the cuBLAS note apart)."""
    import warnings

    prev = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(prev, warn_only=prev_warn)
    msgs = {str(w.message) for w in caught}
    found = sorted(m for m in msgs if "determinis" in m.lower()
                   and CUBLAS_NOTE not in m)
    cublas = any(CUBLAS_NOTE in m for m in msgs)
    return out, found, cublas


def steps_from_zero(solver, n):
    """(Tc, the residuals) after n steps of ``solver`` from its zero state,
    on the device."""
    st = solver.initial_state()
    res = []
    for _ in range(n):
        *st, r = solver.step(*st)
        res.append(r)
    torch.cuda.synchronize()
    return st[1], torch.stack(res)


def repro_record(solver, name, steps=REPRO_STEPS):
    """Phase 16 (c) and (d) on one solver: ``steps`` steps from the zero
    state twice, Tc and the residuals bit for bit, then once more under
    deterministic_audit (its Tc finite; whether it equals the others is
    recorded). Returns the record."""
    t0 = time.perf_counter()
    tc0, r0 = steps_from_zero(solver, steps)
    tc1, r1 = steps_from_zero(solver, steps)
    equal = bool(torch.equal(tc0, tc1) and torch.equal(r0, r1))
    t1 = time.perf_counter()
    (tc2, r2), found, cublas = deterministic_audit(
        lambda: steps_from_zero(solver, steps))
    rec = dict(path=name, steps=steps, bit_equal=equal,
               audit_warnings=found, audit_cublas_note=cublas,
               audit_finite=bool(torch.isfinite(tc2).all()),
               audit_equal=bool(torch.equal(tc0, tc2)
                                and torch.equal(r0, r2)),
               runs_s=t1 - t0, audit_s=time.perf_counter() - t1)
    return rec


def repro_held(rec):
    """Log a phase 16 record, add it to REPRO and raise where it failed: a
    mismatch, a warning of the audit, a non-finite Tc."""
    REPRO.append(rec)
    log("[smoke] phase 16 " + json.dumps(rec))
    if (not (rec["bit_equal"] and rec.get("audit_finite", True))
            or rec.get("audit_warnings")):
        raise RuntimeError(f"phase 16: {rec['path']} is not reproducible: "
                           f"{rec}")
    return rec


def repro_check(solver, name, steps=REPRO_STEPS):
    """repro_record on this process's solver, held (repro_held)."""
    return repro_held(repro_record(solver, name, steps))


def time_turns(fns, n):
    """Mean CUDA-event ms of each of fns, launched in turns after one
    warm-up each."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    tot = [0.0] * len(fns)
    for _ in range(n):
        for i, fn in enumerate(fns):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            tot[i] += e0.elapsed_time(e1)
    return [t / n for t in tot]


# (bucket, state, Dirichlet source, closure source, hull windows); the first
# windowed case is what the flagship's step launches (bucket 0, f32)
K1_CASES = (
    [(0, "f32", False, False, False), (0, "bf16", False, False, False),
     (1, "f32", True, False, False), (1, "bf16", False, False, False),
     (0, "f32", False, True, False), (1, "f32", False, True, False),
     (0, "f32", False, False, True)]
    + [(bi, state, dirichlet, not dirichlet, True)
       for bi in (0, 1) for state in ("f32", "bf16", "f64")
       for dirichlet in (True, False)]
)


def k1_case_inputs(lr, spec, case, rng, gen, inside, inside_t):
    """One K1 case's launch on ``spec`` (``k1_spec``): (args, kw, host
    windows, device windows) for (bucket, state, Dirichlet source, closure
    source, hull windows), seeded random state and sources drawn on the
    card from ``gen`` (closure maps from ``rng``), the spec's operators."""
    bi, state, dirichlet, closure, windowed = case
    L, D, W, BS = spec["L"], spec["D"], spec["W"], spec["BS"]
    cb = spec["buckets"][bi]
    Gb, Km = cb["macro_w"].shape[:2]
    # host windows for the plain version and the bounds, the solver's
    # uploaded tensor for the kernel
    win, win_k = ((spec["win"], spec["win_dev"]) if windowed
                  else (None, None))
    f64 = state == "f64"

    def rnd(*shape):
        """Seeded normal values of a slab-shaped operand (L first, W last),
        zero outside the windows in a windowed case."""
        t = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.float64 if f64 else torch.float32)
        if windowed and shape[0] == L:
            t *= inside_t.view((L,) + (1,) * (len(shape) - 2) + (W,))
        return t

    v = rnd(L, Gb, Km, BS, D, W)
    ttc = rnd(L, Gb, D, W)
    dsrc = rnd(L, Gb, Km, D, W) if dirichlet else None
    xsrc = None
    if closure:  # 40% of the slots read one of XSRC_ROWS random rows
        xmap = np.where(rng.random((L, Gb, W)) < 0.4,
                        rng.integers(0, XSRC_ROWS, (L, Gb, W)), -1)
        if windowed:  # the contract: no closure row outside a window
            xmap = np.where(inside[:, None, :], xmap, -1)
        xsrc = lr.ClosureSource(
            torch.from_numpy(xmap.astype(np.int32)).cuda(),
            rnd(Gb, XSRC_ROWS, Km, BS, D))
    cast = state == "bf16"
    if cast:
        v = v.to(torch.bfloat16)
    ops = [cb["bsrc0"], cb["cin"], cb["bcat"], cb["macro_w"], spec["wvec"]]
    if f64:  # the float64 kernel takes float64 operators
        ops = [t.double() for t in ops]
    kw = dict(shifts=spec["shifts"], dsrc=dsrc, xsrc=xsrc, cast_bf16=cast)
    return (v, ttc, *ops), kw, win, win_k


def case_tag(case, shape_tag=""):
    bi, state, dirichlet, closure, windowed = case
    return (f"{shape_tag}bucket {bi} {state}"
            f"{' dirichlet' if dirichlet else ''}"
            f"{' closure' if closure else ''}"
            f"{' windows' if windowed else ''}")


def k1_repeats(lr, args, kw, win_k, first, n):
    """Phase 16 (a): K1 launched n - 1 more times on the inputs that gave
    ``first`` (its ys, ms); the launches whose ys and whose ms differ from
    the first's in any bit."""
    ys_differ = ms_differ = 0
    for _ in range(n - 1):
        ys, ms = lr.lattice_ring_sweep(*args, **kw, win=win_k)
        torch.cuda.synchronize()
        ys_differ += not torch.equal(ys, first[0])
        ms_differ += not torch.equal(ms, first[1])
        del ys, ms
    return dict(launches=n, ys_differ=ys_differ, ms_differ=ms_differ)


def window_masks(spec):
    """(L, W) in-window masks of ``spec``'s windows, on the host and on the
    card (all True without windows)."""
    L, W = spec["L"], spec["W"]
    inside = np.zeros((L, W), dtype=bool)
    if spec["win"] is not None:
        for l, (lo, hi) in enumerate(spec["win"]):
            inside[l, lo:hi] = True
    return inside, torch.from_numpy(inside).cuda()


def card_generator(rng):
    """A generator on the card seeded from ``rng``: the slab-sized operands
    are drawn there (on the host, numpy's generator took several seconds a
    case at these sizes)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(int(rng.integers(2 ** 62)))
    return gen


def run_k1_cases(lr, spec, cases, rng, shape_tag="", carried_ms=True):
    """Kernel vs plain for each (bucket, state, Dirichlet source, closure
    source, hull windows) case on ``spec`` (``k1_spec``): seeded random
    state, the spec's operators; returns the result rows.

    bf16 state is also held level by level: the plain version reads the
    kernel's own ys as each level's ring (``ring_in``), so a bf16 rounding
    that went the other way at one level is not carried on, and ys and ms
    of every level are held at the bf16 tolerances. ``carried_ms=False``
    reports the end-to-end bf16 ms error without holding it to
    ``BF16_MS_RTOL``: a ring value that rounds the other way moves one band
    of the next level by a bf16 ulp (2^-8 of it), which moves ms there by up
    to that band's share of 2^-8, and over the ~1e9 rounded ring values of
    the wide lattice one such flip lands near the largest ms (1.16e-3 and
    1.19e-3 of max measured on an H100, with ys within 0.5 ulp of max and
    f32 within 2.4e-6: the arithmetic agrees).

    Every case also launches the kernel REPEAT_LAUNCHES times on its inputs
    (phase 16 (a)): ys and ms must repeat bit for bit."""
    L, D, W = spec["L"], spec["D"], spec["W"]
    nf = len(spec["shifts"])
    inside, inside_t = window_masks(spec)
    gen = card_generator(rng)
    rows = []
    for case in cases:
        bi, state, dirichlet, closure, windowed = case
        f64 = state == "f64"
        cast = state == "bf16"
        args, kw, win, win_k = k1_case_inputs(lr, spec, case, rng, gen,
                                              inside, inside_t)
        v, dsrc, xsrc = args[0], kw["dsrc"], kw["xsrc"]
        tag = case_tag(case, shape_tag)
        plan = lr.launch_plan(D, W, nf, v.dtype, L, shifts=spec["shifts"])
        ys, ms = lr.lattice_ring_sweep(*args, **kw, win=win_k)
        torch.cuda.synchronize()
        repeat = k1_repeats(lr, args, kw, win_k, (ys, ms), REPEAT_LAUNCHES)
        ys_r, ms_r = lr.lattice_ring_sweep_ref(*args, **kw, win=win)
        torch.cuda.synchronize()
        if not (torch.isfinite(ys.float()).all() and torch.isfinite(ms).all()):
            raise RuntimeError(f"{tag}: non-finite kernel output")
        ys_rel, ys_abs = rel_err(ys, ys_r)
        ms_rel, ms_abs = rel_err(ms, ms_r)
        level = {}
        if cast:
            ys_ulps = ys_abs / bf16_ulp_of_max(ys_r)
            ys_l, ms_l = lr.lattice_ring_sweep_ref(*args, **kw, win=win,
                                                   ring_in=ys)
            torch.cuda.synchronize()
            level = dict(level_ys_ulps_of_max=rel_err(ys, ys_l)[1]
                         / bf16_ulp_of_max(ys_l),
                         level_ms_rel=rel_err(ms, ms_l)[0])
            del ys_l, ms_l
            ok = (ys_ulps <= BF16_ULPS
                  and (ms_rel <= BF16_MS_RTOL or not carried_ms)
                  and level["level_ys_ulps_of_max"] <= BF16_ULPS
                  and level["level_ms_rel"] <= BF16_MS_RTOL)
            tol = (f"ys <= {BF16_ULPS} bf16 ulps of max, ms rel <= "
                   f"{BF16_MS_RTOL}{'' if carried_ms else ' level by level'}"
                   f"; level by level the same")
        elif f64:
            ys_ulps = None
            ok = ys_rel <= F64_RTOL and ms_rel <= F64_RTOL
            tol = f"ys, ms rel <= {F64_RTOL}"
        else:
            ys_ulps = None
            ok = ys_rel <= F32_RTOL and ms_rel <= F32_RTOL
            tol = f"ys, ms rel <= {F32_RTOL}"
        del ys_r, ms_r
        row = dict(bucket=bi, shape=list(v.shape), state=state,
                   dirichlet=dirichlet, xsrc=closure, windows=windowed,
                   variant=plan.variant, Wt=plan.Wt, C=plan.C,
                   ys_rel=ys_rel, ys_abs=ys_abs, ys_ulps_of_max=ys_ulps,
                   ms_rel=ms_rel, ms_abs=ms_abs, **level, tolerance=tol,
                   repeat=repeat)
        ok = ok and repeat["ys_differ"] == 0 and repeat["ms_differ"] == 0
        if windowed:
            # the windowed kernel against the full-slab kernel
            outside = ~inside_t
            if (ys.abs().amax(dim=(1, 2, 3, 4))[outside].max() != 0
                    or ms.abs().amax(dim=(0, 1, 3))[outside].max() != 0):
                raise RuntimeError(f"{tag}: ys or ms is not zero outside "
                                   f"the windows")
            ys_f, ms_f = lr.lattice_ring_sweep(*args, **kw)
            torch.cuda.synchronize()
            ys_equal = torch.equal(ys, ys_f)
            ms_equal = torch.equal(ms, ms_f)
            del ys_f, ms_f
            row.update(ys_equals_full_slab=ys_equal,
                       ms_equals_full_slab=ms_equal,
                       full_slab_tolerance="ys and ms bit-equal")
            ok = ok and ys_equal and ms_equal
        del ys, ms
        fns = [lambda: lr.lattice_ring_sweep(*args, **kw, win=win_k),
               lambda: lr.lattice_ring_sweep_ref(*args, **kw, win=win)]
        if windowed:
            fns.append(lambda: lr.lattice_ring_sweep(*args, **kw))
        k_ms, p_ms, *full_ms = time_turns(fns, TIMED_LAUNCHES)
        nbytes, flop = lr.sweep_cost(v, nf, dsrc, xsrc, win)
        bound_ms, bound_by = lr.sweep_bound_ms(v, nf, dsrc, xsrc, win)
        full_bound_ms, full_bound_by = lr.sweep_bound_ms(v, nf, dsrc, xsrc)
        win_bound_ms = (lr.sweep_bound_ms(v, nf, dsrc, xsrc, spec["win"])[0]
                        if spec["win"] is not None else full_bound_ms)
        row.update(kernel_ms=k_ms, plain_ms=p_ms, bytes=nbytes, flop=flop,
                   bound_ms=bound_ms, bound_by=bound_by,
                   share_of_bound=bound_ms / k_ms,
                   full_slab_bound_ms=full_bound_ms,
                   full_slab_bound_by=full_bound_by,
                   windows_bound_ms=win_bound_ms, ok=ok)
        line = (f"[smoke] K1 {tag} ({plan.variant}, Wt={plan.Wt}, "
                f"C={plan.C}): kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
                f"ms, bound {bound_ms:.4f} ms ({bound_by}: "
                f"{nbytes / 1e9:.3f} GB, {flop / 1e9:.1f} Gflop), "
                f"{bound_ms / k_ms:.3f} of the bound (bounds: full slab "
                f"{full_bound_ms:.4f} ms, windows {win_bound_ms:.4f} ms)")
        if windowed:
            row.update(full_slab_kernel_ms=full_ms[0],
                       full_slab_share_of_bound=full_bound_ms / full_ms[0])
            line += (f"; full-slab kernel on the same inputs "
                     f"{full_ms[0]:.4f} ms (windows / full "
                     f"{k_ms / full_ms[0]:.3f}), "
                     f"{full_bound_ms / full_ms[0]:.3f} of its bound")
        log("[smoke] kernel vs plain " + json.dumps(row))
        log(line)
        if not ok:
            raise RuntimeError(f"kernel disagrees: {row}")
        if max(row["share_of_bound"],
               row.get("full_slab_share_of_bound", 0.0)) > 1.0:
            raise RuntimeError(f"{tag}: faster than its bound: {row}")
        rows.append(row)
        del v, dsrc, xsrc, args, kw, fns
        torch.cuda.empty_cache()
    return rows


def phase_kernel_vs_plain(solver, lr):
    """Kernel vs plain at the flagship bucket shapes, full slab and with the
    solver's hull windows; returns the result rows."""
    from pbte_tpu_torch.bench_k1 import k1_spec

    if solver.win is None:
        raise RuntimeError("the flagship solver took no hull windows")
    return run_k1_cases(lr, k1_spec(solver), K1_CASES,
                        np.random.default_rng(0))


# the new shapes' cases: each state type, full slab and with the windows
K1_NEW_CASES = [(0, state, False, False, windowed)
                for state in ("f32", "bf16", "f64")
                for windowed in (False, True)]
# the tiled kernel's Dirichlet source (dsrc) and closure source (xmap,
# xval) branches, windowed, in each state type, as K1_CASES holds them at
# the flagship's one-CTA shapes: at hex 16^3 p=3 and at the first shape
# past the ceiling
K1_SOURCE_CASES = [(0, state, dirichlet, not dirichlet, True)
                   for state in ("f32", "bf16", "f64")
                   for dirichlet in (True, False)]


# shapes past the earlier cluster kernel's ceiling of 16 CTAs (D, W, state,
# shifts): the four lattices ROADMAP.md section 3 records (hex 28^3 p=3 f64,
# 40^3 p=3 f32, 60^3 p=3 bf16, 65^3 p=1 f32), at a small L, Gb, Km and BS
BEYOND_CEILING = ((64, 784, "f64", (0, 1, 28)), (64, 1600, "f32", (0, 1, 40)),
                  (64, 3600, "bf16", (0, 1, 60)), (8, 4225, "f32", (0, 1, 65)))
SYNTH_DIMS = dict(L=6, Gb=2, Km=2, BS=4)


def phase_k1_beyond_ceiling(lr):
    """Kernel vs plain at BEYOND_CEILING's shapes (``bench_k1.
    synthetic_spec``'s operands and windows), each in its state type, full
    slab and windowed, the first also with K1_SOURCE_CASES; returns {shape
    name: rows}."""
    from pbte_tpu_torch.bench_k1 import synthetic_spec

    out = {}
    for i, (D, W, state, shifts) in enumerate(BEYOND_CEILING):
        name = f"D={D} W={W} {state}"
        spec = synthetic_spec(D, W, shifts, seed=20 + i, **SYNTH_DIMS)
        cases = [(0, state, False, False, windowed)
                 for windowed in (False, True)]
        if i == 0:
            cases += K1_SOURCE_CASES
        out[name] = run_k1_cases(lr, spec, cases,
                                 np.random.default_rng(30 + i),
                                 shape_tag=f"{name} ")
        del spec
        torch.cuda.empty_cache()
    return out


def phase_k1_new_shapes(lr, specs):
    """Kernel vs plain at the lattice shapes no earlier phase gives K1: hex
    16^3 p=3 and the p=3 golden's lattice (D = 64: the tiled kernel), the
    wide hex 24^3 p=2 (W = 576: the tiled kernel) and the quad 64^2 p=2
    (D = 9, two faces: the one-CTA kernel), each in f32, bf16 and f64, full
    slab and windowed, and with K1_SOURCE_CASES where ``sources`` says so;
    returns {shape name: rows}."""
    out = {}
    for i, (name, spec, bucket, sources) in enumerate(specs):
        cases = [(bucket,) + c[1:] for c in
                 K1_NEW_CASES + (K1_SOURCE_CASES if sources else [])]
        out[name] = run_k1_cases(lr, spec, cases,
                                 np.random.default_rng(10 + i),
                                 shape_tag=f"{name} ", carried_ms=False)
    return out


def check_k1_smem(solver, lr):
    """The wrapper's shared-memory check (lr.kernel_smem_bytes) against the
    kernels' own carve-ups, at the flagship's shapes in all three types."""
    lib = lr._lib()
    W, D, nf, L = solver.W, solver.D, len(solver.shifts), solver.L
    got = {torch.float32: lib.pbte_lattice_ring_smem_bytes(0, D, W, nf, L),
           torch.bfloat16: lib.pbte_lattice_ring_smem_bytes(1, D, W, nf, L),
           torch.float64: lib.pbte_lattice_ring_smem_bytes_f64(D, W, nf, L)}
    for state, n in got.items():
        want = lr.kernel_smem_bytes(D, W, nf, state, L)
        if n != want:
            raise RuntimeError(f"K1 shared memory: the kernel takes {n} B, "
                               f"the wrapper checks {want} B ({state})")
    log(f"[smoke] K1 shared memory per CTA at D={D} W={W}: "
        + ", ".join(f"{str(k).split('.')[-1]} {v} B" for k, v in got.items()))
    # the scratch a launch takes: the CTAs' tickets and the level flags
    for cb in solver.consts["buckets"]:
        Gb, Km, BS = cb["macro_w"].shape
        plan = lr.launch_plan(D, W, nf, torch.float32, L, solver.shifts)
        want = lr.scratch_numel(plan, Gb, Km, BS)
        n = lib.pbte_lattice_ring_scratch_numel(Gb, Km, BS)
        parts = lib.pbte_lattice_ring_ms_parts(BS)
        if n != want or parts != lr.ms_parts(plan, BS):
            raise RuntimeError(f"K1 scratch and ms partials at Gb={Gb} "
                               f"Km={Km} BS={BS}: the kernel takes {n}, "
                               f"{parts}, the wrapper {want}, "
                               f"{lr.ms_parts(plan, BS)}")
    # the tiled kernel's widest tiles and carve-up (its halo from the
    # shifts) at the tiles the plans of phase 3 and 11 launch and beyond
    tiled = lr._lib("lattice_ring_tiled")
    for mode, state in enumerate((torch.float32, torch.bfloat16,
                                  torch.float64)):
        for Dt in lr.TILED_D:
            n = tiled.pbte_lattice_ring_tiled_wt_max(mode, Dt)
            if n != lr.tiled_wt_max(Dt, state):
                raise RuntimeError(f"K1 tiled kernel at D={Dt} ({state}): "
                                   f"widest tile {n}, the wrapper plans "
                                   f"{lr.tiled_wt_max(Dt, state)}")
        for Dt, Wt, C, sh in ((64, 64, 4, (0, 16, 1)), (64, 32, 8, (0, 16, 1)),
                              (64, 128, 29, (0, 1, 60)), (27, 192, 3, (0, 24, 1)),
                              (8, 256, 17, (0, 1, 65)), (9, 240, 1, (0, 1)),
                              (64, 16, 3, (40, 30, 20)), (16, 96, 5, (0, 200))):
            s3 = list(sh) + [0] * (3 - len(sh))
            n = tiled.pbte_lattice_ring_tiled_smem_bytes(mode, Dt, Wt, C,
                                                         len(sh), *s3)
            want = lr.tiled_smem_bytes(
                Dt, Wt, len(sh), state, lr.tiled_halo_blocks(
                    sh, Wt, C, lr.tiled_row_stride(Wt, state)))
            if n != want:
                raise RuntimeError(f"K1 tiled kernel shared memory at D={Dt} "
                                   f"Wt={Wt} C={C} shifts {sh}: the kernel "
                                   f"takes {n} B, the wrapper checks {want} B "
                                   f"({state})")
    for Gb, Km, BS, C in ((4, 10, 40, 3), (2, 6, 8, 49)):
        n = tiled.pbte_lattice_ring_scratch_numel(Gb, Km, BS, C)
        if n != lr.tiled_scratch_numel(Gb, Km, BS, C):
            raise RuntimeError(f"K1 tiled scratch at Gb={Gb} Km={Km} BS={BS} "
                               f"C={C}: the kernel takes {n}, the wrapper "
                               f"{lr.tiled_scratch_numel(Gb, Km, BS, C)}")
    log("[smoke] K1 tiled kernel: the wrapper's widest tiles, shared memory "
        "and scratch sizes equal the library's")


TILED_MODES = ("f32", "bf16", "f64")


def f64_ptxas(log):
    """The ptxas report of each float64 K1 instantiation in a build log:
    {"D=27 dsrc": {"registers": r, "spill_stores": s, "spill_loads": s}}."""
    return kernel_ptxas(log, r"lattice_ring_f64_kernelILi(\d+)ELb([01])E",
                        lambda k: f"D={k.group(1)}"
                                  f"{' dsrc' if k.group(2) == '1' else ''}")


def tiled_ptxas(log):
    """The ptxas report of each tiled K1 instantiation in a build log:
    {"D=64 f32": {"registers": r, "spill_stores": s, "spill_loads": s}}."""
    return kernel_ptxas(log, r"lattice_ring_tiled_kernelILi(\d+)ELi(\d)E",
                        lambda k: f"D={k.group(1)} "
                                  f"{TILED_MODES[int(k.group(2))]}")


def kernel_ptxas(log, pattern, name):
    """{name(match): ptxas registers and spill} of each entry function whose
    mangled name matches ``pattern``."""
    import re

    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(pattern, m.group(1))
            key = name(k) if k else None
            if key:
                out[key] = {}
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[key].update(spill_stores=int(m.group(1)),
                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[key]["registers"] = int(m.group(1))
    return out


def edge_totals(block):
    """Small and ragged totals in bytes for a kernel of `block`-byte tiles or
    stages: one 16-byte vector, below one block, one block plus 16 bytes,
    fewer blocks than the card has CTAs, and many blocks with a ragged end."""
    return (16, block - 16, block + 16, 7 * block + 48,
            1000 * block + 4096 + 16)


def phase_dma_edges(dma, bench_dma):
    """Every K2 and K3 configuration bit-exact at the edge totals."""
    cfgs = bench_dma.configs()
    blocks = [info.get("tile_bytes", info.get("stage_bytes"))
              for _, _, info in cfgs]
    gen = torch.Generator(device="cuda").manual_seed(2)
    big = torch.randn(max(max(edge_totals(b)) for b in blocks) // 4,
                      generator=gen, device="cuda")
    n = 0
    for (name, fn, _), block in zip(cfgs, blocks):
        for total in edge_totals(block):
            x = big[:total // 4]
            y = fn(x)
            torch.cuda.synchronize()
            if not torch.equal(y, x):
                raise RuntimeError(f"{name}: the copy of {total} B differs "
                                   f"from its input")
            n += 1
    log(f"[smoke] dma {len(cfgs)} kernel configurations bit-exact at the "
        f"small and ragged totals: {n} copies")


def phase_dma(dma, bench_dma):
    """K2 and K3 at the edge totals and against the plain copy at 512 MB,
    then the probe's sweep (its main path) with the launch counts read
    around it."""
    phase_dma_edges(dma, bench_dma)
    rows = bench_dma.total_rows_for(DMA_TOTAL_MB)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((rows, dma.LANE), generator=gen, device="cuda")
    ref = dma.copy_ref(x)
    errs = {"auto": 0.0, "manual": 0.0}
    for name, fn, info in bench_dma.configs():
        y = fn(x)
        torch.cuda.synchronize()
        if not (torch.equal(y, x) and torch.equal(y, ref)):
            raise RuntimeError(f"{name}: the copy differs from its input")
        key = "auto" if info["kernel"] == "K2" else "manual"
        errs[key] = max(errs[key], (y - ref).abs().max().item())
        del y
    log(f"[smoke] dma {len(bench_dma.configs())} kernel configurations "
        f"bit-exact at {x.numel() * 4} B: max |y - plain| {errs}")
    del x, ref
    torch.cuda.empty_cache()

    tracing.reset()
    res = bench_dma.run(DMA_TOTAL_MB, DMA_REPS)
    counts = tracing.report()["counts"]
    launches = {k: counts.get(f"dma_copy.launches.{k}", 0)
                for k in ("auto", "manual")}
    log("[smoke] dma probe " + json.dumps(res))
    for name, gbs in res["gbs"].items():
        line = (f"[smoke] dma {name:15s} {res['ms'][name]:8.4f} ms "
                f"{gbs:8.1f} GB/s")
        if name in res["rate_vs_plain"]:
            r = res["rate_vs_plain"][name]
            line += (f"  plain {res['plain_ms'][name]:.4f} ms, rate x"
                     f"{r['median']:.4f} of plain [{r['min']:.4f}, "
                     f"{r['max']:.4f}]")
        log(line)
    if min(launches.values()) < 1:
        raise RuntimeError(f"the probe launched a copy kernel no time: "
                           f"{launches}")
    return res, launches, errs


STATE_KEYS = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float64: "f64"}


def phase_flagship(solver, lr, setup_s, name):
    """Time a flagship step through the kernel; returns (launches of the
    solver's state type, row)."""
    key = STATE_KEYS[solver.state_dtype]
    torch.cuda.reset_peak_memory_stats()
    u, Tc, Tv = solver.initial_state()
    tracing.reset()
    res = []
    for _ in range(WARMUP_STEPS):
        u, Tc, Tv, r = solver.step(u, Tc, Tv)
        res.append(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        u, Tc, Tv, r = solver.step(u, Tc, Tv)
        res.append(r)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k1_launches(state=key)
    res = [float(x) for x in res]
    want = len(solver.consts["buckets"]) * (WARMUP_STEPS + TIMED_STEPS)
    ne, D, K, BS = solver.ne, solver.D, solver.K, solver.BS
    row = dict(
        ne=ne, D=D, K=K, BS=BS, G=solver.G, L=solver.L, W=solver.W,
        buckets=[[int(len(g)), km] for g, km in solver._ring_buckets],
        setup_s=setup_s, ms_per_step=wall / TIMED_STEPS * 1e3,
        dof_per_s=TIMED_STEPS * K * BS * ne * D / wall,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches=launches, residuals=res,
    )
    log(f"[smoke] {name} " + json.dumps(row))
    if launches != want or k1_launches() != want:
        raise RuntimeError(f"{name}: {k1_by_state()}"
                           f" kernel launches, want {want} {key}")
    if Tc.shape != (ne, D) or not torch.isfinite(Tc).all():
        raise RuntimeError(f"{name}: Tc is not finite of shape (ne, D)")
    if not (np.all(np.isfinite(res)) and res[-1] < res[0]):
        raise RuntimeError(f"{name}: residuals not finite and falling: {res}")

    # 3 steps from one state, through the kernel and through the plain
    # version, on the card
    outs = []
    for sweep in (lr.lattice_ring_sweep, lr.lattice_ring_sweep_ref):
        solver.ring_sweep = sweep
        s = (u, Tc, Tv)
        for _ in range(3):
            s = solver.step(*s)[:3]
        outs.append(s[1])
        del s
    solver.ring_sweep = lr.lattice_ring_sweep
    torch.cuda.synchronize()
    tc_rel, tc_abs = rel_err(outs[0], outs[1])
    # bf16 state: a sum next to a bf16 rounding boundary rounds the other
    # way on one side and the steps carry it on
    tol = {"f32": F32_RTOL, "bf16": BF16_MS_RTOL, "f64": F64_RTOL}[key]
    log(f"[smoke] {name} 3 steps kernel vs plain: Tc rel {tc_rel:.3e} "
        f"(abs {tc_abs:.3e}), tolerance {tol}")
    if not tc_rel <= tol:
        raise RuntimeError(f"{name} Tc: kernel disagrees with plain version")
    row["tc_kernel_vs_plain_rel"] = tc_rel
    return launches, row


PARAM_KEYS = ("nx", "ny", "nz", "order", "polar", "azimuth", "nspec")


def phase_golden(SourceIterationSolver, unit_cube, file, keys=PARAM_KEYS,
                 lr=None, repro=None):
    """The port on the GPU against a pbte_tpu golden Tc (isothermal walls,
    or periodic, diffuse and specular closures when the file names them),
    the problem built by ``unit_cube(**params)`` from the file's ``keys``.
    With ``lr`` it returns the K1 launches by variant of the solve too;
    with ``repro`` (a name) the solver also takes phase 16's repro_check."""
    golden = pathlib.Path(__file__).resolve().parent / "tests" / "data"
    with np.load(golden / file) as d:
        params = {k: d[k].item() for k in keys}
        bcs = dict(zip(d["bc_attrs"].tolist(), d["bc_temps"].tolist()))
        ref = torch.from_numpy(d["Tc"][-1]).cuda()
        steps = int(d["steps"])
        periodic = tuple(d["periodic"].tolist()) if "periodic" in d else ()
        kw = {f"{k}_bcs": d[k].tolist() for k in ("diffuse", "specular")
              if k in d}
    if periodic:
        params["periodic"] = periodic
    s = SourceIterationSolver(*unit_cube(**params), bcs, device="cuda", **kw)
    if lr is not None:
        tracing.reset()
    r = s.solve(tol=0, max_iter=steps, verbose=False)
    rel, ab = rel_err(r.Tc, ref)
    ring = ("multi-class ring" if getattr(s, "_multi", None) is not None
            else f"K1 {k1_by_variant()}"
            if lr is not None else s.sweep_mode)
    log(f"[smoke] golden {file} {params} {kw} {steps} steps ({ring}): Tc "
        f"rel {rel:.3e} (abs {ab:.3e}), tolerance {GOLDEN_RTOL}")
    if not rel <= GOLDEN_RTOL:
        raise RuntimeError(f"GPU Tc disagrees with the pbte_tpu golden {file}")
    if repro:
        repro_check(s, repro)
    if lr is None:
        return rel
    return rel, k1_by_variant(), s


def phase_accel_golden(SourceIterationSolver, unit_cube, lr):
    """The port's float64 BiCGStab solve through the f64 kernel against
    pbte_tpu's float64 XLA ring (tests/data/torch_port_golden_accel.npz):
    Tc and Tv, the step count and the Tv residual."""
    golden = pathlib.Path(__file__).resolve().parent / "tests" / "data"
    with np.load(golden / "torch_port_golden_accel.npz") as d:
        params = {k: int(d[k]) for k in PARAM_KEYS}
        bcs = dict(zip(d["bc_attrs"].tolist(), d["bc_temps"].tolist()))
        ref = {k: torch.from_numpy(d[k]).cuda() for k in ("Tc", "Tv")}
        steps, max_iter = int(d["iterations"]), int(d["max_iter"])
        ref_res = float(d["residual"])
    s = SourceIterationSolver(*unit_cube(**params), bcs, device="cuda",
                              dtype=torch.float64)
    tracing.reset()
    r = s.solve(tol=0, max_iter=max_iter, verbose=False,
                accelerate="bicgstab")
    n_f64 = k1_launches(state="f64")
    tc_rel, tc_abs = rel_err(r.Tc, ref["Tc"])
    tv_rel, _ = rel_err(r.Tv, ref["Tv"])
    res_rel = abs(r.residual - ref_res) / ref_res
    log(f"[smoke] golden torch_port_golden_accel.npz {params} f64 bicgstab "
        f"max_iter={max_iter}: {r.iterations} step applications (golden "
        f"{steps}), {n_f64} f64 kernel launches, Tc rel {tc_rel:.3e} (abs "
        f"{tc_abs:.3e}), Tv rel {tv_rel:.3e}, Tv residual rel "
        f"{res_rel:.3e}, tolerance {ACCEL_GOLDEN_RTOL}")
    if not (r.iterations == steps
            and n_f64 == len(s.consts["buckets"]) * steps
            and max(tc_rel, tv_rel, res_rel) <= ACCEL_GOLDEN_RTOL):
        raise RuntimeError("the GPU's f64 BiCGStab solve disagrees with the "
                           "pbte_tpu golden")
    return tc_rel


def phase_scan_golden(SourceIterationSolver, tet_cube):
    """The port's f32 scan on the GPU against pbte_tpu's scan golden
    (tests/data/torch_port_golden_scan.npz: a 6-tet cube with diffuse
    walls, the class-batched full factor cache)."""
    golden = pathlib.Path(__file__).resolve().parent / "tests" / "data"
    with np.load(golden / "torch_port_golden_scan.npz") as d:
        params = {k: int(d[k]) for k in ("n", "order", "polar", "azimuth",
                                         "nspec")}
        bcs = dict(zip(d["bc_attrs"].tolist(), d["bc_temps"].tolist()))
        ref = torch.from_numpy(d["Tc"][-1]).cuda()
        steps = int(d["steps"])
        diffuse = d["diffuse"].tolist()
    s = SourceIterationSolver(*tet_cube(**params), bcs, device="cuda",
                              diffuse_bcs=diffuse, sweep_mode="scan",
                              cache_policy="full")
    r = s.solve(tol=0, max_iter=steps, verbose=False)
    rel, ab = rel_err(r.Tc, ref)
    log(f"[smoke] golden torch_port_golden_scan.npz {params} diffuse="
        f"{diffuse} scan {s.cache_policy} ncls={s._scan.ncls} {steps} steps: "
        f"Tc rel {rel:.3e} (abs {ab:.3e}), tolerance {GOLDEN_RTOL}")
    if not (s.sweep_mode == "scan" and rel <= GOLDEN_RTOL):
        raise RuntimeError("the GPU's scan path disagrees with the pbte_tpu "
                           "scan golden")
    repro_check(s, "scan golden 3^3 tets, diffuse walls (the scan's "
                   "closure scatters)")
    return rel


def phase_super_golden(SourceIterationSolver, tet_box):
    """The port's f32 supercell ring on the GPU against pbte_tpu's
    (tests/data/torch_port_golden_super.npz: a small 6-tet box with
    ``supercell="on"``, pbte_tpu's XLA ring with f32 operands)."""
    golden = pathlib.Path(__file__).resolve().parent / "tests" / "data"
    with np.load(golden / "torch_port_golden_super.npz") as d:
        params = {k: int(d[k]) for k in ("nx", "ny", "nz", "order", "polar",
                                         "azimuth", "nspec")}
        bcs = dict(zip(d["bc_attrs"].tolist(), d["bc_temps"].tolist()))
        ref = torch.from_numpy(d["Tc"][-1]).cuda()
        steps = int(d["steps"])
    s = SourceIterationSolver(*tet_box(**params), bcs, device="cuda",
                              supercell="on")
    r = s.solve(tol=0, max_iter=steps, verbose=False)
    rel, ab = rel_err(r.Tc, ref)
    log(f"[smoke] golden torch_port_golden_super.npz {params} supercell "
        f"G={s.G} D'={s.D} {steps} steps: Tc rel {rel:.3e} (abs {ab:.3e}), "
        f"tolerance {GOLDEN_RTOL}")
    if not (s._super is not None and rel <= GOLDEN_RTOL):
        raise RuntimeError("the GPU's supercell ring disagrees with the "
                           "pbte_tpu supercell golden")
    return rel


def profile_steps(solver, state, n):
    """torch.profiler over n steps from ``state``: per step, the device
    kernel launches, the copies and fills, and the device milliseconds,
    and the kernels that took the most device time; None for each where
    the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s = state
        for _ in range(n):
            s = solver.step(*s)[:3]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the program's spans (``tracing``) may show on the device's timeline
    # too: not kernels
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith("pbte.")]
    if not dev:
        return dict(launches_per_step=None, copies_per_step=None,
                    device_ms_per_step=None, profiled_ms_per_step=None,
                    top=None, top_ops=None)
    ops = []  # (aten op, self device us): the ops that launched kernels
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0 and e.key.startswith("aten::"):
            ops.append((e.key, us))
    ops.sort(key=lambda kv: -kv[1])
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(
        launches_per_step=(len(dev) - len(copies)) / n,
        copies_per_step=len(copies) / n,
        device_ms_per_step=us / n / 1e3,
        profiled_ms_per_step=wall / n * 1e3,
        top=[dict(name=k[:100], ms_per_step=v / n / 1e3, share=v / us)
             for k, v in top],
        top_ops=[dict(op=k, ms_per_step=v / n / 1e3, share=v / us)
                 for k, v in ops[:10]])


def phase_tet_scan(SourceIterationSolver, problem, prob, lr, card):
    """The legacy production tet shape ``prob`` through the scan path
    (phase 9); returns its row and the Tc of its 3 f32 and 3 f64 steps (on
    the host)."""
    t0 = time.perf_counter()
    s = SourceIterationSolver(*prob, problem.WALL_BCS, device="cuda",
                              **problem.LEGACY_TET_SOLVER)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    sv = s._scan
    ne, D, K, BS = s.ne, s.D, s.K, s.BS
    state_bytes = s.G * s.Km * BS * D * ne * 4
    log(f"[smoke] legacy tet {problem.LEGACY_TET} setup {setup_s:.1f} s: "
        f"sweep_mode={s.sweep_mode} cache_policy={s.cache_policy} "
        f"ncls={sv.ncls} G={s.G} Km={s.Km} L={s.L} W={s.W} segments="
        f"{sv.segments} hoisted rhs={sv._hoist_rhs} sequential groups="
        f"{sv._seq_groups}, f32 state {state_bytes / 1e9:.3f} GB")
    if not (s.sweep_mode == "scan" and s.cache_policy == "full"
            and sv.ncls > 0):
        raise RuntimeError("the legacy tet shape did not take the scan path "
                           "with the class factor cache")
    torch.cuda.reset_peak_memory_stats()
    tracing.reset()
    u, Tc, Tv = s.initial_state()
    res = []
    for _ in range(WARMUP_STEPS):
        u, Tc, Tv, r = s.step(u, Tc, Tv)
        res.append(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TET_TIMED_STEPS):
        u, Tc, Tv, r = s.step(u, Tc, Tv)
        res.append(r)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = [float(x) for x in res]
    ms = wall / TET_TIMED_STEPS * 1e3
    row = dict(
        ne=ne, D=D, K=K, BS=BS, G=s.G, Km=s.Km, L=s.L, ncls=sv.ncls,
        segments=len(sv.segments), setup_s=setup_s, ms_per_step=ms,
        dof_per_s=TET_TIMED_STEPS * K * BS * ne * D / wall,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        k1_launches=k1_launches(), residuals=res)
    if Tc.shape != (ne, D) or not torch.isfinite(Tc).all():
        raise RuntimeError("legacy tet: Tc is not finite of shape (ne, D)")
    if not (np.all(np.isfinite(res)) and res[-1] < res[0]):
        raise RuntimeError(f"legacy tet: residuals not finite and falling: "
                           f"{res}")
    prof = profile_steps(s, (u, Tc, Tv), TET_PROFILED_STEPS)
    if prof["launches_per_step"] is None:
        raise RuntimeError("legacy tet: torch.profiler saw no device activity")
    row.update(prof)
    # the device's busy share: kernel time over wall time, both of the
    # profiled steps
    row["busy_share"] = (prof["device_ms_per_step"]
                         / prof["profiled_ms_per_step"])
    del u, Tc, Tv

    # 3 steps from the zero state: f32, f64, and f32 with the class streams
    from pbte_tpu_torch.solver import scan

    outs = {}
    for key, dt, budget in (("f32", torch.float32, None),
                            ("f64", torch.float64, None),
                            ("f32_class_streams", torch.float32, 0)):
        if key != "f32":
            del s
            torch.cuda.empty_cache()
            saved = scan.CLASS_OPS_BUDGET
            if budget is not None:
                scan.CLASS_OPS_BUDGET = budget
            try:
                t0 = time.perf_counter()
                s = SourceIterationSolver(*prob, problem.WALL_BCS,
                                          device="cuda", dtype=dt,
                                          **problem.LEGACY_TET_SOLVER)
                torch.cuda.synchronize()
            finally:
                scan.CLASS_OPS_BUDGET = saved
            row[f"{key}_setup_s"] = time.perf_counter() - t0
            if s._scan._scan_cls_ops != (budget is not None):
                raise RuntimeError(f"legacy tet {key}: class streams "
                                   f"{s._scan._scan_cls_ops}")
            torch.cuda.reset_peak_memory_stats()
        st = s.initial_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TET_COMPARE_STEPS):
            st = s.step(*st)[:3]
        torch.cuda.synchronize()
        row[f"{key}_ms_per_step"] = (
            (time.perf_counter() - t0) / TET_COMPARE_STEPS * 1e3)
        if key != "f32":
            row[f"{key}_max_memory_allocated"] = (
                torch.cuda.max_memory_allocated())
        outs[key] = st[1]
        del st
    rel, ab = rel_err(outs["f32"], outs["f64"])
    row["f32_vs_f64_rel"] = rel
    tc_3 = {k: outs[k].cpu() for k in ("f32", "f64")}
    cs_rel, _ = rel_err(outs["f32_class_streams"], outs["f32"])
    row["class_streams_vs_f32_rel"] = cs_rel
    del s, outs
    torch.cuda.empty_cache()
    log(f"[smoke] legacy tet scan " + json.dumps(row))
    log(f"[smoke] legacy tet scan: {ms:.3f} ms/step, "
        f"{row['dof_per_s']:.4g} DOF/s, peak "
        f"{row['max_memory_allocated'] / 1e9:.2f} GB, "
        f"{prof['launches_per_step']} launches/step, busy share "
        f"{row['busy_share']:.4f}, f32 vs f64 {TET_COMPARE_STEPS} steps Tc "
        f"rel {rel:.3e} (abs {ab:.3e}), tolerance {TET_F32_F64_RTOL}; class "
        f"streams {row['f32_class_streams_ms_per_step']:.3f} ms/step, Tc rel "
        f"{cs_rel:.3e} to the f32 steps, tolerance {TET_CLASS_STREAMS_RTOL}; "
        f"on {card}")
    if not rel <= TET_F32_F64_RTOL:
        raise RuntimeError("legacy tet: f32 and f64 scans disagree")
    if not cs_rel <= TET_CLASS_STREAMS_RTOL:
        raise RuntimeError("legacy tet: the class streams disagree")

    # phase 16 (c): the scan's closure scatters at the legacy tet shape cut
    # to REPRO_TET's bands, with diffuse walls
    s = SourceIterationSolver(
        *problem.tet_cube(**dict(problem.LEGACY_TET, **REPRO_TET)),
        {a: t for a, t in problem.WALL_BCS.items()
         if a not in REPRO_TET_DIFFUSE},
        diffuse_bcs=list(REPRO_TET_DIFFUSE), device="cuda",
        **problem.LEGACY_TET_SOLVER)
    if s.sweep_mode != "scan":
        raise RuntimeError("the legacy tet with diffuse walls did not scan")
    repro_check(s, f"legacy tet {REPRO_TET} diffuse walls "
                   f"{list(REPRO_TET_DIFFUSE)} (the scan's closure scatters)")
    del s
    torch.cuda.empty_cache()
    return row, tc_3


def phase_tet_super(SourceIterationSolver, problem, prob, lr, card, tc_scan,
                    refs):
    """The legacy production tet shape ``prob`` with the solver's defaults
    (phase 10): it must resolve to the supercell ring (G = 8 octant groups
    of the 5^3 macro lattice, D' = 6 x 20 = 120, L = 13, W = 25). Set-up
    with the factor build on its own, 2 + 10 timed steps, DOF/s, peak
    memory, the profiler's launches, busy share and top ops over 2 more
    steps, and 3 steps from the zero state against the scan's 3 f32 steps
    ``tc_scan["f32"]`` (the two paths are iterate-exact: f32 roundoff);
    then the same 3 steps in float64 against the scan's float64 steps. The
    ring is torch products, so no kernel of the kernels line launches here
    (held: K1's count stays 0). The bf16-state ring runs between
    (``phase_tet_super_bf16``). Puts the problem and the f32 ring's 3-step
    Tc into ``refs["tet"]`` for phase 14 (f). Returns its row."""
    tracing.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = SourceIterationSolver(*prob, problem.WALL_BCS, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    ne, D, K, BS = s.ne, s.D, s.K, s.BS
    log(f"[smoke] legacy tet supercell {problem.LEGACY_TET} setup "
        f"{setup_s:.1f} s: sweep_mode={s.sweep_mode} supercell="
        f"{s._super is not None} G={s.G} Km={s.Km} L={s.L} W={s.W} D'={D} "
        f"buckets={[(len(g), k) for g, k in s._ring_buckets]}")
    factor_build_s = stage_s("pbte.setup.supercell_factor")
    log(f"[smoke] legacy tet supercell factor build {factor_build_s:.2f} s "
        f"(float64 block forward substitution on the card)")
    if not (s._super is not None and s.sweep_mode == "ring"
            and (s.G, D, s.L, s.W) == (8, 120, 13, 25)):
        raise RuntimeError("the legacy tet shape did not resolve to the "
                           "supercell ring with G=8, D'=120, L=13, W=25")
    setup_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    u, Tc, Tv = s.initial_state()
    res = []
    for _ in range(WARMUP_STEPS):
        u, Tc, Tv, r = s.step(u, Tc, Tv)
        res.append(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TET_TIMED_STEPS):
        u, Tc, Tv, r = s.step(u, Tc, Tv)
        res.append(r)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = [float(x) for x in res]
    ms = wall / TET_TIMED_STEPS * 1e3
    row = dict(
        ne=ne, D=D, K=K, BS=BS, G=s.G, Km=s.Km, L=s.L, W=s.W,
        setup_s=setup_s, factor_build_s=factor_build_s,
        setup_max_memory_allocated=setup_peak, ms_per_step=ms,
        dof_per_s=TET_TIMED_STEPS * K * BS * ne * D / wall,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        residuals=res)
    if Tc.shape != (ne, D) or not torch.isfinite(Tc).all():
        raise RuntimeError("legacy tet supercell: Tc is not finite of shape "
                           "(ne, D)")
    if not (np.all(np.isfinite(res)) and res[-1] < res[0]):
        raise RuntimeError(f"legacy tet supercell: residuals not finite and "
                           f"falling: {res}")
    prof = profile_steps(s, (u, Tc, Tv), TET_PROFILED_STEPS)
    if prof["launches_per_step"] is None:
        raise RuntimeError("legacy tet supercell: torch.profiler saw no "
                           "device activity")
    row.update(prof)
    row["busy_share"] = (prof["device_ms_per_step"]
                         / prof["profiled_ms_per_step"])
    u32 = (u, Tc, Tv)
    st = s.initial_state()
    for _ in range(TET_COMPARE_STEPS):
        st = s.step(*st)[:3]
    rel, ab = rel_err(s.Tc_fine(st[1]), tc_scan["f32"].cuda())
    row["vs_scan_rel"] = rel
    row["bf16"] = phase_tet_super_bf16(SourceIterationSolver, problem, prob,
                                       card, s, u32, st[1])
    refs["tet"] = (prob, dict(bc_temps=problem.WALL_BCS), st[1].cpu())
    repro_check(s, "legacy tet supercell ring")
    del s, st, u32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = SourceIterationSolver(*prob, problem.WALL_BCS, device="cuda",
                              dtype=torch.float64)
    torch.cuda.synchronize()
    row["f64_setup_s"] = time.perf_counter() - t0
    row["f64_factor_build_s"] = (stage_s("pbte.setup.supercell_factor")
                                 - factor_build_s)
    st = s.initial_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TET_COMPARE_STEPS):
        st = s.step(*st)[:3]
    torch.cuda.synchronize()
    row["f64_ms_per_step"] = (time.perf_counter() - t0) / TET_COMPARE_STEPS * 1e3
    row["f64_max_memory_allocated"] = torch.cuda.max_memory_allocated()
    rel64, _ = rel_err(s.Tc_fine(st[1]), tc_scan["f64"].cuda())
    row["f64_vs_scan_rel"] = rel64
    row["k1_launches"] = k1_launches()
    del s, st
    torch.cuda.empty_cache()
    log(f"[smoke] legacy tet supercell " + json.dumps(row))
    log(f"[smoke] legacy tet supercell: {ms:.3f} ms/step, "
        f"{row['dof_per_s']:.4g} DOF/s, peak "
        f"{row['max_memory_allocated'] / 1e9:.2f} GB, "
        f"{prof['launches_per_step']} launches/step, busy share "
        f"{row['busy_share']:.4f}; {TET_COMPARE_STEPS} steps Tc against the "
        f"scan's rel {rel:.3e} (abs {ab:.3e}), tolerance {TET_SUPER_RTOL}; "
        f"f64 {row['f64_ms_per_step']:.3f} ms/step, peak "
        f"{row['f64_max_memory_allocated'] / 1e9:.2f} GB, Tc against the "
        f"f64 scan's rel {rel64:.3e}, tolerance {TET_SUPER_F64_RTOL}; "
        f"no kernel of the kernels line launched (K1 "
        f"{row['k1_launches']}): the ring is torch products; on {card}")
    if not (rel <= TET_SUPER_RTOL and rel64 <= TET_SUPER_F64_RTOL):
        raise RuntimeError("legacy tet: the supercell ring and the scan "
                           "disagree")
    if row["k1_launches"]:
        raise RuntimeError("legacy tet supercell: K1 launched")
    return row


def phase_tet_super_bf16(SourceIterationSolver, problem, prob, card, s32,
                         st32, tc32):
    """Phase 10's bf16 part: the legacy tet shape with
    ``PBTE_RING_STATE_BF16=1`` must resolve to the supercell ring with bf16
    state. Set-up, 2 warm-up steps, then TET_TIMED_STEPS steps in turns
    with the f32 ring ``s32`` (from its state ``st32``), each step timed by
    CUDA events, ms/step of both; the bf16 ring's own peak memory over 2
    steps of it alone (above what the f32 ring holds: its consts, state and
    step temporaries, as phase 10's f32 peak counts them);
    torch.profiler over 2 more steps; 3 steps
    from the zero state against the f32 ring's 3 (``tc32``) at
    TET_SUPER_BF16_RTOL of max; finite, falling residuals. Returns its
    row."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()  # what the f32 ring holds
    os.environ["PBTE_RING_STATE_BF16"] = "1"
    try:
        t0 = time.perf_counter()
        s = SourceIterationSolver(*prob, problem.WALL_BCS, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
    finally:
        del os.environ["PBTE_RING_STATE_BF16"]
    if not (s._super is not None and s.sweep_mode == "ring"
            and s.state_dtype == torch.bfloat16):
        raise RuntimeError("the legacy tet shape with PBTE_RING_STATE_BF16=1 "
                           "did not resolve to the supercell ring with bf16 "
                           "state")
    st = s.initial_state()
    res = []
    for _ in range(WARMUP_STEPS):
        *st, r = s.step(*st)
        res.append(r)
    ms = {"bf16": 0.0, "f32": 0.0}
    torch.cuda.synchronize()
    for _ in range(TET_TIMED_STEPS):
        for key in ("f32", "bf16"):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            if key == "bf16":
                *st, r = s.step(*st)
                res.append(r)
            else:
                st32 = s32.step(*st32)[:3]
            e1.record()
            torch.cuda.synchronize()
            ms[key] += e0.elapsed_time(e1) / TET_TIMED_STEPS
    if st[0][0].dtype != torch.bfloat16:
        raise RuntimeError("legacy tet supercell bf16: the state is not bf16")
    del st32  # the f32 ring's memory back to ``base``
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(WARMUP_STEPS):
        *st, r = s.step(*st)
        res.append(r)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    res = [float(x) for x in res]
    prof = profile_steps(s, tuple(st), TET_PROFILED_STEPS)
    del st
    st = s.initial_state()
    for _ in range(TET_COMPARE_STEPS):
        st = s.step(*st)[:3]
    rel, ab = rel_err(st[1], tc32)
    ne, D, K, BS = s.ne, s.D, s.K, s.BS
    row = dict(setup_s=setup_s, ms_per_step=ms["bf16"],
               f32_ms_per_step_in_turns=ms["f32"],
               dof_per_s=K * BS * ne * D / (ms["bf16"] * 1e-3),
               max_memory_allocated=peak, residuals=res, vs_f32_rel=rel,
               vs_f32_abs=ab, tolerance=TET_SUPER_BF16_RTOL,
               launches_per_step=prof["launches_per_step"],
               device_ms_per_step=prof["device_ms_per_step"],
               top=prof["top"], top_ops=prof["top_ops"])
    del s, st
    torch.cuda.empty_cache()
    log("[smoke] legacy tet supercell bf16 " + json.dumps(row))
    log(f"[smoke] legacy tet supercell bf16 state: {ms['bf16']:.3f} ms/step "
        f"against the f32 ring's {ms['f32']:.3f} in turns, "
        f"{row['dof_per_s']:.4g} DOF/s, peak {peak / 1e9:.2f} GB (its own), "
        f"set-up {setup_s:.1f} s; {TET_COMPARE_STEPS} steps Tc against the "
        f"f32 ring's rel {rel:.3e} (abs {ab:.3e}), tolerance "
        f"{TET_SUPER_BF16_RTOL}; on {card}")
    if not (np.all(np.isfinite(res)) and res[-1] < res[0]):
        raise RuntimeError(f"legacy tet supercell bf16: residuals not finite "
                           f"and falling: {res}")
    if not rel <= TET_SUPER_BF16_RTOL:
        raise RuntimeError("legacy tet: the bf16 supercell ring and the f32 "
                           "ring disagree")
    return row


def count_plain_sweeps(lr):
    """Wrap K1's plain version so every call of it is counted; returns
    (calls list, restore function)."""
    calls = []
    plain = lr.lattice_ring_sweep_ref

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    lr.lattice_ring_sweep_ref = counted

    def restore():
        lr.lattice_ring_sweep_ref = plain
    return calls, restore


def time_lattice(s, name, card, steps):
    """2 warm-up + ``steps`` timed steps of solver ``s`` from the zero
    state, with K1's launches by variant and state counted over all of them
    and every call of K1's plain version counted (on the card it must never
    run); returns the row."""
    from pbte_tpu_torch.ops import lattice_ring as lr

    plain_calls, restore = count_plain_sweeps(lr)
    try:
        torch.cuda.reset_peak_memory_stats()
        tracing.reset()
        u, Tc, Tv = s.initial_state()
        res = []
        for _ in range(WARMUP_STEPS):
            u, Tc, Tv, r = s.step(u, Tc, Tv)
            res.append(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            u, Tc, Tv, r = s.step(u, Tc, Tv)
            res.append(r)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    res = [float(x) for x in res]
    ne, D, K, BS = s.ne, s.D, s.K, s.BS
    row = dict(
        ne=ne, D=D, K=K, BS=BS, G=s.G, L=s.L, W=s.W, state=str(u[0].dtype),
        buckets=[[int(len(g)), km] for g, km in s._ring_buckets],
        windows=s.win is not None, multi_class=s._multi is not None,
        ms_per_step=wall / steps * 1e3,
        dof_per_s=steps * K * BS * ne * D / wall,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        k1_by_variant=k1_by_variant(),
        k1_by_state=k1_by_state(),
        plain_calls=len(plain_calls), residuals=res)
    log(f"[smoke] {name} " + json.dumps(row))
    log(f"[smoke] {name}: {row['ms_per_step']:.3f} ms/step, "
        f"{row['dof_per_s']:.4g} DOF/s, peak "
        f"{row['max_memory_allocated'] / 1e9:.2f} GB, K1 launches "
        f"{row['k1_by_variant']}, plain sweeps {len(plain_calls)}; "
        f"on {card}")
    if plain_calls:
        raise RuntimeError(f"{name}: K1's plain version ran on the card")
    if Tc.shape != (ne, D) or not torch.isfinite(Tc).all():
        raise RuntimeError(f"{name}: Tc is not finite of shape (ne, D)")
    if not (np.all(np.isfinite(res)) and res[-1] < res[0]):
        raise RuntimeError(f"{name}: residuals not finite and falling: {res}")
    del u, Tc, Tv
    return row


def phase_new_lattices(SourceIterationSolver, problem, lr, card, wide_prob,
                       quad_prob, refs):
    """Phase 11: the lattices the port took on the card in no earlier run.
    The wide hex 24^3 p=2 (flagship angles and bands, W = 576) in f32 state
    (``wide_f32``), bf16 and f64: 2 + 10 timed steps each through K1's
    tiled kernel, every launch counted by variant and no plain sweep; the
    quad 64^2 p=2 through the one-CTA kernel at D = 9; then the graded hex
    16^3 p=2 (x spacing alternating 1 : 2) on the multi-class torch ring,
    timed, and its 3 f32 and 3 f64 steps from the zero state held against
    the same problem's scan (GRADED_RTOL, GRADED_F64_RTOL of max). Puts the
    graded problem and its ring's 3 f32 steps' Tc into ``refs["graded"]``
    for phase 14 (f). Returns {row name: row}."""
    rows = {}
    n_steps = WARMUP_STEPS + NEW_TIMED_STEPS
    for name, prob, bcs, kw, env, variant in (
            ("wide_f32", wide_prob, problem.WALL_BCS, {}, None, "tiled"),
            ("wide_bf16", wide_prob, problem.WALL_BCS, {}, "1", "tiled"),
            ("wide_f64", wide_prob, problem.WALL_BCS,
             dict(dtype=torch.float64), None, "tiled"),
            ("quad_f32", quad_prob, problem.SQUARE_BCS, {}, None,
             "persistent")):
        if env:
            os.environ["PBTE_RING_STATE_BF16"] = env
        try:
            t0 = time.perf_counter()
            s = SourceIterationSolver(*prob, bcs, device="cuda", **kw)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
        finally:
            os.environ.pop("PBTE_RING_STATE_BF16", None)
        row = time_lattice(s, name, card, NEW_TIMED_STEPS)
        row["setup_s"] = setup_s
        repro_check(s, f"{name} (K1 {variant})")
        want = {variant: len(s._ring_buckets) * n_steps}
        got = {k: v for k, v in row["k1_by_variant"].items() if v}
        if got != want:
            raise RuntimeError(f"{name}: K1 launches {got}, want {want}")
        rows[name] = row
        del s
        torch.cuda.empty_cache()

    # the graded lattice: the multi-class ring against the scan
    t0 = time.perf_counter()
    graded = problem.graded_cube(**GRADED)
    assembly_s = time.perf_counter() - t0
    tc = {}
    for dt in (torch.float32, torch.float64):
        for mode in ("auto", "scan"):
            t0 = time.perf_counter()
            s = SourceIterationSolver(*graded, problem.WALL_BCS,
                                      device="cuda", dtype=dt,
                                      sweep_mode=mode)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            if mode == "auto" and not (s.sweep_mode == "ring"
                                       and s._multi is not None):
                raise RuntimeError("the graded lattice did not take the "
                                   "multi-class ring")
            if (mode, dt) == ("auto", torch.float32):
                row = time_lattice(s, "graded_f32", card, NEW_TIMED_STEPS)
                row.update(setup_s=setup_s, assembly_s=assembly_s,
                           ncls=int(s._multi[0].cls_oh.shape[0]),
                           coupling_classes=[
                               int(mb.cstack.shape[0]) // s.D
                               for mb in s._multi])
                if any(row["k1_by_variant"].values()):
                    raise RuntimeError("graded_f32: K1 launched on the "
                                       "multi-class ring")
                rows["graded_f32"] = row
                repro_check(s, "graded 16^3 multi-class ring")
            st = s.initial_state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TET_COMPARE_STEPS):
                st = s.step(*st)[:3]
            torch.cuda.synchronize()
            key = f"{mode}_{str(dt).split('.')[-1]}"
            rows["graded_f32"][f"{key}_ms_per_step"] = (
                (time.perf_counter() - t0) / TET_COMPARE_STEPS * 1e3)
            tc[key] = st[1]
            del s, st
            torch.cuda.empty_cache()
    rel, ab = rel_err(tc["auto_float32"], tc["scan_float32"])
    rel64, _ = rel_err(tc["auto_float64"], tc["scan_float64"])
    refs["graded"] = (graded, dict(bc_temps=problem.WALL_BCS),
                      tc["auto_float32"].cpu())
    row = rows["graded_f32"]
    row.update(vs_scan_rel=rel, f64_vs_scan_rel=rel64)
    log(f"[smoke] graded lattice: {TET_COMPARE_STEPS} steps of the "
        f"multi-class ring against the scan's: f32 Tc rel {rel:.3e} (abs "
        f"{ab:.3e}), tolerance {GRADED_RTOL}; f64 rel {rel64:.3e}, tolerance "
        f"{GRADED_F64_RTOL}; ms/step ring f32 "
        f"{row['auto_float32_ms_per_step']:.2f}, scan f32 "
        f"{row['scan_float32_ms_per_step']:.2f}, ring f64 "
        f"{row['auto_float64_ms_per_step']:.2f}, scan f64 "
        f"{row['scan_float64_ms_per_step']:.2f}; on {card}")
    if not (rel <= GRADED_RTOL and rel64 <= GRADED_F64_RTOL):
        raise RuntimeError("the graded lattice: the multi-class ring and the "
                           "scan disagree")
    return rows


def cli_config(path):
    """Phase 12's YAML config: the flagship's walls, angles and bands (the
    subset form config/config.yaml has, which the port reads without
    PyYAML)."""
    from pbte_tpu_torch.problem import FLAGSHIP, WALL_BCS

    lines = ["mesh:", "  path: unit-cube-hex", "boundary_conditions:"]
    for attr, temp in WALL_BCS.items():
        lines += [f"  - attr: {attr}", f"    temperature: {temp}"]
    lines += ["angles:", "  dimension: 3",
              f"  polar_points: {FLAGSHIP['polar']}",
              f"  azimuth_points: {FLAGSHIP['azimuth']}",
              "  polar_scheme: gauss", "  azimuth_scheme: gauss",
              "numerical:", f"  n_spectral: {FLAGSHIP['nspec']}"]
    pathlib.Path(path).write_text("\n".join(lines) + "\n")


def cli_line(out, key):
    """The CLI's printed line that holds ``key``."""
    return next(line for line in out.splitlines() if key in line)


def cli_seconds(line):
    """The cumulative seconds a CLI set-up line ends with, '(12.3s)'."""
    return float(line.rsplit("(", 1)[1].rstrip("s)"))


def phase_cli_flagship(lr, card, tmp, state, flag_dof):
    """Phase 12's in-process CLI run at the flagship's width in ``state``
    ("f32" or "f64"): K1's launches by variant and the plain version's
    calls around it, the solver line, the set-up seconds by stage, the
    done line, and the residual history against the library's solve of
    ``problem.unit_cube(**FLAGSHIP)``. Returns the row."""
    import contextlib
    import gc
    import io

    from pbte_tpu_torch import cli
    from pbte_tpu_torch.problem import FLAGSHIP, WALL_BCS, unit_cube
    from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

    out_dir = tmp / f"flagship_{state}"
    n = FLAGSHIP["nx"]  # the builtin's 4^3 refined to n^3
    argv = ["-c", str(tmp / "flagship.yaml"), "-m", "unit-cube-hex", "-r",
            str(int(np.log2(n // 4))), "-o", str(FLAGSHIP["order"]), "--face-mode", "consistent",
            "--dtype", state, "--tol", "0", "--max-iter", str(CLI_ITERS),
            "--check-every", str(CLI_CHECK_EVERY), "--no-dumps", "--out",
            str(out_dir)]
    calls, restore = count_plain_sweeps(lr)
    buf = io.StringIO()
    try:
        tracing.reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
        by_variant = k1_by_variant()
        by_state = k1_by_state()
    finally:
        restore()
    gc.collect()
    torch.cuda.empty_cache()
    out = buf.getvalue()
    lines = {k: cli_line(out, k) for k in ("mesh:", "assembled", "angles:",
                                          "solver[", "done:")}
    for line in lines.values():
        log(f"[smoke] cli {state}: {line}")
    m = re.search(r"solver\[(\w+)\]: groups=(\d+) levels<=(\d+) .*"
                  r"slab=(\d+)x(\d+)", lines["solver["])
    mode, G, L, L2, W = m.group(1), *map(int, m.groups()[1:])
    done = re.search(r"done: (\d+) iters, residual (\S+), (\S+)s, (\S+) "
                     r"element-ordinate DOF/s", lines["done:"])
    secs = [cli_seconds(lines[k]) for k in ("mesh:", "assembled", "angles:",
                                            "solver[")]
    hist = np.loadtxt(out_dir / "3D/log/PBTE_NonGraySMRT_step_resisual.txt")

    # the library's solve of the same problem (elements in lattice order)
    dt = torch.float32 if state == "f32" else torch.float64
    t0 = time.perf_counter()
    s = SourceIterationSolver(*unit_cube(**FLAGSHIP), WALL_BCS,
                              device="cuda", dtype=dt)
    lib_setup = time.perf_counter() - t0
    want = len(s._ring_buckets) * CLI_ITERS  # one launch a bucket a step
    ref = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.solve(tol=0, max_iter=CLI_ITERS, check_every=CLI_CHECK_EVERY,
            verbose=False, callback=lambda it, r: ref.append((it, r)))
    torch.cuda.synchronize()
    lib_solve = time.perf_counter() - t0
    del s
    gc.collect()
    torch.cuda.empty_cache()
    ref = np.array(ref)
    rel = float(np.abs(hist[:, 1] - ref[:, 1]).max()
                / np.abs(ref[:, 1]).max())
    tol = CLI_F32_RTOL if state == "f32" else CLI_F64_RTOL
    row = dict(
        rc=rc, sweep_mode=mode, G=G, L=L, W=W,
        k1_by_variant=by_variant, k1_by_state=by_state,
        plain_calls=len(calls), iterations=int(done.group(1)),
        residual=float(done.group(2)), solve_s=float(done.group(3)),
        dof_per_s=float(done.group(4)), phase5_dof_per_s=flag_dof,
        setup_s=dict(mesh=secs[0], assembly=round(secs[1] - secs[0], 1),
                     tables=round(secs[2] - secs[1], 1),
                     solver=round(secs[3] - secs[2], 1)),
        wall_s=wall, lib_setup_s=lib_setup, lib_solve_s=lib_solve,
        lib_dof_per_s=CLI_ITERS * FLAGSHIP["polar"] * FLAGSHIP["azimuth"]
        * 2 * FLAGSHIP["nspec"] * n ** 3 * (FLAGSHIP["order"] + 1) ** 3
        / lib_solve,
        history_rows=len(hist), history_vs_library_rel=rel,
        history_tolerance=tol)
    log(f"[smoke] cli {state} " + json.dumps(row))
    log(f"[smoke] cli {state}: {row['dof_per_s']:.4g} DOF/s over the CLI's "
        f"solve against phase 5's {flag_dof:.4g} (the library's solve "
        f"{row['lib_dof_per_s']:.4g}); set-up {secs[3]:.1f} s (mesh "
        f"{secs[0]:.1f}, assembly {secs[1] - secs[0]:.1f}, tables "
        f"{secs[2] - secs[1]:.1f}, solver {secs[3] - secs[2]:.1f}); K1 "
        f"{by_variant}, plain sweeps {len(calls)}; residual history against "
        f"the library's {rel:.3e} of max (tolerance {tol}); on {card}")
    if rc != 0 or calls:
        raise RuntimeError(f"cli {state}: rc {rc}, {len(calls)} plain sweeps")
    if (mode, G, L, L2, W) != ("ring", 8, 3 * n - 2, 3 * n - 2, n * n):
        raise RuntimeError(f"cli {state}: solver line {lines['solver[']}, "
                           f"want ring G=8 L={3 * n - 2} W={n * n}")
    got = {k: v for k, v in by_variant.items() if v}
    if got != {"persistent": want} or by_state.get(state) != want:
        raise RuntimeError(f"cli {state}: K1 launches {by_variant} "
                           f"{by_state}, want {want} one-CTA {state}")
    if hist.shape != ref.shape or not np.array_equal(hist[:, 0], ref[:, 0]):
        raise RuntimeError(f"cli {state}: history rows {hist[:, 0]} against "
                           f"{ref[:, 0]}")
    if not (np.isfinite(hist).all() and rel <= tol):
        raise RuntimeError(f"cli {state}: residual history disagrees with "
                           "the library's solve")
    return row


def run_cli(args, cwd):
    """``python -m pbte_tpu_torch.cli`` of this checkout in ``cwd``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = (str(pathlib.Path(__file__).resolve().parent)
                         + os.pathsep + env.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pbte_tpu_torch.cli", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=CLI_SUBPROCESS_TIMEOUT)
    log(f"[smoke] cli subprocess {' '.join(args)}: rc {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s")
    return proc


def checked(proc, what):
    if proc.returncode != 0:
        raise RuntimeError(f"cli {what}: rc {proc.returncode}\n"
                           f"{proc.stdout[-1500:]}\n{proc.stderr[-3000:]}")
    return proc


def cli_card_vs_cpu(tmp):
    """The entry point on the card and with ``--platform cpu`` on the same
    machine, from scratch working directories, with dumps: host logs
    byte-equal, fields within CLI_CARD_RTOL of max."""
    from pbte_tpu_torch.io.outputs import compare_outputs

    runs = {}
    for name, extra in (("card", []), ("cpu", ["--platform", "cpu"])):
        cwd = tmp / f"sub_{name}"
        cwd.mkdir()
        proc = checked(run_cli(CLI_SMALL + ["--max-iter", "20"] + extra,
                               cwd), name)
        runs[name] = (proc, cwd / "output")
        log(f"[smoke] cli {name}: " + cli_line(proc.stdout, "solver[")
            + " | " + cli_line(proc.stdout, "done:"))
    if "cuda" not in cli_line(runs["card"][0].stdout, "solver["):
        raise RuntimeError("cli: the default platform did not solve on the "
                           "card")
    errs = compare_outputs(runs["card"][1], runs["cpu"][1], CLI_CARD_RTOL)
    log("[smoke] cli card against cpu: host logs byte-equal, fields "
        + json.dumps(errs) + f" of max (tolerance {CLI_CARD_RTOL})")
    return errs


def cli_resume(cwd):
    """6 iterations with a checkpoint and 4 resumed against 10 straight:
    Tc, the coefficients and the residual history within CLI_RESUME_RTOL
    of max."""
    from pbte_tpu_torch.io.outputs import field_err

    checked(run_cli(CLI_BASE + ["--max-iter", "10", "--out", "full"], cwd),
            "full")
    checked(run_cli(CLI_BASE + ["--max-iter", "6", "--out", "p1",
                                "--checkpoint", "ck.npz",
                                "--checkpoint-every", "6"], cwd), "first")
    second = checked(run_cli(CLI_BASE + ["--max-iter", "4", "--out", "p2",
                                         "--checkpoint", "ck.npz",
                                         "--resume"], cwd), "resume")
    if "resumed from" not in second.stdout:
        raise RuntimeError("cli: --resume did not resume")
    errs = {f: field_err(cwd / "p2" / f, cwd / "full" / f)
            for f in ("log/Tc_all.txt", "log/coeff_all.txt")}
    hist = "3D/log/PBTE_NonGraySMRT_step_resisual.txt"
    h_full, h_res = np.loadtxt(cwd / "full" / hist), np.loadtxt(
        cwd / "p2" / hist)
    errs["history"] = float(np.abs(h_res[:, 1] - h_full[6:, 1]).max()
                            / np.abs(h_full[:, 1]).max())
    log(f"[smoke] cli resume (6 + 4 against 10): {json.dumps(errs)} of max "
        f"(tolerance {CLI_RESUME_RTOL})")
    if not max(errs.values()) <= CLI_RESUME_RTOL:
        raise RuntimeError("cli: the resumed run disagrees")
    return errs


def cli_bicgstab(cwd):
    """--accelerate bicgstab to a linear relres of 1e-9."""
    proc = checked(run_cli(CLI_BASE + ["--accelerate", "bicgstab", "--tol",
                                       "1e-9", "--max-iter", "600",
                                       "--check-every", "10", "--no-dumps",
                                       "--out", "acc"], cwd), "bicgstab")
    acc = cli_line(proc.stdout, "bicgstab done")
    log(f"[smoke] cli {acc}")
    relres = float(re.search(r"linear relres (\S+),", acc).group(1))
    if not relres <= 1e-9:
        raise RuntimeError(f"cli: bicgstab stopped at relres {relres}")
    return acc


def cli_profile(cwd):
    """--profile writes a Chrome trace; returns the K1 kernels it names."""
    checked(run_cli(CLI_BASE + ["--max-iter", "3", "--no-dumps", "--profile",
                                "prof", "--out", "pr"], cwd), "profile")
    traces = list((cwd / "prof").glob("*.json"))
    names = {e.get("name", "") for t in traces
             for e in json.loads(t.read_text())["traceEvents"]
             if e.get("cat") == "kernel"}
    k1 = sorted(n for n in names if "lattice_ring" in n)
    log(f"[smoke] cli --profile: {len(traces)} trace, K1 kernels {k1}")
    if len(traces) != 1 or not k1:
        raise RuntimeError("cli: the profile trace names no K1 kernel")
    return k1


def cli_parallel(cwd):
    """-p 2x2 under torchrun (four gloo ranks sharing the card): the
    slab-lattice solver, the serial run's files (cli_resume's "full", 10
    steps), finite fields. Returns its done line."""
    from pbte_tpu_torch.io.outputs import files

    env = dict(os.environ)
    env["PYTHONPATH"] = (str(pathlib.Path(__file__).resolve().parent)
                         + os.pathsep + env.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = checked(subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "pbte_tpu_torch.cli", *CLI_BASE,
         "--max-iter", "10", "-p", "2x2", "--out", "par"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=CLI_SUBPROCESS_TIMEOUT),
        "-p 2x2")
    done = cli_line(proc.stdout, "done:")
    log(f"[smoke] cli -p 2x2 under torchrun in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{cli_line(proc.stdout, 'slab-lattice solver')} | {done}")
    tc = (cwd / "par/log/Tc_all.txt").read_text().split()
    if (set(files(cwd / "par")) != set(files(cwd / "full"))
            or not all(np.isfinite(float(x)) for x in tc
                       if x[0] in "-0123456789")):
        raise RuntimeError("cli -p 2x2: not the serial run's files, or "
                           "non-finite fields")
    return done


def phase_cli(lr, card, flag_dof):
    """Phase 12: the command-line interface. Returns {name: row}."""
    import tempfile

    t_phase = time.perf_counter()
    rows = {}
    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        cli_config(tmp / "flagship.yaml")
        for state in ("f32", "f64"):
            rows[state] = phase_cli_flagship(lr, card, tmp, state, flag_dof)
        cwd = tmp / "sub"
        cwd.mkdir()
        # the subprocess checks run side by side (each waits on its own
        # processes; -p 2x2 compares with the resume check's full run)
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(4) as ex:
            card_vs_cpu = ex.submit(cli_card_vs_cpu, tmp)
            chain = ex.submit(lambda: (cli_resume(cwd), cli_parallel(cwd)))
            bicgstab = ex.submit(cli_bicgstab, cwd)
            profile_k1 = ex.submit(cli_profile, cwd)
            resume, parallel = chain.result()
            rows["subprocess"] = dict(
                card_vs_cpu=card_vs_cpu.result(), resume=resume,
                bicgstab=bicgstab.result(), profile_k1=profile_k1.result(),
                parallel=parallel)
    log(f"[smoke] phase 12 (the CLI) took {time.perf_counter() - t_phase:.1f}"
        f" s")
    return rows


def general_cli(lr, tmp, state):
    """Phase 13 (a) in ``state``: the CLI at -r 7 in this process, its
    solve's result taken by wrapping ``SourceIterationSolver.solve``;
    returns (the solver line's sweep mode, the CLI's ms/step over its
    solve, Tc on the host, the solver line)."""
    import contextlib
    import io

    from pbte_tpu_torch import cli
    from pbte_tpu_torch.problem import DEFAULT_CONFIG
    from pbte_tpu_torch.solver import source_iteration as si

    got = {}
    solve = si.SourceIterationSolver.solve

    def keep(self, *a, **kw):
        got["res"] = res = solve(self, *a, **kw)
        return res

    argv = ["-c", str(DEFAULT_CONFIG), "-r", str(GENERAL_REFINE),
            "--face-mode", "consistent", "--dtype", state, "--tol", "0",
            "--max-iter", str(GENERAL_STEPS), "--check-every",
            str(GENERAL_STEPS), "--no-dumps", "--out",
            str(tmp / f"general_{state}")]
    buf = io.StringIO()
    si.SourceIterationSolver.solve = keep
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        si.SourceIterationSolver.solve = solve
    out = buf.getvalue()
    line = cli_line(out, "solver[")
    done = re.search(r"done: (\d+) iters, residual (\S+), (\S+)s",
                     cli_line(out, "done:"))
    if rc != 0 or "NotImplementedError" in out:
        raise RuntimeError(f"general ring cli {state}: rc {rc}\n{out[-2000:]}")
    mode = re.search(r"solver\[(\w+)\]", line).group(1)
    ms = float(done.group(3)) / int(done.group(1)) * 1e3
    tc = got["res"].Tc.detach().cpu()
    del got
    return mode, ms, tc, line


def time_solve(s, steps):
    """``steps`` plain steps of ``s`` from the zero state, the residual read
    at the end: (ms/step, Tc on the host)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = s.solve(tol=0, max_iter=steps, check_every=steps, verbose=False)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3, r.Tc.detach().cpu()


def phase_general(SourceIterationSolver, problem, lr, card, refs):
    """Phase 13: the general ring against the scan (see the module
    docstring). Puts the -r 7 problem and the 12^3 tet cube with its
    diffuse walls into ``refs`` for phase 14 (f). Returns {case: row}."""
    import gc
    import tempfile

    t_phase = time.perf_counter()
    rows = {}
    tracing.reset()
    calls, restore = count_plain_sweeps(lr)
    try:
        with tempfile.TemporaryDirectory() as d:
            tmp = pathlib.Path(d)
            prob, bcs = problem.config_problem(GENERAL_REFINE,
                                               face_mode="consistent")
            for state in ("f32", "f64"):
                mode, ring_ms, tc_ring, line = general_cli(lr, tmp, state)
                dt = torch.float32 if state == "f32" else torch.float64
                s = SourceIterationSolver(*prob, bcs, device="cuda", dtype=dt,
                                          sweep_mode="scan")
                scan_ms, tc_scan = time_solve(s, GENERAL_STEPS)
                del s
                gc.collect()
                torch.cuda.empty_cache()
                rel, _ = rel_err(tc_ring, tc_scan)
                rows[f"cli_r{GENERAL_REFINE}_{state}"] = row = dict(
                    sweep_mode=mode, ring_ms_per_step=ring_ms,
                    scan_ms_per_step=scan_ms, tc_rel=rel,
                    tolerance=GENERAL_RTOL[state])
                log(f"[smoke] general ring cli -r {GENERAL_REFINE} {state}: "
                    f"{line.strip()}")
                log(f"[smoke] general ring cli -r {GENERAL_REFINE} {state}: "
                    f"ring {ring_ms:.3f} ms/step (the CLI's solve), scan "
                    f"{scan_ms:.3f} ms/step, {GENERAL_STEPS} steps; Tc "
                    f"against the scan {rel:.3e} of max (tolerance "
                    f"{GENERAL_RTOL[state]}); on {card}")
                if mode != "ring" or not rel <= GENERAL_RTOL[state]:
                    raise RuntimeError(f"general ring cli {state}: {row}")
            refs["general"] = (prob, dict(bc_temps=bcs), None)
            del prob
            # phase 16 (c): the general ring at -r REPRO_GENERAL_REFINE
            prob, bcs = problem.config_problem(REPRO_GENERAL_REFINE,
                                               face_mode="consistent")
            s = SourceIterationSolver(*prob, bcs, device="cuda")
            if s.sweep_mode != "ring" or not s._general:
                raise RuntimeError("the default config did not take the "
                                   "general ring")
            repro_check(s, f"general ring -r {REPRO_GENERAL_REFINE}")
            del s, prob
        tet_bcs = {
            "dirichlet": dict(bc_temps={a: t for a, t in
                                        problem.WALL_BCS.items() if a != 6},
                              dirichlet_bcs={6: 0.1}),
            "diffuse": dict(bc_temps={a: t for a, t in
                                      problem.WALL_BCS.items()
                                      if a not in (2, 4)},
                            diffuse_bcs=[2, 4]),
        }
        for n, walls, states in ((8, "dirichlet", ("f64",)),
                                 (8, "diffuse", ("f64",)),
                                 (12, "diffuse", ("f32", "f64"))):
            prob = problem.tet_cube(n, **GENERAL_TET)
            if n == 12:
                refs["scan"] = (prob, dict(tet_bcs[walls], sweep_mode="scan"),
                                None)
            for state in states:
                dt = torch.float32 if state == "f32" else torch.float64
                ring = SourceIterationSolver(*prob, device="cuda", dtype=dt,
                                             **tet_bcs[walls])
                if ring.sweep_mode != "ring" or not ring._general:
                    raise RuntimeError(f"tet {n}^3 {walls}: auto resolved "
                                       f"to {ring.sweep_mode}, want the "
                                       "general ring")
                ring_ms, tc_ring = time_solve(ring, GENERAL_TET_STEPS)
                shape = dict(G=ring.G, L=ring.L, W=ring.W)
                if (n, state) == (12, "f32"):
                    repro_check(ring, f"general ring tet 12^3 {walls} walls "
                                      f"(the closure sums)")
                del ring
                scan = SourceIterationSolver(*prob, device="cuda", dtype=dt,
                                             sweep_mode="scan",
                                             **tet_bcs[walls])
                scan_ms, tc_scan = time_solve(scan, GENERAL_TET_STEPS)
                if (n, state) == (12, "f32"):
                    repro_check(scan, f"scan tet 12^3 {walls} walls (the "
                                      f"scan's closure scatters)")
                del scan
                gc.collect()
                torch.cuda.empty_cache()
                rel, _ = rel_err(tc_ring, tc_scan)
                rows[f"tet{n}_{walls}_{state}"] = row = dict(
                    shape, ring_ms_per_step=ring_ms,
                    scan_ms_per_step=scan_ms, tc_rel=rel,
                    tolerance=GENERAL_RTOL[state])
                log(f"[smoke] general ring tet {n}^3 {walls} {state}: "
                    + json.dumps(row) + f" ({GENERAL_TET_STEPS} steps; on "
                    f"{card})")
                if not rel <= GENERAL_RTOL[state]:
                    raise RuntimeError(f"tet {n}^3 {walls} {state}: ring "
                                       f"against scan {rel:.3e}")
    finally:
        restore()
    k1 = sum(k1_by_variant().values())
    if k1 or calls:
        raise RuntimeError(f"the general ring ran K1 ({k1} launches, "
                           f"{len(calls)} plain sweeps)")
    log(f"[smoke] phase 13 (the general ring) took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return rows


def tree_norm(tree):
    """sqrt of the sum of squares over the leaves of a state tree."""
    from pbte_tpu_torch.solver.accel import tree_dot

    return float(torch.sqrt(tree_dot(tree, tree)))


def solve_bicgstab(s64):
    """The f64 flagship's accelerated solve from the zero state: (result,
    the linear relres at every read, wall seconds)."""
    relres = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = s64.solve(tol=ACCEL_TOL, max_iter=ACCEL_MAX_ITER, verbose=False,
                    check_every=ACCEL_CHECK_EVERY, accelerate="bicgstab",
                    callback=lambda nmv, res: relres.append(res))
    torch.cuda.synchronize()
    return acc, relres, time.perf_counter() - t0


def phase_f64_flagship(SourceIterationSolver, problem, lr, walls):
    """The f64 flagship: timed steps, the accelerated solve, the plain solve
    to the same Tv residual, and refined_solve on an f32 base. Returns
    (f64 kernel launches of the phase, row)."""
    from pbte_tpu_torch.solver import accel

    s64, setup_s = build_flagship(SourceIterationSolver, problem,
                                  "f64 flagship", dtype=torch.float64,
                                  **walls)
    launches, row = phase_flagship(s64, lr, setup_s, "f64 flagship")
    torch.cuda.empty_cache()

    # the accelerated solve
    torch.cuda.reset_peak_memory_stats()
    tracing.reset()
    acc, relres, acc_s = solve_bicgstab(s64)
    acc_peak = torch.cuda.max_memory_allocated()
    acc_launches = k1_launches(state="f64")
    launches += acc_launches
    nb = len(s64.consts["buckets"])
    row.update(bicgstab=dict(
        step_applications=acc.iterations, wall_s=acc_s,
        ms_per_step_application=acc_s / acc.iterations * 1e3,
        linear_relres=relres[-1], tv_residual=acc.residual,
        max_memory_allocated=acc_peak, k1_launches=acc_launches))
    log(f"[smoke] f64 flagship bicgstab: {acc.iterations} step applications "
        f"in {acc_s:.2f} s ({acc_s / acc.iterations * 1e3:.2f} ms each), "
        f"linear relres {relres[-1]:.3e}, Tv residual {acc.residual:.3e}, "
        f"peak {acc_peak / 1e9:.2f} GB, K1 f64 launches {acc_launches} "
        f"(want {nb} x {acc.iterations}); relres every read: "
        f"{[float(f'{x:.3e}') for x in relres]}")
    if acc_launches != nb * acc.iterations or k1_launches() \
            != acc_launches:
        raise RuntimeError("the accelerated solve did not run every step "
                           "through the f64 kernel")
    if not (relres[-1] <= ACCEL_TOL and acc_peak < ACCEL_PEAK_LIMIT
            and torch.isfinite(acc.Tc).all()):
        raise RuntimeError(f"the accelerated f64 solve: {row['bicgstab']}")
    Tc_acc = acc.Tc
    n_acc = acc.iterations
    del acc
    torch.cuda.empty_cache()

    # phase 16 (b): the same solve again from the zero state repeats its
    # step applications, its relres at every read and its Tc bit for bit
    tracing.reset()
    again, relres2, again_s = solve_bicgstab(s64)
    launches += k1_launches(state="f64")
    repro_held(dict(
        path="f64 flagship bicgstab", solves=2,
        step_applications=[n_acc, again.iterations],
        relres_reads=len(relres), wall_s=[acc_s, again_s],
        bit_equal=bool(again.iterations == n_acc and relres2 == relres
                       and torch.equal(again.Tc, Tc_acc))))
    del again
    torch.cuda.empty_cache()
    repro_check(s64, "f64 flagship (K1 one-CTA f64)")

    # the plain solve to the same Tv residual
    tracing.reset()
    torch.cuda.reset_peak_memory_stats()
    tv_res = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = s64.solve(tol=row["bicgstab"]["tv_residual"],
                      max_iter=PLAIN_MAX_ITER, verbose=False,
                      callback=lambda it, res: tv_res.append(res))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    launches += k1_launches(state="f64")
    tc_rel, _ = rel_err(Tc_acc, plain.Tc)
    # the plain iteration's rate over its last 100 steps (the slowest mode)
    n = min(100, len(tv_res) - 1)
    rho = (tv_res[-1] / tv_res[-1 - n]) ** (1.0 / n)
    row.update(plain=dict(
        steps=plain.iterations, wall_s=plain_s, tv_residual=plain.residual,
        max_memory_allocated=torch.cuda.max_memory_allocated(), rate=rho,
        tc_vs_bicgstab_rel=tc_rel))
    ratio = plain.iterations / row["bicgstab"]["step_applications"]
    log(f"[smoke] f64 flagship plain solve to Tv residual "
        f"{row['bicgstab']['tv_residual']:.3e}: {plain.iterations} steps in "
        f"{plain_s:.2f} s (residual {plain.residual:.3e}), {ratio:.2f}x the "
        f"accelerated step applications, {plain_s / acc_s:.2f}x its wall "
        f"time; rate over the last {n} steps {rho:.5f}; Tc accelerated vs "
        f"plain rel {tc_rel:.3e}, tolerance {ACCEL_TC_RTOL}")
    if not (ratio >= 3 and tc_rel <= ACCEL_TC_RTOL
            and plain.residual < row["bicgstab"]["tv_residual"]):
        raise RuntimeError(f"accelerated vs plain f64: {row['plain']}")
    del plain
    torch.cuda.empty_cache()

    # iterative refinement of an f32 solve with the f64 defect step
    s32, _ = build_flagship(SourceIterationSolver, problem, "f32 base",
                            **walls)
    tracing.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = accel.refined_solve(s32, s64.step, tol=1e-7, max_iter=3000,
                              inner_tol=1e-4, inner_max_iter=2000,
                              verbose=False, check_every=10)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    launches += k1_launches(state="f64")
    x_ref = (out["u_refined"], out["Tc_refined"])
    Tv0 = torch.zeros((s64.ne,), dtype=torch.float64, device=s64.device)
    u_p, Tc_p, _, _ = s64.step(*x_ref, Tv0)
    launches += nb
    d_after = tree_norm(tuple(a.sub_(b) for a, b in zip(u_p, x_ref[0]))
                        + (Tc_p - x_ref[1],))
    del u_p, Tc_p
    gain = out["defect_norm"] / d_after
    base_rel, _ = rel_err(out["base_result"].Tc, Tc_acc)
    ref_rel, _ = rel_err(out["Tc_refined"], Tc_acc)
    row.update(refined=dict(
        base_steps=out["base_result"].iterations, wall_s=ref_s,
        defect_before=out["defect_norm"], defect_after=d_after, gain=gain,
        correction_steps=out["correction_steps"],
        correction_relres=out["correction_relres"],
        certified_bound=d_after / (1.0 - rho),
        tc_base_vs_bicgstab_rel=base_rel,
        tc_refined_vs_bicgstab_rel=ref_rel,
        max_memory_allocated=torch.cuda.max_memory_allocated()))
    log(f"[smoke] f64 refined_solve (f32 base): "
        f"{out['base_result'].iterations} base steps, defect "
        f"{out['defect_norm']:.3e} -> {d_after:.3e} ({gain:.1f}x) after "
        f"{out['correction_steps']} correction steps (relres "
        f"{out['correction_relres']:.2e}), bound ||d||/(1-rho) "
        f"{d_after / (1.0 - rho):.3e}; Tc vs the accelerated f64 solve: "
        f"base {base_rel:.3e}, refined {ref_rel:.3e}; {ref_s:.2f} s")
    if not gain >= REFINE_GAIN:
        raise RuntimeError(f"refined_solve: the defect fell {gain:.1f}x, "
                           f"want >= {REFINE_GAIN}")
    del out, x_ref, s32, s64
    torch.cuda.empty_cache()
    log(f"[smoke] f64 flagship " + json.dumps(row))
    return launches, row


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def _shard_rank(rank, world, cfg):
    """Phase 14 on one of four ranks: (a), (c), (d), (e) (see the module
    docstring); returns this rank's results (the global fields on every
    rank, from the solvers' gathers)."""
    from pbte_tpu_torch import problem
    from pbte_tpu_torch.ops import lattice_ring as lr
    from pbte_tpu_torch.parallel.comm import Grid
    from pbte_tpu_torch.parallel.slab import SlabLatticeSolver
    from pbte_tpu_torch.parallel.spatial import SpatialShardedSolver
    from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

    dev = cfg["device"]
    if dev == "cuda":
        torch.cuda.set_device(0)
    grid = Grid(dir=2, space=2)
    out = dict(rank=rank)

    # (a) the slab solver at the flagship, f32
    t0 = time.perf_counter()
    prob = problem.unit_cube(**cfg["flagship"])
    s = SlabLatticeSolver(*prob, problem.WALL_BCS, grid, device=dev)
    _sync(dev)
    out["a_setup_s"] = time.perf_counter() - t0
    out["a_shape"] = dict(L=s.L, W=s.W, G=s.G, Kl=s.Kl, BS=s.BS, D=s.D,
                          ne_loc=s.ne_loc, windows=s.win is not None)
    tcs = []
    for sweep in (lr.lattice_ring_sweep, lr.lattice_ring_sweep_ref):
        s.ring_sweep = sweep
        st = s.initial_state()
        for _ in range(3):
            st = s.step(*st)[:3]
        tcs.append(s.gather_Tc(st[1]))
        del st
    s.ring_sweep = lr.lattice_ring_sweep
    out["a_tc_kernel"], out["a_tc_plain"] = tcs
    # phase 16 (c), (d) on this rank: K1 and the slab's closure sums
    out["a_repro"] = repro_record(s, "slab 2 x 2 flagship f32 (K1; the "
                                     "slab's closure sums)")
    u, Tc, Tv = s.initial_state()
    for _ in range(2):
        u, Tc, Tv, r = s.step(u, Tc, Tv)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tracing.reset()
    res = []
    _sync(dev)
    grid.barrier()
    t0 = time.perf_counter()
    for _ in range(cfg["timed_steps"]):
        u, Tc, Tv, r = s.step(u, Tc, Tv)
        res.append(r)
    _sync(dev)
    grid.barrier()
    wall = time.perf_counter() - t0
    out["a_launches"] = k1_launches()
    out["a_ms_per_step"] = wall / cfg["timed_steps"] * 1e3
    out["a_residuals"] = [float(x) for x in res]
    # the lagged closure source alone: the exit layer's ppermute (through
    # the host on gloo) and the entry-row source
    n_src = 5
    _sync(dev)
    grid.barrier()
    t0 = time.perf_counter()
    for _ in range(n_src):
        s._closure_source(u)
    _sync(dev)
    grid.barrier()
    out["a_halo_ms"] = (time.perf_counter() - t0) / n_src * 1e3
    p = grid.index("space")
    layer = s.W * s.Kl * s.BS * s.D * u.element_size()
    out["a_halo_bytes"] = layer * (len(s._g_plus) * (p + 1 < s.P)
                                   + len(s._g_minus) * (p > 0))
    out["a_peak_bytes"] = (torch.cuda.max_memory_allocated()
                           if dev == "cuda" else 0)
    del s, u, Tc, Tv, prob
    if dev == "cuda":
        torch.cuda.empty_cache()

    # (c) slab BiCGStab, f64
    prob = problem.unit_cube(**cfg["accel"])
    s = SlabLatticeSolver(*prob, problem.WALL_BCS, grid, dtype=torch.float64,
                          device=dev)
    t0 = time.perf_counter()
    r = s.solve(tol=1e-10, max_iter=1500, verbose=False, check_every=10,
                accelerate="bicgstab")
    out["c_tc"], out["c_iterations"] = r.Tc_global(), r.iterations
    out["c_wall_s"] = time.perf_counter() - t0
    del s, r, prob

    # (d) the spatially sharded solver on 6-tet cubes, f64
    walls = problem.WALL_BCS
    for key in ("tet_small", "tet_timed"):
        c = cfg[key]
        sp = SpatialShardedSolver(
            *problem.tet_cube(**c), walls, grid, dtype=torch.float64,
            topo=problem.tet_topology(c["n"], c["n"], c["n"]), device=dev,
            partition_method="multilevel")
        if key == "tet_small":
            r = sp.solve(tol=0, max_iter=4, verbose=False)
            out["d_tc"], out["d_part"] = r.Tc_global(), sp.element_partition
            continue
        st = sp.initial_state()
        st = sp.step(*st)[:3]
        res = []
        _sync(dev)
        grid.barrier()
        t0 = time.perf_counter()
        for _ in range(10):
            *st, r = sp.step(*st)
            res.append(r)
        _sync(dev)
        grid.barrier()
        out["d_ms_per_step"] = (time.perf_counter() - t0) / 10 * 1e3
        out["d_residuals"] = [float(x) for x in res]
        out["d_tc_finite"] = bool(np.isfinite(sp.gather_Tc(st[1])).all())
        out["d_shape"] = dict(ne=sp.ne, L=sp.L, W=sp.W, G=sp.G,
                              interface=sp.pplan.num_interface)
        del sp, st
    # phase 16 (c), (d) on this rank: the spatial solver's wall sums, on
    # the small cube with diffuse and specular walls
    c = cfg["tet_small"]
    refl = dict(REPRO_SPATIAL_WALLS)
    sp = SpatialShardedSolver(
        *problem.tet_cube(**c), refl.pop("bc_temps"), grid,
        dtype=torch.float64, topo=problem.tet_topology(c["n"], c["n"], c["n"]),
        device=dev, partition_method="multilevel", **refl)
    out["d_repro"] = repro_record(sp, "spatial 2 x 2 tet 3^3, diffuse and "
                                      "specular walls (its wall sums)")
    del sp

    # (e) dir sharding of the single-device solver: 2 dir ranks (each
    # space rank a replica)
    prob = problem.unit_cube(**cfg["flagship"])
    tracing.reset()
    sd = SourceIterationSolver(*prob, walls, device=dev, dir_sharding=grid)
    st = sd.initial_state()
    for _ in range(3):
        st = sd.step(*st)[:3]
    out["e_tc"] = st[1].cpu().numpy()
    out["e_launches"] = k1_launches()
    del sd, st
    if rank != 0:  # the fields once
        for k in [k for k, v in out.items() if isinstance(v, np.ndarray)]:
            del out[k]
    return out


def _solver_path(s):
    """Which sweep a solver runs: supercell, scan, general, multi or k1."""
    if s._super is not None:
        return "supercell"
    if s.sweep_mode == "scan":
        return "scan"
    return ("general" if s._general else "multi" if s._multi is not None
            else "k1")


def _shard_path_rank(rank, world, cfg):
    """Phase 14 (f) on one of two ranks: each of SHARD_PATHS' problems (a
    pickle the parent wrote) with ``dir_sharding`` on its grid, 2 warm-up
    steps, then 3 f32 steps from the zero state timed between barriers;
    returns per case the path,
    the shard's shape, ms/step, peak memory, K1's launches and (rank 0)
    Tc."""
    import pickle

    from pbte_tpu_torch.ops import lattice_ring as lr
    from pbte_tpu_torch.parallel.comm import Grid
    from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

    dev = cfg["device"]
    if dev == "cuda":
        torch.cuda.set_device(0)
    grids, out = {}, {}
    for name, key, shape, _ in SHARD_PATHS:
        gk = tuple(shape.items())
        if gk not in grids:
            grids[gk] = Grid(**shape)
        with open(cfg["pickles"][key], "rb") as f:
            prob, kw = pickle.load(f)
        if dev == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        tracing.reset()
        t0 = time.perf_counter()
        s = SourceIterationSolver(*prob, device=dev, dir_sharding=grids[gk],
                                  **kw)
        _sync(dev)
        setup_s = time.perf_counter() - t0
        st = s.initial_state()
        for _ in range(WARMUP_STEPS):  # first launches, handles, allocator
            st = s.step(*st)[:3]
        st = s.initial_state()
        u0 = st[0][0] if isinstance(st[0], tuple) else st[0]
        grids[gk].barrier()
        t0 = time.perf_counter()
        res = []
        for _ in range(SHARD_PATH_STEPS):
            *st, r = s.step(*st)
            res.append(r)
        _sync(dev)
        grids[gk].barrier()
        wall = time.perf_counter() - t0
        out[name] = dict(
            path=_solver_path(s), shard=list(u0.shape), setup_s=setup_s,
            ms_per_step=wall / SHARD_PATH_STEPS * 1e3,
            peak_bytes=(torch.cuda.max_memory_allocated() if dev == "cuda"
                        else 0),
            k1_launches=k1_launches(),
            residuals=[float(x) for x in res],
            Tc=st[1].cpu().numpy() if rank == 0 else None)
        del s, st, u0, prob
    return out


def phase_sharded_paths(card, cfg, refs, SourceIterationSolver):
    """Phase 14 (f): SHARD_PATHS on two gloo ranks sharing the card, each
    against the single-device solver's 3 f32 steps (phases 10 and 11's,
    or computed here before the ranks take the card) at SHARD_1x1_RTOL of
    max. Returns its rows."""
    import pickle
    import tempfile

    from pbte_tpu_torch.parallel.launch import run_ranks

    dev = cfg["device"]
    rows = {}
    with tempfile.TemporaryDirectory() as d:
        pickles, tc_ref = {}, {}
        for key, (prob, kw, tc) in refs.items():
            if tc is None:
                s = SourceIterationSolver(*prob, device=dev, **kw)
                st = s.initial_state()
                for _ in range(SHARD_PATH_STEPS):
                    st = s.step(*st)[:3]
                tc = st[1].cpu()
                del s, st
            tc_ref[key] = tc
            pickles[key] = str(pathlib.Path(d) / f"{key}.pkl")
            with open(pickles[key], "wb") as f:
                pickle.dump((prob, kw), f)
        if dev == "cuda":
            torch.cuda.empty_cache()
        ranks = run_ranks(_shard_path_rank, 2, (dict(cfg, pickles=pickles),),
                          workdir=d, timeout=SHARD_TIMEOUT)
    for name, key, shape, path in SHARD_PATHS:
        got = [r[name] for r in ranks]
        rel, _ = rel_err(torch.as_tensor(got[0]["Tc"]), tc_ref[key])
        rows[name] = row = dict(
            grid=shape, path=got[0]["path"], shard=got[0]["shard"],
            setup_s=max(g["setup_s"] for g in got),
            ms_per_step=[g["ms_per_step"] for g in got],
            peak_bytes=[g["peak_bytes"] for g in got],
            k1_launches=[g["k1_launches"] for g in got],
            residuals=got[0]["residuals"], tc_rel=rel,
            tolerance=SHARD_1x1_RTOL)
        log(f"[smoke] phase 14 (f) {name}: " + json.dumps(row) + f" on {card}")
        res = row["residuals"]
        if (row["path"] != path or any(row["k1_launches"])
                or not rel <= SHARD_1x1_RTOL
                or not (np.all(np.isfinite(res)) and res[-1] < res[0])):
            raise RuntimeError(f"phase 14 (f) {name}: {row}")
    return rows


def phase_sharded(card, cfg, refs):
    """Phase 14: the domain-decomposed solvers, (a)-(e) on four ranks,
    then (f) on two (``refs``: phase_sharded_paths' problems). Returns its
    row."""
    import tempfile

    from pbte_tpu_torch import native, problem
    from pbte_tpu_torch.parallel.comm import Grid
    from pbte_tpu_torch.parallel.launch import run_ranks
    from pbte_tpu_torch.parallel.slab import SlabLatticeSolver
    from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver
    from pbte_tpu_torch.validation.oracle import solve_oracle

    t_phase = time.perf_counter()
    dev = cfg["device"]
    # both native libraries build (raise otherwise)
    native.get_lib()
    native.get_partition_lib()
    row = {}

    # (b) slab on one rank against the single-device solver, and (e)'s and
    # (c)'s references, before the ranks take the card
    prob = problem.unit_cube(**cfg["flagship"])
    one = SlabLatticeSolver(*prob, problem.WALL_BCS, Grid(dir=1, space=1),
                            device=dev)
    sd = SourceIterationSolver(*prob, problem.WALL_BCS, device=dev)
    a, b = one.initial_state(), sd.initial_state()
    for i in range(5):
        a, b = one.step(*a)[:3], sd.step(*b)[:3]
        if i == 2:
            tc3 = b[1].cpu().numpy()
    row["b_rel"] = rel_err(torch.as_tensor(one.gather_Tc(a[1])),
                           b[1].cpu())[0]
    del one, sd, a, b, prob
    prob = problem.unit_cube(**cfg["accel"])
    ref_c = SourceIterationSolver(*prob, problem.WALL_BCS,
                                  dtype=torch.float64, device=dev).solve(
        tol=1e-10, max_iter=1500, verbose=False, check_every=10,
        accelerate="bicgstab")
    tc_c = ref_c.Tc.cpu().numpy()
    del ref_c, prob
    if dev == "cuda":
        torch.cuda.empty_cache()
    log(f"[smoke] phase 14 (b) slab 1 x 1 against one device, 5 flagship "
        f"steps: Tc rel {row['b_rel']:.3e} (tolerance {SHARD_1x1_RTOL})")
    if not row["b_rel"] <= SHARD_1x1_RTOL:
        raise RuntimeError("phase 14 (b): the 1 x 1 slab disagrees")

    with tempfile.TemporaryDirectory() as d:
        ranks = run_ranks(_shard_rank, 4, (cfg,), workdir=d,
                          timeout=SHARD_TIMEOUT)
    r0 = ranks[0]
    for r in ranks:
        for key in ("a_repro", "d_repro"):
            repro_held(dict(r[key], path=f"{r[key]['path']}, rank "
                                         f"{r['rank']}"))
    a_rel = rel_err(torch.as_tensor(r0["a_tc_kernel"]),
                    torch.as_tensor(r0["a_tc_plain"]))[0]
    row["a"] = dict(
        shape=r0["a_shape"], setup_s=max(r["a_setup_s"] for r in ranks),
        kernel_vs_plain_rel=a_rel,
        ms_per_step=max(r["a_ms_per_step"] for r in ranks),
        launches=[r["a_launches"] for r in ranks],
        halo_bytes=[r["a_halo_bytes"] for r in ranks],
        halo_ms=max(r["a_halo_ms"] for r in ranks),
        peak_bytes=[r["a_peak_bytes"] for r in ranks],
        residuals=r0["a_residuals"])
    log("[smoke] phase 14 (a) slab 2 x 2 flagship f32 " + json.dumps(row["a"])
        + f" on {card}")
    if not a_rel <= F32_RTOL:
        raise RuntimeError(f"phase 14 (a): K1 against its plain version "
                           f"{a_rel:.3e} > {F32_RTOL}")
    if min(row["a"]["launches"]) == 0:
        raise RuntimeError("phase 14 (a): a rank launched no K1")
    res = row["a"]["residuals"]
    if not (np.all(np.isfinite(res)) and res[-1] < res[0]):
        raise RuntimeError(f"phase 14 (a): residuals {res}")
    row["c_rel"] = rel_err(torch.as_tensor(r0["c_tc"]),
                           torch.as_tensor(tc_c))[0]
    row["c"] = dict(iterations=r0["c_iterations"], wall_s=r0["c_wall_s"])
    log(f"[smoke] phase 14 (c) slab 2 x 2 BiCGStab f64: "
        f"{r0['c_iterations']} step applications in {r0['c_wall_s']:.1f} s, "
        f"Tc rel {row['c_rel']:.3e} against one device (tolerance "
        f"{SHARD_ACCEL_RTOL})")
    if not row["c_rel"] <= SHARD_ACCEL_RTOL:
        raise RuntimeError("phase 14 (c): the BiCGStab fixed points differ")
    c = cfg["tet_small"]
    _, Tco, *_ = solve_oracle(*problem.tet_cube(**c), problem.WALL_BCS,
                              tol=0, max_iter=4, part=r0["d_part"])
    row["d_rel"] = rel_err(torch.as_tensor(r0["d_tc"]),
                           torch.as_tensor(Tco))[0]
    row["d"] = dict(shape=r0["d_shape"], ms_per_step=r0["d_ms_per_step"],
                    residuals=r0["d_residuals"])
    log(f"[smoke] phase 14 (d) spatial 2 x 2: 3^3 tets against the lagged "
        f"oracle {row['d_rel']:.3e} (tolerance {SHARD_ORACLE_RTOL}); 12^3 "
        f"tets " + json.dumps(row["d"]) + f" on {card}")
    dres = r0["d_residuals"]
    if not (row["d_rel"] <= SHARD_ORACLE_RTOL and r0["d_tc_finite"]
            and np.all(np.isfinite(dres)) and dres[-1] < dres[0]):
        raise RuntimeError("phase 14 (d): the spatial solver failed")
    row["e_rel"] = rel_err(torch.as_tensor(r0["e_tc"]),
                           torch.as_tensor(tc3))[0]
    row["e_launches"] = [r["e_launches"] for r in ranks]
    log(f"[smoke] phase 14 (e) dir sharding over 2 ranks, 3 flagship "
        f"steps: Tc rel {row['e_rel']:.3e} (tolerance {SHARD_1x1_RTOL}), "
        f"K1 launches {row['e_launches']}")
    if not row["e_rel"] <= SHARD_1x1_RTOL or min(row["e_launches"]) == 0:
        raise RuntimeError("phase 14 (e): dir sharding failed")
    row["f"] = phase_sharded_paths(card, cfg, refs, SourceIterationSolver)
    row["seconds"] = time.perf_counter() - t_phase
    log(f"[smoke] phase 14 (the sharded solvers) took {row['seconds']:.1f} s")
    return row


def phase_compensated(solver, lr, card):
    """Phase 5's compensated solve of the f32 flagship: COMPENSATED_ITERS
    iterations through K1 (launches counted, K1's plain version never
    called), Tc finite and within COMPENSATED_RTOL of max of the plain
    iteration's after as many steps. Returns the row."""
    calls, restore = count_plain_sweeps(lr)
    try:
        tracing.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = solver.solve(tol=0, max_iter=COMPENSATED_ITERS,
                         check_every=COMPENSATED_CHECK_EVERY, verbose=False,
                         accelerate="compensated")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_variant = k1_by_variant()
        launches = k1_launches()
    finally:
        restore()
    # an iteration steps the value part once
    plain = solver.solve(tol=0, max_iter=COMPENSATED_ITERS, verbose=False,
                         check_every=COMPENSATED_ITERS)
    rel, _ = rel_err(r.Tc, plain.Tc)
    # b, two steps an iteration, a residual step every COMPENSATED_CHECK_EVERY
    # iterations and the final one, each one launch a bucket
    steps = (r.iterations + COMPENSATED_ITERS // COMPENSATED_CHECK_EVERY + 1)
    want = steps * len(solver._ring_buckets)
    row = dict(iterations=r.iterations, residual=r.residual, wall_s=wall,
               k1_launches=launches, k1_by_variant=by_variant,
               plain_calls=len(calls), vs_plain_rel=rel)
    log(f"[smoke] compensated flagship: {COMPENSATED_ITERS} iterations, "
        f"{r.iterations} step applications in {wall:.3f} s, residual "
        f"{r.residual:.3e}, K1 launches {by_variant} (want {want}), plain "
        f"sweeps {len(calls)}; Tc against {COMPENSATED_ITERS} plain steps' "
        f"rel "
        f"{rel:.3e} (tolerance {COMPENSATED_RTOL}); on {card}")
    if calls or launches != want or by_variant.get("persistent") != want:
        raise RuntimeError(f"compensated flagship: K1 launches {by_variant}, "
                           f"want {want} one-CTA; plain sweeps {len(calls)}")
    if not (torch.isfinite(r.Tc).all() and r.residual == r.residual
            and rel <= COMPENSATED_RTOL):
        raise RuntimeError("compensated flagship: Tc not finite or not the "
                           "plain iteration's")
    return row


def _p3_wide_child(conn, size, card):
    """Phase 15's process: sends ("ready", set-up) once its solver is
    built, waits for "go", then sends ("row", row); ("error", text) where
    either fails."""
    import traceback

    try:
        _p3_wide_run(conn, size, card)
    except Exception as e:  # the parent raises it
        conn.send(("error", f"{type(e).__name__}: {e}\n"
                            f"{traceback.format_exc()[-3000:]}"))
    finally:
        conn.close()


def _p3_wide_run(conn, size, card):
    import bench_torch
    from pbte_tpu_torch import problem
    from pbte_tpu_torch.ops import lattice_ring as lr
    from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

    # each stage's host memory (the card machine reports no VmHWM: its
    # peak is ru_maxrss) and device peak, logged as it ends
    stage, stages = bench_torch.stage_logger("p3_wide",
                                             torch.device("cuda"))
    t0 = time.perf_counter()
    stage("start")
    prob = problem.unit_cube(**size)
    assembly_s = time.perf_counter() - t0
    stage("assembled")
    t1 = time.perf_counter()
    s = SourceIterationSolver(*prob, problem.WALL_BCS, dtype=torch.float64,
                              device="cuda")
    torch.cuda.synchronize()
    solver_s = time.perf_counter() - t1
    del prob
    stage("constructed")
    conn.send(("ready", dict(stages=stages, assembly_s=assembly_s,
                             solver_s=solver_s)))
    if conn.recv() != "go":
        return
    stage("go")
    row = time_lattice(s, "p3_wide_f64", card, P3_WIDE_STEPS)
    stage("steps")
    # one more step from a non-zero state, each bucket's sweep launched and
    # then run through the plain version on the same inputs (not counted:
    # the counts were read above)
    inner, errs = s.ring_sweep, []

    def compared(v, *args, **kw):
        ys, ms = inner(v, *args, **kw)
        ys_p, ms_p = lr.lattice_ring_sweep_ref(v, *args,
                                               **dict(kw, win=s.win))
        errs.append(dict(ys_rel=rel_err(ys, ys_p)[0],
                         ms_rel=rel_err(ms, ms_p)[0]))
        return ys, ms

    st = s.step(*s.initial_state())[:3]
    s.ring_sweep = compared
    try:
        s.step(*st)
    finally:
        s.ring_sweep = inner
    torch.cuda.synchronize()
    stage("compared")
    row.update(nx=size["nx"], order=size["order"], stages=stages,
               assembly_s=assembly_s, solver_s=solver_s,
               buckets_n=len(s._ring_buckets), vs_plain=errs,
               windows=s.win is not None)
    conn.send(("row", row))


def start_p3_wide(card):
    """Start phase 15's process (its BLAS on P3_WIDE_THREADS threads) and a
    thread that stops it past bench_torch.P3_WIDE_HOST_LIMIT_GB of host
    memory; returns (process, connection, the stop record)."""
    import multiprocessing as mp
    import threading

    import bench_torch

    ctx = mp.get_context("spawn")
    conn, child_conn = ctx.Pipe()
    keys = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(dict.fromkeys(keys, str(P3_WIDE_THREADS)))
    try:
        proc = ctx.Process(target=_p3_wide_child,
                           args=(child_conn, P3_WIDE, card), daemon=True)
        proc.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    child_conn.close()
    stopped = []

    def watch():
        while proc.is_alive():
            rss = bench_torch.status_gb(proc.pid, "VmRSS")
            if rss > bench_torch.P3_WIDE_HOST_LIMIT_GB:
                stopped.append(rss)
                proc.kill()
                return
            time.sleep(0.5)

    threading.Thread(target=watch, daemon=True).start()
    return proc, conn, stopped


def _p3_wide_recv(proc, conn, stopped, timeout, what):
    import bench_torch

    if not conn.poll(timeout):
        proc.kill()
        raise RuntimeError(f"p3_wide: no {what} after {timeout} s")
    try:
        kind, payload = conn.recv()
    except EOFError:
        proc.join(10)
        raise RuntimeError(
            f"p3_wide: its process ended (exit {proc.exitcode}) before its "
            f"{what}" + (f", stopped at {stopped[0]:.1f} GB of host memory "
                         f"(limit {bench_torch.P3_WIDE_HOST_LIMIT_GB})"
                         if stopped else "")) from None
    if kind == "error":
        raise RuntimeError(f"p3_wide: {payload}")
    return payload


def phase_p3_wide(proc, conn, stopped, card):
    """Phase 15 (see the module docstring): waits for the process's
    set-up, sends it "go" and checks its row. Returns the row."""
    t0 = time.perf_counter()
    setup = _p3_wide_recv(proc, conn, stopped, P3_WIDE_SETUP_TIMEOUT,
                          "set-up")
    log(f"[smoke] p3_wide set-up (in its process, while the earlier phases "
        f"ran): assembly {setup['assembly_s']:.1f} s, solver "
        f"{setup['solver_s']:.1f} s; host memory by stage "
        + json.dumps(setup["stages"])
        + f"; waited {time.perf_counter() - t0:.1f} s for it here")
    conn.send("go")
    row = _p3_wide_recv(proc, conn, stopped, P3_WIDE_RUN_TIMEOUT, "row")
    proc.join(60)
    peak = max(st["maxrss_gb"] for st in row["stages"])
    want = {"tiled": row["buckets_n"] * (WARMUP_STEPS + P3_WIDE_STEPS)}
    got = {k: v for k, v in row["k1_by_variant"].items() if v}
    worst = max(max(e.values()) for e in row["vs_plain"])
    log(f"[smoke] p3_wide hex {row['nx']}^3 p={row['order']} f64 (ne "
        f"{row['ne']}, D {row['D']}, W {row['W']}, L {row['L']}): set-up "
        f"{row['assembly_s'] + row['solver_s']:.1f} s, host peak "
        f"{peak:.2f} GB, {row['ms_per_step']:.3f} ms/step, "
        f"{row['dof_per_s']:.4g} DOF/s, device peak "
        f"{row['max_memory_allocated'] / 1e9:.2f} GB, K1 {got}; one step's "
        f"sweep against the plain version {json.dumps(row['vs_plain'])} "
        f"(tolerance {F64_RTOL}); on {card}")
    if got != want or row["k1_by_state"].get("f64") != want["tiled"]:
        raise RuntimeError(f"p3_wide: K1 launches {got}, want {want} f64")
    if len(row["vs_plain"]) != row["buckets_n"] or not worst <= F64_RTOL:
        raise RuntimeError("p3_wide: a sweep disagrees with the plain "
                           "version")
    if proc.exitcode != 0:
        raise RuntimeError(f"p3_wide: its process exited {proc.exitcode}")
    return row


def phase_repro_summary(rows, new_rows, beyond_rows, card):
    """Phase 16: the reproducibility checks the earlier phases ran (K1's
    repeated launches in phase 3's rows, REPRO's paths), summed up; raises
    where one failed (each check also raised where it ran)."""
    k1 = (rows + sum(new_rows.values(), [])
          + sum(beyond_rows.values(), []))
    by = {}
    for r in k1:
        key = f"{r['variant']} {r['state']}"
        by.setdefault(key, [0, 0])
        by[key][0] += 1
        by[key][1] += r["repeat"]["ys_differ"] + r["repeat"]["ms_differ"]
    bicg = next(r for r in REPRO if r["path"] == "f64 flagship bicgstab")
    out = dict(
        k1_cases=len(k1), k1_launches_a_case=REPEAT_LAUNCHES,
        k1_cases_differing={k: v[1] for k, v in by.items()},
        k1_cases_by_kernel={k: v[0] for k, v in by.items()},
        bicgstab_step_applications=bicg["step_applications"],
        paths={r["path"]: r["bit_equal"] for r in REPRO},
        audit_warnings=sorted({w for r in REPRO
                               for w in r.get("audit_warnings", ())}),
        audit_cublas_note=any(r.get("audit_cublas_note") for r in REPRO),
        audit_tc_equal={r["path"]: r["audit_equal"] for r in REPRO
                        if "audit_equal" in r})
    log("[smoke] phase 16 reproducibility " + json.dumps(out) + f" on {card}")
    if (any(by[k][1] for k in by) or not all(out["paths"].values())
            or out["audit_warnings"]):
        raise RuntimeError(f"phase 16: not reproducible: {out}")
    return out


def build_flagship(SourceIterationSolver, problem, name, **kw):
    t0 = time.perf_counter()
    solver = SourceIterationSolver(*problem, device="cuda", **kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"[smoke] {name} setup {setup_s:.1f} s: G={solver.G} L={solver.L} "
        f"W={solver.W} shifts={solver.shifts} buckets="
        f"{[(list(map(int, g)), k) for g, k in solver._ring_buckets]} "
        f"windows={'off' if solver.win is None else 'on'}")
    return solver, setup_s


def main() -> int:
    if not torch.cuda.is_available():
        log("[smoke] no CUDA device: this check runs on a GPU only")
        return 1
    from pbte_tpu_torch import bench_dma
    from pbte_tpu_torch.ops import _build
    from pbte_tpu_torch.ops import dma_copy as dma
    from pbte_tpu_torch.ops import lattice_ring as lr
    from pbte_tpu_torch import problem as problem_mod
    from pbte_tpu_torch.problem import (DIFFUSE_WALLS, FLAGSHIP, WALL_BCS,
                                        graded_cube, unit_cube, unit_square)
    from pbte_tpu_torch.solver.source_iteration import SourceIterationSolver

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    log(f"[smoke] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()}")
    card = bench_dma.card_name_power()
    log(f"[smoke] nvidia-smi: {card}")
    # phase 15's host set-up runs in a process of its own from here on
    p3w = start_p3_wide(card)

    mark("phase 2 (the builds)")
    t0 = time.perf_counter()
    built = _build.load_all(["lattice_ring", "lattice_ring_tiled",
                             "dma_copy"])
    builds = tracing.report()["stages"].get("pbte.setup.kernel_build", {})
    log(f"[smoke] built {[b.path.name for b in built.values()]} in "
        f"{time.perf_counter() - t0:.1f} s ({builds.get('calls', 0)} builds "
        f"and loads, {builds.get('host_s', 0.0):.1f} s summed)")
    for b in built.values():
        log(b.log.strip())
    f64_regs = f64_ptxas(built["lattice_ring"].log)
    log("[smoke] K1 f64 ptxas " + json.dumps(f64_regs))
    if len(f64_regs) != 2 * len(lr.KERNEL_D):
        raise RuntimeError(f"want the ptxas report of {2 * len(lr.KERNEL_D)}"
                           f" float64 K1 instantiations (D in "
                           f"{lr.KERNEL_D}; with and without dsrc), got "
                           f"{sorted(f64_regs)}")
    tiled_regs = tiled_ptxas(built["lattice_ring_tiled"].log)
    log("[smoke] K1 tiled ptxas " + json.dumps(tiled_regs))
    spilled = {k: v for k, v in tiled_regs.items()
               if v.get("spill_stores") or v.get("spill_loads")}
    if len(tiled_regs) != 3 * len(lr.TILED_D) or spilled:
        raise RuntimeError(f"want the ptxas report of {3 * len(lr.TILED_D)}"
                           f" tiled K1 instantiations (D in {lr.TILED_D}, "
                           f"three state types) and no spill, got "
                           f"{sorted(tiled_regs)}, spilled {spilled}")

    mark("phase 3 (K1 against its plain version)")
    problem = unit_cube(**FLAGSHIP)
    solver, setup_s = build_flagship(SourceIterationSolver, problem,
                                     "flagship", bc_temps=WALL_BCS)
    check_k1_smem(solver, lr)
    rows = phase_kernel_vs_plain(solver, lr)
    mark("phase 4 (the copy probe)")
    dma_res, dma_launches, dma_errs = phase_dma(dma, bench_dma)
    best = dma_res["best"]
    all_b = rows[0]["bytes"]
    k1_gbs = all_b / (rows[0]["kernel_ms"] * 1e-3) / 1e9
    log(f"[smoke] K1 bucket 0 f32: {all_b} B in all in "
        f"{rows[0]['kernel_ms']:.3f} ms = {k1_gbs:.1f} GB/s, "
        f"{k1_gbs / best['gbs']:.3f} of the best copy rate "
        f"({best['name']}, {best['gbs']:.1f} GB/s), "
        f"{rows[0]['share_of_bound']:.3f} of the {rows[0]['bound_ms']:.3f} ms "
        f"bound, on {card}")

    mark("phase 5 (the flagship)")
    launches, flag = phase_flagship(solver, lr, setup_s, "flagship")
    comp = phase_compensated(solver, lr, card)
    repro_check(solver, "flagship f32 (K1 one-CTA)")
    del solver
    torch.cuda.empty_cache()

    # phase 3 at the new shapes: the tiled kernel (D = 64; W = 576) and
    # the one-CTA kernel at D = 9, each on its lattice's own windows
    mark("phase 3 at the new shapes")
    from pbte_tpu_torch.bench_k1 import P3_LATTICE, WIDE, k1_spec, p3_spec

    t0 = time.perf_counter()
    wide_prob = unit_cube(**WIDE)
    quad_prob = unit_square(**QUAD)
    specs = []
    for name, prob, bcs in (("wide 24^3 p=2", wide_prob, WALL_BCS),
                            ("quad 64^2 p=2", quad_prob,
                             problem_mod.SQUARE_BCS)):
        s = SourceIterationSolver(*prob, bcs, device="cuda")
        spec = k1_spec(s)
        # the wide lattice's last bucket (Km = 6): three f64 state-sized
        # buffers of bucket 0 would take 42 GB
        specs.append((name, spec, len(spec["buckets"]) - 1
                      if name.startswith("wide") else 0, False))
        del s
    golden = pathlib.Path(__file__).resolve().parent / "tests" / "data"
    with np.load(golden / "torch_port_golden_p3.npz") as d:
        golden_p3 = {k: d[k].item() for k in PARAM_KEYS + ("length",)}
    specs[:0] = [("p3 16^3 p=3", p3_spec(P3_LATTICE), 0, True),
                 ("p3 golden 17x17x4", p3_spec(golden_p3), 0, False)]
    log(f"[smoke] new K1 shapes set up in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{n} L={sp['L']} D={sp['D']} W={sp['W']} shifts="
                    f"{sp['shifts']}" for n, sp, *_ in specs))
    new_rows = phase_k1_new_shapes(lr, specs)
    del specs
    torch.cuda.empty_cache()
    mark("phase 3 past the ceiling")
    beyond_rows = phase_k1_beyond_ceiling(lr)

    mark("phase 6 (diffuse walls, bf16 state)")
    film, film_setup_s = build_flagship(SourceIterationSolver, problem,
                                        "diffuse-wall flagship",
                                        **DIFFUSE_WALLS)
    film_launches, film_row = phase_flagship(film, lr, film_setup_s,
                                             "diffuse-wall flagship")
    repro_check(film, "diffuse-wall flagship (K1; the closure sums)")
    del film
    torch.cuda.empty_cache()

    os.environ["PBTE_RING_STATE_BF16"] = "1"
    try:
        bf16, bf16_setup_s = build_flagship(
            SourceIterationSolver, problem, "bf16-state flagship",
            bc_temps=WALL_BCS)
    finally:
        del os.environ["PBTE_RING_STATE_BF16"]
    bf16_launches, bf16_row = phase_flagship(bf16, lr, bf16_setup_s,
                                             "bf16-state flagship")
    repro_check(bf16, "bf16-state flagship (K1 one-CTA bf16)")
    del bf16
    torch.cuda.empty_cache()

    mark("phase 7 (the goldens)")
    golden_rel = phase_golden(SourceIterationSolver, unit_cube,
                              "torch_port_golden.npz")
    closure_rel = phase_golden(
        SourceIterationSolver, unit_cube, "torch_port_golden_closures.npz",
        repro="hex 8^3 periodic, diffuse and specular walls (the closure "
              "sums)")
    accel_rel = phase_accel_golden(SourceIterationSolver, unit_cube, lr)
    scan_rel = phase_scan_golden(SourceIterationSolver, problem_mod.tet_cube)
    super_rel = phase_super_golden(SourceIterationSolver, problem_mod.tet_box)
    p3_rel, p3_launches, _ = phase_golden(
        SourceIterationSolver, unit_cube, "torch_port_golden_p3.npz",
        keys=PARAM_KEYS + ("length",), lr=lr)
    if p3_launches["tiled"] == 0 or p3_launches["persistent"]:
        raise RuntimeError(f"the p=3 golden ran K1 {p3_launches}, want the "
                           f"tiled kernel")
    graded_rel, graded_launches, s = phase_golden(
        SourceIterationSolver, graded_cube, "torch_port_golden_graded.npz",
        keys=("n", "order", "polar", "azimuth", "nspec"), lr=lr)
    if s._multi is None or any(graded_launches.values()):
        raise RuntimeError("the graded golden did not run the multi-class "
                           "ring alone")
    del s

    mark("phase 8 (the f64 flagship)")
    f64_launches, f64_row = phase_f64_flagship(
        SourceIterationSolver, problem, lr, dict(bc_temps=WALL_BCS))
    torch.cuda.empty_cache()

    mark("phases 9, 10 (the legacy tet)")
    refs = {}  # phase 14 (f)'s problems and single-device references
    tet_prob = problem_mod.tet_cube(**problem_mod.LEGACY_TET)
    tet, tc_scan = phase_tet_scan(SourceIterationSolver, problem_mod,
                                  tet_prob, lr, card)
    tet_super = phase_tet_super(SourceIterationSolver, problem_mod, tet_prob,
                                lr, card, tc_scan, refs)
    del tet_prob
    torch.cuda.empty_cache()

    mark("phase 11 (the new lattices)")
    new = phase_new_lattices(SourceIterationSolver, problem_mod, lr, card,
                             wide_prob, quad_prob, refs)
    del wide_prob, quad_prob
    torch.cuda.empty_cache()

    mark("phase 12 (the CLI)")
    cli_rows = phase_cli(lr, card, flag["dof_per_s"])
    mark("phase 13 (the general ring)")
    general = phase_general(SourceIterationSolver, problem_mod, lr, card,
                            refs)
    mark("phase 14 (the sharded solvers)")
    sharded = phase_sharded(card, dict(SHARD_CONFIG, flagship=FLAGSHIP),
                            refs)
    del refs
    mark("phase 15 (hex 28^3 p=3 f64)")
    p3_wide = phase_p3_wide(*p3w, card)

    mark("phase 16 (reproducibility)")
    repro = phase_repro_summary(rows, new_rows, beyond_rows, card)

    mark("the kernels line")
    jax_mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib"))
    if jax_mods:
        raise RuntimeError(f"the port imported JAX: {jax_mods[:5]}")

    # the launch the flagship's step makes: bucket 0, hull windows (f32 with
    # no source; bf16 and f64 with the Dirichlet source, the case measured
    # with windows in those types)
    def main_row(state):
        return next(r for r in rows if r["windows"] and r["bucket"] == 0
                    and r["state"] == state and not r["xsrc"]
                    and r["dirichlet"] == (state != "f32"))

    acc = f64_row["bicgstab"]
    log(f"[smoke] summary: flagship {flag['ms_per_step']:.3f} ms/step, "
        f"{flag['dof_per_s']:.4g} DOF/s; diffuse-wall flagship "
        f"{film_row['ms_per_step']:.3f} ms/step, "
        f"{film_row['dof_per_s']:.4g} DOF/s; bf16 state "
        f"{bf16_row['ms_per_step']:.3f} ms/step; f64 "
        f"{f64_row['ms_per_step']:.3f} ms/step, bicgstab "
        f"{acc['step_applications']} step applications in "
        f"{acc['wall_s']:.2f} s against {f64_row['plain']['steps']} plain "
        f"steps in {f64_row['plain']['wall_s']:.2f} s, peak "
        f"{acc['max_memory_allocated'] / 1e9:.2f} GB; refined defect "
        f"{f64_row['refined']['gain']:.1f}x; best copy {best['name']} "
        f"{best['gbs']:.1f} GB/s; golden rel {golden_rel:.3e}, closure "
        f"golden rel {closure_rel:.3e}, f64 bicgstab golden rel "
        f"{accel_rel:.3e}, scan golden rel {scan_rel:.3e}, supercell golden "
        f"rel {super_rel:.3e}; legacy tet scan {tet['ms_per_step']:.3f} "
        f"ms/step, {tet['dof_per_s']:.4g} DOF/s; supercell ring "
        f"{tet_super['ms_per_step']:.3f} ms/step, "
        f"{tet_super['dof_per_s']:.4g} DOF/s, bf16 state "
        f"{tet_super['bf16']['ms_per_step']:.3f} ms/step (f32 "
        f"{tet_super['bf16']['f32_ms_per_step_in_turns']:.3f} in turns), "
        f"peak {tet_super['bf16']['max_memory_allocated'] / 1e9:.2f} GB; "
        f"p=3 golden rel {p3_rel:.3e}, "
        f"graded golden rel {graded_rel:.3e}; K1 past the old 16-CTA "
        f"ceiling: {sum(map(len, beyond_rows.values()))} cases held; "
        + "; ".join(f"{k} {r['ms_per_step']:.3f} ms/step, "
                    f"{r['dof_per_s']:.4g} DOF/s"
                    for k, r in new.items())
        + "; the CLI at the flagship's width: "
        + ", ".join(f"{k} {cli_rows[k]['dof_per_s']:.4g} DOF/s, set-up "
                    f"{sum(cli_rows[k]['setup_s'].values()):.1f} s"
                    for k in ("f32", "f64"))
        + "; the general ring against its scan: "
        + ", ".join(f"{k} {r['ring_ms_per_step']:.3f} against "
                    f"{r['scan_ms_per_step']:.3f} ms/step"
                    for k, r in general.items())
        + f"; slab 2 x 2 on four ranks sharing the card "
        f"{sharded['a']['ms_per_step']:.3f} ms/step, halo "
        f"{sharded['a']['halo_ms']:.3f} ms/step; spatial 2 x 2 12^3 tets "
        f"{sharded['d']['ms_per_step']:.3f} ms/step; dir/band sharding on "
        f"two ranks: "
        + ", ".join(f"{k} {max(r['ms_per_step']):.3f} ms/step"
                    for k, r in sharded["f"].items())
        + f"; compensated flagship {comp['iterations']} step applications,"
        f" Tc rel {comp['vs_plain_rel']:.3e} of the plain iteration's; "
        f"hex 28^3 p=3 f64 {p3_wide['ms_per_step']:.3f} ms/step after "
        f"{p3_wide['assembly_s'] + p3_wide['solver_s']:.1f} s of set-up, "
        f"host peak {max(st['maxrss_gb'] for st in p3_wide['stages']):.2f} GB"
        f"; on {card}")

    def k1_entry(name, state, n, shape=None,
                 source="pbte_tpu_torch/csrc/lattice_ring.cu"):
        """A K1 kernel's entry: its times and bound from phase 3 (the
        flagship's bucket-0 windowed launch, or the windowed case of a new
        ``shape``), its largest error over phase 3's cases of the same
        state type (the flagship's, or the new shapes' of the same
        variant), its launches ``n`` on the main path."""
        if shape is None:
            r, same = main_row(state), [x for x in rows
                                        if x["state"] == state]
        else:
            r = next(x for x in new_rows[shape]
                     if x["state"] == state and x["windows"])
            same = [x for x in sum(new_rows.values(), [])
                    + sum(beyond_rows.values(), [])
                    if x["state"] == state and x["variant"] == r["variant"]]
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": "pbte_tpu/ops/lattice_ring.py:234",
            "launches": n,
            "max_abs_err": max(max(x["ys_abs"], x["ms_abs"]) for x in same),
            "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
        }

    def tiled_entry(name, state, row, extra=0):
        return k1_entry(name, state,
                        new[row]["k1_by_variant"]["tiled"] + extra,
                        shape="wide 24^3 p=2",
                        source="pbte_tpu_torch/csrc/lattice_ring_tiled.cu")

    def best_row(prefix):
        """The fastest row of a kernel: its paired median ms and the plain
        copy's median ms of the same rounds."""
        name = min((n for n in dma_res["ms"] if n.startswith(prefix)),
                   key=dma_res["ms"].get)
        return dma_res["ms"][name], dma_res["plain_ms"][name]

    auto_ms, auto_plain_ms = best_row("auto/")
    manual_ms, manual_plain_ms = best_row("manual/")
    # a copy moves each input byte once in and once out: 2 x the array
    copy_bound_ms = dma_res["bytes_per_call"] / lr.H100_BYTES_PER_S * 1e3

    log(f"[smoke] done in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [
        k1_entry("lattice_ring_sweep", "f32", launches + film_launches
                 + comp["k1_launches"]
                 + cli_rows["f32"]["k1_by_state"]["f32"]
                 + sum(sharded["a"]["launches"])),
        k1_entry("lattice_ring_sweep_bf16", "bf16", bf16_launches),
        k1_entry("lattice_ring_sweep_f64", "f64", f64_launches
                 + cli_rows["f64"]["k1_by_state"]["f64"]),
        k1_entry("lattice_ring_sweep_d9", "f32",
                 new["quad_f32"]["k1_by_variant"]["persistent"],
                 shape="quad 64^2 p=2"),
        tiled_entry("lattice_ring_sweep_tiled", "f32", "wide_f32"),
        tiled_entry("lattice_ring_sweep_tiled_bf16", "bf16", "wide_bf16"),
        tiled_entry("lattice_ring_sweep_tiled_f64", "f64", "wide_f64",
                    p3_wide["k1_by_variant"]["tiled"]),
        {
            "name": "dma_auto_copy",
            "route": "cuda",
            "source": "pbte_tpu_torch/csrc/dma_copy.cu",
            "replaces": "scripts/bench_pallas_dma.py:76",
            "launches": dma_launches["auto"],
            "max_abs_err": dma_errs["auto"],
            "ms": auto_ms,
            "plain_ms": auto_plain_ms,
            "bound_ms": copy_bound_ms,
            "bound_by": "bytes",
            "library_ms": auto_plain_ms,
        },
        {
            "name": "dma_manual_copy",
            "route": "cuda",
            "source": "pbte_tpu_torch/csrc/dma_copy.cu",
            "replaces": "scripts/bench_pallas_dma.py:140",
            "launches": dma_launches["manual"],
            "max_abs_err": dma_errs["manual"],
            "ms": manual_ms,
            "plain_ms": manual_plain_ms,
            "bound_ms": copy_bound_ms,
            "bound_by": "bytes",
            "library_ms": manual_plain_ms,
        },
    ]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
