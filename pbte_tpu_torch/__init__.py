"""PyTorch + CUDA port of pbte_tpu's solver.

The port imports PyTorch and never JAX, and nothing of ``pbte_tpu``. It
keeps its own copy of the numpy host layers, trimmed to what it calls and
held to pbte_tpu's by tests/test_torch_host_layers.py:

- ``mesh``: tri, quad, tet, hex and mixed meshes (builtins, the gmsh and
  MFEM readers, the MFEM writer), uniform refinement, face tables,
  periodic pairing, the golden-format summary;
- ``fem``: quadrature and L2 nodal bases on every reference element,
  assembly in both face modes (and the closed-form volume operators of
  ``fem.exact``), the geometry-class helpers and the supercell merge (its
  block factor in torch);
- ``angular``: the discrete-ordinates quadrature and the legacy
  Control.yaml patterns;
- ``material``: the non-gray SMRT silicon tables;
- ``sweep``: upwind levelization, the sweep plan, lattice detection, the
  reference's greedy orders and their log;
- ``config`` and ``io.yamlish``: the run configuration from config.yaml /
  si.yaml or a legacy Control.yaml;
- ``io.writers``, ``io.slice``, ``io.vtu``: the golden-format dumps, the
  sampled slices and the ParaView output; ``io.outputs`` compares two
  runs' output directories;
- ``validation.oracle``: the sequential numpy oracle (a test reference);

and the modules that were JAX in pbte_tpu:

- ``models.macroscopic``: the macroscopic weights, Tc / Tv reductions and
  the scale-invariant residual;
- ``ops.lattice_ring``: the lattice ring sweep, a plain PyTorch version and
  the hand-written CUDA kernels it dispatches to for CUDA tensors: one CTA
  a level (``csrc/lattice_ring.cu``) or a level in column tiles, one CTA
  a tile (``csrc/lattice_ring_tiled.cu``), chosen from the shape;
- ``ops.dma_copy``: the streaming copies of pbte_tpu's DMA probe, a plain
  version and two CUDA kernels (``csrc/dma_copy.cu``), driven by
  ``bench_dma`` (``python -m pbte_tpu_torch.bench_dma``);
- ``solver.source_iteration``: ``SourceIterationSolver`` on the lattice
  ring, with periodic, diffuse and specular closures
  (``solver.lattice_tables`` holds its lattice host tables;
  ``solver.lattice_multi`` the multi-class ring of graded lattices, torch
  ops), resolving
  ``sweep_mode`` as pbte_tpu does and dispatching a merged 6-tet or
  2-triangle lattice to ``solver.super_ring``, the supercell two-matmul
  ring, a mesh off the box lattice with wide levels to
  ``solver.one_hot_ring``, the general ring (pbte_tpu's one-hot ring; its
  upwind reads are ``ops.ring_plan``'s integer tables), and every other
  mesh to ``solver.scan``, the level-window scan (all torch ops);
- ``solver.accel``: BiCGStab over the state, correction solves, refinement;
- ``io.checkpoint``: checkpoints with pbte_tpu's fields;
- ``convert``: numpy consts/state from ``pbte_tpu`` into this package's
  layouts, ring and scan, and the supercell ring's state both ways (used
  by the parity tests);
- ``native``: the C++ mirror of the reference's solver (a verbatim copy
  of pbte_tpu's, built with g++ at first use), the CPU baseline of
  ``bench_torch.py``;
- ``problem``: the unit-cube, graded-cube, unit-square and 6-tet box
  problems, the flagship and the legacy production tet shape among them,
  and the default config's problem at a refinement;
- ``cli``: the command-line interface, ``python -m pbte_tpu_torch.cli``
  (pbte_tpu's flags and files; ``--platform cpu`` for the CPU).

The entry points (``SourceIterationSolver``, ``consts_from_numpy``,
``state_from_numpy``, the CLI) run on the GPU unless the caller asks for
the CPU (``device="cpu"``, ``--platform cpu``); without a GPU the default
raises.
"""
