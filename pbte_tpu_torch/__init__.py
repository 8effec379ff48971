"""PyTorch + CUDA port of pbte_tpu's lattice-ring solve.

The port imports PyTorch and never JAX, and nothing of ``pbte_tpu``. It
keeps its own copy of the numpy host layers the lattice path needs, trimmed
to what it calls and held to pbte_tpu's by tests/test_torch_host_layers.py:

- ``mesh``: hex box meshes, face tables, periodic pairing;
- ``fem``: hex quadrature, the L2 nodal basis, consistent DG assembly and
  the geometry-class helpers;
- ``angular``: the discrete-ordinates quadrature;
- ``material``: the non-gray SMRT silicon tables;
- ``sweep``: upwind levelization, the sweep plan, lattice detection;

and the modules that were JAX in pbte_tpu:

- ``models.macroscopic``: the macroscopic weights, Tc / Tv reductions and
  the scale-invariant residual;
- ``ops.lattice_ring``: the lattice ring sweep, a plain PyTorch version and
  the hand-written CUDA kernel (``csrc/lattice_ring.cu``) it dispatches to
  for CUDA tensors;
- ``ops.dma_copy``: the streaming copies of pbte_tpu's DMA probe, a plain
  version and two CUDA kernels (``csrc/dma_copy.cu``), driven by
  ``bench_dma`` (``python -m pbte_tpu_torch.bench_dma``);
- ``solver.source_iteration``: ``SourceIterationSolver`` restricted to the
  single-class Cartesian lattice path, with periodic, diffuse and specular
  closures (``solver.lattice_tables`` holds its lattice host tables);
- ``convert``: numpy consts/state from ``pbte_tpu`` into this package's
  layouts (used by the parity tests);
- ``problem``: the unit-cube lattice problems, the flagship among them.

The entry points (``SourceIterationSolver``, ``consts_from_numpy``,
``state_from_numpy``) run on the GPU unless the caller passes
``device="cpu"``; without a GPU the default raises.
"""
