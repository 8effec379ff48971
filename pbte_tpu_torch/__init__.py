"""PyTorch + CUDA port of pbte_tpu's lattice-ring solve.

The port imports PyTorch and never JAX. The framework-free host layers
(mesh, FEM assembly, angular quadrature, material tables, sweep planning,
the lattice-ring table helpers) are imported from ``pbte_tpu`` as they
stand; only the modules that imported JAX are ported here:

- ``models.macroscopic``: Tc / Tv reductions and the scale-invariant
  residual;
- ``ops.lattice_ring``: the lattice ring sweep, a plain PyTorch version and
  the hand-written CUDA kernel (``csrc/lattice_ring.cu``) it dispatches to
  for CUDA tensors;
- ``ops.dma_copy``: the streaming copies of pbte_tpu's DMA probe, a plain
  version and two CUDA kernels (``csrc/dma_copy.cu``), driven by
  ``bench_dma`` (``python -m pbte_tpu_torch.bench_dma``);
- ``solver.source_iteration``: ``SourceIterationSolver`` restricted to the
  single-class Cartesian lattice path, with periodic, diffuse and specular
  closures;
- ``convert``: numpy consts/state from ``pbte_tpu`` into this package's
  layouts (used by the parity tests);
- ``problem``: the unit-cube lattice problems, the flagship among them.
"""
