"""Standalone partition-validation entry point (this package's copy of
``pbte_tpu/validation/__main__.py``).

The operational analog of the reference's `TestMeshPartition N` binary
(ref: Reference Project/src/Validation/TestMeshPartition.cpp:16-164):
partition a mesh N ways, print the partition statistics, run the 7
invariant checks of validation/partition.py, and exit 0 (valid) / 1
(invalid or setup error) so shell scripts can gate on it.

Usage:
    python -m pbte_tpu_torch.validation N [--mesh PATH|BUILTIN]
                                    [--method rcb|greedy|multilevel]

Like the reference runner, the mesh path is searched in a few likely
locations relative to the working directory (TestMeshPartition.cpp:45-64).
"""

from __future__ import annotations

import argparse
import os
import sys


def _find_mesh(spec: str) -> str:
    """Reference-style multi-path mesh search (TestMeshPartition.cpp:45-64)."""
    if not spec or "/" not in spec and "." not in spec:
        return spec  # builtin name — no path search
    base = os.path.basename(spec)
    for cand in (spec, os.path.join("..", spec), os.path.join("..", "..", spec),
                 os.path.join("config", "mesh", base)):
        if os.path.exists(cand):
            return cand
    return spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pbte_tpu_torch.validation",
        description="partition a mesh and run the 7 invariant checks",
    )
    ap.add_argument("nparts", type=int, help="number of partitions")
    ap.add_argument("--mesh", default="unit-cube-tet",
                    help="mesh file or builtin name (default unit-cube-tet)")
    ap.add_argument("--refine", type=int, default=0)
    ap.add_argument("--method", default="multilevel",
                    choices=["rcb", "greedy", "multilevel"],
                    help="partitioner (multilevel = the METIS recipe)")
    args = ap.parse_args(argv)

    if args.nparts < 1:
        print(f"error: invalid partition count {args.nparts}", file=sys.stderr)
        return 1

    from pbte_tpu_torch import mesh as pmesh
    from pbte_tpu_torch.parallel import partition as part_mod
    from pbte_tpu_torch.validation.partition import validate

    spec = _find_mesh(args.mesh)
    try:
        m = pmesh.load_mesh(spec)
    except Exception as e:
        print(f"error loading mesh {spec!r}: {e}", file=sys.stderr)
        return 1
    m = pmesh.uniform_refine(m, args.refine)
    topo = pmesh.connect(m)
    print(f">>> mesh: {m.geom} dim={m.dim} ne={m.num_elements} "
          f"nv={m.num_vertices}")

    print(f">>> partitioning into {args.nparts} partitions "
          f"({args.method}) ...")
    try:
        plan = part_mod.build_plan(topo, args.nparts, method=args.method)
    except Exception as e:
        print(f"error: mesh partitioning failed: {e}", file=sys.stderr)
        return 1
    # partition statistics (the reference's printPartitionStatistics,
    # MeshPartitioning.hpp:300-312): per-part cell counts + balance + cut
    counts = [int(c) for c in plan.local_counts]
    print(f">>> partition sizes: {counts}")
    print(f">>> load balance: {plan.load_balance():.3f}  "
          f"edge cut: {plan.edge_cut()}  "
          f"interface cells: {plan.num_interface} "
          f"({plan.num_interface / max(m.num_elements, 1):.1%})")

    print(">>> starting partition validation ...")
    result = validate(plan, topo)
    result.print()
    if result.ok:
        print(">>> all validations passed!")
        return 0
    print(f">>> validation failed with {len(result.errors)} error(s)!",
          file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
