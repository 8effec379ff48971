"""Partition invariant validation.

This package's copy of ``pbte_tpu/validation/partition.py``: a port of the reference's only formal test harness,
MeshPartitionValidator<dim> with its 7 named invariant checks
(ref: Reference Project/include/Validation/MeshPartitionValidator.hpp:62-96):
cell assignment, partition-cell consistency, boundary faces, communication
faces, neighbor cells, communication cells, local indices.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ValidationResult:
    errors: list

    @property
    def ok(self) -> bool:
        return not self.errors

    def print(self):
        if self.ok:
            print("partition validation: all checks passed")
        else:
            print(f"partition validation: {len(self.errors)} error(s)")
            for e in self.errors[:20]:
                print("  -", e)


def validate(plan, topo) -> ValidationResult:
    """Run all invariant checks on a PartitionPlan against its topology."""
    errors = []
    ne, nf = topo.elem_neighbor.shape
    part = plan.part
    P = plan.nparts

    # 1. cell assignment: every element owned by exactly one valid partition
    if part.min() < 0 or part.max() >= P:
        errors.append("cell assignment: partition id out of range")
    # 2. partition-cells consistency: local_elems lists exactly the owned cells
    seen = np.zeros(ne, dtype=np.int64)
    for p in range(P):
        elems = plan.local_elems[p][plan.local_elems[p] >= 0]
        if len(elems) != plan.local_counts[p]:
            errors.append(f"partition {p}: local count mismatch")
        if np.any(part[elems] != p):
            errors.append(f"partition {p}: contains cells owned elsewhere")
        seen[elems] += 1
    if np.any(seen != 1):
        errors.append("partition-cells: some cells missing or duplicated")

    # 3. local indices: local_of_global consistent with local_elems
    for p in range(P):
        elems = plan.local_elems[p][plan.local_elems[p] >= 0]
        if not np.array_equal(plan.local_of_global[elems], np.arange(len(elems))):
            errors.append(f"partition {p}: local index map inconsistent")

    # 4. communication (interface) cells: exactly those referenced across parts
    nbr = topo.elem_neighbor
    nbr_part = np.where(nbr >= 0, part[np.clip(nbr, 0, None)], -1)
    cross = (nbr >= 0) & (nbr_part != part[:, None])
    expected_iface = np.unique(nbr[cross])
    if not np.array_equal(np.sort(plan.interface), np.sort(expected_iface)):
        errors.append("interface cell list mismatch")

    # 5. neighbor references: each face resolves to the correct element
    for p in range(P):
        elems = plan.local_elems[p][plan.local_elems[p] >= 0]
        for li, e in enumerate(elems):
            for f in range(nf):
                n = nbr[e, f]
                nl = plan.nbr_local[p, li, f]
                ni = plan.nbr_iface[p, li, f]
                if n < 0:
                    if nl != -1 or ni != -1:
                        errors.append(f"p{p} e{e} f{f}: boundary face has neighbor ref")
                elif part[n] == p:
                    if nl < 0 or plan.local_elems[p, nl] != n:
                        errors.append(f"p{p} e{e} f{f}: wrong local neighbor")
                else:
                    if ni < 0 or plan.interface[ni] != n:
                        errors.append(f"p{p} e{e} f{f}: wrong interface neighbor")

    # 6. boundary faces stay boundary in the plan
    bdry = nbr < 0
    for p in range(P):
        elems = plan.local_elems[p][plan.local_elems[p] >= 0]
        both = (plan.nbr_local[p, : len(elems)] >= 0) | (
            plan.nbr_iface[p, : len(elems)] >= 0
        )
        if np.any(both & bdry[elems]):
            errors.append(f"partition {p}: boundary face marked interior")

    # 7. communication faces symmetric: if e sees n across a face, n's owner
    # must see e as interface or local
    for e in range(ne):
        for f in range(nf):
            n = nbr[e, f]
            if n >= 0 and part[n] != part[e]:
                if plan.iface_of_global[e] < 0:
                    errors.append(f"e{e}: referenced across partition but not interface")
                    break

    return ValidationResult(errors=errors)
