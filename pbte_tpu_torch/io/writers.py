"""Golden-format text dumps, diffable against the reference's outputs.

This package's own copy of ``pbte_tpu/io/writers.py``: the coefficient dump
(``coeff_all.txt``), the temperature dump (``Tc_all.txt``) and the element
integral dump (``integrals_all.txt``). Arrays are numpy (a caller holding
torch tensors moves them to the host first).
"""

from __future__ import annotations

import os

import numpy as np


def _g(x) -> str:
    return f"{x:g}"


def write_coefficients(u, quad, num_branches, path):
    """u (K, BS, ne, D) -> coeff_all.txt format (ref: src/Utils.cpp:166-224)."""
    u = np.asarray(u)
    K, BS, ne, D = u.shape
    S = BS // num_branches
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for k in range(K):
            for b in range(num_branches):
                for s in range(S):
                    f.write(f"# dir {k} branch {b} spec {s}\n")
                    f.write(f"# ndof {D} ne {ne}\n")
                    d = quad.directions[k]
                    f.write(
                        "# direction: "
                        + " ".join(_g(x) for x in d)
                        + f" weight {quad.weights[k]:g}\n"
                    )
                    for e in range(ne):
                        f.write(f"elem {e}\n")
                        f.write(" ".join(_g(x) for x in u[k, b * S + s, e]) + "\n")
                    f.write("\n")


def write_temperature(Tc, path):
    """Tc (ne, D) -> Tc_all.txt format (ref: src/Utils.cpp:226-260)."""
    Tc = np.asarray(Tc)
    ne, D = Tc.shape
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("# Tc matrix\n")
        f.write(f"# ndof {D} ne {ne}\n")
        for e in range(ne):
            f.write(f"elem {e}\n")
            f.write(" ".join(_g(x) for x in Tc[e]) + "\n")


def write_element_integrals(ops, path, rank=0, world=1):
    """ElementOps -> integrals_all.txt format (ref: src/Utils.cpp:48-164)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    ne, D = ops.basis_int.shape
    with open(path, "w") as f:
        f.write("DG integral dump (local rank block)\n")
        f.write(f"rank: {rank}/{world}\n")
        f.write(f"elements: {ne}\n\n")
        for e in range(ne):
            f.write(f"=== Element {e} (rank {rank}) ===\n")
            f.write(
                f"basis_integrals [size={D}]: "
                + " ".join(_g(x) for x in ops.basis_int[e])
                + "\n"
            )
            f.write(f"mass_matrix [shape={D}x{D}]\n")
            for row in ops.mass[e]:
                f.write("  " + " ".join(_g(x) for x in row) + "\n")
            for d in range(ops.dim):
                f.write(f"stiffness_matrix_dim{d} [shape={D}x{D}]\n")
                for row in ops.stiff[e, d]:
                    f.write("  " + " ".join(_g(x) for x in row) + "\n")
            for lf in range(ops.faces_per_elem):
                f.write(f"face_mass_matrix[{lf}] [shape={D}x{D}]\n")
                for row in ops.face_mass[e, lf]:
                    f.write("  " + " ".join(_g(x) for x in row) + "\n")
                f.write(
                    f"face_integral[{lf}] [size={D}]: "
                    + " ".join(_g(x) for x in ops.face_int[e, lf])
                    + "\n"
                )
            for lf in range(ops.faces_per_elem):
                nbr = int(ops.neighbor[e, lf])
                attr = int(ops.face_attr[e, lf])
                # the reference prints MFEM's global face id per coupling
                # block (src/Utils.cpp:100-148); omit only if the ops were
                # built without the mesh-topology mirror
                fid = (
                    f"face_id={int(ops.elem_face[e, lf])}, "
                    if ops.elem_face is not None
                    else ""
                )
                f.write(
                    f"face_coupling[{lf}]: {fid}neighbor={nbr}, "
                    f"attr={attr}, shared=0\n"
                )
                if nbr >= 0:
                    f.write(f"  coupling [shape={D}x{D}]\n")
                    for row in ops.coupling[e, lf]:
                        f.write("  " + " ".join(_g(x) for x in row) + "\n")
                else:
                    f.write(
                        f"  isothermal_rhs [size={D}]: "
                        + " ".join(_g(x) for x in ops.face_int[e, lf])
                        + "\n"
                    )
            if e != ne - 1:  # the reference ends at the last rhs line
                f.write("\n")
