"""Meshes: this package's own copy of ``pbte_tpu.mesh``: builtins, the
gmsh and MFEM readers, the MFEM writer, uniform refinement, the face
tables and the golden-format summary (``mesh.summary``)."""

from pbte_tpu_torch.mesh.builtins import (  # noqa: F401
    load_builtin,
    make_cartesian_2d,
    make_cartesian_3d,
    make_mixed_2d,
)
from pbte_tpu_torch.mesh.core import (  # noqa: F401
    GEOM_HEX,
    GEOM_MIXED,
    GEOM_QUAD,
    GEOM_TET,
    GEOM_TRIANGLE,
    MeshData,
    MeshTopology,
    connect,
    finalize,
    make_periodic,
)
from pbte_tpu_torch.mesh.gmsh_io import load_gmsh_mesh  # noqa: F401
from pbte_tpu_torch.mesh.mfem_io import (  # noqa: F401
    load_mfem_mesh,
    parse_mfem_mesh,
    write_mfem_mesh,
)
from pbte_tpu_torch.mesh.refine import uniform_refine  # noqa: F401


def load_mesh(spec: str) -> MeshData:
    """Load a mesh file (gmsh ``.msh`` or MFEM ``.mesh``) or a built-in
    name."""
    import os

    if os.path.exists(spec):
        if spec.endswith(".msh"):
            return load_gmsh_mesh(spec)
        return load_mfem_mesh(spec)
    if os.sep in spec or spec.endswith((".mesh", ".msh")):
        raise FileNotFoundError(f"mesh file not found: {spec}")
    return load_builtin(spec)
