"""Hex meshes: this package's own copy of the parts of ``pbte_tpu.mesh``
the lattice path uses."""

from pbte_tpu_torch.mesh.builtins import make_cartesian_3d  # noqa: F401
from pbte_tpu_torch.mesh.core import (  # noqa: F401
    GEOM_HEX,
    MeshData,
    MeshTopology,
    connect,
    make_periodic,
)
