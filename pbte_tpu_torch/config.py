"""Typed run configuration, YAML-schema-compatible with the reference.

This package's own copy of ``pbte_tpu/config.py``: one dataclass read from
the same files,

- config.yaml: mesh.path, boundary_conditions [{attr, temperature} or
  {attr, type: periodic|dirichlet|diffuse|specular[, value]}], angles
  {dimension, polar_points, azimuth_points, polar_scheme, azimuth_scheme},
  numerical {n_spectral, tolerance, max_iter};
- si.yaml beside it: the material constants
  (``material.nongray_smrt.load_material``);
- or a legacy Control.yaml with its Si_PhononModel.yaml.

Every number is coerced with float() or int(): PyYAML reads ``1e-7`` as a
string under YAML 1.1.
"""

from __future__ import annotations

import dataclasses
import os

from pbte_tpu_torch.angular import quadrature as ang
from pbte_tpu_torch.io.yamlish import load_yaml_file
from pbte_tpu_torch.material import nongray_smrt


@dataclasses.dataclass
class RunConfig:
    mesh_spec: str = "unit-square-tri"  # path or builtin name
    bc_temps: dict = dataclasses.field(default_factory=dict)
    angles: ang.AngularOptions = dataclasses.field(default_factory=ang.AngularOptions)
    n_spectral: int = 20
    tolerance: float = 1e-7
    max_iter: int = 101
    order: int = 1
    refine: int = 0
    material: nongray_smrt.PhononMaterial = dataclasses.field(
        default_factory=lambda: nongray_smrt.SILICON
    )
    face_mode: str = "mfem-parity"
    output_dir: str = "output"
    # boundary attrs declared periodic (legacy BC type 4); the faces must be
    # pairable — via gmsh $Periodic records or mesh.make_periodic()
    periodic_attrs: list = dataclasses.field(default_factory=list)
    # legacy BC type 7: attr -> prescribed incoming intensity (Dirichlet)
    dirichlet_bcs: dict = dataclasses.field(default_factory=dict)
    # legacy BC types 2/3: reflective walls (lagged closures in the solver)
    diffuse_attrs: list = dataclasses.field(default_factory=list)
    specular_attrs: list = dataclasses.field(default_factory=list)


def load_legacy_control(control_path: str, material_path: str | None = None) -> RunConfig:
    """A legacy Control.yaml and its Si_PhononModel.yaml (the
    Si_PhononModel.yaml beside the control file when ``material_path`` is
    None).

    Boundary types: 1 thermalizing (isothermal), 2 diffuse, 3 specular, 4
    periodic (the attrs land in ``periodic_attrs``; the mesh layer pairs
    the faces), 7 Dirichlet; any other raises NotImplementedError."""
    cfg = load_yaml_file(control_path) or {}
    rc = RunConfig()
    rc.order = int(cfg.get("POLYDEG", 1))
    sdim = int(cfg.get("SPATIAL_DIM", 3))
    pattern = int(cfg.get("SOLID_ANGLE_PATTERN", 1))
    npole = int(cfg.get("NPOLE", 8))
    if sdim == 2:
        npole = 1  # GlobalConfig forces NPOLE=1 in 2D (GlobalConfig.hpp:78-80)
    rc.angles = ang.AngularOptions(
        dimension=sdim,
        polar_points=npole,
        azimuth_points=int(cfg.get("NAZIM", 16)),
    )
    rc.legacy_pattern = pattern  # type: ignore[attr-defined]
    rc.n_spectral = int(cfg.get("NSPEC", 20))
    rc.tolerance = float(cfg.get("TOL", 1e-7))
    rc.max_iter = int(cfg.get("TMAX", 101))
    mesh_path = str(cfg.get("MESH_PATH", "."))
    mesh_tag = str(cfg.get("MESH_TAG", ""))
    if mesh_tag:
        rc.mesh_spec = os.path.join(mesh_path, mesh_tag + ".msh")
    rc.output_dir = str(cfg.get("OUTPUT_PATH", "output"))

    for attr, spec in (cfg.get("BOUNDARY_COND") or {}).items():
        bc_type, value = int(spec[0]), float(spec[1])
        if bc_type == 1:
            rc.bc_temps[int(attr)] = value
        elif bc_type == 4:
            rc.periodic_attrs.append(int(attr))
        elif bc_type == 7:
            rc.dirichlet_bcs[int(attr)] = value
        elif bc_type == 2:
            rc.diffuse_attrs.append(int(attr))
        elif bc_type == 3:
            rc.specular_attrs.append(int(attr))
        else:
            raise NotImplementedError(
                f"legacy boundary type {bc_type}; supported: 1 "
                "(thermalizing), 2 (diffuse), 3 (specular), 4 (periodic), "
                "7 (Dirichlet)"
            )

    if material_path is None:
        cand = os.path.join(os.path.dirname(control_path), "Si_PhononModel.yaml")
        material_path = cand if os.path.exists(cand) else None
    if material_path:
        mcfg = load_yaml_file(material_path)
        rc.material = nongray_smrt.PhononMaterial(
            C_LA=tuple(float(x) for x in mcfg["C_LA"]),
            C_TA=tuple(float(x) for x in mcfg["C_TA"]),
            lattice_dist=float(mcfg["LATTICE_DIST"]),
            Ai=float(mcfg["Ai"]),
            BL=float(mcfg["BL"]),
            BT=float(mcfg["BT"]),
            BU=float(mcfg["BU"]),
            num_spectral=rc.n_spectral,
            ref_temp=float(cfg.get("T_REF", 300.0)),
            ref_len=float(cfg.get("L_REF", 1.0e-6)),
        )
    return rc


def load_run_config(config_path: str, material_path: str | None = None) -> RunConfig:
    cfg = load_yaml_file(config_path) or {}
    if isinstance(cfg, dict) and ("BOUNDARY_COND" in cfg or "POLYDEG" in cfg):
        return load_legacy_control(config_path, material_path)
    rc = RunConfig()

    mesh_cfg = cfg.get("mesh") or {}
    if mesh_cfg.get("path"):
        path = str(mesh_cfg["path"])
        if not os.path.isabs(path) and not os.path.exists(path):
            # resolve relative to the config file's directory tree, the way
            # the reference resolves config-relative mesh paths
            cand = os.path.join(os.path.dirname(config_path), "..", path)
            if os.path.exists(cand):
                path = os.path.normpath(cand)
        rc.mesh_spec = path

    for bc in cfg.get("boundary_conditions") or []:
        kind = str(bc.get("type", "")).lower()
        if kind == "periodic":
            rc.periodic_attrs.append(int(bc["attr"]))
        elif kind == "dirichlet":
            rc.dirichlet_bcs[int(bc["attr"])] = float(bc["value"])
        elif kind == "diffuse":
            rc.diffuse_attrs.append(int(bc["attr"]))
        elif kind == "specular":
            rc.specular_attrs.append(int(bc["attr"]))
        else:
            rc.bc_temps[int(bc["attr"])] = float(bc["temperature"])

    if cfg.get("angles"):
        rc.angles = ang.options_from_config(cfg)

    num = cfg.get("numerical") or {}
    rc.n_spectral = int(num.get("n_spectral", rc.n_spectral))
    rc.tolerance = float(num.get("tolerance", rc.tolerance))
    rc.max_iter = int(num.get("max_iter", rc.max_iter))

    if material_path is None:
        cand = os.path.join(os.path.dirname(config_path), "si.yaml")
        material_path = cand if os.path.exists(cand) else None
    if material_path:
        rc.material = nongray_smrt.load_material(material_path)
    return rc
