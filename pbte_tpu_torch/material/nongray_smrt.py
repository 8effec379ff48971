"""Non-gray SMRT phonon spectral tables for silicon-like materials.

This package's own copy of ``pbte_tpu/material/nongray_smrt.py``
(``PhononMaterial``, ``PhononTables``, ``build_tables``, ``SILICON``,
``load_material`` and the golden-format ``write_tables``): small
(branches, bands) float64 tables built once on the host.

- midpoint k-bands:       k_j = (2j-1)/(2S) * k_max,  k_max = 2*pi/a
- quadratic dispersion:   w = c0*k + c1*k^2,  vg = c0 + 2*c1*k
- band weight:            dw = k_max * vg
- scattering rates:       LA: Ai*w^4 + BL*T^3*w^2
                          TA: Ai*w^4 + (BT*w*T^4 if k < k_max/2
                                        else BU*w^2/sinh(hbar*w/(kB*T)))
- density of states:      D = k^2 / (2*pi^2*vg)
- Bose-Einstein heat cap: C = hbar^2 w^2 D e^x / ((e^x-1)^2 kB T^2)
- volumetric heat cap:    C_V = sum C * invKn * (k_max*vg)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pbte_tpu_torch import tracing

HBAR = 1.054571800e-34  # reduced Planck [J*s]
KB = 1.38064852e-23  # Boltzmann [J/K]


@dataclasses.dataclass(frozen=True)
class PhononMaterial:
    C_LA: tuple[float, float]
    C_TA: tuple[float, float]
    lattice_dist: float
    Ai: float
    BL: float
    BT: float
    BU: float
    num_branches: int = 2
    num_spectral: int = 20
    ref_temp: float = 300.0
    ref_len: float = 1.0e-6

    @property
    def k_max(self) -> float:
        return 2.0 * np.pi / self.lattice_dist


@dataclasses.dataclass(frozen=True)
class PhononTables:
    """Spectral tables, shape (num_branches, num_spectral), float64;
    branch 0 = LA, branch 1 = TA."""

    k: np.ndarray  # wave vectors [1/m]
    omega: np.ndarray  # angular frequency [rad/s]
    dw: np.ndarray  # band weight k_max*vg [rad/s]
    vg: np.ndarray  # group velocity [m/s]
    inv_kn: np.ndarray  # scattering rate [1/s]
    density: np.ndarray  # phonon DOS [s/m^3]
    heat_cap: np.ndarray  # modal heat capacity
    heat_cap_v: float  # volumetric heat capacity weight C_V
    k_max: float
    ref_temp: float
    ref_len: float

    @property
    def num_branches(self) -> int:
        return self.k.shape[0]

    @property
    def num_spectral(self) -> int:
        return self.k.shape[1]

    def flat(self, name: str) -> np.ndarray:
        """Flattened (B*S,) view of a table, branch-major."""
        return getattr(self, name).reshape(-1)


def load_material(path: str) -> PhononMaterial:
    """A material YAML file of the reference's schema (config/si.yaml)."""
    from pbte_tpu_torch.io.yamlish import load_yaml_file

    cfg = load_yaml_file(path)
    return PhononMaterial(
        C_LA=tuple(float(x) for x in cfg["C_LA"]),
        C_TA=tuple(float(x) for x in cfg["C_TA"]),
        lattice_dist=float(cfg["lattice_dist"]),
        Ai=float(cfg["Ai"]),
        BL=float(cfg["BL"]),
        BT=float(cfg["BT"]),
        BU=float(cfg["BU"]),
        num_branches=int(cfg.get("num_branches", 2)),
        num_spectral=int(cfg.get("num_spectral", 20)),
        ref_temp=float(cfg.get("reference_temperature", 300.0)),
        ref_len=float(cfg.get("reference_length", 1.0e-6)),
    )


@tracing.stage("pbte.setup.tables")
def build_tables(mat: PhononMaterial,
                 num_spectral: int | None = None) -> PhononTables:
    """Build the spectral tables; ``num_spectral`` overrides the
    material's band count."""
    S = int(num_spectral) if num_spectral is not None else mat.num_spectral
    if mat.num_branches != 2:
        raise ValueError(
            "non-gray SMRT tables require exactly 2 branches (LA, TA)")
    k_max = mat.k_max
    T = mat.ref_temp

    j = np.arange(1, S + 1, dtype=np.float64)
    kb = (2.0 * j - 1.0) / (2.0 * S) * k_max  # midpoint bands

    coeffs = np.array([mat.C_LA, mat.C_TA], dtype=np.float64)  # (2, 2)
    c0 = coeffs[:, 0:1]
    c1 = coeffs[:, 1:2]

    k = np.broadcast_to(kb, (2, S)).copy()
    w = c0 * k + c1 * k * k
    vg = c0 + 2.0 * c1 * k
    dw = k_max * vg
    density = k * k / vg / (2.0 * np.pi**2)

    inv_la = mat.Ai * w[0] ** 4 + mat.BL * T**3 * w[0] ** 2
    # TA: normal process below k_max/2 (strict <), Umklapp above
    inv_ta = mat.Ai * w[1] ** 4 + np.where(
        k[1] < k_max / 2.0,
        mat.BT * w[1] * T**4,
        mat.BU * w[1] ** 2 / np.sinh(HBAR * w[1] / (KB * T)),
    )
    inv_kn = np.stack([inv_la, inv_ta])

    x = HBAR * w / (KB * T)
    expx = np.exp(x)
    heat_cap = HBAR**2 * w * w * density * expx / (
        (expx - 1.0) ** 2 * KB * T * T)
    heat_cap_v = float(np.sum(heat_cap * inv_kn * (k_max * vg)))

    return PhononTables(
        k=k,
        omega=w,
        dw=dw,
        vg=vg,
        inv_kn=inv_kn,
        density=density,
        heat_cap=heat_cap,
        heat_cap_v=heat_cap_v,
        k_max=k_max,
        ref_temp=T,
        ref_len=mat.ref_len,
    )


# default silicon parameters (pbte_tpu's, from its config/si.yaml)
SILICON = PhononMaterial(
    C_LA=(9.01e3, -2.0e-7),
    C_TA=(5.23e3, -2.26e-7),
    lattice_dist=5.43e-10,
    Ai=1.498e-45,
    BL=1.18e-24,
    BT=8.708e-13,
    BU=2.890e-18,
)


def write_tables(tables: PhononTables, path: str) -> None:
    """The reference's golden-format table dump
    (``phonon_properties.txt``)."""
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("Phonon properties\n")
        f.write(f"num_branches: {tables.num_branches}\n")
        f.write(f"num_spectral: {tables.num_spectral}\n")
        f.write(f"k_max: {tables.k_max:g}\n")
        f.write(f"reference_temperature: {tables.ref_temp:g}\n")
        f.write(f"reference_length: {tables.ref_len:g}\n")
        f.write(f"HeatCapV: {tables.heat_cap_v:g}\n\n")
        f.write("branch idx k w dw vg invKn density heatCap\n")
        for p in range(tables.num_branches):
            for s in range(tables.num_spectral):
                f.write(
                    f"{p} {s} {tables.k[p, s]:g} {tables.omega[p, s]:g} "
                    f"{tables.dw[p, s]:g} {tables.vg[p, s]:g} "
                    f"{tables.inv_kn[p, s]:g} {tables.density[p, s]:g} "
                    f"{tables.heat_cap[p, s]:g}\n"
                )
