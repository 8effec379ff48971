"""A configuration file -> (ops, quad, tables), through a given set of host
layers: the program's (``port.layers``) for the timed side, the frozen
copies of ``reference/`` (``reference.check.layers``) for the plain
reference. Both sets have the same functions under the same names, so one
recipe builds both sides from the same numbers. This module imports
neither side."""

from __future__ import annotations


def build(config, layers):
    """(ops, quad, tables) of ``config`` through ``layers``."""
    m = config["mesh"]
    make = getattr(layers.builtins, f"make_{m['generator']}")
    mesh = make(*m["cells"], m["element"]).scaled(float(m["edge_m"]))
    ops = layers.assembly.assemble(layers.core.connect(mesh),
                                   order=int(config["order"]),
                                   face_mode=config["face_mode"])
    quad = layers.angular.build(layers.angular.AngularOptions(
        **config["angles"]))
    mat = {k: tuple(v) if isinstance(v, list) else v
           for k, v in config["material"].items()}
    tables = layers.material.build_tables(layers.material.PhononMaterial(
        **mat))
    return ops, quad, tables


def dof_per_step(ops, quad, tables):
    """Element-ordinate DOF one step updates: K BS ne D of the fine mesh."""
    return (quad.num_directions * tables.num_branches * tables.num_spectral
            * ops.num_elements * ops.ndof)
