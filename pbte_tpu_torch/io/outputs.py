"""Compare two output directories of the command-line interface.

``compare_outputs(ours, ref, rtol)`` holds one run's files to another's
(the GPU against the CPU, this package against pbte_tpu, a resumed run
against a straight one): the same file set, the host logs (mesh summary,
angles, sweep orders, phonon properties, element integrals) byte for
byte, and every other file as parsed floats. Numbers are compared in blocks
of one kind, each by its own largest value: a VTU's data arrays one by
one; in a table, the columns of one header stem (``x``, ``y`` and ``z``;
``T``; ``Qx``, ``Qy`` and ``Qz``); the rest of a file together. A value
may differ by ``rtol`` of its block's largest value beside one unit of the
last digit it is printed with (``%g`` keeps six significant digits, so a
sum that lands on the other side of a rounding boundary moves that digit).
"""

from __future__ import annotations

import math
import pathlib
import re

import numpy as np

HOST_LOGS = re.compile(r"(^|/)log/(mesh_.*|angles_.*|sweep_.*"
                       r"|phonon_properties|integrals_all)\.txt$")
_TOKEN = re.compile(r"[\s\"<>=]+")


def _numbers(text):
    """(values, last-digit units) of every token of ``text`` that parses
    as a float."""
    vals, units = [], []
    for tok in _TOKEN.split(text):
        try:
            v = float(tok)
        except ValueError:
            continue
        mant = tok.lower().split("e")[0].lstrip("+-")
        digits = mant.replace(".", "").lstrip("0")
        decimals = len(mant.split(".")[1]) if "." in mant else 0
        exp = int(tok.lower().split("e")[1]) if "e" in tok.lower() else 0
        vals.append(v)
        # a unit of the last printed digit, at most that of the sixth
        # significant one (%g drops trailing zeros; every writer prints six
        # or more); 0 for integers and exact zeros
        unit = 0.0
        if digits and math.isfinite(v) and ("." in mant or "e" in tok.lower()):
            unit = min(10.0 ** (exp - decimals),
                       10.0 ** (math.floor(math.log10(abs(v))) - 5))
        units.append(unit)
    return vals, units


def blocks(path):
    """A text file's numbers as [(values, units)] blocks of one kind."""
    path = pathlib.Path(path)
    text = path.read_text()
    if path.suffix == ".vtu":
        return [tuple(map(np.array, _numbers(p)))
                for p in text.split("<DataArray")]
    table, rest, names = [], ([], []), []
    for line in text.splitlines():
        vals, units = _numbers(line)
        if vals and len(vals) == len(line.split()):
            table.append((vals, units))
        else:
            rest[0].extend(vals)
            rest[1].extend(units)
            names = line.split()
    if not table or len({len(v) for v, _ in table}) != 1:
        vals = sum((v for v, _ in table), []) + rest[0]
        units = sum((u for _, u in table), []) + rest[1]
        return [(np.array(vals), np.array(units))]
    cols = np.array([v for v, _ in table]).T
    ucols = np.array([u for _, u in table]).T
    if len(names) != len(cols):
        names = [str(i) for i in range(len(cols))]
    stems = [n.rstrip("xyz") or "xyz" for n in names]
    out = []
    for stem in dict.fromkeys(stems):
        idx = [i for i, t in enumerate(stems) if t == stem]
        out.append((cols[idx].reshape(-1), ucols[idx].reshape(-1)))
    return out + [tuple(map(np.array, rest))]


def field_err(ours, ref):
    """The largest over blocks of max |a - b| / max |b|, each difference
    first less one unit of the last digit printed (NaNs must sit at the
    same places and the blocks have the same shapes)."""
    err = 0.0
    xs, ys = blocks(ours), blocks(ref)
    if len(xs) != len(ys):
        raise ValueError(f"{ours}: {len(xs)} blocks against {len(ys)}")
    for (x, ux), (y, uy) in zip(xs, ys):
        if x.shape != y.shape:
            raise ValueError(f"{ours}: {x.shape} numbers against {y.shape}")
        nan = np.isnan(y)
        if not np.array_equal(np.isnan(x), nan):
            raise ValueError(f"{ours}: NaNs at other places")
        x, y = x[~nan], y[~nan]
        unit = np.maximum(ux, uy)[~nan]
        if y.size:
            d = np.maximum(np.abs(x - y) - unit, 0.0)
            err = max(err, float(d.max() / max(np.abs(y).max(), 1e-300)))
    return err


def files(root):
    root = pathlib.Path(root)
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def compare_outputs(ours, ref, rtol):
    """Hold output directory ``ours`` to ``ref``; raises AssertionError on
    a difference, else returns {file: field_err} of the compared fields."""
    names = files(ref)
    got = files(ours)
    if got != names:
        raise AssertionError(f"file sets differ: {sorted(set(got) ^ set(names))}")
    errs = {}
    for f in names:
        a, b = pathlib.Path(ours) / f, pathlib.Path(ref) / f
        if HOST_LOGS.search(f):
            if a.read_bytes() != b.read_bytes():
                raise AssertionError(f"{f}: host log differs")
        else:
            errs[f] = field_err(a, b)
            if not errs[f] <= rtol:
                raise AssertionError(f"{f}: {errs[f]:.3e} of max > {rtol}")
    return errs
