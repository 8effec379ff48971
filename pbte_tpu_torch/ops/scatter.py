"""Collision-free scatters over static index maps.

``index_add_`` and ``scatter_add_`` on CUDA tensors add through atomics:
where a target row repeats in the index, the order of its additions, and so
the rounding of its sum, changes from run to run. Every scatter of the port
adds over a map that is fixed when its solver is built (closure rows: a
corner element has several closure faces). ``unique_layers`` splits such a
map once into layers in which no target repeats; each layer's scatter then
makes one addition a target, and the layers run in a fixed order, so the
sum is a function of the inputs on any device. The process's determinism
flags (``torch.use_deterministic_algorithms``) are left alone.

``LayerMemo`` keeps the layers of each map tensor it has seen, so a caller
builds them at the first step and never again (nor when its consts are
replaced by tensors of the same map: a new tensor gets its own layers).
"""

from __future__ import annotations

import numpy as np
import torch


def unique_layers(rows):
    """Split the columns of a static index map into layers in which no
    target repeats.

    ``rows``: integer array or tensor, ``(N,)`` (a target per column) or
    ``(G, N)`` (a target per column in each of G independent maps, all
    scattered by one call, as ``scatter_add_`` along the last axis). Each
    pass takes, in order, every remaining column whose targets are the
    first remaining occurrence in every map; a target that repeats k times
    spreads over k layers. Returns a list of int64 tensors of column
    indices, ascending within a layer, on the device of ``rows`` when it is
    a tensor; together they hold every column exactly once."""
    device = rows.device if isinstance(rows, torch.Tensor) else None
    r = (rows.cpu().numpy() if isinstance(rows, torch.Tensor)
         else np.asarray(rows))
    r = r.reshape(-1, r.shape[-1]) if r.ndim else r.reshape(1, 1)
    left = np.arange(r.shape[1])
    layers = []
    while len(left):
        take = np.ones(len(left), dtype=bool)
        for row in r[:, left]:
            first = np.zeros(len(left), dtype=bool)
            first[np.unique(row, return_index=True)[1]] = True
            take &= first
        layers.append(torch.as_tensor(left[take], dtype=torch.int64,
                                      device=device))
        left = left[~take]
    return layers


def index_add_layered_(out, dim, index, src, layers):
    """``out.index_add_(dim, index, src)`` as one ``index_add_`` a layer of
    ``layers`` (``unique_layers(index)``), in layer order. Returns out."""
    for cols in layers:
        out.index_add_(dim, index[cols], src.index_select(dim, cols))
    return out


def scatter_add_layered_(out, pos, src, layers):
    """``out.scatter_add_(-1, pos, src)`` with ``pos`` ``(G, N)`` broadcast
    over the axes between the first and the last (``out`` ``(G, ..., M)``,
    ``src`` ``(G, ..., N)``), one ``scatter_add_`` a layer of ``layers``
    (``unique_layers(pos)``), in layer order. Returns out."""
    mid = (1,) * (out.dim() - 2)
    for cols in layers:
        p = pos[:, cols]
        out.scatter_add_(-1, p.view(p.shape[:1] + mid + p.shape[1:]).expand(
            out.shape[:-1] + p.shape[1:]), src.index_select(-1, cols))
    return out


class LayerMemo:
    """``unique_layers`` of each static map tensor, built at its first use.

    ``layers(key, rows)`` returns the layers of ``rows``, a map derived
    from the tensor ``key`` alone (``key`` itself, or e.g. rows of it
    offset by their group), built the first time ``key`` is seen; the memo
    holds ``key`` so that its identity stays its own."""

    def __init__(self):
        self._memo = {}

    def layers(self, key, rows=None):
        hit = self._memo.get(id(key))
        if hit is None or hit[0] is not key:
            hit = (key, unique_layers(key if rows is None else rows))
            self._memo[id(key)] = hit
        return hit[1]
