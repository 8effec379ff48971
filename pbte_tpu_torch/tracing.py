"""The port's spans and counters: one registry for the process.

- ``span(name)`` marks a part of the hot path (a step, its sweep, a
  BiCGStab update). It records only while ``torch.profiler`` runs: then
  it opens a ``torch.profiler.record_function(name)`` (a
  ``user_annotation`` in the profiler's Chrome trace, on the kernels'
  clock) and keeps a record in memory: its name, the span it opened
  inside (so a step's spans hang from it, and a solve's steps from the
  solve), its host start and end (``time.perf_counter``) and, once CUDA is
  initialised, a pair of CUDA events recorded on the current stream at
  enter and exit. With the profiler off it costs one check and enters a
  shared no-op context.
- ``stage(name)`` marks a set-up stage (assembly, the solver's
  constructor, a kernel build). Stages keep their host seconds always
  (a dozen a process, each seconds long) and open ``record_function``
  while the profiler runs. ``stage`` is also a decorator.
- ``count(name, n=1)`` adds to a counter, always.
- ``report()`` resolves the span records (one synchronise when CUDA
  events wait) and returns every span's, stage's and counter's totals;
  ``reset()`` clears the registry.

Nothing else in the package keeps counts or span times. The names:

- spans: ``pbte.solve`` (a BiCGStab or plain outer solve, a root);
  ``pbte.step`` (one step application: a root, or in a solve) and in it
  ``pbte.step.sources`` (the lagged Tc slab and the closure sources),
  ``pbte.step.sweep`` (one bucket's sweep) and ``pbte.step.macroscopic``
  (the partials' sum, Tc, Tv and the residual); ``pbte.bicgstab.update``
  (BiCGStab's vector updates) and in it ``pbte.bicgstab.dot`` (its inner
  products); ``pbte.bicgstab.residual_read`` and
  ``pbte.solve.residual_read`` (the host's reads of the residual);
- stages: ``pbte.setup.connect`` (``mesh.core.connect``),
  ``pbte.setup.assemble`` (``fem.assembly.assemble``),
  ``pbte.setup.face_trace`` (``fem.assembly.inverse_map``),
  ``pbte.setup.angles`` (``angular.quadrature.build``),
  ``pbte.setup.tables`` (``material.nongray_smrt.build_tables``),
  ``pbte.setup.solver`` (the solvers' constructors),
  ``pbte.setup.kernel_build`` (``ops._build.load`` of a new library),
  ``pbte.setup.supercell_factor`` (the supercell ring's factors);
- counters: ``k1.launches.<variant>.<state>`` (K1's launches, variant
  "persistent" or "tiled", state "f32", "bf16" or "f64"),
  ``dma_copy.launches.auto`` and ``.manual`` (K2's and K3's),
  ``bicgstab.restarts.plateau`` and ``.breakdown`` (BiCGStab's restarts of
  its recurrence), ``bicgstab.step_applications``.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

_profiler_on = torch._C._autograd._profiler_enabled
_NOOP = contextlib.nullcontext()
_lock = threading.Lock()  # stages and counts may come from threads
_open: list = []  # the open spans, innermost last
_spans: list = []  # closed span records, in closing order
_stages: dict = {}  # name -> [calls, host seconds]
_counts: dict = {}  # name -> count


def span(name):
    """A hot-path span: a no-op unless the profiler runs."""
    if not _profiler_on():
        return _NOOP
    return _Span(name)


class _Span:
    __slots__ = ("name", "parent", "rf", "ev", "t0", "t1", "device_s")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.parent = _open[-1] if _open else None
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.ev = self.device_s = None
        if torch.cuda.is_initialized():
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record()
        _open.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self.ev is not None:
            self.ev[1].record()
        _open.pop()
        self.rf.__exit__(*exc)
        self.rf = None
        _spans.append(self)
        return False


@contextlib.contextmanager
def stage(name):
    """A set-up stage: its host seconds always, a ``record_function``
    while the profiler runs."""
    t0 = time.perf_counter()
    try:
        if _profiler_on():
            with torch.profiler.record_function(name):
                yield
        else:
            yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            s = _stages.setdefault(name, [0, 0.0])
            s[0] += 1
            s[1] += dt


def count(name, n=1):
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def report():
    """The registry's totals:

    - ``spans``: per name ``calls``, ``host_s``, ``device_s`` (the stream's
      time between the span's events; on CPU tensors, where the work is
      synchronous, the host time), ``self_device_s`` (``device_s`` less
      its child spans') and ``parents`` (the names of the spans it opened
      inside);
    - ``stages``: per name ``calls`` and ``host_s``;
    - ``counts``: per name the count."""
    recs = list(_spans)
    if any(r.ev is not None for r in recs):
        torch.cuda.synchronize()
    child = {}
    for r in recs:
        if r.device_s is None:
            r.device_s = (r.ev[0].elapsed_time(r.ev[1]) * 1e-3
                          if r.ev is not None else r.t1 - r.t0)
            r.ev = None
        if r.parent is not None:
            child[id(r.parent)] = child.get(id(r.parent), 0.0) + r.device_s
    spans = {}
    for r in recs:
        e = spans.setdefault(r.name, dict(calls=0, host_s=0.0, device_s=0.0,
                                          self_device_s=0.0, parents=set()))
        e["calls"] += 1
        e["host_s"] += r.t1 - r.t0
        e["device_s"] += r.device_s
        e["self_device_s"] += max(r.device_s - child.get(id(r), 0.0), 0.0)
        if r.parent is not None:
            e["parents"].add(r.parent.name)
    for e in spans.values():
        e["parents"] = sorted(e["parents"])
    with _lock:
        stages = {n: dict(calls=c, host_s=s) for n, (c, s) in _stages.items()}
        counts = dict(_counts)
    return dict(spans=spans, stages=stages, counts=counts)


def reset():
    """Clear every span record, stage and counter."""
    with _lock:
        _spans.clear()
        _stages.clear()
        _counts.clear()
