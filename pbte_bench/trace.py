"""The traced segment: ``torch.profiler`` over a short steady part of a
run, read back from its Chrome trace.

Device intervals are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events; busy time is the length of their union, the window
the host clock around the segment (ending in a synchronise). An idle gap
is named after the innermost host operation running at its middle."""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
TOP = 10


class Trace:
    """Device intervals (name, start_us, end_us) and host intervals of one
    traced segment, and its length on the host clock (``window_s``)."""

    def __init__(self, device_ev, host_ev, window_s):
        self.device_ev = sorted(device_ev, key=lambda e: e[1])
        self.host_ev = host_ev
        self.window_s = float(window_s)
        self.busy_s = _union_us(self.device_ev) * 1e-6

    def kernel_s(self, match=None):
        """Device seconds of the intervals whose name contains ``match``
        (all with None)."""
        return sum(e - s for n, s, e in self.device_ev
                   if match is None or match in n) * 1e-6

    def by_name(self):
        out = defaultdict(float)
        for n, s, e in self.device_ev:
            out[n] += (e - s) * 1e-6
        return out

    def gaps(self, top=TOP):
        """(name, seconds) of the ``top`` longest idle gaps between device
        intervals."""
        out, end = [], None
        for _, s, e in self.device_ev:
            if end is not None and s > end:
                out.append(((s + end) / 2, (s - end) * 1e-6))
            end = e if end is None else max(end, e)
        out = sorted(out, key=lambda x: -x[1])[:top]
        return [(self._host_at(mid), sec) for mid, sec in out]

    def _host_at(self, t):
        best, width = "host", None
        for n, s, e in self.host_ev:
            if s <= t <= e and (width is None or e - s < width):
                best, width = n, e - s
        return best

    def breakdown(self):
        ops = sorted(self.by_name().items(), key=lambda x: -x[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.gaps()]}


def _union_us(ev):
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in ev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile(fn, sync):
    """Run ``fn()`` under the profiler (CPU and CUDA activities), ending
    in ``sync()``; returns (fn's result, Trace)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    dev, host = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        iv = (ev.get("name", ""), float(ev["ts"]),
              float(ev["ts"]) + float(ev["dur"]))
        if ev.get("cat") in DEVICE_CATS:
            dev.append(iv)
        elif ev.get("cat") in HOST_CATS:
            host.append(iv)
    return out, Trace(dev, host, window_s)
