"""Reduce a ``torch.profiler`` trace of a stretch of updates to what the
per-layer readers and the result's ``breakdown`` need: the device's busy
time (the union of kernel, copy and set intervals), the device time by
kernel name, and the idle gaps named by what the host was doing in them.

The trace is read from the profiler's Chrome-trace export, whose event
categories are stable across PyTorch versions. The stretch is the span
of the ``bench.trace_window`` annotation, which opens and closes on a
synchronized device.
"""

from __future__ import annotations

import bisect
import collections
import json
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

MARKER = "bench.trace_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# what a gap means when only the harness's own annotations cover it
BETWEEN_OPS = {MARKER: "host between operations",
               "bench.update": "host in the update, between operations",
               "bench.old_dist": "host in the old_dist forward"}


class TraceSummary:
    """Device and host intervals (µs) of the stretch ``MARKER`` spans."""

    def __init__(self, path: Path):
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        dev: List[Tuple[float, float, str]] = []
        host: List[Tuple[float, float, str, object]] = []
        window = None
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e["dur"])
            if cat in DEVICE_CATS:
                dev.append((ts, ts + dur, e.get("name", "?")))
            elif cat in HOST_CATS:
                host.append((ts, ts + dur, e.get("name", "?"), e.get("tid")))
                if e.get("name") == MARKER:
                    window = (ts, ts + dur)
        if window is None:
            raise RuntimeError(f"the trace holds no {MARKER} span")
        self.t0, self.t1 = window
        self.window_s = (self.t1 - self.t0) * 1e-6
        by_name: Dict[str, float] = collections.defaultdict(float)
        spans = []
        for s, t, name in dev:
            s, t = max(s, self.t0), min(t, self.t1)
            if t > s:
                by_name[name] += (t - s) * 1e-6
                spans.append((s, t))
        self.by_name = dict(by_name)
        self.busy_intervals = _union(spans)
        self.busy_s = sum(t - s for s, t in self.busy_intervals) * 1e-6
        self._host = _main_thread(host)
        self._starts = [h[0] for h in self._host]

    def kernel_seconds(self, patterns: Iterable[str]) -> float:
        pats = tuple(patterns)
        return sum(v for k, v in self.by_name.items()
                   if any(p in k for p in pats))

    def top_ops(self, n: int = 10) -> List[list]:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], secs] for name, secs in ops]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The idle time, summed by the innermost host operation running at
        each gap's midpoint, largest first."""
        gaps, edge = [], self.t0
        for s, t in self.busy_intervals:
            if s > edge:
                gaps.append((edge, s))
            edge = max(edge, t)
        if self.t1 > edge:
            gaps.append((edge, self.t1))
        total: Dict[str, float] = collections.defaultdict(float)
        for s, t in gaps:
            total[self._host_at((s + t) / 2)] += (t - s) * 1e-6
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], secs] for name, secs in top]

    def _host_at(self, mid: float) -> str:
        i = bisect.bisect_right(self._starts, mid)
        best = None
        for s, t, name in reversed(self._host[max(0, i - 400):i]):
            if t >= mid and (best is None or t - s < best[0]):
                best = (t - s, name)
        # nothing nearer covers it: only the stretch's own annotation does
        name = best[1] if best else MARKER
        return BETWEEN_OPS.get(name, name)


def _union(spans) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, t in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return [(s, t) for s, t in merged]


def _main_thread(host):
    """The host events of the thread that opened the stretch."""
    marker_tids = [h[3] for h in host if h[2] == MARKER]
    if not marker_tids:
        return []
    return sorted((s, t, n) for s, t, n, tid in host if tid == marker_tids[0])
