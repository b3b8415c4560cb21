"""A bounded device trace: ``torch.profiler`` over one callable, read back
from its Chrome trace.

Device busy time is the union of the device operations' intervals
(kernels, copies, sets) inside the traced window, never a sum of
per-kernel totals, which double-counts overlap.  Idle time is the rest of
the window; each idle stretch is charged to the innermost host span
(``span(name)``, a ``record_function`` range named ``bench:<name>``)
open at the time, so the breakdown says what the host was doing while the
device waited.
"""

import contextlib
import json
import os
import time
from collections import defaultdict

import torch

from . import device as dv

_PREFIX = "bench:"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name):
    """A host span the trace labels idle time with."""
    return torch.profiler.record_function(_PREFIX + name)


class Trace:
    """What a traced window shows: ``window_s`` (host clock), ``busy_s``
    (union of device intervals), ``device_ops`` {name: seconds},
    ``idle_by_span`` {span: idle seconds}, ``kernel_s(substring)``."""

    def __init__(self, events, window_us, wall_s):
        t0, t1 = window_us
        self.window_s = wall_s
        dev = []
        spans = []
        for e in events:
            if e.get("ph") != "X":
                continue
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            if e.get("cat") in _DEVICE_CATS:
                s, f = max(ts, t0), min(ts + dur, t1)
                if f > s:
                    dev.append((s, f, e.get("name", "?")))
            elif e.get("name", "").startswith(_PREFIX) \
                    and e.get("name") != _PREFIX + "window" \
                    and e.get("cat") == "user_annotation":
                spans.append((ts, ts + dur, e["name"][len(_PREFIX):]))
        self.device_ops = defaultdict(float)
        for s, f, name in dev:
            self.device_ops[name] += (f - s) * 1e-6
        busy, idle = _union(sorted((s, f) for s, f, _ in dev), t0, t1)
        self.busy_s = busy * 1e-6
        self.idle_by_span = defaultdict(float)
        for s, f in idle:
            self._charge(spans, s, f)

    def _charge(self, spans, s, f):
        """Split the idle stretch [s, f) over the innermost open spans."""
        cuts = sorted({s, f} | {x for a, b, _ in spans for x in (a, b)
                                if s < x < f})
        for a, b in zip(cuts[:-1], cuts[1:]):
            mid = 0.5 * (a + b)
            inner = [sp for sp in spans if sp[0] <= mid < sp[1]]
            name = min(inner, key=lambda sp: sp[1] - sp[0])[2] \
                if inner else "(no span)"
            self.idle_by_span[name] += (b - a) * 1e-6

    def kernel_s(self, substring):
        """Device seconds of the operations whose name holds ``substring``,
        or None where there are none."""
        hits = [v for k, v in self.device_ops.items() if substring in k]
        return sum(hits) if hits else None

    def breakdown(self, n=10):
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _union(intervals, t0, t1):
    """(covered length, uncovered stretches) of sorted intervals in
    [t0, t1]."""
    covered, gaps, cur = 0.0, [], t0
    for s, f in intervals:
        if s > cur:
            gaps.append((cur, s))
            cur = s
        if f > cur:
            covered += f - cur
            cur = f
    if t1 > cur:
        gaps.append((cur, t1))
    return covered, gaps


@contextlib.contextmanager
def traced(tmpdir, out, device):
    """Trace the body; on exit ``out["trace"]`` holds its ``Trace``.  The
    Chrome trace goes to ``tmpdir`` and is deleted once read."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    dv.sync(device)
    with profile(activities=acts) as prof:
        with span("window"):
            t0 = time.perf_counter()
            yield
            dv.sync(device)
            wall = time.perf_counter() - t0
    path = os.path.join(tmpdir, f"bench_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    win = [e for e in events if e.get("name") == _PREFIX + "window"
           and e.get("ph") == "X"]
    if not win:
        raise RuntimeError("the device trace holds no window span")
    t0 = float(win[0]["ts"])
    out["trace"] = Trace(events, (t0, t0 + float(win[0]["dur"])), wall)
