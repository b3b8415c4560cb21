"""Profiling hooks: device traces and stage timers.

``device_trace()`` records a ``torch.profiler`` trace (CPU activity, and
CUDA activity where a card is present) and writes it as a Chrome trace;
``StageTimer`` accumulates named sections with means and 95% intervals
for CSV export.  ``Codec.profile = True`` gives per-stage wall times
(``codec/codec.py``).
"""

import contextlib
import os
import tempfile
import time

import numpy as np
import torch


@contextlib.contextmanager
def device_trace(log_dir=None):
    """Trace the enclosed work with ``torch.profiler``; on exit write
    ``<log_dir>/trace_<pid>_<ns>.json`` (Chrome trace format, readable by
    chrome://tracing and Perfetto) and print its path.  ``log_dir``
    defaults to ``upcc_trace`` under the temporary directory."""
    from torch.profiler import ProfilerActivity, profile
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "upcc_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    print(f"device trace written to {path}")


class StageTimer:
    def __init__(self):
        self.samples = {}

    @contextlib.contextmanager
    def section(self, name):
        t0 = time.time()
        yield
        self.samples.setdefault(name, []).append(time.time() - t0)

    def summary(self):
        out = {}
        for name, vals in self.samples.items():
            v = np.asarray(vals)
            ci = 1.96 * v.std() / max(np.sqrt(len(v)), 1)
            out[name] = {"mean_s": float(v.mean()), "ci95_s": float(ci),
                         "n": len(v)}
        return out
