"""Profiling: the port's tracer, device traces and stage timers.

The tracer.  ``span(name)`` marks a piece of the program's work and
``count(name, n)`` adds to a counter of the unit being worked on.  A unit
is one codec call (``frame(name)`` opens its root span under a fresh frame
id) or one training step (``span("train.step", unit=step)``); every span
inside it records its name, its own id, its parent's id, the unit and its
start and end in ``time.time_ns()``, the clock of the profiler's Chrome
trace (``ts`` in us plus the trace's ``baseTimeNanoseconds``).  The open
span lives in a context variable, so a worker thread that runs in a copy
of the submitting thread's context (``contextvars.copy_context().run``)
nests its spans under the submitter's.

Spans and counts record only while ``torch.profiler`` records, or inside
``recording()``, which yields the record.  Under the profiler each span
also opens ``record_function("upcc:<name>")``, so the program's spans lie
in the same trace as the device operations.  A new recording, or the
first span of a new profiler session, starts an empty record:
``last_record()`` holds the last traced window.  Off, ``span`` is one flag
check returning a shared null context: no ``record_function``, no
allocation, no device synchronization.  A span opened with ``sync=True``
inside ``synchronizing(device)`` (``Codec.profile``'s stages) synchronizes
the device at both ends while it records, so that its host length holds
the device work it enqueued.

``device_trace()`` records a ``torch.profiler`` trace (CPU activity, and
CUDA activity where a card is present) and writes it as a Chrome trace,
the operator's view of one window with the ``upcc:`` spans in it;
``StageTimer`` accumulates named sections with means and 95% intervals for
CSV export (the JAX package's twin).  ``Codec.profile = True`` gives
per-stage wall times, synchronized (``codec/codec.py``).
"""

import contextlib
import contextvars
import functools
import itertools
import os
import tempfile
import threading
import time
from collections import namedtuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "upcc:"

# unit: (root span's name, its id); start_ns and end_ns: time.time_ns()
Span = namedtuple("Span", "name id parent unit start_ns end_ns")


class Record:
    """One traced window: ``spans`` (``Span``, in the order they ended) and
    ``counts`` {unit: {counter: total}}."""

    def __init__(self):
        self.spans = []
        self.counts = {}

    def total(self, name):
        """The counter ``name`` summed over every unit of the record."""
        return sum(c.get(name, 0) for c in self.counts.values())


_current = contextvars.ContextVar("upcc_span", default=None)  # (id, unit)
_span_ids = itertools.count(1)
_frame_ids = itertools.count(1)
_NEW_FRAME = object()
_sync_device = contextvars.ContextVar("upcc_sync_device", default=None)
_lock = threading.Lock()
_recordings = 0   # open recording() blocks
_live = False     # the record belongs to the session under way
_record = Record()


def _begin():
    global _record, _live
    with _lock:
        if not _live:
            _record, _live = Record(), True


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def drop(self):
        pass


_NULL = _Null()


class _Span:
    __slots__ = ("name", "unit", "id", "parent", "token", "rf", "start",
                 "record", "dropped", "sync")

    def __init__(self, name, unit, sync=None):
        self.name, self.unit, self.dropped = name, unit, False
        self.sync = sync

    def __enter__(self):
        if not _live:
            _begin()
        self.record = _record
        cur = _current.get()
        self.parent, unit = cur if cur is not None else (None, None)
        if self.unit is not None:
            unit = (self.name, next(_frame_ids) if self.unit is _NEW_FRAME
                    else self.unit)
        self.unit = unit
        self.id = next(_span_ids)
        self.token = _current.set((self.id, unit))
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        if self.sync is not None:
            torch.cuda.synchronize(self.sync)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.sync is not None:
            torch.cuda.synchronize(self.sync)
        end = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _current.reset(self.token)
        if not self.dropped:
            self.record.spans.append(Span(self.name, self.id, self.parent,
                                          self.unit, self.start, end))
        return False

    def drop(self):
        """Leave this span out of the record (a step that found no
        batch)."""
        self.dropped = True


def enabled():
    """Whether spans and counts record now."""
    return bool(_recordings or _autograd_profiler._is_profiler_enabled)


def span(name, unit=None, sync=False):
    """A span of the program's work, as a context manager.  ``unit``: the
    id of the unit this span is the root of; by default the span belongs
    to the enclosing span's unit.  ``sync``: synchronize the device of the
    enclosing ``synchronizing`` block at both ends."""
    global _live
    if _recordings or _autograd_profiler._is_profiler_enabled:
        dev = _sync_device.get() if sync else None
        return _Span(name, unit,
                     dev if dev is not None and dev.type == "cuda" else None)
    _live = False
    return _NULL


@contextlib.contextmanager
def synchronizing(device):
    """Spans opened with ``sync=True`` inside the block synchronize
    ``device`` at both ends while they record."""
    token = _sync_device.set(device)
    try:
        yield
    finally:
        _sync_device.reset(token)


def frame(name):
    """The root span of a codec call, under a fresh frame id."""
    return span(name, _NEW_FRAME)


def count(name, n):
    """Add ``n`` to the counter ``name`` of the current unit."""
    if not (_recordings or _autograd_profiler._is_profiler_enabled):
        return
    if not _live:
        _begin()
    cur = _current.get()
    unit = cur[1] if cur is not None else None
    with _lock:
        c = _record.counts.setdefault(unit, {})
        c[name] = c.get(name, 0) + int(n)


def coder(name):
    """Decorate a host coder ``fn(data, ...)`` with the leaf span
    ``coder.<name>`` and the counters ``coder.<name>.symbols`` and
    ``.bytes``: an encoder (a name ending in ``.enc``) reads symbols from
    ``data`` and returns bytes; a decoder reads bytes and returns
    symbols."""
    encoder = name.endswith(".enc")
    label = "coder." + name

    def wrap(fn):
        @functools.wraps(fn)
        def run(data, *args, **kwargs):
            if not (_recordings or _autograd_profiler._is_profiler_enabled):
                return fn(data, *args, **kwargs)
            with span(label):
                out = fn(data, *args, **kwargs)
            symbols, raw = (data, out) if encoder else (out, data)
            count(label + ".symbols", np.size(symbols))
            count(label + ".bytes", len(raw))
            return out
        return run
    return wrap


@contextlib.contextmanager
def recording():
    """Record every span and count of the enclosed work, in every thread,
    into a new record, which it yields."""
    global _record, _live, _recordings
    with _lock:
        _record, _live = Record(), True
        _recordings += 1
    try:
        yield _record
    finally:
        with _lock:
            _recordings -= 1
            if not _recordings:
                _live = False


def last_record():
    """The record of the last recording or profiler session."""
    return _record


@contextlib.contextmanager
def device_trace(log_dir=None):
    """Trace the enclosed work with ``torch.profiler``; on exit write
    ``<log_dir>/trace_<pid>_<ns>.json`` (Chrome trace format, readable by
    chrome://tracing and Perfetto) and print its path.  The trace holds the
    program's spans as ``upcc:<name>`` ranges beside the device
    operations, and ``last_record()`` the same spans with their units and
    parents.  ``log_dir`` defaults to ``upcc_trace`` under the temporary
    directory."""
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
