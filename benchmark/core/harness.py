"""One run of one cell: set-up, the timed window, the traced window when
asked, the comparison with the reference, the result line.

A traffic driver (``benchmark/traffic/<driver>.py``) supplies:

- ``setup(ctx) -> state``: inputs and weights from ``ctx.seed``, the
  program's set-up, every shape of the window warmed up;
- ``window(state, seconds) -> dict``: the closed loop for ``seconds``,
  ending in a device synchronization: ``units`` completed, ``elapsed``
  seconds, ``failed`` units, and what its end-to-end metrics read;
- ``end_to_end(state, win) -> {metric: value}``;
- ``traced(state, ctx) -> dict``: a bounded traced window (``trace``, a
  ``core.trace.Trace``; ``units``; ``stage_s``, the program's stage
  seconds over it; ``unit_s``, its seconds a unit);
- ``judge(state, ctx) -> (checks, work)``: frees the program's state,
  runs the reference and returns [(name, value, limit)] and the
  reference's counts of the traced units (``work`` records and
  ``model_flops``).
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "upcc_tpu")


def forbidden_modules(names):
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def _fixed_cache_dirs(root):
    """Every build and kernel cache at a fixed path inside the checkout,
    so that only a checkout's first run builds."""
    build = os.path.join(root, "build")
    os.environ["UPCC_TORCH_BUILD"] = build
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")


def power_limit():
    """(card name, power limit) as nvidia-smi reads them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


@contextlib.contextmanager
def phase(name):
    """Print a set-up phase's seconds on standard error."""
    t0 = time.perf_counter()
    yield
    print(f"setup: {name} {time.perf_counter() - t0:.3f} s", file=sys.stderr,
          flush=True)


class Context:
    def __init__(self, root, cell, seed, seconds, trace, device, config,
                 traffic, tmpdir):
        self.root, self.cell, self.seed = root, cell, seed
        self.seconds, self.trace, self.device = seconds, trace, device
        self.config, self.traffic, self.tmpdir = config, traffic, tmpdir


def layer_metrics(manifest, cell, inputs):
    """The cell's per-layer metrics that found something to read."""
    from . import manifest as mf
    out = {}
    for m in manifest.per_layer(cell):
        value = mf.reader(m["name"])(inputs)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(correct, attempted, failed, metrics, device, checks,
                breakdown=None, extra=None):
    """The last line's object; the compared numbers come last."""
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out.update(extra or {})
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    return out


def run_cell(root, cell, seed, seconds, trace, t_start=None):
    t_start = time.perf_counter() if t_start is None else t_start
    _fixed_cache_dirs(root)
    from . import manifest as mf
    man = mf.Manifest(root)
    work = man.workload(cell)
    import torch
    chips = int(work.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    traffic = mf.traffic(work["traffic"])
    driver = mf.driver(traffic["driver"])
    device = torch.device("cuda", 0)
    tmpdir = tempfile.mkdtemp(prefix="bench_")
    try:
        ctx = Context(root, cell, seed, seconds, trace, device,
                      man.config(work["config"]), traffic, tmpdir)
        return _run(ctx, man, driver, t_start)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def _run(ctx, man, driver, t_start):
    from . import device as dv
    from . import peaks
    state = driver.setup(ctx)
    dv.sync(ctx.device)
    setup_s = time.perf_counter() - t_start
    win = driver.window(state, ctx.seconds)
    peak = dv.peak_bytes(ctx.device)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"benchmark: loaded after the window: {bad}", file=sys.stderr)
        return 4
    tr = driver.traced(state, ctx) if ctx.trace else None
    e2e = dict(driver.end_to_end(state, win), setup_s=setup_s)
    with phase("reference (not in setup_s)"):
        checks, work = driver.judge(state, ctx)
    kind = dv.name(ctx.device)
    device = {"platform": "gpu", "kind": kind, "count": 1,
              "memory_peak_bytes": peak}
    limit = power_limit()
    extra = {"power": limit, "window_s": win["elapsed"]}
    if ctx.trace:
        t = tr["trace"]
        device.update(busy_s=t.busy_s, window_s=t.window_s)
        inputs = dict(tr, work=work, peaks=peaks.for_card(kind))
        metrics = layer_metrics(man, ctx.cell, inputs)
        breakdown = t.breakdown()
        unit_s = win["elapsed"] / max(win["units"], 1)
        extra["tracing_overhead"] = tr["unit_s"] / unit_s - 1.0
    else:
        units = {m["name"]: m["unit"] for m in man.end_to_end(ctx.cell)}
        metrics = {n: {"value": e2e[n], "unit": u} for n, u in units.items()}
        breakdown = None
    correct = win["failed"] == 0 and all(v <= lim for _, v, lim in checks)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"benchmark: loaded in this process: {bad}", file=sys.stderr)
        return 4
    line = result_line(correct, win["units"], win["failed"], metrics, device,
                       checks, breakdown, extra)
    print(f"card: {limit}", file=sys.stderr)
    if ctx.trace:
        print(f"tracing overhead: {extra['tracing_overhead']:+.4f} of a "
              f"unit's time", file=sys.stderr)
    for name, v, lim in checks:
        print(f"check {name} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
