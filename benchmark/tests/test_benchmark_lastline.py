"""The result line's schema, and the device trace's arithmetic: busy time is
a union of intervals, idle time goes to the innermost host span."""

import json

from benchmark.core.harness import result_line
from benchmark.core.trace import Trace


def test_result_line_keys_and_order():
    line = result_line(
        True, 40, 0, {"frames_per_s": {"value": 1.3, "unit": "frames/s"}},
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "memory_peak_bytes": 123}, [("geom_gap", 1e-5, 1e-3)],
        breakdown={"device_ops": [["k", 0.1]], "idle_gaps": [["s", 0.2]]},
        extra={"power": "x"})
    text = json.dumps(line)
    back = json.loads(text)
    assert list(back)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(back)[-1] == "checks"
    assert back["checks"]["geom_gap"] == {"value": 1e-5, "limit": 1e-3}
    for m in back["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(back["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert "\n" not in text


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_union_and_idle_spans():
    events = [
        _x("bench:window", "user_annotation", 0, 100),
        _x("bench:frame", "user_annotation", 0, 100),
        _x("bench:enc.voxelize", "user_annotation", 10, 30),
        _x("k_a", "kernel", 5, 10),       # 5-15
        _x("k_b", "kernel", 12, 10),      # 12-22, overlaps k_a
        _x("memcpy", "gpu_memcpy", 50, 10),  # 50-60
        _x("k_c", "kernel", 95, 20),      # clipped at 100
    ]
    t = Trace(events, (0.0, 100.0), 100e-6)
    assert abs(t.busy_s - 32e-6) < 1e-12  # 5-22, 50-60, 95-100
    assert abs(t.kernel_s("k_") - (10 + 10 + 5) * 1e-6) < 1e-12
    idle = dict(t.idle_by_span)
    # 22-40 inside enc.voxelize, 0-5, 40-50, 60-95 inside frame only
    assert abs(idle["enc.voxelize"] - 18e-6) < 1e-12
    assert abs(idle["frame"] - (5 + 10 + 35) * 1e-6) < 1e-12
    b = t.breakdown()
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
