"""The port's benchmark driver (``upcc_tpu_torch.bench``) on the CPU at
width 16 with a few thousand points and 1-2 reps: the root script's three
JSON lines in its order, their keys, and the gates that ran."""

import ast
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from upcc_tpu_torch import bench
from upcc_tpu_torch.weights import FLAGSHIP_CONFIG, flagship_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--width", "16", "--vox11_points", "4000",
        "--vox10_points", "3000", "--vox11_reps", "2",
        "--vox10_reps", "2", "--stream_frames", "2",
        "--stream_sweeps", "1"]


def root_metrics():
    """The metric names of the root bench.py's JSON lines, in its order."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    found = [(v.lineno, v.value) for node in ast.walk(tree)
             if isinstance(node, ast.Dict)
             for k, v in zip(node.keys, node.values)
             if isinstance(k, ast.Constant) and k.value == "metric"]
    return [name for _, name in sorted(found)]


@pytest.fixture(scope="module")
def tiny_run():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = bench.main(TINY)
    return out, buf.getvalue().splitlines()


def test_bench_prints_the_root_scripts_three_lines_in_order(tiny_run):
    out, lines = tiny_run
    assert lines[0].startswith("# ")
    body = [ln for ln in lines if not ln.startswith("#")]
    assert len(body) == 3
    parsed = [json.loads(ln) for ln in body]
    assert [p["metric"] for p in parsed] == root_metrics() == [
        "encdec_fps_vox11", "encdec_fps_vox10_stream", "encdec_fps_vox10"]
    for p in parsed:
        assert set(p) == {"metric", "value", "unit", "vs_baseline"}
        assert p["value"] > 0 and "seeded init at width 16" in p["unit"]
    assert parsed[0]["vs_baseline"] is None
    for p in parsed[1:]:
        assert p["vs_baseline"] == pytest.approx(
            p["value"] / bench.BASELINE_FPS, rel=1e-2, abs=0.01)
    # every # line comes before the JSON lines
    assert all(ln.startswith("#") for ln in lines[:-3])
    assert out["lines"] == parsed


def test_bench_gates_ran(tiny_run):
    out, lines = tiny_run
    gates = out["gates"]
    assert any("vox10 warm-up bit-exact" in g for g in gates)
    assert any("vox11 warm-up bit-exact" in g for g in gates)
    assert any("vox10 2 frames: decoded = sum k[2]" in g for g in gates)
    assert any("vox11 2 frames: decoded = sum k[2]" in g for g in gates)
    assert any("byte-identical to compress()" in g for g in gates)
    assert len(out["times"]["vox10"]) == len(out["times"]["vox11"]) == 2
    # the vox11 frame's groups: encode and decode sides cover every point
    groups = out["groups"]["vox11"]
    for side in ("encode", "decode"):
        rows = [g for g in groups if g["side"] == side]
        assert rows and sum(g["points"] for g in rows) <= 4000
    assert any(ln.startswith("# vox11 groups:") for ln in lines)


def test_bench_gates_raise():
    """The count and launch gates fail a wrong frame."""
    frame = bench.make_frame(3, 64, 500)
    codec, _ = bench.make_codec(16, "cpu")
    data = codec.compress(frame, bench.Q, block_size=64)
    rec = codec.decompress(data)
    bench.check_count(data, rec, "ok")
    with pytest.raises(AssertionError, match="sum k"):
        bench.check_count(data, rec[1:], "short")
    ok = {"tap_gemm": 19, "topk_mask": 3, "compact": 3}
    bench.check_launches(ok, "frame")
    bench.check_launches({k: 2 * v for k, v in ok.items()}, "two", ok, 2)
    with pytest.raises(AssertionError, match="topk_mask"):
        bench.check_launches(dict(ok, topk_mask=0), "no K2")
    with pytest.raises(AssertionError, match="expected"):
        bench.check_launches(ok, "stream", ok, 2)


def test_bench_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    made = []
    monkeypatch.setattr(bench, "make_codec",
                        lambda *a, **kw: made.append(a))
    with pytest.raises(RuntimeError, match="not available"):
        bench.main([])
    assert made == []


def test_bench_flagship_config_at_width():
    assert flagship_config(128) == FLAGSHIP_CONFIG
    cfg = flagship_config(16)
    assert cfg["g_s"]["min_one_child"] and cfg["g_a"]["N3"] == 16
    assert cfg["entropy_model"]["C_hyper_bottleneck"] == 24
    assert np.isclose(bench.BASELINE_FPS, 1 / 40.89)
