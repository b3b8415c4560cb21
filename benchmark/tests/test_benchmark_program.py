"""The readers of the port's own spans and counters (``core/program.py``):
their values on a synthetic record, nothing where the port has no tracer,
and a traced CPU run of each kind of cell that reads them.  The device
trace's arithmetic does not see the port's ``upcc:`` ranges."""

import sys
from collections import namedtuple

import pytest

from benchmark.core import manifest as mf
from benchmark.core import program
from benchmark.core.trace import Trace
from conftest import run_cell, tiny_codec, tiny_train

Span = namedtuple("Span", "name id parent unit start_ns end_ns")
MS = 1_000_000


class Rec:
    def __init__(self, spans, counts):
        self.spans, self.counts = spans, counts


def _train_record():
    spans = []
    for step in range(2):
        u, o = ("train.step", step), 100 * MS * step
        root = 10 * step + 1
        spans += [
            Span("train.collate", root + 1, root, u, o, o + 4 * MS),
            Span("train.voxelize", root + 2, root, u, o + 4 * MS, o + 7 * MS),
            Span("train.forward", root + 3, root, u, o + 7 * MS, o + 40 * MS),
            Span("train.backward", root + 4, root, u, o + 40 * MS,
                 o + 80 * MS),
            Span("train.clip_adam", root + 5, root, u, o + 80 * MS,
                 o + 90 * MS),
            Span("train.step", root, None, u, o, o + 90 * MS)]
    return Rec(spans, {})


def _codec_record():
    u = ("codec.decompress", 5)
    spans = [
        Span("coder.octree.dec", 2, 1, u, 0, 2 * MS),
        Span("coder.rans.dec", 3, 1, u, 2 * MS, 4 * MS),
        Span("dec.rans_y", 1, 0, u, 0, 5 * MS),
        Span("codec.decompress", 0, None, u, 0, 9 * MS)]
    counts = {u: {"coder.octree.dec.symbols": 1000,
                  "coder.octree.dec.bytes": 400,
                  "coder.rans.dec.symbols": 7000,
                  "coder.rans.dec.bytes": 900,
                  "gs.generated": 800, "gs.kept": 200}}
    return Rec(spans, counts)


@pytest.mark.parametrize("metric,record,value", [
    ("data_ms.train", _train_record, 7.0),
    ("gs_kept_share.codec", _codec_record, 25.0),
    ("coder_msym_s.codec", _codec_record, 8000 / 4e-3 / 1e6),
])
def test_reader_reads_a_synthetic_record(metric, record, value, monkeypatch):
    from upcc_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "last_record", record)
    assert mf.reader(metric)({}) == pytest.approx(value)


@pytest.mark.parametrize("metric", ["data_ms.train", "gs_kept_share.codec",
                                    "coder_msym_s.codec"])
@pytest.mark.parametrize("port", ["no_tracer", "no_module", "empty"])
def test_reader_finds_nothing_without_the_tracer(metric, port, monkeypatch):
    from upcc_tpu_torch.utils import profiling
    if port == "no_tracer":
        monkeypatch.delattr(profiling, "last_record")
    elif port == "no_module":
        import upcc_tpu_torch.utils
        monkeypatch.delattr(upcc_tpu_torch.utils, "profiling")
        monkeypatch.setitem(sys.modules, "upcc_tpu_torch.utils.profiling",
                            None)
    else:
        monkeypatch.setattr(profiling, "last_record", lambda: Rec([], {}))
    assert program.record() is None
    assert mf.reader(metric)({}) is None


def test_self_time_leaves_out_what_overlapping_children_cover():
    u = ("codec.compress", 1)
    rec = Rec([Span("a", 2, 1, u, 2 * MS, 6 * MS),
               Span("b", 3, 1, u, 4 * MS, 8 * MS),
               Span("c", 4, 1, u, 9 * MS, 12 * MS),
               Span("root", 1, None, u, 0, 10 * MS)], {})
    assert program.self_ns(rec, lambda n: n == "root") == 3 * MS
    assert program.self_ns(rec, lambda n: n in ("a", "b")) == 8 * MS


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_is_blind_to_the_program_spans():
    events = [
        _x("bench:window", "user_annotation", 0, 100),
        _x("bench:step", "user_annotation", 0, 100),
        _x("bench:forward", "user_annotation", 10, 30),
        _x("k_a", "kernel", 5, 10),
        _x("k_b", "kernel", 12, 10),
        _x("memcpy", "gpu_memcpy", 50, 10),
        _x("k_c", "kernel", 95, 20),
    ]
    program_spans = [
        _x("upcc:train.step", "user_annotation", 0, 100),
        _x("upcc:train.forward", "user_annotation", 10, 30),
        _x("upcc:train.backward", "user_annotation", 45, 40),
        _x("upcc:coder.rans.dec", "user_annotation", 60, 5),
    ]
    a = Trace(events, (0.0, 100.0), 100e-6)
    b = Trace(events + program_spans, (0.0, 100.0), 100e-6)
    assert a.busy_s == b.busy_s
    assert dict(a.device_ops) == dict(b.device_ops)
    assert dict(a.idle_by_span) == dict(b.idle_by_span)
    assert a.breakdown() == b.breakdown()


def test_codec_traced_run_reads_the_port_counters(tiny_weights, tmp_path,
                                                  capsys):
    cell = "codec_vox10_decode"
    config, traffic = tiny_codec(cell, *tiny_weights)
    rc, line = run_cell(cell, config, traffic, tmp_path, trace=True,
                        capsys=capsys)
    assert rc == 0 and line["correct"] is True
    metrics = line["metrics"]
    assert 0 < metrics["gs_kept_share.codec"]["value"] < 100
    assert metrics["coder_msym_s.codec"]["value"] > 0
    assert "data_ms.train" not in metrics


def test_train_traced_run_reads_the_data_pipeline(tiny_weights, tmp_path,
                                                  capsys):
    config, traffic = tiny_train(tiny_weights[0])
    rc, line = run_cell("train_flagship_b8", config, traffic, tmp_path,
                        trace=True, capsys=capsys)
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["data_ms.train"]["value"] > 0
    assert "gs_kept_share.codec" not in line["metrics"]
