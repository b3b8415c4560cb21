"""The region-candidate decode cell and the stream cell at a CPU test's
size: the region model's decode against the reference bit for bit (both
in f32 here) with its spans and counters read, the stream driver's window
and traced stream, and the manifest's names for both cells."""

from collections import namedtuple

import numpy as np
import pytest
import torch

from benchmark.core import manifest as mf
from benchmark.traffic import codec_stream
from conftest import ROOT, load, run_cell, tiny_codec

REGION = "codec_vox10_region_decode"
STREAM = "codec_vox10_stream"


def region_codec(model_cfg, weights):
    """(config, traffic) of the region cell at a CPU test's size: the
    width-16 flagship's weights under region5_codec's g_s settings."""
    config, traffic = tiny_codec(REGION)
    gs = load("benchmark/configs/region5_codec.json")["model"]["g_s"]
    cfg = dict(model_cfg, g_s=dict(model_cfg["g_s"], **{
        k: gs[k] for k in ("min_one_child", "region_candidates",
                           "region_dilate_factor")}))
    config["model"], config["weights"] = cfg, weights
    return config, traffic


def test_region_cell_matches_the_reference(tiny_weights, tmp_path, capsys):
    config, traffic = region_codec(*tiny_weights)
    rc, line = run_cell(REGION, config, traffic, tmp_path, trace=True,
                        capsys=capsys)
    assert rc == 0 and line["correct"] is True and line["failed"] == 0
    checks = {k: v["value"] for k, v in line["checks"].items()}
    assert checks == dict.fromkeys(checks, 0)
    metrics = line["metrics"]
    assert metrics["gs_region_ms.codec"]["value"] > 0
    assert 0 < metrics["gs_region_kept_share.codec"]["value"] < 100
    assert metrics["model_ms.codec"]["value"] > 0
    assert "gs_kept_share.codec" not in metrics


class Ctx:
    def __init__(self, config, traffic, tmp_path, seed=2 ** 31 + 3):
        self.root, self.cell, self.seed = ROOT, STREAM, seed
        self.device, self.trace = torch.device("cpu"), True
        self.config, self.traffic, self.tmpdir = config, traffic, \
            str(tmp_path)


def stream_cell(model_cfg, weights):
    config, traffic = tiny_codec(STREAM, model_cfg, weights)
    traffic["stream_frames"] = 4
    return config, traffic


def test_stream_window_taps_the_unstreamed_containers(tiny_weights,
                                                      tmp_path):
    torch.set_num_threads(2)
    config, traffic = stream_cell(*tiny_weights)
    st = codec_stream.setup(Ctx(config, traffic, tmp_path))
    out = codec_stream.run_stream(st)
    assert [i for i, _, _, _ in out] == [0, 1, 0, 1]
    for i, latency, data, rec in out:
        assert latency > 0
        assert data == st.first[i][0]
        assert np.array_equal(rec, st.first[i][1])
    win = codec_stream.window(st, 0.01)
    assert win["failed"] == 0 and win["units"] == 4
    assert len(win["latencies"]) == win["units"]
    e2e = codec_stream.end_to_end(st, win)
    assert e2e["bpp"] == 8 * sum(
        len(st.first[i][0]) for i in (0, 1)) / sum(
        len(st.frames[i]) for i in (0, 1))


def test_stream_window_counts_a_changed_container(tiny_weights, tmp_path):
    torch.set_num_threads(2)
    config, traffic = stream_cell(*tiny_weights)
    st = codec_stream.setup(Ctx(config, traffic, tmp_path))
    data, rec = st.first[1]
    st.first[1] = (data[:-1] + bytes([data[-1] ^ 1]), rec)
    assert codec_stream.window(st, 0.01)["failed"] == 2


def test_stream_cell_traced_run(tiny_weights, tmp_path, capsys):
    config, traffic = stream_cell(*tiny_weights)
    rc, line = run_cell(STREAM, config, traffic, tmp_path, trace=True,
                        capsys=capsys)
    assert rc == 0 and line["correct"] is True and line["failed"] == 0
    metrics = line["metrics"]
    assert 0 < metrics["gs_kept_share.codec"]["value"] < 100
    assert metrics["coder_msym_s.codec"]["value"] > 0
    for name in ("host_ms.codec", "model_ms.codec", "gs_region_ms.codec"):
        assert name not in metrics


def test_in_flight_counts_overlapping_roots():
    Span = namedtuple("Span", "name id parent unit start_ns end_ns")

    class Rec:
        def __init__(self, spans, counts):
            self.spans, self.counts = spans, counts

    u = [("codec.compress", i) for i in range(3)]
    rec = Rec([Span("codec.compress", 1, None, u[0], 0, 10),
               Span("codec.compress", 2, None, u[1], 5, 15),
               Span("codec.compress", 3, None, u[2], 15, 20),
               Span("enc.partition", 4, 1, u[0], 0, 6)], {})
    assert codec_stream.in_flight(rec) == {"codec.compress": 2,
                                          "codec.decompress": 0}
    assert codec_stream.in_flight(None) is None


@pytest.mark.parametrize("cell,metrics", [
    (REGION, ["host_ms.codec", "coder_ms.codec", "model_ms.codec",
              "k1_roofline.codec", "device_idle.codec", "mfu.codec",
              "coder_msym_s.codec", "gs_region_ms.codec",
              "gs_region_kept_share.codec"]),
    (STREAM, ["k1_roofline.codec", "device_idle.codec", "mfu.codec",
              "gs_kept_share.codec", "coder_msym_s.codec"]),
])
def test_manifest_resolves_the_new_cells(cell, metrics):
    man = mf.Manifest(ROOT)
    w = man.workload(cell)
    assert w["chips"] == 1
    assert [m["name"] for m in man.end_to_end(cell)] == [
        "frames_per_s", "frame_p90_s", "bpp", "setup_s"]
    assert [m["name"] for m in man.per_layer(cell)] == metrics
    for m in metrics:
        assert callable(mf.reader(m))
    config = man.config(w["config"])
    traffic = mf.traffic(w["traffic"])
    assert traffic["limits"] == mf.traffic("codec_vox10_decode")["limits"]
    assert callable(mf.driver(traffic["driver"]).window)
    if cell == REGION:
        flag = man.config("flagship_codec")
        assert config["weights"] == flag["weights"]
        assert config["reduced"] == []
        gs, fgs = config["model"]["g_s"], flag["model"]["g_s"]
        assert {k: v for k, v in gs.items() if k not in (
            "min_one_child", "region_candidates", "region_dilate_factor")} \
            == {k: v for k, v in fgs.items() if k != "min_one_child"}
        assert gs["region_candidates"] and not gs["min_one_child"]
        assert config["model"]["g_a"] == flag["model"]["g_a"]
        assert {k: v for k, v in traffic.items()} == mf.traffic(
            "codec_vox10_decode")
    else:
        assert traffic["depth"] == 2 and traffic["stream_frames"] == 8
