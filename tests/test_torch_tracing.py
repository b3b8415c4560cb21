"""The port's tracer (``upcc_tpu_torch/utils/profiling.py``) on the CPU at
N=16: spans and counts record only inside ``recording()`` or under
``torch.profiler``; frame and step ids and parents hold across the codec's
worker threads and streams; the bytes do not depend on recording; the
harness's stage hook still fills ``stage_times``; the training step's
phases; the span clock against the profiler's Chrome trace; the g_s and
coder counters against what the calls did."""

import contextvars
import json
import sys
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from upcc_tpu_torch.codec import bitstream
from upcc_tpu_torch.codec import codec as codec_mod
from upcc_tpu_torch.codec.codec import Codec
from upcc_tpu_torch.data.synthetic import surface_cloud
from upcc_tpu_torch.models import transforms
from upcc_tpu_torch.models.unified import UnifiedModel
from upcc_tpu_torch.ops import coords as C
from upcc_tpu_torch.utils import profiling as P
from upcc_tpu_torch.weights import flagship_config

torch.set_num_threads(2)

Q = (0.5, 0.5)
STAGES = {"enc.partition", "enc.voxelize", "enc.host_levels",
          "enc.analysis", "enc.hyper", "enc.params", "enc.symbols",
          "enc.entropy_coding", "dec.octree", "dec.rans_z", "dec.params",
          "dec.rans_y", "dec.synthesis", "dec.fetch"}


@pytest.fixture(scope="module")
def codec():
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = UnifiedModel(flagship_config(16))
    c = Codec(model, device="cpu")
    c.update()
    return c


def _frame(seed, offsets=(0, 128)):
    rng = np.random.default_rng(seed)
    parts = []
    for off in offsets:
        xyz, rgb = surface_cloud(rng, extent=64, n_target=1200)
        parts.append(np.concatenate(
            [(xyz + np.array([[off, 0, 0]])).astype(np.float32), rgb], 1))
    return np.concatenate(parts)


@pytest.fixture(scope="module")
def frame():
    return _frame(7)


def _by_unit(rec):
    units = {}
    for s in rec.spans:
        units.setdefault(s.unit, []).append(s)
    return units


def _check_tree(spans):
    """One root a unit; every other span's parent lies in its unit and
    encloses it in time.  Returns the root."""
    ids = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent not in ids]
    assert len(roots) == 1, [s.name for s in roots]
    for s in spans:
        if s is not roots[0]:
            p = ids[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    return roots[0]


def test_spans_off_record_nothing_and_call_nothing(codec, frame,
                                                   monkeypatch):
    with P.recording():
        pass
    before = P.last_record()

    def refuse(*a, **k):
        raise AssertionError("called while recording is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    assert not P.enabled()
    assert P.span("a") is P.span("b", unit=3) is P.frame("c")
    with P.span("a"):
        P.count("x", 1)
    codec.decompress(codec.compress(frame, Q, block_size=64))
    rec = P.last_record()
    assert rec is before and not rec.spans and not rec.counts


def test_profiler_session_records_and_its_trace_holds_the_spans(
        codec, frame, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    codec.compress(frame, Q, block_size=64)   # off: no span anywhere
    with profile(activities=[ProfilerActivity.CPU]) as idle:
        torch.ones(4).sum()
    idle.export_chrome_trace(str(tmp_path / "idle.json"))
    assert P.PREFIX not in (tmp_path / "idle.json").read_text()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        data = codec.compress(frame, Q, block_size=64)
    rec = P.last_record()
    assert {s.name for s in rec.spans} >= {"codec.compress", "enc.voxelize"}
    assert len([s for s in rec.spans if s.name == "codec.compress"]) == 1
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = Counter(e["name"] for e in json.loads(path.read_text())
                    ["traceEvents"] if e.get("name", "").startswith("upcc:"))
    assert names == Counter(P.PREFIX + s.name for s in rec.spans)
    # a later span off the profiler leaves the session's record as it was
    codec.decompress(data)
    assert P.last_record() is rec
    # the next session starts an empty record
    with profile(activities=[ProfilerActivity.CPU]):
        codec.decompress(data)
    assert P.last_record() is not rec
    assert {s.name for s in P.last_record().spans} >= {"codec.decompress"}
    assert "codec.compress" not in {s.name for s in P.last_record().spans}


def test_recording_yields_a_new_record_each_time():
    with P.recording() as a:
        with P.span("x", unit=1):
            P.count("n", 2)
            P.count("n", 3)
    with P.recording() as b:
        pass
    assert a is not b and not b.spans and P.last_record() is b
    assert [s.name for s in a.spans] == ["x"]
    assert a.counts == {("x", 1): {"n": 5}}


def test_threads_lose_no_span_or_count():
    """16 threads, each its own unit, spans and counts interleaved at a
    short switch interval: every span and every count arrives."""
    def work(i):
        with P.span("stress.root", unit=i):
            for _ in range(200):
                with P.span("stress.leaf"):
                    P.count("n", 1)
                    P.count("shared", 1)
        return i

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with P.recording() as rec:
            with ThreadPoolExecutor(max_workers=16) as ex:
                futures = [ex.submit(contextvars.copy_context().run, work, i)
                           for i in range(16)]
                assert [f.result(timeout=60) for f in futures] == list(
                    range(16))
    finally:
        sys.setswitchinterval(interval)
    units = _by_unit(rec)
    assert sorted(units) == [("stress.root", i) for i in range(16)]
    for spans in units.values():
        assert len(spans) == 201
        _check_tree(spans)
    assert all(c == {"n": 200, "shared": 200} for c in rec.counts.values())
    assert len({s.id for s in rec.spans}) == len(rec.spans)


def test_worker_threads_carry_parents_and_frame_ids(codec, frame,
                                                    monkeypatch):
    """Two groups run on two worker threads (recording alone leaves the
    parallel path on); their stages nest under the frame's root."""
    monkeypatch.setattr(codec_mod, "MAX_GROUP", 1)
    groups, _ = codec._partition_blocks(frame, 64, 1.0)
    assert len(groups) > 1
    threads = []
    real = Codec._in_worker

    def spy(self, fn, *args):
        threads.append(threading.current_thread() is threading.main_thread())
        return real(self, fn, *args)

    monkeypatch.setattr(Codec, "_in_worker", spy)
    with P.recording() as rec:
        data = codec.compress(frame, Q, block_size=64)
        codec.decompress(data)
    assert len(threads) == 2 * len(groups) and not any(threads)
    units = _by_unit(rec)
    assert len(units) == 2
    for spans in units.values():
        root = _check_tree(spans)
        assert root.name in ("codec.compress", "codec.decompress")
        ids = {s.id: s for s in spans}
        for s in spans:
            if s.name.startswith(("enc.", "dec.")):
                assert s.parent == root.id
            if s.name.startswith("coder."):
                assert ids[s.parent].name.startswith(("enc.", "dec."))
        per_stage = Counter(s.name for s in spans)
        first = "enc.voxelize" if root.name == "codec.compress" \
            else "dec.octree"
        assert per_stage[first] == len(groups)


def test_stream_frames_are_units_of_their_own(codec, frame):
    frames = [frame, frame[:1500], frame[700:]]
    with P.recording() as rec:
        datas = list(codec.compress_stream(iter(frames), Q, block_size=64,
                                           depth=2))
        list(codec.decompress_stream(iter(datas), depth=2))
    units = _by_unit(rec)
    roots = [_check_tree(spans) for spans in units.values()]
    assert Counter(r.name for r in roots) == {"codec.compress": 3,
                                              "codec.decompress": 3}
    assert len({r.unit for r in roots}) == 6
    for r in roots:
        assert r.parent is None and r.unit == (r.name, r.unit[1])


@pytest.mark.parametrize("geom", ["topk", "coded"])
def test_bytes_do_not_depend_on_recording(codec, frame, geom):
    off = codec.compress(frame, Q, block_size=64, geom=geom)
    rec_off = codec.decompress(off)
    with P.recording() as rec:
        on = codec.compress(frame, Q, block_size=64, geom=geom)
        rec_on = codec.decompress(on)
    assert on == off
    np.testing.assert_array_equal(rec_on, rec_off)
    assert rec.counts and rec.spans


def test_profiled_codec_fills_the_harness_stage_keys(codec, frame):
    """The benchmark wraps ``Codec._stage`` and reads ``stage_times`` with
    ``profile`` set: every stage still passes through the hook."""
    seen = []
    stage = codec._stage

    def hook(name):
        seen.append(name)
        return stage(name)

    codec.profile, codec.stage_times = True, {}
    codec._stage = hook
    try:
        with P.recording() as rec:
            codec.decompress(codec.compress(frame, Q, block_size=64))
    finally:
        codec.profile = False
        del codec._stage
    assert set(codec.stage_times) == STAGES == set(seen)
    assert all(v > 0 for v in codec.stage_times.values())
    assert STAGES <= {s.name for s in rec.spans}


def test_gs_counts_equal_the_candidates_the_prunes_saw(codec, frame,
                                                       monkeypatch):
    seen = Counter()
    real = transforms.compact

    def spy(keys, keep, *args, **kwargs):
        seen["generated"] += int(C.key_is_valid(keys).sum())
        seen["kept"] += int(keep.sum())
        return real(keys, keep, *args, **kwargs)

    data = codec.compress(frame, Q, block_size=64)
    monkeypatch.setattr(transforms, "compact", spy)
    with P.recording() as rec:
        codec.decompress(data)
    (counts,) = rec.counts.values()
    assert seen["kept"] > 0
    assert counts["gs.generated"] == seen["generated"]
    assert counts["gs.kept"] == seen["kept"]


def test_coder_counts_equal_the_streams(codec, frame):
    with P.recording() as rec:
        data = codec.compress(frame, Q, block_size=64)
    (enc,) = rec.counts.values()
    blocks, _ = bitstream.read_container(data)
    cb = codec.model.entropy_model.C_bottleneck
    zch = codec.tables["z"]["cdf"].shape[0]
    assert enc["coder.rans.enc.bytes"] == sum(
        len(b["y_bytes"]) + len(b["z_bytes"]) for b in blocks)
    assert enc["coder.rans.enc.symbols"] == sum(
        b["n_y"] * cb + b["n_z"] * zch for b in blocks)
    assert enc["coder.octree.enc.bytes"] == sum(
        len(b["coord_bytes"]) for b in blocks)
    assert enc["coder.octree.enc.symbols"] == sum(b["n_y"] for b in blocks)
    with P.recording() as rec:
        codec.decompress(data)
    (dec,) = rec.counts.values()
    for kind in ("rans", "octree"):
        for what in ("symbols", "bytes"):
            assert dec[f"coder.{kind}.dec.{what}"] \
                == enc[f"coder.{kind}.enc.{what}"]
    assert 0 < dec["coder.rans.dec.direct"] <= dec["coder.rans.dec.symbols"]
    coder_spans = [s for s in rec.spans if s.name.startswith("coder.")]
    assert Counter(s.name for s in coder_spans) == {
        "coder.octree.dec": len(blocks), "coder.rans.dec": 2 * len(blocks)}


def test_span_clock_is_the_chrome_trace_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span("clock.outer", unit=0):
            time.sleep(0.005)
            with P.span("clock.inner"):
                time.sleep(0.005)
            time.sleep(0.005)
    spans = {s.name: s for s in P.last_record().spans}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = {e["name"]: e for e in trace["traceEvents"]
              if e.get("ph") == "X"
              and e.get("name", "").startswith(P.PREFIX + "clock.")}
    assert set(events) == {P.PREFIX + n for n in spans}
    for name, s in spans.items():
        e = events[P.PREFIX + name]
        start = base + e["ts"] * 1e3
        end = start + e["dur"] * 1e3
        assert abs(start - s.start_ns) < 1e6 and abs(end - s.end_ns) < 1e6
    assert spans["clock.inner"].parent == spans["clock.outer"].id


@pytest.fixture
def trainer(tmp_path):
    from upcc_tpu_torch.data.dataset import write_split
    from upcc_tpu_torch.training.trainer import Training
    cfg_model = flagship_config(16)
    ds = tmp_path / "dataset"
    ds.mkdir()
    rng = np.random.default_rng(0)
    for split, n in (("train", 5), ("val", 1)):
        pts, cols = zip(*[surface_cloud(rng, extent=32, n_target=400)
                          for _ in range(n)])
        write_split(str(ds / f"{split}.npz"), list(pts), list(cols))
    cfg = {
        "experiment_name": "trace", "results_path": str(tmp_path / "res"),
        "model": cfg_model, "data_path": str(ds), "min_points_train": 10,
        "transforms": {"train": {"1_ColorJitter": {"key": "ColorJitter"}}},
        "q_map": {"lambda_A_min": 0, "lambda_A_max": 12800,
                  "lambda_G_min": 0, "lambda_G_max": 200,
                  "mode": "quadratic"},
        "loss": {
            "focal": {"type": "Multiscale_FocalLoss", "alpha": 0.5,
                      "gamma": 2.0},
            "color": {"type": "ColorLoss", "loss": "L2"},
            "bpp-y": {"type": "BPPLoss", "key": "y", "weight": 1.0},
            "bpp-z": {"type": "BPPLoss", "key": "z", "weight": 1.0}},
        "epochs": 1, "batch_size": 2, "val_every": 0,
    }
    return Training(cfg, capacity=2048, device="cpu", renders=False)


def test_training_step_records_its_five_phases(trainer):
    """A whole epoch of 5 cubes in batches of 2: three steps, each a
    ``train.step`` root under its step number with the five phases as its
    children, and no root for the look past the last batch."""
    t = trainer
    t.model.train()
    with P.recording() as rec:
        n = sum(1 for _ in t._seq_steps(0, t._batches(
            np.random.default_rng(0))))
    assert n == 3 and t.step_fn.step == 3
    units = _by_unit(rec)
    assert sorted(units) == [("train.step", i) for i in range(3)]
    for (_, step), spans in units.items():
        root = _check_tree(spans)
        assert root.name == "train.step" and root.unit == ("train.step", step)
        children = [s for s in spans if s.parent == root.id]
        assert sorted(s.name for s in children) == sorted(
            ["train.collate", "train.voxelize", "train.forward",
             "train.backward", "train.clip_adam"])
        assert [s.name for s in sorted(children, key=lambda s: s.start_ns)] \
            == ["train.collate", "train.voxelize", "train.forward",
                "train.backward", "train.clip_adam"]
