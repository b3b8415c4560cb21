"""Closed-loop codec traffic: one client sends a frame, waits for its
container, decodes it, then sends the next frame.

Traffic keys: ``frames`` (``generator``, a function of the frozen
``reference/plain/data/synthetic.py``; ``count`` frames, frame i drawn from
``default_rng((seed, i))``; ``extent``, ``points``), ``q``,
``block_size``, ``geom``, ``trace_frames`` (frames in the traced window,
taken in turn), ``limits`` of the comparison with the reference.

A frame's latency runs from ``Codec.compress`` to the end of
``Codec.decompress`` of its container.
"""

import gc
import os
import time

import numpy as np

from benchmark.core import device as dv
from benchmark.core.harness import phase
from benchmark.core.trace import span, traced as trace_window
from benchmark.reference import codec_ref, rate
from benchmark.reference.plain.data import synthetic
from benchmark.reference.plain.models.unified import UnifiedModel as RefModel
from benchmark.reference.plain.weights import load_weights as ref_load


def make_frames(spec, seed):
    gen = getattr(synthetic, spec["generator"])
    frames = []
    for i in range(spec["count"]):
        xyz, rgb = gen(np.random.default_rng((seed, i)),
                       extent=spec["extent"], n_target=spec["points"])
        frames.append(np.concatenate([xyz.astype(np.float32), rgb], axis=1))
    return frames


def load_codec(ctx):
    """The port's codec on the committed weights, prepared (``update()``),
    with its kernels built."""
    from upcc_tpu_torch import kernels
    from upcc_tpu_torch.codec.codec import Codec
    from upcc_tpu_torch.models.unified import UnifiedModel
    from upcc_tpu_torch.weights import load_weights
    if ctx.device.type == "cuda":
        kernels.build(["tap_gemm", "topk_mask", "compact"])
    model = UnifiedModel(ctx.config["model"])
    load_weights(model, os.path.join(ctx.root, ctx.config["weights"]))
    codec = Codec(model, device=ctx.device)
    codec.update()
    return codec


class State:
    def __init__(self, ctx):
        t = ctx.traffic
        self.q = tuple(t["q"])
        self.block, self.geom = t["block_size"], t["geom"]
        with phase("frames"):
            self.frames = make_frames(t["frames"], ctx.seed)
        with phase("codec load + update()"):
            self.codec = load_codec(ctx)
        self.first = {}   # frame index -> (container, decoded frame)
        self.device = ctx.device

    def compress(self, i):
        return self.codec.compress(self.frames[i], self.q,
                                   block_size=self.block, geom=self.geom)

    def roundtrip(self, i):
        data = self.compress(i)
        return data, self.codec.decompress(data)


def setup(ctx):
    st = State(ctx)
    with phase("warm-up"):
        for _ in range(2):  # every frame's shapes, twice
            for i in range(len(st.frames)):
                st.first[i] = st.roundtrip(i)
        dv.sync(ctx.device)
    return st


def _loop(st, seconds, unit):
    """Run ``unit(i)`` over the frames in turn until ``seconds`` have
    passed; each returns (container, decoded frame)."""
    lat, answers = [], []
    n = len(st.frames)
    t0 = time.perf_counter()
    i = 0
    while True:
        s = time.perf_counter()
        data, rec = unit(i % n)
        dv.sync(st.device)
        e = time.perf_counter()
        lat.append(e - s)
        answers.append((i % n, data, rec))
        i += 1
        if e - t0 >= seconds:
            break
    return {"elapsed": e - t0, "units": i, "latencies": lat,
            "answers": answers}


def _count_failed(st, answers):
    """Answers that differ from their frame's first: the same frame and q
    give the same container and the same decoded frame."""
    bad = 0
    for i, data, rec in answers:
        data0, rec0 = st.first[i]
        bad += int(data != data0 or not np.array_equal(rec, rec0))
    return bad


def run_window(st, seconds, unit):
    """The window's result: latencies, units, failed, bits and points."""
    win = _loop(st, seconds, unit)
    answers = win.pop("answers")
    win["failed"] = _count_failed(st, answers)
    win["bits"] = sum(8 * len(data) for _, data, _ in answers)
    win["points"] = sum(len(st.frames[i]) for i, _, _ in answers)
    return win


def window(st, seconds):
    return run_window(st, seconds, st.roundtrip)


def end_to_end(st, win):
    lat = np.asarray(win["latencies"])
    return {"frames_per_s": win["units"] / win["elapsed"],
            "frame_p90_s": float(np.percentile(lat, 90)),
            "bpp": win["bits"] / win["points"]}


def _labelled(codec):
    """The codec's stage spans, also as trace spans."""
    stage = codec._stage

    def labelled_stage(name):
        cm = stage(name)

        class _Both:
            def __enter__(self):
                self.s = span(name)
                self.s.__enter__()
                return cm.__enter__()

            def __exit__(self, *exc):
                try:
                    return cm.__exit__(*exc)
                finally:
                    self.s.__exit__(*exc)

        return _Both()

    codec._stage = labelled_stage


def traced_frames(st, ctx, unit):
    """``trace_frames`` units under the profiler, with the codec's stage
    times (``Codec.profile``) on."""
    n = ctx.traffic["trace_frames"]
    codec = st.codec
    codec.profile, codec.stage_times = True, {}
    _labelled(codec)
    out = {}
    try:
        with trace_window(ctx.tmpdir, out, ctx.device):
            for i in range(n):
                with span("frame"):
                    unit(i % len(st.frames))
    finally:
        codec.profile = False
        del codec._stage
    st.traced_idx = [i % len(st.frames) for i in range(n)]
    return {"trace": out["trace"], "units": n,
            "stage_s": dict(codec.stage_times),
            "unit_s": out["trace"].window_s / n}


def traced(st, ctx):
    return traced_frames(st, ctx, st.roundtrip)


def judge_frames(st, ctx, phases):
    """Free the port, run the reference over every frame, compare each
    frame's first decode with it; the reference's counts of the traced
    frames' ``phases`` ("enc", "dec")."""
    st.codec = None
    gc.collect()
    dv.free(ctx.device)
    model = RefModel(ctx.config["model"])
    ref_load(model, os.path.join(ctx.root, ctx.config["weights"]))
    model = model.to(ctx.device).eval()
    gaps, counts = dict.fromkeys(codec_ref.GAPS, 0.0), []
    for i, frame in enumerate(st.frames):
        c, blocks = {}, []
        ref = codec_ref.roundtrip(model, frame, st.q, st.block, ctx.device, c,
                                  blocks)
        data, decoded = st.first[i]
        for k, v in codec_ref.frame_gaps(
                decoded, rate.container_blocks(data), ref, blocks).items():
            gaps[k] = max(gaps[k], v)
        counts.append(c)
    lim = ctx.traffic["limits"]
    checks = [(k, gaps[k], v) for k, v in lim.items()]
    records, flops = [], 0.0
    for i in getattr(st, "traced_idx", []):
        for p in phases:
            records += counts[i][p]["records"]
            flops += counts[i][p]["model_flops"]
    return checks, {"records": records, "model_flops": flops}


def judge(st, ctx):
    return judge_frames(st, ctx, ("enc", "dec"))
