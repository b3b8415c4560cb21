"""Closed-loop streamed codec traffic: a live sender and receiver.  One
stream is ``stream_frames`` frames, the cell's frames in turn, encoded by
``Codec.compress_stream`` and decoded by ``Codec.decompress_stream``, each
at ``depth`` frames in flight, chained:
``decompress_stream(compress_stream(frames, depth), depth)``.  The next
stream starts when the last decode of the one before is yielded.

Traffic keys: ``codec_loop``'s, with ``stream_frames`` and ``depth`` in
place of ``trace_frames``.

A frame's latency runs from the moment ``compress_stream`` pulls it from
its input to the moment ``decompress_stream`` yields its decode.  Its
container is tapped between the two generators; a frame fails when its
container or its decode differs from its frame's unstreamed first
roundtrip of set-up.  The traced window is one whole stream, without
``Codec.profile`` (which would force depth 1).
"""

import sys
import time

from benchmark.core import device as dv
from benchmark.core import program
from benchmark.core.harness import phase
from benchmark.core.trace import span, traced as trace_window
from benchmark.traffic import codec_loop
from benchmark.traffic.codec_loop import end_to_end  # noqa: F401


def setup(ctx):
    st = codec_loop.setup(ctx)
    st.stream_frames = ctx.traffic["stream_frames"]
    st.depth = ctx.traffic["depth"]
    with phase("warm-up stream"):
        run_stream(st)
        dv.sync(ctx.device)
    return st


def run_stream(st):
    """One stream: [(frame index, latency, container, decoded frame)] in
    order."""
    n = len(st.frames)
    order = [j % n for j in range(st.stream_frames)]
    pulled, containers = [], []

    def source():
        for i in order:
            pulled.append(time.perf_counter())
            yield st.frames[i]

    def tap(stream):
        for data in stream:
            containers.append(data)
            yield data

    sent = st.codec.compress_stream(source(), st.q, block_size=st.block,
                                    depth=st.depth, geom=st.geom)
    out = []
    for j, rec in enumerate(st.codec.decompress_stream(tap(sent),
                                                       depth=st.depth)):
        out.append((order[j], time.perf_counter() - pulled[j],
                    containers[j], rec))
    return out


def window(st, seconds):
    lat, answers = [], []
    t0 = time.perf_counter()
    while True:
        for i, latency, data, rec in run_stream(st):
            lat.append(latency)
            answers.append((i, data, rec))
        dv.sync(st.device)
        e = time.perf_counter()
        if e - t0 >= seconds:
            break
    return {"elapsed": e - t0, "units": len(answers), "latencies": lat,
            "failed": codec_loop._count_failed(st, answers),
            "bits": sum(8 * len(data) for _, data, _ in answers),
            "points": sum(len(st.frames[i]) for i, _, _ in answers)}


def in_flight(rec, names=("codec.compress", "codec.decompress")):
    """The most root spans of each name open at once in a tracer record,
    {name: count}; None without a record."""
    if rec is None:
        return None
    out = {}
    for name in names:
        edges = sorted(e for s in program.roots(rec, name)
                       for e in ((s.start_ns, 1), (s.end_ns, -1)))
        cur = best = 0
        for _, d in edges:
            cur += d
            best = max(best, cur)
        out[name] = best
    return out


def traced(st, ctx):
    codec = st.codec
    codec_loop._labelled(codec)
    out = {}
    try:
        with trace_window(ctx.tmpdir, out, ctx.device):
            with span("stream"):
                answers = run_stream(st)
    finally:
        del codec._stage
    bad = codec_loop._count_failed(st, [(i, d, r) for i, _, d, r in answers])
    print(f"traced stream: depth {st.depth}, frames in flight "
          f"{in_flight(program.record())}, failed {bad}", file=sys.stderr)
    st.traced_idx = [i for i, _, _, _ in answers]
    n = len(answers)
    return {"trace": out["trace"], "units": n, "stage_s": {},
            "unit_s": out["trace"].window_s / n}


def judge(st, ctx):
    return codec_loop.judge_frames(st, ctx, ("enc", "dec"))
