"""Decode-only closed-loop codec traffic: a playback client.  Set-up
encodes the frames once; the window decodes their containers in turn,
each decode waiting for the one before.

Traffic keys as ``codec_loop``'s.  A frame's latency is its
``Codec.decompress``; its bits are its container's.
"""

from benchmark.traffic import codec_loop
from benchmark.traffic.codec_loop import end_to_end, setup  # noqa: F401


def _decode(st):
    def unit(i):
        data = st.first[i][0]
        return data, st.codec.decompress(data)
    return unit


def window(st, seconds):
    return codec_loop.run_window(st, seconds, _decode(st))


def traced(st, ctx):
    return codec_loop.traced_frames(st, ctx, _decode(st))


def judge(st, ctx):
    return codec_loop.judge_frames(st, ctx, ("dec",))
