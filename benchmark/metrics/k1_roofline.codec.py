"""Kernel K1 (``csrc/tap_gemm.cu`` on ``tap_mainloop.cuh``) over the
traced frames: its least time on this card, from the reference's counts
of the frames' tap products, over the device time of its
``tap_mainloop_kernel`` launches, in %."""

from benchmark.reference import work


def read(inp):
    return work.roofline(inp, "tap_mainloop_kernel",
                         work.k1_records(inp["work"]["records"]))
