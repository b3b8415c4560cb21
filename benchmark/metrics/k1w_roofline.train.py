"""Kernel K1w (``csrc/tap_wgrad.cu``, ``tap_wgrad_kernel``) in the traced
training steps: its least time on this card, from the reference's counts
of the same steps' weight gradients, over its device time, in %."""

from benchmark.reference import work


def read(inp):
    return work.roofline(inp, "tap_wgrad_kernel",
                         work.k1w_records(inp["work"]["records"]))
