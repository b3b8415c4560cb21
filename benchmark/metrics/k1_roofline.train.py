"""Kernel K1 in the traced training steps, forward and dgrad
(``tap_mainloop_kernel``): its least time on this card, from the
reference's counts of the same steps' tap products, over its device time,
in %."""

from benchmark.reference import work


def read(inp):
    return work.roofline(inp, "tap_mainloop_kernel",
                         work.k1_records(inp["work"]["records"]))
