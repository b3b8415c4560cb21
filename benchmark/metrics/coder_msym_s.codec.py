"""The host coders' rate over the traced frames: every symbol the rANS,
octree and occupancy coders encode or decode (the port's counters
``coder.<kind>.<enc|dec>.symbols``; an octree symbol is one coordinate)
over the self time of the coders' own spans (``coder.*``), in millions of
symbols a second."""

from benchmark.core import program


def read(inp):
    rec = program.record()
    if rec is None:
        return None
    ns = program.self_ns(rec, lambda n: n.startswith("coder."))
    symbols = program.counter(rec, lambda n: n.startswith("coder.")
                              and n.endswith(".symbols"))
    if not ns or not symbols:
        return None
    return symbols / (ns * 1e-9) / 1e6
