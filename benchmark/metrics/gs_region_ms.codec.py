"""Region-candidate g_s's own set-up of each level: the dilation of the
parent set and its neighbour maps, child family and cover (the port's
spans ``gs.region.dilate`` and ``gs.region.maps``, which synchronize the
device at both ends under ``Codec.profile``), in self time, in ms a
traced frame."""

from benchmark.core import program


def read(inp):
    rec = program.record()
    if rec is None:
        return None
    ns = program.self_ns(rec, lambda n: n.startswith("gs.region."))
    return 1e-6 * ns / inp["units"] if ns else None
