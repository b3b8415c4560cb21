"""The share of region-candidate g_s's covered candidates (the children of
the dilated parent set that the kernel-5 transpose reaches, which the
occupancy heads score) that its top-k keeps, over the traced frames, from
the port's counters ``gs.region.kept`` and ``gs.region.covered``, in %."""

from benchmark.core import program


def read(inp):
    rec = program.record()
    if rec is None:
        return None
    covered = program.counter(rec, lambda n: n == "gs.region.covered")
    if not covered:
        return None
    return 100.0 * program.counter(
        rec, lambda n: n == "gs.region.kept") / covered
