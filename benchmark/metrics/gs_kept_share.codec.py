"""The share of g_s's candidates that its prunes keep over the traced
frames, from the port's counters ``gs.kept`` and ``gs.generated`` (8
candidates a parent voxel at each level, the top-k's kept ones), in %."""

from benchmark.core import program


def read(inp):
    rec = program.record()
    if rec is None:
        return None
    generated = program.counter(rec, lambda n: n == "gs.generated")
    if not generated:
        return None
    return 100.0 * program.counter(rec, lambda n: n == "gs.kept") / generated
