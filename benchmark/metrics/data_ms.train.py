"""The training step's host data pipeline, from the port's own spans: the
self time of ``train.collate`` (pack, load and augment the cubes, collate)
and ``train.voxelize`` (host voxelize, root maps, the copies to the
device), in ms a traced step."""

from benchmark.core import program


def read(inp):
    rec = program.record()
    if rec is None:
        return None
    steps = len(program.roots(rec, "train.step"))
    if not steps:
        return None
    ns = program.self_ns(rec, lambda n: n in ("train.collate",
                                              "train.voxelize"))
    return ns * 1e-6 / steps
