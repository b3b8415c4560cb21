"""Codec orchestration on the host (``codec/codec.py``): the block partition,
host voxelization, host level counts and root maps, and the decoded
points' fetch, in ms a traced frame, from the codec's own stage times
(``Codec.profile``)."""

STAGES = ("enc.partition", "enc.voxelize", "enc.host_levels", "dec.fetch")


def read(inp):
    found = [inp["stage_s"][k] for k in STAGES if k in inp["stage_s"]]
    return 1e3 * sum(found) / inp["units"] if found else None
