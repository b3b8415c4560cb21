"""The host coders (``coding/``): rANS and octree coding on the encode side,
octree, z and y decoding on the decode side, in ms a traced frame, from
the codec's own stage times (``Codec.profile``)."""

STAGES = ("enc.entropy_coding", "dec.octree", "dec.rans_z", "dec.rans_y")


def read(inp):
    found = [inp["stage_s"][k] for k in STAGES if k in inp["stage_s"]]
    return 1e3 * sum(found) / inp["units"] if found else None
