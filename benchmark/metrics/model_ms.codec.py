"""The model (``models/``): g_a, h_a, the params graph, the y symbols,
the decoder's params graph and g_s, in ms a traced frame, from the
codec's own stage times (``Codec.profile``, which synchronizes the
device around each stage)."""

STAGES = ("enc.analysis", "enc.hyper", "enc.params", "enc.symbols",
          "dec.params", "dec.synthesis")


def read(inp):
    found = [inp["stage_s"][k] for k in STAGES if k in inp["stage_s"]]
    return 1e3 * sum(found) / inp["units"] if found else None
