"""Operation and byte counts of the model's products, from the model's
definition and the reference's own neighbour maps; the yardstick of the
rooflines and of ``mfu``.

A tap product (a conv, a down-conv or a transposed conv in brick layout,
and its dgrad and wgrad) counts 2 operations per structurally nonzero
weight element of a tap and valid (row, tap) pair of its map: the kernel's
taps laid into the (slot in, slot out) structure, the same whatever the
implementation plans, pads or tiles.  Bytes count every operand read once
and the output written once: bf16 features, weights and output gradients,
int32 indices and bool flags of the map, an f32 output (dgrad: f32 input
gradient; wgrad: f32 weight gradient of the nonzero elements).  The bound
of a product is the larger of operations over the peak rate and bytes
over the peak bandwidth.
"""

import contextlib

import numpy as np
from torch.utils.flop_counter import FlopCounterMode

from .plain.ops import family as F

BF16, F32, I32, BOOL = 2, 4, 4, 1


def flops(rec):
    return 2.0 * float(np.sum(rec["pairs"] * rec["nnz"]))


def nbytes(rec):
    rows, taps = rec["rows"], rec["taps"]
    nnz = float(np.sum(rec["nnz"]))
    maps = rows * taps * (I32 + BOOL)
    src_in = rec["n_src"] * rec["k_in"]
    rows_out = rows * rec["k_out"]
    if rec["pass"] == "fwd":
        return maps + src_in * BF16 + nnz * BF16 + rows_out * F32
    if rec["pass"] == "dgrad":
        return maps + rows_out * BF16 + nnz * BF16 + src_in * F32
    return maps + src_in * BF16 + rows_out * BF16 + nnz * F32


def bound_s(records, peaks):
    """Least device seconds of the records' products on a card with
    ``peaks`` (``core.peaks``)."""
    return sum(max(flops(r) / peaks["bf16_flops"],
                   nbytes(r) / peaks["hbm_bytes"]) for r in records)


@contextlib.contextmanager
def counting(out):
    """Count the body's model operations into ``out["model_flops"]``: every
    dense product torch runs, less the frozen engine's dense stand-ins of
    the tap products, plus the tap products' structural count
    (``out["records"]`` gets their records)."""
    records = []
    F.WORK = records
    plain0 = F.PLAIN_FLOPS[0]
    counter = FlopCounterMode(display=False)
    try:
        with counter:
            yield
    finally:
        F.WORK = None
    out["records"] = records
    out["model_flops"] = float(counter.get_total_flops()) \
        - float(F.PLAIN_FLOPS[0] - plain0) + sum(flops(r) for r in records)


def k1_records(records):
    """The products K1 runs (forward and dgrad)."""
    return [r for r in records if r["pass"] in ("fwd", "dgrad")]


def k1w_records(records):
    return [r for r in records if r["pass"] == "wgrad"]


def roofline(inp, kernel, records):
    """Share of ``records``' bound in the device time of the traced
    operations named ``kernel``, in %; None where either is missing."""
    t = inp["trace"].kernel_s(kernel)
    if not records or not t or inp["peaks"] is None:
        return None
    return 100.0 * bound_s(records, inp["peaks"]) / t
