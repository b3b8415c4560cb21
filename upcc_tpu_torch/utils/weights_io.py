"""Compact weight snapshots: the torch counterparts of the JAX package's
``utils/weights_io.py``, through the port's flax-msgpack carrier
(``upcc_tpu_torch/weights.py``), so both packages read each other's files.

``save_compact`` writes every float parameter rounded to bfloat16 (half
the bytes, committable); ``load_params`` reads a float32 or bfloat16
snapshot into the module, whose parameters keep their own dtypes.
"""

from ..weights import load_weights, save_flax_msgpack


def save_compact(model, path):
    """Write a bfloat16 flax-msgpack snapshot of ``model``'s parameters."""
    save_flax_msgpack(model, path, dtype="bfloat16")


def load_params(model, path):
    """Load an f32 or bf16 snapshot into ``model`` (strict: every
    parameter, equal shapes); returns the model."""
    return load_weights(model, path)
