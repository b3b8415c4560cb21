"""Writes the JAX-written stream fixture that the port decodes: a small
frame encoded by the JAX package with the committed epoch-193 flagship
weights, and the JAX package's own decode of it.

    JAX_PLATFORMS=cpu python3 tests/fixtures/make_jax_stream.py

Run from the repository root on a CPU host with the JAX package; the JAX
codec computes in f32 there (matmuls at "highest" precision).  Writes

  * ``jax_stream_flagship.upcc``: the container,
    ``surface_cloud(default_rng(2024), extent=128, n_target=6000)`` at
    q = (0.5, 0.5), block 128;
  * ``jax_stream_flagship_decoded.npy``: the JAX decode, uint8 [N, 6]
    (xyz, then rgb on the 8-bit grid: rgb * 255).

Not a test module: the port's tests and ``chip_smoke.py`` read the two
files (``chip_smoke.py`` decodes the container on the card)."""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

SEED, EXTENT, N_TARGET = 2024, 128, 6000
Q, BLOCK = (0.5, 0.5), 128
STREAM = os.path.join(HERE, "jax_stream_flagship.upcc")
DECODED = os.path.join(HERE, "jax_stream_flagship_decoded.npy")


def main():
    from upcc_tpu.codec.io import load_codec
    from upcc_tpu.data.synthetic import surface_cloud

    codec, _ = load_codec(os.path.join(ROOT, "results",
                                       "CVPR_inverse_scaling"))
    xyz, rgb = surface_cloud(np.random.default_rng(SEED), extent=EXTENT,
                             n_target=N_TARGET)
    frame = np.concatenate([xyz.astype(np.float32), rgb], 1)
    data = codec.compress(frame, Q, block_size=BLOCK)
    rec = np.asarray(codec.decompress(data))
    assert rec[:, :3].min() >= 0 and rec[:, :3].max() < 256
    rgb8 = np.round(rec[:, 3:6] * 255.0)
    assert np.abs(rec[:, 3:6] * 255.0 - rgb8).max() < 1e-3  # 8-bit grid
    out = np.concatenate([rec[:, :3], rgb8], 1).astype(np.uint8)
    with open(STREAM, "wb") as f:
        f.write(data)
    np.save(DECODED, out)
    print(f"{len(frame)} points -> {len(data)} B, decoded {len(out)} "
          f"points; wrote {STREAM} and {DECODED}")


if __name__ == "__main__":
    main()
