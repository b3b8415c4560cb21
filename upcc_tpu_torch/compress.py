"""File-level codec CLI: PLY <-> .upcc bitstream with a trained experiment.

    python3 -m upcc_tpu_torch.compress encode in.ply out.upcc \\
        --experiment results/CVPR_inverse_scaling --q 0.4 0.4
    python3 -m upcc_tpu_torch.compress decode out.upcc rec.ply \\
        --experiment results/CVPR_inverse_scaling

Multiple inputs stream through the pipelined codec path
(Codec.compress_stream / decompress_stream), overlapping host entropy
coding with the next frame's device passes; outputs are byte-identical to
one-at-a-time coding.  Runs on the GPU unless ``--device cpu`` is given.
"""

import argparse
import os
import sys
import time

import numpy as np

from .codec.io import load_codec
from .data.ply import read_ply, write_ply


def _load_cloud(path):
    xyz, rgb = read_ply(path)
    if rgb is None:
        # codec color convention is [0,1] floats on the 8-bit grid
        rgb = np.full_like(xyz, 0.5, dtype=np.float64)
    return np.concatenate([np.asarray(xyz, np.float64),
                           np.asarray(rgb, np.float64)], axis=1)


def _read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("mode", choices=["encode", "decode"])
    ap.add_argument("inputs", nargs="+",
                    help="input file(s); with multiple inputs the last "
                         "positional is treated as an output DIRECTORY")
    ap.add_argument("output", help="output file (or directory for many)")
    ap.add_argument("--experiment", default="results/CVPR_inverse_scaling",
                    help="trained experiment dir (config.yaml + weights)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    ap.add_argument("--q", type=float, nargs=2, default=(0.5, 0.5),
                    metavar=("Q_G", "Q_A"),
                    help="quality in [0,1]^2: geometry, attributes")
    ap.add_argument("--block_size", type=int, default=1024)
    ap.add_argument("--scaling_factor", type=float, default=1.0)
    ap.add_argument("--geom", choices=["topk", "coded"], default="topk",
                    help="'coded' = lossless geometry: every candidate "
                         "voxel's occupancy bit is entropy-coded with the "
                         "learned logit as context (codec/refine.py)")
    ap.add_argument("--color_affine", action="store_true",
                    help="encoder-side signaled color refit: decode the "
                         "stream, fit a [3,4] YUV affine against the input "
                         "and attach it (48 B) to the container "
                         "(codec/color_affine.py); slower encode, better "
                         "color fidelity")
    ap.add_argument("--color_resid", type=float, default=0.0, metavar="LAM",
                    help="residual color enhancement layer with Lagrangian "
                         "weight LAM (training-loss units; e.g. 12800 = "
                         "the flagship's lambda_A at q_a=1): RAHT-code "
                         "quantized YUV residuals vs the input as a second "
                         "layer (codec/color_resid.py); implies the "
                         "encoder-side self-decode")
    ap.add_argument("--ladder", type=float, nargs="+", default=None,
                    metavar="Q",
                    help="multi-rate simulcast encode: flat q_g q_a pairs "
                         "(e.g. --ladder 0.2 0.2 0.5 0.5 1 1). Writes one "
                         "<out>.rN.upcc per rung from ONE analysis pass "
                         "(Codec.compress_multi), byte-identical to "
                         "separate --q encodes.")
    a = ap.parse_args(argv)
    if a.ladder is not None:
        if a.mode != "encode":
            ap.error("--ladder only applies to encode")
        if len(a.ladder) % 2:
            ap.error("--ladder takes q_g q_a PAIRS (even count of floats)")
        if a.color_affine or a.color_resid:
            ap.error("--color_affine/--color_resid with --ladder is not "
                     "supported yet (each rung would need its own "
                     "decode+fit)")

    many = len(a.inputs) > 1
    if many:
        stems = [os.path.splitext(os.path.basename(p))[0] for p in a.inputs]
        dupes = {s for s in stems if stems.count(s) > 1}
        if dupes:
            ap.error(f"duplicate output stems {sorted(dupes)}: inputs from "
                     "different directories would overwrite each other in "
                     f"{a.output}")
        os.makedirs(a.output, exist_ok=True)

    codec, _ = load_codec(a.experiment, device=a.device)

    def out_path(inp, ext):
        if not many:
            return a.output
        stem = os.path.splitext(os.path.basename(inp))[0]
        return os.path.join(a.output, stem + ext)

    t0 = time.time()
    if a.mode == "encode" and a.ladder is not None:
        qs = [tuple(a.ladder[i:i + 2]) for i in range(0, len(a.ladder), 2)]
        for inp in a.inputs:
            blobs = codec.compress_multi(_load_cloud(inp), qs,
                                         block_size=a.block_size,
                                         scaling_factor=a.scaling_factor,
                                         geom=a.geom)
            base, ext = os.path.splitext(out_path(inp, ".upcc"))
            for r, blob in enumerate(blobs):
                dst = f"{base}.r{r}{ext or '.upcc'}"
                with open(dst, "wb") as f:
                    f.write(blob)
                print(f"{inp} q={qs[r]} -> {dst}  {len(blob)} bytes")
    elif a.mode == "encode":
        frames = (_load_cloud(p) for p in a.inputs)
        blobs = codec.compress_stream(frames, q=tuple(a.q),
                                      block_size=a.block_size,
                                      scaling_factor=a.scaling_factor,
                                      geom=a.geom)
        for inp, blob in zip(a.inputs, blobs):
            if a.color_affine or a.color_resid:
                blob, _rec = codec.refit_colors(
                    blob, _load_cloud(inp), resid_lam=a.color_resid,
                    fit_affine=a.color_affine)
            dst = out_path(inp, ".upcc")
            with open(dst, "wb") as f:
                f.write(blob)
            print(f"{inp} -> {dst}  {len(blob)} bytes")
    else:
        blobs = (_read_bytes(p) for p in a.inputs)
        for inp, rec in zip(a.inputs, codec.decompress_stream(blobs)):
            rec = np.asarray(rec)
            dst = out_path(inp, ".ply")
            write_ply(dst, rec[:, :3], rec[:, 3:6])
            print(f"{inp} -> {dst}  {len(rec)} points")
    print(f"done in {time.time() - t0:.2f}s", file=sys.stderr)


if __name__ == "__main__":
    main()
