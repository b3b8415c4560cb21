"""Benchmark of the port: the root ``bench.py``'s frames/s protocol on one GPU.

    python3 -m upcc_tpu_torch.bench [--device cpu] [--width 16]
        [--vox11_points N] [--vox10_points N] [--vox11_reps 5]
        [--vox10_reps 15] [--stream_frames 8] [--stream_sweeps 2]

Prints one ``#`` line with the card's name and power limit (``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``), ``#`` lines with the
rep times, bpp, encode and decode groups and launches per frame, then the
root script's three JSON lines ``{"metric", "value", "unit",
"vs_baseline"}`` in its order:

- ``encdec_fps_vox11``: ``surface_cloud(default_rng(7), extent=2047,
  n_target=1_200_000)`` at block 512; one warm-up of both directions, then
  5 reps, the median of the fastest 3;
- ``encdec_fps_vox10_stream``: the vox10 frame 8 times through
  ``compress_stream`` -> ``decompress_stream`` at block 1024, best of 2
  sweeps;
- ``encdec_fps_vox10``: ``surface_cloud(default_rng(10), extent=1024,
  n_target=760_000)`` at block 1024; one warm-up, then 15 reps, the median
  of the fastest 8.

q = (0.5, 0.5) in every line; ``vs_baseline`` divides by 1/(15.56 + 25.33)
frames/s, the reference's enc+dec seconds on one vox10 frame (BASELINE.md),
and is None on the vox11 line.  The root script times in the same order:
vox10, then vox11, then the stream.

At the flagship's width (128) the model is the committed epoch-193 flagship
(``results/CVPR_inverse_scaling/weights_bf16.msgpack``; the port has no
flax init); at any other width it is a seeded init (``torch.manual_seed``)
of the flagship config at that width.  Each ``unit`` says which.

Gates (each raises, and the script exits non-zero): on each frame's
warm-up, with ``codec.debug`` on, the encoder's and decoder's symbols,
indexes, scales and means are bit-exact over every block; on every timed
frame the decoded count equals the sum of the transmitted ``k[2]`` and no
conv prepared its weights; the stream's containers are byte-identical to
``compress()`` of the same frame; on the card, kernels K1 (tap_gemm), K2
(topk_mask) and K3 (compact) each launch in every frame, and every K2 and
K3 call of the vox11 warm-up (recorded through ``kernels.RECORD``) equals
its plain version bit for bit.  The vox11 frame's encode and decode groups
are printed with their blocks, points, ``k`` per level and, on the card,
each group's peak memory run alone.

Needs a CUDA device unless ``--device cpu`` is given: without one it
raises and never carries on on the CPU.

Left out: the root script's ``paused_trainer`` (SIGSTOP of a live
``train.py`` found through ``/tmp/upcc_train.pid`` for the benchmark's
duration).  Its only writer of that pid file is the TPU host's trainer
watchdog (``scripts/train_watchdog.sh``), which the port has no twin of, and
the port's trainer (``python3 -m upcc_tpu_torch.train``) would not match its
``train.py`` command-line check anyway.
"""

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from . import kernels, resolve_device
from .codec import bitstream
from .codec.codec import Codec, _chunk_decode_groups
from .data.synthetic import surface_cloud
from .models.unified import UnifiedModel
from .ops import family as F
from .ops.sparse import SparseTensor, compact, compact_plain
from .ops.topk import topk_mask, topk_mask_plain
from .weights import FLAGSHIP_CONFIG, flagship_config, load_weights

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(_ROOT, "results", "CVPR_inverse_scaling",
                       "weights_bf16.msgpack")
FLAGSHIP_WIDTH = 128
BASELINE_FPS = 1.0 / (15.56 + 25.33)
Q = (0.5, 0.5)
# the kernels of the codec's main path: K1, K2, K3
FRAME_KERNELS = ("tap_gemm", "topk_mask", "compact")


def card_line(device):
    """The card's name and power limit as nvidia-smi prints them."""
    if device.type != "cuda":
        return "cpu (no card)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def make_codec(width, device, seed=0):
    """(codec with update() done, what the weights are)."""
    if width == FLAGSHIP_WIDTH:
        model = load_weights(UnifiedModel(FLAGSHIP_CONFIG), WEIGHTS)
        what = "committed epoch-193 weights"
    else:
        torch.manual_seed(seed)
        model = UnifiedModel(flagship_config(width))
        what = f"seeded init at width {width}"
    codec = Codec(model, device=device)
    codec.update()
    return codec, what


def make_frame(seed, extent, n_points):
    xyz, rgb = surface_cloud(np.random.default_rng(seed), extent=extent,
                             n_target=n_points)
    return np.concatenate([xyz.astype(np.float32), rgb], 1)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sum_k(data):
    blocks, _ = bitstream.read_container(data)
    return sum(int(b["k"][2]) for b in blocks)


def check_count(data, rec, what):
    k = sum_k(data)
    if rec.shape[0] != k or not np.isfinite(rec).all():
        raise AssertionError(f"{what}: decoded {rec.shape[0]} points, "
                             f"transmitted sum k[2] = {k}")


def check_launches(launches, what, per_frame=None, frames=1):
    """K1, K2 and K3 each launched in every frame (``per_frame``: the
    sequential frame's counts, which every frame of a stream repeats)."""
    for name in FRAME_KERNELS:
        if launches[name] < frames:
            raise AssertionError(f"{what}: kernel {name} launched "
                                 f"{launches[name]} times in {frames} "
                                 f"frame(s)")
    if per_frame is not None:
        want = {n: per_frame[n] * frames for n in FRAME_KERNELS}
        if launches != want:
            raise AssertionError(f"{what}: launches {launches}, "
                                 f"{frames} x {per_frame} expected")


def frame_launches():
    return {name: kernels.LAUNCHES[name] for name in FRAME_KERNELS}


def warm_up(codec, frame, block, record=False):
    """One compress -> decompress with ``codec.debug`` on: the encoder's
    and decoder's symbols, indexes, scales and means bit-exact over every
    block, the decoded count = sum k[2].  With ``record``, every kernel
    call's inputs (``kernels.RECORD``).  Returns (data, rec, blocks,
    record or None)."""
    codec.debug, codec.debug_info = True, []
    if record:
        kernels.RECORD = {}
    try:
        data = codec.compress(frame, Q, block_size=block)
        rec = codec.decompress(data)
        _sync(codec.device)
    finally:
        rec_calls, kernels.RECORD = kernels.RECORD, None
        codec.debug = False
    enc = [d for d in codec.debug_info if d["side"] == "enc"]
    dec = [d for d in codec.debug_info if d["side"] == "dec"]
    codec.debug_info = []
    if not len(enc) == len(dec) >= 1:
        raise AssertionError(f"debug records: {len(enc)} encoder, "
                             f"{len(dec)} decoder blocks")
    for e, d in zip(enc, dec):
        for key in ("y_keys", "z_sym", "y_idx", "y_sym", "scales", "means"):
            if not np.array_equal(e[key], d[key]):
                raise AssertionError(f"encoder/decoder {key} differ")
    check_count(data, rec, f"warm-up at block {block}")
    return data, rec, len(enc), (rec_calls if record else None)


def check_recorded(record):
    """Every recorded K2 and K3 call against its plain version, bit for
    bit.  Returns printable lines."""
    lines = []
    for keys, logits, k in record.get("topk_mask", []):
        got = topk_mask(SparseTensor(keys, logits[:, None]), logits, k)
        ref = topk_mask_plain(keys, logits, k)
        if not torch.equal(got, ref):
            raise AssertionError(f"topk_mask differs from its plain version "
                                 f"(n={keys.shape[0]}, maxb={k.shape[0]})")
        lines.append(f"K2 n={keys.shape[0]} maxb={k.shape[0]} live batches="
                     f"{int((k > 0).sum())} kept={int(ref.sum())}: "
                     f"bit-equal to topk_mask_plain")
    for keys, keep, arrays, m in record.get("compact", []):
        got = compact(keys, keep, *arrays, out_capacity=m)
        ref = compact_plain(keys, keep, *arrays, out_capacity=m)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"compact differs from its plain version "
                                 f"(n={keys.shape[0]}, m={m})")
        lines.append(f"K3 n={keys.shape[0]} m={m} kept="
                     f"{min(int(keep.sum()), m)} payloads={len(arrays)}: "
                     f"bit-equal to compact_plain")
    return lines


def group_table(codec, frame, block, data):
    """The frame's encode groups (from the codec's partition) and decode
    groups (from the container): blocks, points and k per level each;
    on the card, each group's peak memory when run alone."""
    blocks, _ = bitstream.read_container(data)
    groups, levels = codec._partition_blocks(frame, block, 1.0)
    on_card = codec.device.type == "cuda"
    qv = np.asarray(Q, np.float32).reshape(1, 2)
    rows, at = [], 0

    def peak(fn):
        if not on_card:
            return None
        _sync(codec.device)
        torch.cuda.reset_peak_memory_stats(codec.device)
        with torch.no_grad():
            fn()
        _sync(codec.device)
        return torch.cuda.max_memory_allocated(codec.device) / 2 ** 30

    for group, origins in groups:
        blks = blocks[at:at + len(group)]
        at += len(group)
        rows.append({
            "side": "encode", "blocks": len(group),
            "points": int(sum(len(x) for x, _ in group)),
            "k": [int(sum(int(b["k"][i]) for b in blks)) for i in range(3)],
            "peak_gib": peak(lambda: codec._encode_at_q(
                codec._encode_shared(group, origins, levels), qv))})
    for blks in _chunk_decode_groups(blocks):
        k = [int(sum(int(b["k"][i]) for b in blks)) for i in range(3)]
        rows.append({"side": "decode", "blocks": len(blks), "points": k[2],
                     "k": k, "peak_gib": peak(
                         lambda: codec._decompress_group(blks))})
    return rows


def timed_reps(codec, frame, block, reps, what, per_frame=None):
    """``reps`` timed compress -> decompress pairs, each gated (decoded
    count, no conv preparing weights, on the card K1/K2/K3 launched).
    Returns (times s, data, launches of the last frame)."""
    times, launches = [], None
    on_card = codec.device.type == "cuda"
    for _ in range(reps):
        kernels.reset_launches()
        prepared = F.PREPARE_CALLS
        t0 = time.perf_counter()
        data = codec.compress(frame, Q, block_size=block)
        rec = codec.decompress(data)
        _sync(codec.device)
        times.append(time.perf_counter() - t0)
        launches = frame_launches()
        check_count(data, rec, what)
        if F.PREPARE_CALLS != prepared:
            raise AssertionError(f"{what}: a conv prepared its weights "
                                 f"during the frame")
        if on_card:
            check_launches(launches, what, per_frame)
            per_frame = per_frame or launches
    return times, data, launches


def _median_fastest(times, n):
    return float(np.median(sorted(times)[:n]))


def run(device="cuda", width=FLAGSHIP_WIDTH, vox11_points=1_200_000,
        vox10_points=760_000, vox11_reps=5, vox10_reps=15, stream_frames=8,
        stream_sweeps=2, keep_record=False):
    """The whole protocol; prints the ``#`` lines and the three JSON lines
    and returns what it measured ({"lines", "times", "gates", ...}; with
    ``keep_record`` also the vox11 warm-up's recorded kernel calls)."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    where = "1 GPU" if on_card else "CPU"
    print(f"# {card_line(device)}", flush=True)
    codec, weights = make_codec(width, device)
    gates = []
    out = {"times": {}, "bpp": {}, "launches": {}, "groups": {},
           "gates": gates}

    # vox10 (timed first, printed last, as in the root script)
    frame10 = make_frame(10, 1024, vox10_points)
    data10, _, nb, _ = warm_up(codec, frame10, 1024)
    gates.append(f"vox10 warm-up bit-exact over {nb} block(s)")
    t10, data10, l10 = timed_reps(codec, frame10, 1024, vox10_reps, "vox10")
    dt10 = _median_fastest(t10, 8)
    bpp10 = len(data10) * 8.0 / len(frame10)
    gates.append(f"vox10 {vox10_reps} frames: decoded = sum k[2]")
    out["times"]["vox10"], out["bpp"]["vox10"] = t10, bpp10
    out["launches"]["vox10"] = l10
    print(f"# vox10 rep times s: {t10}; {len(frame10)} pts, {dt10} s/frame "
          f"enc+dec (median of the fastest 8), {bpp10} bpp",
          flush=True)

    # vox11: the Owlii protocol half at block 512
    frame11 = make_frame(7, 2047, vox11_points)
    data11, _, nb, record = warm_up(codec, frame11, 512,
                                    record=on_card)
    gates.append(f"vox11 warm-up bit-exact over {nb} block(s)")
    if on_card:
        for line in check_recorded(record):
            print(f"# vox11 recorded {line}", flush=True)
        gates.append("vox11 recorded K2/K3 calls bit-equal to plain")
    groups = group_table(codec, frame11, 512, data11)
    out["groups"]["vox11"] = groups
    for g in groups:
        print(f"# vox11 {g['side']} group: blocks={g['blocks']} points="
              f"{g['points']} k={g['k']} peak="
              + ("n/a" if g["peak_gib"] is None
                 else f"{g['peak_gib']:.3f} GiB"), flush=True)
    split = {s: [g["blocks"] for g in groups if g["side"] == s]
             for s in ("encode", "decode")}
    same = "match" if split["encode"] == split["decode"] else "differ"
    print(f"# vox11 groups: {len(split['encode'])} encode {split['encode']}, "
          f"{len(split['decode'])} decode {split['decode']} (blocks each; "
          f"the splits {same})", flush=True)
    t11, data11, l11 = timed_reps(codec, frame11, 512, vox11_reps, "vox11")
    dt11 = _median_fastest(t11, 3)
    bpp11 = len(data11) * 8.0 / len(frame11)
    gates.append(f"vox11 {vox11_reps} frames: decoded = sum k[2]")
    out["times"]["vox11"], out["bpp"]["vox11"] = t11, bpp11
    out["launches"]["vox11"] = l11
    print(f"# vox11 rep times s: {t11}; {len(frame11)} pts, {dt11} s/frame "
          f"enc+dec (median of the fastest 3), {bpp11} bpp",
          flush=True)

    # the pipelined serving path on the vox10 frame
    frames = [frame10] * stream_frames
    sweeps = []
    for _ in range(stream_sweeps):
        kernels.reset_launches()
        prepared = F.PREPARE_CALLS
        t0 = time.perf_counter()
        blobs = list(codec.compress_stream(iter(frames), Q, block_size=1024))
        outs = list(codec.decompress_stream(iter(blobs)))
        _sync(device)
        sweeps.append((time.perf_counter() - t0) / stream_frames)
        if len(outs) != stream_frames or F.PREPARE_CALLS != prepared:
            raise AssertionError("stream: frames lost or weights prepared")
        for blob, rec in zip(blobs, outs):
            if blob != data10:
                raise AssertionError("stream container differs from "
                                     "compress() of the same frame")
            check_count(blob, rec, "stream")
        if on_card:
            check_launches(frame_launches(), "stream", l10, stream_frames)
    gates.append(f"stream: {stream_frames} containers byte-identical to "
                 f"compress(), decoded = sum k[2]")
    if on_card:
        gates.append("K1/K2/K3 launched in every frame")
    dts = min(sweeps)
    out["times"]["stream"] = sweeps
    print(f"# stream per-frame times s: {sweeps}", flush=True)
    for name, lnch in (("vox11", l11), ("vox10", l10)):
        print(f"# launches per {name} frame: {lnch}", flush=True)
    print(f"# gates passed: {'; '.join(gates)}", flush=True)

    tail = f"{weights}, q=(0.5, 0.5)"
    lines = [
        {"metric": "encdec_fps_vox11", "value": round(1.0 / dt11, 4),
         "unit": f"frames/s ({where}, enc+dec, {len(frame11)} pts vox11, "
                 f"block 512, {tail})",
         "vs_baseline": None},
        {"metric": "encdec_fps_vox10_stream", "value": round(1.0 / dts, 4),
         "unit": f"frames/s ({where}, pipelined enc+dec, {stream_frames}-"
                 f"frame stream, {len(frame10)} pts vox10, {tail})",
         "vs_baseline": round(1.0 / dts / BASELINE_FPS, 2)},
        {"metric": "encdec_fps_vox10", "value": round(1.0 / dt10, 4),
         "unit": f"frames/s ({where}, enc+dec, {len(frame10)} pts vox10, "
                 f"{tail})",
         "vs_baseline": round(1.0 / dt10 / BASELINE_FPS, 2)},
    ]
    for line in lines:
        print(json.dumps(line), flush=True)
    out["lines"] = lines
    if keep_record:
        out["record"], out["codec"] = record, codec
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=FLAGSHIP_WIDTH)
    ap.add_argument("--vox11_points", type=int, default=1_200_000)
    ap.add_argument("--vox10_points", type=int, default=760_000)
    ap.add_argument("--vox11_reps", type=int, default=5)
    ap.add_argument("--vox10_reps", type=int, default=15)
    ap.add_argument("--stream_frames", type=int, default=8)
    ap.add_argument("--stream_sweeps", type=int, default=2)
    a = ap.parse_args(argv)
    return run(**vars(a))


if __name__ == "__main__":
    main()
