#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``upcc_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # the whole check, one card
    python3 chip_smoke.py --kernels  # build + kernel checks only

Phases, each printing its lines; any failure raises and exits non-zero:
  1. the card's name and power limit (nvidia-smi); build the CUDA kernels
     (one nvcc per source, in parallel) and print the build seconds;
  2. every kernel against its plain PyTorch version on edge-case inputs:
     K1 tap_gemm through its prepared weights at each caller layout, held
     against the dense plain version on the dense stack (f32 tolerance
     below; ragged and short row counts, unread taps, nothing read, indices
     beyond the source, and rows placed elsewhere in a larger call being
     bit-equal), K2 topk_mask in both of its modes (resident and
     streaming, on the same inputs, and streaming by shape at 40M
     candidates) and K3 compact (bit for bit: empty input and output, none
     and all kept, m past n, 9 payloads in two launches, 1-, 3- and
     1200-byte rows, payloads at odd byte offsets, and a run of calls on
     one stream with n and payload counts growing and shrinking), P1
     tile_tapconv in both operand
     types (tolerances at P1_TOL) and P2 window_gather_sum in its slab mode
     (8- and 4-float slabs, ragged widths) and its streaming mode (exact,
     bit for bit);
  3. the codec's main path at full width: the committed epoch-193 flagship
     weights, the vox10-scale synthetic frame (760k points), compress ->
     decompress at q=(0.5, 0.5), block 1024 (once recording every kernel
     call's inputs, once timed with the launch counts zeroed just before),
     then block 512 (an 8-block group); checks encoder/decoder bit-exactness,
     the decoded count against the transmitted k, the launches per frame
     (K1 19, K2 3, K3 3; 61 / 0 / 9 on the coded path) and that no conv
     prepared its weights during the frame (update() did);
  4. every recorded main-path kernel call against its plain version (K1:
     the prepared weights the codec used against the dense stack built from
     the layer's parameter; K2 in both modes), timed (kernel, plain, one
     library call or call sequence doing the same work as yardstick) beside
     its roofline bound; one call of K2 and of K3 under torch.profiler,
     whose device operations (at most K2_MAX_DEVICE_OPS and
     K3_MAX_DEVICE_OPS) are listed;
  5. the two probe entry points (upcc_tpu_torch.probes) at their published
     shapes, launch counts zeroed just before; then P1 and P2 on the same
     full arrays against their plain versions, timed beside a library call
     and the bound (P2 in each of its modes, and with a conflict-free
     index);
  6. the lossless path at full width: compress(geom="coded") -> decompress
     at block 1024 and block 512; every stage's context bins equal on both
     sides, the decoded voxel set equal to the input's, K1 and K3 launched;
     stage times, bpp with the occupancy streams' share, peak memory; K3
     on one coded frame's 9 recorded calls, checked and timed as in phase
     4 without the profiler (`[k3 coded]`);
  7. compress_multi at three q's and compress_stream / decompress_stream
     at depth 2 over three frames, byte-identical to the sequential calls
     and timed beside them; refit_colors (affine + residual layer) with
     decompress(new container) equal to the returned reconstruction;
  8. ``[jax stream]``: the committed stream written by the JAX package
     (tests/fixtures/jax_stream_flagship.upcc, made by
     tests/fixtures/make_jax_stream.py) decoded by the port on the card
     and compared with the JAX decode committed beside it: counts, whether
     identical, else how many points differ and the first block that
     diverges.  Reported, not asserted (the scale indexes come from floats
     and the card uses bf16 operands); a decode that raises is reported as
     such; a missing or unreadable fixture fails the run;
  9. ``[region]``: region-candidate g_s at the widths of
     configs/ablation/abl_region5.yaml on a seeded init (no committed
     weights), the same frame at q=(0.5, 0.5), block 1024: encoder/decoder
     bit-exact, decoded count = sum of k[2], no conv preparing weights
     during the frame, launches per frame 19/3/3; every K1, K2 and K3
     call of the region decode against its plain version and timed;
     candidate counts per level, dec.synthesis ms, peak memory and one
     decode's device time by operation (torch.profiler);
 10. ``[eval]``: the evaluation driver (upcc_tpu_torch.evaluate) on the
     flagship for longdress (rebuilt from its seed) at block 1024 and
     q = (0, 0), (0.5, 0.5), (1, 1), color refit on, native PCQM at
     200,000 points, written to a temporary results directory; each row
     beside the committed results/CVPR_inverse_scaling/test.csv row of the
     same (sequence, q_g, q_a), with the differences (reported, not
     gated); the row's 23 columns, 760,000 points and synthetic=1 are
     asserted.
The last three lines are the nvidia-smi line, the kernels JSON line and
the result line {"ok": true, "device": {...}}.

K1 tolerance: the kernel and the plain version both multiply the same
bf16-rounded operands exactly and sum in f32 in different orders, so
max|kernel - plain| <= 1e-3 * max|plain| + 1e-5.
"""

import csv
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from upcc_tpu_torch import kernels
from upcc_tpu_torch.codec import bitstream
from upcc_tpu_torch.codec.codec import CODEC_MAX_BATCH, Codec
from upcc_tpu_torch.data.synthetic import surface_cloud
from upcc_tpu_torch.eval.metrics import pc_metrics
from upcc_tpu_torch.models.layers import _TapConv
from upcc_tpu_torch.models.unified import UnifiedModel
from upcc_tpu_torch.ops import coords as C
from upcc_tpu_torch.ops import family as F
from upcc_tpu_torch.ops import sparse
from upcc_tpu_torch.ops.probe_kernels import (WindowPlan, tile_tapconv,
                                              tile_tapconv_plain,
                                              window_gather_sum,
                                              window_gather_sum_plain,
                                              window_plan)
from upcc_tpu_torch.ops.sparse import SparseTensor, compact, compact_plain
from upcc_tpu_torch.ops.topk import (topk_mask, topk_mask_plain, topk_plan,
                                     topk_smem)
from upcc_tpu_torch.probes import (PEAK_BF16, PEAK_BYTES, PEAK_TF32,
                                   micro_gather, window_gather)
from upcc_tpu_torch.profile_codec import _device_us
from upcc_tpu_torch.weights import (ABL_REGION5_CONFIG, FLAGSHIP_CONFIG,
                                    load_weights)

HERE = os.path.dirname(os.path.abspath(__file__))
EXPERIMENT = os.path.join(HERE, "results", "CVPR_inverse_scaling")
WEIGHTS = os.path.join(EXPERIMENT, "weights_bf16.msgpack")
JAX_STREAM = os.path.join(HERE, "tests", "fixtures",
                          "jax_stream_flagship.upcc")
JAX_DECODED = os.path.join(HERE, "tests", "fixtures",
                           "jax_stream_flagship_decoded.npy")
REPLACES = {
    "tap_gemm": ("upcc_tpu_torch/csrc/tap_gemm.cu",
                 "upcc_tpu/ops/family.py:610"),
    "topk_mask": ("upcc_tpu_torch/csrc/topk.cu", "upcc_tpu/ops/topk.py:68"),
    "compact": ("upcc_tpu_torch/csrc/compact.cu",
                "upcc_tpu/ops/sparse.py:81"),
    "tile_tapconv": ("upcc_tpu_torch/csrc/tile_tapconv.cu",
                     "scripts/micro_gather.py:80"),
    "window_gather_sum": ("upcc_tpu_torch/csrc/window_gather.cu",
                          "scripts/prof_pallas_gather.py:37"),
}


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, reps):
    """Mean ms per call over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, flops, peak=PEAK_BF16):
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def device_ops(fn):
    """The device operations (kernels, memsets, copies) of one call of
    ``fn`` as torch.profiler sees them, after one warm-up call:
    [(name, start us, duration us)] in start order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(((e.name, e.time_range.start, e.time_range.elapsed_us())
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda op: op[1])


def print_ops(tag, ops):
    """One line per device operation: its time and the gap before it."""
    t0 = ops[0][1] if ops else 0
    end = t0
    for i, (name, start, dur) in enumerate(ops):
        print(f"[{tag}] op {i}: start +{start - t0:.1f} us, {dur:.1f} us, "
              f"gap {max(0.0, start - end):.1f} us: {name[:70]}", flush=True)
        end = max(end, start + dur)
    busy = sum(op[2] for op in ops)
    print(f"[{tag}] {len(ops)} device ops, busy {busy:.1f} us over a span of "
          f"{end - t0:.1f} us", flush=True)


# -- phase 2: kernels on edge-case inputs ------------------------------------

def check_tap_gemm(gen):
    """K1 through its prepared path (block list from the tap tables)
    against the dense plain version on the dense stack, per call shape."""
    dev = "cuda"
    bf = torch.bfloat16

    def rw(taps, cin, cout):
        return torch.randn((taps, cin, cout), generator=gen, device=dev) \
            * (1.0 / (taps * cin)) ** 0.5

    def inputs(rows, n_src, k_in, p_ok=0.8):
        idx = torch.randint(0, n_src + 64, (rows, 27), generator=gen,
                            device=dev, dtype=torch.int32)  # some clipped
        ok = torch.rand((rows, 27), generator=gen, device=dev) < p_ok
        ok[: rows // 16] = False  # rows that read nothing
        flat = torch.randn((n_src, k_in), generator=gen, device=dev).to(bf)
        return flat, idx, ok

    def compare(name, flat, idx, ok, plan, dense):
        got = F.tap_gemm(flat, idx, ok, plan)
        ref = F.tap_gemm_plain(flat, idx, ok, dense)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tol = 1e-3 * float(ref.abs().max()) + 1e-5
        print(f"[k1] {name}: rows={idx.shape[0]} K_in={dense.shape[1]} "
              f"K_out={dense.shape[2]} BN={plan.bn} "
              f"listed_blocks={plan.n_blocks} "
              f"max_abs_err={err:.3e} tol={tol:.3e}", flush=True)
        assert err <= tol, f"tap_gemm {name} disagrees with its plain version"
        return got

    def case(name, rows, n_src, kind, ks, cin, cout, edit=None):
        w = rw(ks ** 3, cin, cout)
        plan = F.prepare_taps(w, kind, ks, bf)
        dense = F._dense_taps(w, kind, ks).to(bf)
        flat, idx, ok = inputs(rows, n_src, dense.shape[1])
        if edit is not None:
            edit(idx, ok)
        compare(f"{kind} k{ks} {name}", flat, idx, ok, plan, dense)
        return flat, idx, ok, plan, dense

    case("1024->512", 3000, 2500, "conv", 3, 128, 64)
    case("1024->1024", 2048, 2048, "conv", 5, 128, 128)
    case("512->8 (K_out 8)", 1500, 1200, "conv", 3, 64, 1)
    case("1536->2048 (hs3)", 1024, 4096, "conv", 3, 192, 256)
    case("1536->1536 (C 192)", 777, 900, "conv", 3, 192, 192)
    case("1024->128", 2000, 2000, "down", 5, 128, 128)
    case("1536->192 (C 192), rows < tile", 50, 900, "down", 3, 192, 192)
    case("128->1024", 4100, 4000, "transpose", 5, 128, 128)
    case("256->1024 (cin 4)", 1000, 1000, "grand_down", 5, 4, 128)
    case("1024->2048 (cout 32)", 1000, 1000, "grand_transpose", 5, 128, 32)
    case("2048->1024 (cout 16)", 1001, 1000, "grand_conv", 3, 32, 16)
    case("1024->64 (cout 1)", 1000, 1000, "grand_conv", 3, 16, 1)

    def unread_taps(idx, ok):
        ok[:, 20:] = False       # taps nobody reads
        ok[:256, 3:11] = False   # whole tiles that skip taps 3..10
        ok[300:310, 5] = True
    case("tiles with unread taps", 1000, 800, "conv", 3, 128, 64,
         edit=unread_taps)

    def nothing_read(idx, ok):
        ok[:] = False
    flat, idx, ok, plan, dense = case("all ok = 0", 333, 500, "conv", 3, 64,
                                      64, edit=nothing_read)
    assert not F.tap_gemm(flat, idx, ok, plan).any()

    def far_indices(idx, ok):
        idx[::3] = 2 ** 31 - 1   # far beyond n_src: clipped to the last row
    case("idx beyond n_src", 640, 100, "conv", 5, 128, 128, edit=far_indices)

    # placement invariance: the same logical rows alone and inside a larger
    # call, shifted by a non-multiple of the row tile, are bit-equal
    for kind, ks, cin, cout, rows in (("conv", 5, 128, 128, 1000),
                                      ("grand_conv", 3, 32, 16, 333),
                                      ("down", 3, 192, 192, 77)):
        w = rw(ks ** 3, cin, cout)
        plan = F.prepare_taps(w, kind, ks, bf)
        flat, idx, ok = inputs(rows, 3000, plan.k_in)
        alone = F.tap_gemm(flat, idx, ok, plan)
        _, idx2, ok2 = inputs(3 * rows + 17, 3000, plan.k_in, p_ok=0.4)
        at = rows + 5
        idx2[at:at + rows], ok2[at:at + rows] = idx, ok
        inside = F.tap_gemm(flat, idx2, ok2, plan)[at:at + rows]
        torch.cuda.synchronize()
        same = torch.equal(alone.view(torch.int32), inside.view(torch.int32))
        print(f"[k1] placement {kind} k{ks}: rows={rows} inside "
              f"{3 * rows + 17} at {at}: bit-equal={same}", flush=True)
        assert same, "tap_gemm depends on where a row sits in its call"


def topk_modes(keys, k):
    """K2's plan for these inputs and, where that one is resident, the
    streaming plan of the same grid: both modes on the same inputs."""
    n, maxb = keys.shape[0], k.shape[0]
    plan = topk_plan(n, maxb, *kernels.device_limits(keys.device))
    plans = {("resident" if plan.resident else "streaming"): plan}
    if plan.resident:
        plans["streaming"] = plan._replace(
            resident=False, smem=topk_smem(maxb, plan.per_block, False))
    return plans


def check_topk(gen):
    dev = "cuda"

    def check(name, keys, logits, kt):
        ref = topk_mask_plain(keys, logits, kt)
        st = SparseTensor(keys, logits[:, None])
        for mode, plan in topk_modes(keys, kt).items():
            got = topk_mask(st, logits, kt, plan=plan)
            torch.cuda.synchronize()
            nbad = int((got != ref).sum())
            print(f"[k2] {name}: n={keys.shape[0]} batches={kt.shape[0]} "
                  f"{mode} grid={plan.grid} per_block={plan.per_block} "
                  f"kept={int(got.sum())} mismatches={nbad}", flush=True)
            assert nbad == 0, \
                f"topk_mask {name} ({mode}) differs from its plain version"

    def case(name, counts, k, quant):
        keys = []
        for b, n in enumerate(counts):
            m = torch.randperm(1 << 20, generator=gen, device=dev)[:n]
            keys.append(torch.sort(m.to(torch.int64)).values
                        | (b << C.BATCH_SHIFT))
        keys = torch.cat(keys + [torch.full((777,), C.SENTINEL,
                                            dtype=torch.int64, device=dev)])
        logits = torch.randn(keys.shape[0], generator=gen, device=dev)
        logits = torch.round(logits * quant) / quant  # many ties
        logits[::97] = -0.0
        logits[1::97] = 0.0
        check(name, keys, logits,
              torch.tensor(k, dtype=torch.int32, device=dev))

    counts = torch.randint(1, 40000, (63,), generator=gen,
                           device=dev).tolist()
    k = [int(c * f) for c, f in zip(counts, torch.rand(
        63, generator=gen, device=dev).tolist())]
    k[0], k[1], k[2], k[3] = 0, counts[1], counts[2] + 5, -3
    case("63 batches, k=0, k=count, k>count, k<0", counts, k + [0], 4.0)
    case("one batch, coarse ties", [300000], [123457], 1.0)
    case("tie-heavy 8 batches", [5000] * 8, [2500] * 8, 0.5)
    # the main path's form: one populated batch of 64, the rest k = 0
    case("main-path form, maxb 64", [1 << 20], [300001] + [0] * 63, 2.0)
    # more batches than keys can name (the last ones stay empty): the
    # per-batch arrays' alignment in shared memory
    case("maxb 1023, 64 populated", [2000] * 64, [1000] * 64 + [5] * 959,
         2.0)
    # the buffers K2 keeps per stream, after a call with fewer batches and
    # many blocks: coarse positive ties put the thresholds' low bytes in
    # bin 0, where stray counts from an earlier call would move them
    case("maxb 1, coarse ties", [600000], [250000], 2.0)
    case("maxb 2 after maxb 1", [300000, 300000], [120000, 150000], 2.0)
    case("maxb 8 after maxb 2", [70000] * 8, [30000] * 8, 2.0)
    # beyond what the grid can hold in shared memory: streaming by shape
    n = 40_000_003
    keys = torch.arange(n, device=dev, dtype=torch.int64) * 5
    keys[-1001:] = C.SENTINEL
    logits = torch.round(torch.randn(n, generator=gen, device=dev) * 2) / 2
    logits[::101] = -0.0
    check("40M candidates, one batch, tie-heavy", keys, logits,
          torch.tensor([n // 3], dtype=torch.int32, device=dev))
    del keys, logits


def check_compact(gen):
    """K3 bit-equal to its plain version on edge cases: empty input and
    output, none and all kept, m past n, 9 payloads (two launches), 1-, 3-
    and 1200-byte rows, payloads at odd byte offsets (narrower units), and
    a run of calls on one stream whose n and payload counts grow and
    shrink (stale status words would show)."""
    dev = "cuda"

    def keys_of(n):
        keys = torch.sort(torch.randint(0, 1 << 50, (n,), generator=gen,
                                        device=dev)).values
        keys[n - n // 10:] = C.SENTINEL
        return keys

    def payload(n, kind):
        if kind == "f32x128":
            a = torch.randn((n, 128), generator=gen, device=dev)
            a[::7] = -0.0
            return a
        if kind == "bf16x32":
            return torch.randn((n, 32), generator=gen, device=dev).to(
                torch.bfloat16)
        if kind == "i32":
            return torch.randint(0, 1 << 30, (n,), generator=gen, device=dev,
                                 dtype=torch.int32)
        if kind == "boolx3":
            return torch.rand((n, 3), generator=gen, device=dev) < 0.5
        if kind == "u8":
            return torch.randint(0, 256, (n,), generator=gen, device=dev,
                                 dtype=torch.uint8)
        if kind == "f32x300":  # 1200-byte rows: 75 units over 32 lanes
            return torch.randn((n, 300), generator=gen, device=dev)
        if kind == "i64x2":
            return torch.randint(-(1 << 40), 1 << 40, (n, 2), generator=gen,
                                 device=dev)
        # views at byte offsets 1, 2 and 4: 1-, 1- and 4-byte units
        width, offset, dtype = {"u8x5@1": (5, 1, torch.uint8),
                                "bf16x8@2": (8, 2, torch.bfloat16),
                                "f32x4@4": (4, 4, torch.float32)}[kind]
        size = torch.tensor([], dtype=dtype).element_size()
        raw = torch.randint(0, 256, (offset + n * width * size,),
                            generator=gen, device=dev, dtype=torch.uint8)
        view = raw[offset:].view(dtype).view(n, width)
        assert view.data_ptr() % 16 == offset and view.is_contiguous()
        return view

    def bits(t):
        return t.flatten().view(torch.uint8)

    def check(name, n, m, p, kinds):
        keys = keys_of(n)
        keep = torch.rand(n, generator=gen, device=dev) < p
        arrays = [payload(n, k) for k in kinds]
        got = compact(keys, keep, *arrays, out_capacity=m)
        ref = compact_plain(keys, keep, *arrays, out_capacity=m)
        torch.cuda.synchronize()
        same = len(got) == len(ref) and all(
            a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(bits(a), bits(b)) for a, b in zip(got, ref))
        print(f"[k3] {name}: n={n} m={m} kept={int(keep.sum())} "
              f"payloads={len(kinds)} rows [{payload_rows(keys, arrays)}] "
              f"bit-equal={same}", flush=True)
        assert same, f"compact ({name}) differs from its plain version"

    four = ["f32x128", "bf16x32", "i32", "boolx3"]
    check("random", 1 << 21, 700000, 0.5, four)
    check("random, small m", 100003, 2048, 0.9, four)
    check("random, m > n", 5000, 6000, 0.3, four)
    check("n = 0", 0, 1000, 0.5, four)
    check("m = 0", 10000, 0, 0.5, four)
    check("none kept", 300000, 200000, 0.0, four)
    check("all kept, m < n", 300000, 123457, 1.0, four)
    check("all kept, m > n", 300001, 400000, 1.0, four)
    check("keys only", 77777, 50000, 0.6, [])
    check("9 payloads: two launches", 200000, 150000, 0.7,
          four + ["u8", "f32x300", "i64x2", "bf16x8@2", "u8x5@1"])
    check("1- and 3-byte rows, odd offsets", 123456, 100000, 0.4,
          ["u8", "boolx3", "u8x5@1", "bf16x8@2", "f32x4@4"])
    # one stream, n and payload counts growing and shrinking
    for i, (n, m, p, count) in enumerate((
            (5000, 5000, 0.5, 1), (3_000_000, 1_000_000, 0.4, 9),
            (4096, 2000, 0.9, 0), (1 << 21, 600000, 0.3, 3),
            (1000, 3000, 0.5, 2), (4_194_304, 1_048_576, 0.26, 1))):
        check(f"sequence {i}", n, m, p,
              (four + ["u8", "f32x300", "i64x2", "bf16x8@2", "u8x5@1"])
              [:count])


# P1 tolerances, as a share of max|plain|.  bf16 operands: kernel and plain
# version multiply the same values exactly and sum in f32 in another order.
# f32 operands: the kernel rounds both operands to TF32 (relative 2^-11
# each), the plain version multiplies in full f32; over a sum of 27 * K_in
# products of random sign that is a few 1e-4 of the largest output.
P1_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-3}
# K2 runs as one cooperative kernel, K3 as one single-pass kernel (at most
# one memset of scratch beside either is allowed); None lifts the check
# (to profile an older kernel with the same script)
K2_MAX_DEVICE_OPS = 2
K3_MAX_DEVICE_OPS = 2


def check_tile_tapconv(gen):
    dev = "cuda"
    # (tiles, tile, K_in, K_out): 3 tiles of 2048 rows (48 row blocks, no
    # multiple of the card's 132 SMs), tiles of 96 rows that straddle the
    # 128-row blocks and leave a ragged last block, and narrow odd widths
    for tiles, tile, k_in, k_out in ((3, 2048, 128, 128), (7, 96, 128, 128),
                                     (5, 200, 72, 40)):
        rows = tiles * tile
        idx = torch.randint(0, tile, (rows, 27), generator=gen, device=dev,
                            dtype=torch.int32)
        idx[::5, 3] = idx[::5, 4]  # repeated source rows
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((rows, k_in), generator=gen, device=dev).to(dtype)
            w = torch.randn((27, k_in, k_out), generator=gen,
                            device=dev).to(dtype)
            got = tile_tapconv(x, idx, w, tile)
            ref = tile_tapconv_plain(x, idx, w, tile)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            tol = P1_TOL[dtype] * float(ref.abs().max()) + 1e-5
            print(f"[p1] tiles={tiles} tile={tile} K_in={k_in} K_out={k_out} "
                  f"{str(dtype).split('.')[-1]}: max_abs_err={err:.3e} "
                  f"tol={tol:.3e}", flush=True)
            assert err <= tol, "tile_tapconv disagrees with its plain version"


def window_modes(win):
    """P2's plan for these windows, 4-float slabs where the plan's are 8
    wide and the row splits into them, and the streaming plan."""
    s_rows, k = win.shape[1], win.shape[2]
    plan = window_plan(s_rows, k, kernels.device_limits(win.device)[1])
    plans = {(f"slab W={plan.width} last={plan.last}" if plan.width
              else "streaming"): plan}
    if plan.width == 8 and k % 8 == 0:
        plans["slab W=4 last=4"] = WindowPlan(4, k // 4, 4, s_rows * 16)
    plans["streaming"] = WindowPlan(0, 0, 0, 0)
    return plans


def check_window_gather(gen):
    dev = "cuda"
    # the probe's shape; narrow and ragged widths (K % 8 == 4: a 4-wide
    # last slab); a window only 4-wide slabs fit; one no slab fits
    for tiles, s_rows, k in ((1, 4096, 512), (3, 1000, 64), (2, 37, 12),
                             (2, 4096, 12), (2, 4096, 64), (1, 10000, 64),
                             (1, 20000, 64)):
        win = torch.randn((tiles, s_rows, k), generator=gen, device=dev)
        win[:, ::11] = -0.0
        idx = torch.randint(0, s_rows, (tiles, 27, s_rows), generator=gen,
                            device=dev, dtype=torch.int32)
        idx[:, 5] = idx[:, 6]  # repeated indices
        idx[:, :, ::7] = 0
        idx[:, 3, ::13] = -5          # clipped to the first row
        idx[:, 4, ::13] = s_rows + 9  # clipped to the last
        ref = window_gather_sum_plain(win, idx)
        for mode, plan in window_modes(win).items():
            got = window_gather_sum(win, idx, plan=plan)
            torch.cuda.synchronize()
            same = torch.equal(got.view(torch.int32), ref.view(torch.int32))
            print(f"[p2] tiles={tiles} window={s_rows} K={k} {mode}: "
                  f"bit-equal={same} (tolerance: exact)", flush=True)
            assert same, f"window_gather_sum ({mode}) differs from its " \
                "plain version"


def bank_wavefronts(idx, width):
    """Mean shared-memory wavefronts per quarter warp of P2's slab-mode
    gathers with these indices, counted from the indices (a model of the
    banks, not a hardware counter): at width 8 a quarter warp (8 lanes x
    16 bytes) reads 4 output rows' source rows, 32 bytes each, so source
    row r lies in bank group r % 4; distinct rows of one group serialize.
    At width 4 a quarter warp reads 8 rows of 16 bytes, group r % 8."""
    per = 4 if width == 8 else 8
    rows = idx.clamp(0, idx.shape[-1] - 1).long().reshape(-1, per)
    rows = rows.sort(1).values
    new = torch.ones_like(rows, dtype=torch.float32)
    new[:, 1:] = (rows[:, 1:] != rows[:, :-1]).float()
    groups = torch.zeros((rows.shape[0], per), device=rows.device)
    groups.scatter_add_(1, rows % per, new)
    return float(groups.amax(1).mean())


# -- phase 4: recorded main-path calls ---------------------------------------

def measure_recorded(record, layer_of, tag="main", profile=True):
    """Every recorded call against its plain version, timed beside the
    plain version, the library yardstick and the bound.  layer_of:
    id(prepared plan) -> (layer, call shape) it was made for.  With
    ``profile``, one call of K2 and each K3 call under torch.profiler
    (device operations gated)."""
    rows = {}

    def add(name, err, t_k, t_p, t_l, nbytes, flops):
        r = rows.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                   "plain_ms": 0.0, "library_ms": 0.0,
                                   "bound_ms": 0.0, "t_bytes": 0.0,
                                   "t_ops": 0.0})
        b, _ = bound_ms(nbytes, flops)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += t_k
        r["plain_ms"] += t_p
        r["library_ms"] += t_l
        r["bound_ms"] += b
        r["t_bytes"] += nbytes / PEAK_BYTES * 1e3
        r["t_ops"] += flops / PEAK_BF16 * 1e3

    for flat, idx, ok, plan in record.get("tap_gemm", []):
        # the layer's dense stack from its parameter, not via the plan
        layer, kind = layer_of[id(plan)]
        w = F._dense_taps(layer.w.detach(), kind, layer.kernel_size) \
            .to(torch.bfloat16)
        got = F.tap_gemm(flat, idx, ok, plan)
        ref = F.tap_gemm_plain(flat, idx, ok, w)
        err = float((got - ref).abs().max())
        tol = 1e-3 * float(ref.abs().max()) + 1e-5
        assert err <= tol, "tap_gemm disagrees with its plain version on " \
            f"a {tag}-path call"
        del got, ref
        t_k = cuda_time(lambda: F.tap_gemm(flat, idx, ok, plan), 5)
        t_p = cuda_time(lambda: F.tap_gemm_plain(flat, idx, ok, w), 2)
        rows_, taps = idx.shape
        stack = (flat[idx.clamp(max=flat.shape[0] - 1).long()]
                 * ok[..., None].to(flat.dtype)).reshape(rows_, -1)
        w2 = w.reshape(-1, w.shape[-1])
        t_l = cuda_time(lambda: torch.matmul(stack, w2), 3)
        del stack
        nnz = (w != 0).reshape(taps, -1).sum(1).double()
        flops = float(2 * (ok.sum(0).double() * nnz).sum())
        nbytes = (flat.numel() * 2 + w.numel() * 2 + idx.numel() * 4
                  + ok.numel() + rows_ * w.shape[-1] * 4)
        print(f"[k1 {tag}] rows={rows_} K_in={w.shape[1]} K_out={w.shape[2]} "
              f"BN={plan.bn} listed_blocks={plan.n_blocks} "
              f"err={err:.3e} kernel={t_k:.3f} ms plain={t_p:.3f} ms "
              f"matmul={t_l:.3f} ms bound={bound_ms(nbytes, flops)[0]:.4f} ms",
              flush=True)
        add("tap_gemm", err, t_k, t_p, t_l, nbytes, flops)

    for keys, logits, k in record.get("topk_mask", []):
        st = SparseTensor(keys, logits[:, None])
        ref = topk_mask_plain(keys, logits, k)
        modes = topk_modes(keys, k)
        t_modes = {}
        for mode, plan in modes.items():
            got = topk_mask(st, logits, k, plan=plan)
            assert torch.equal(got, ref), \
                f"topk_mask ({mode}) differs on a {tag}-path call"
            t_modes[mode] = cuda_time(
                lambda: topk_mask(st, logits, k, plan=plan), 10)
        t_k = cuda_time(lambda: topk_mask(st, logits, k), 10)
        t_p = cuda_time(lambda: topk_mask_plain(keys, logits, k), 3)
        b = C.key_batch(keys).long().clamp(0, k.shape[0] - 1)
        b = torch.where(C.key_is_valid(keys), b, k.shape[0])
        counts = torch.bincount(b, minlength=k.shape[0] + 1)[:k.shape[0]]
        big = int(torch.argmax(counts))
        seg = logits[b == big].contiguous()
        kk = int(min(max(int(k[big]), 1), seg.shape[0]))
        t_l = cuda_time(lambda: torch.topk(seg, kk), 10)
        n = keys.shape[0]
        nbytes = n * (8 + 4 + 1) + k.numel() * 4
        ops = device_ops(lambda: topk_mask(st, logits, k)) if profile \
            else None
        if profile:
            print_ops("k2 ops", ops)
        plan = next(iter(modes.values()))
        print(f"[k2 {tag}] n={n} maxb={k.shape[0]} kept={int(ref.sum())} "
              f"kernel={t_k:.3f} ms ("
              + ", ".join(f"{m} {t:.3f}" for m, t in t_modes.items())
              + f"; grid={plan.grid} per_block={plan.per_block}) "
              f"plain={t_p:.3f} ms torch.topk={t_l:.3f} ms "
              f"bound={bound_ms(nbytes, 0)[0]:.4f} ms"
              + (f" device ops per call={len(ops)}" if profile else ""),
              flush=True)
        if profile and K2_MAX_DEVICE_OPS is not None:
            assert 0 < len(ops) <= K2_MAX_DEVICE_OPS, \
                f"topk_mask ran {len(ops)} device operations in one call"
        add("topk_mask", 0.0, t_k, t_p, t_l, nbytes, 0)

    for t_k, t_p, t_l, nbytes in measure_compact(record.get("compact", []),
                                                 tag, profile):
        add("compact", 0.0, t_k, t_p, t_l, nbytes, 0)
    return rows


def payload_rows(keys, arrays):
    """Each payload's row bytes and, where the package plans K3, the bytes
    a lane moves at once and the lanes that move one row."""
    rows = [int(np.prod(a.shape[1:])) * a.element_size() for a in arrays]
    plan_of = getattr(sparse, "compact_plan", None)
    if plan_of is None:
        return ", ".join(f"{r} B" for r in rows)
    plan = plan_of(keys.shape[0], keys.shape[0], tuple(
        (r, sparse.alignment(a)) for r, a in zip(rows, arrays)),
        *kernels.device_limits(keys.device))
    return ", ".join(f"{r} B x{u} ({lanes} lanes)" for r, u, lanes in
                     zip(rows, plan.units, plan.lanes))


def measure_compact(calls, tag, profile=True):
    """K3 on recorded calls: bit-equal to its plain version, timed beside
    the plain version, the library doing the same work and the bound; with
    ``profile``, each call's device operations under torch.profiler (at
    most K3_MAX_DEVICE_OPS).  Yields (kernel, plain, library ms, bytes).
    The coded frame's calls are not profiled: late in a run, after the
    probes, torch.profiler on the H100 host has delivered windows without
    any device record (twice in five runs), which would fail the gate
    for want of a measurement."""
    tot = np.zeros(4)
    for keys, keep, arrays, m in calls:
        got = compact(keys, keep, *arrays, out_capacity=m)
        ref = compact_plain(keys, keep, *arrays, out_capacity=m)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), \
            f"compact differs on a recorded call ({tag})"
        del got, ref
        t_k = cuda_time(lambda: compact(keys, keep, *arrays,
                                        out_capacity=m), 10)
        t_p = cuda_time(lambda: compact_plain(keys, keep, *arrays,
                                              out_capacity=m), 3)
        # the same work in library calls: keys and every payload, kept
        # rows only, truncated at m
        t_l = cuda_time(lambda: [a[keep][:m] for a in (keys, *arrays)], 10)
        n = keys.shape[0]
        row = sum(a[0].numel() * a.element_size() for a in arrays) if n else 0
        # the function needs keep, the kept rows (up to m) and the m outputs
        kept = min(int(keep.sum()), m)
        nbytes = n + kept * (8 + row) + m * (8 + row)
        b = bound_ms(nbytes, 0)[0]
        line = (f"[k3 {tag}] n={n} m={m} kept={kept} payloads={len(arrays)} "
                f"rows [{payload_rows(keys, arrays)}] kernel={t_k:.3f} ms "
                f"plain={t_p:.3f} ms a[keep][:m] for keys and payloads="
                f"{t_l:.3f} ms bound={b:.4f} ms")
        if profile:
            ops = device_ops(lambda: compact(keys, keep, *arrays,
                                             out_capacity=m))
            print_ops(f"k3 ops {tag}", ops)
            line += (f" device ops per call={len(ops)} "
                     f"({sum(op[2] for op in ops):.1f} us busy)")
            if K3_MAX_DEVICE_OPS is not None:
                assert 0 < len(ops) <= K3_MAX_DEVICE_OPS, \
                    f"compact ran {len(ops)} device operations in one call"
        print(line, flush=True)
        tot += (t_k, t_p, t_l, b)
        yield t_k, t_p, t_l, nbytes
    print(f"[k3 {tag}] {len(calls)} calls: kernel={tot[0]:.3f} ms "
          f"plain={tot[1]:.3f} ms library={tot[2]:.3f} ms "
          f"bound={tot[3]:.4f} ms", flush=True)


CODEC_KERNELS = ("tap_gemm", "topk_mask", "compact")
# launches per frame (encode + decode), top-k and coded geometry
TOPK_LAUNCHES = {"tap_gemm": 19, "topk_mask": 3, "compact": 3}
CODED_LAUNCHES = {"tap_gemm": 61, "topk_mask": 0, "compact": 9}


def codec_launches():
    return {name: kernels.LAUNCHES[name] for name in CODEC_KERNELS}


# -- phase 5: the probe entry points -------------------------------------------

def run_probes():
    """Drive both probe entry points (counts zeroed just before), then
    hold P1 and P2 against their plain versions on the full arrays."""
    kernels.reset_launches()
    micro_gather.main([])
    window_gather.main([])
    launches = dict(kernels.LAUNCHES)
    for name in ("tile_tapconv", "window_gather_sum"):
        assert launches[name] > 0, f"the probes did not launch {name}"
    rows = {}

    r = rows["tile_tapconv"] = {"max_abs_err": 0.0, "ms": 0.0,
                                "plain_ms": 0.0, "library_ms": 0.0,
                                "bound_ms": 0.0, "bound_by": "operations"}
    n_rows, tile = 1 << 19, 2048
    for dtype in (torch.bfloat16, torch.float32):
        x, idx, w = micro_gather.tapconv_inputs(n_rows, tile, dtype, "cuda")
        got = tile_tapconv(x, idx, w, tile)
        ref = tile_tapconv_plain(x, idx, w, tile)
        err = float((got - ref).abs().max())
        tol = P1_TOL[dtype] * float(ref.abs().max()) + 1e-5
        assert err <= tol, "tile_tapconv disagrees at the probe's shape"
        del got, ref
        t_k = cuda_time(lambda: tile_tapconv(x, idx, w, tile), 5)
        t_p = cuda_time(lambda: tile_tapconv_plain(x, idx, w, tile), 2)
        base = (torch.arange(n_rows, device="cuda") // tile * tile)[:, None]
        stack = x[base + idx.long()].reshape(n_rows, -1)
        w2 = w.reshape(-1, w.shape[-1])
        t_l = cuda_time(lambda: torch.matmul(stack, w2), 3)
        lib = f"matmul(pre-gathered stack, same type)={t_l:.3f} ms"
        if dtype == torch.float32:
            # the kernel rounds to TF32: the like-for-like library call is
            # the matmul with TF32 allowed (around this call only)
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                t_l32, t_l = t_l, cuda_time(lambda: torch.matmul(stack, w2), 3)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            lib = (f"matmul(pre-gathered stack, allow_tf32)={t_l:.3f} ms "
                   f"(full f32: {t_l32:.3f} ms)")
        del stack
        size = x.element_size()
        flops = 2 * n_rows * idx.shape[1] * w.shape[1] * w.shape[2]
        nbytes = (x.numel() * size + w.numel() * size + idx.numel() * 4
                  + n_rows * w.shape[2] * 4)
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32
        b, by = bound_ms(nbytes, flops, peak)
        print(f"[p1 probe] {str(dtype).split('.')[-1]} rows={n_rows} "
              f"tile={tile} err={err:.3e} tol={tol:.3e} kernel={t_k:.3f} ms "
              f"plain={t_p:.3f} ms {lib} bound={b:.4f} ms by {by}",
              flush=True)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += t_k
        r["plain_ms"] += t_p
        r["library_ms"] += t_l
        r["bound_ms"] += b
        del x, idx, w

    win, idx = window_gather.window_inputs(16, "cuda")
    ref = window_gather_sum_plain(win, idx)
    modes = window_modes(win)
    t_modes = {}
    for mode, plan in modes.items():
        got = window_gather_sum(win, idx, plan=plan)
        assert torch.equal(got, ref), \
            f"window_gather_sum ({mode}) differs at the probe's shape"
        t_modes[mode] = cuda_time(
            lambda: window_gather_sum(win, idx, plan=plan), 10)
    del got, ref
    t_k = cuda_time(lambda: window_gather_sum(win, idx), 10)
    t_p = cuda_time(lambda: window_gather_sum_plain(win, idx), 3)
    il = idx.long()
    t_l = cuda_time(lambda: [win[t][il[t]].sum(0)
                             for t in range(win.shape[0])], 3)
    # the same work with every row gathering itself: the slab modes'
    # shared-memory reads without bank conflicts
    ident = torch.arange(win.shape[1], device="cuda", dtype=torch.int32
                         ).expand(idx.shape).contiguous()
    t_id = {m: cuda_time(lambda: window_gather_sum(win, ident, plan=plan), 10)
            for m, plan in modes.items() if plan.width}
    nbytes = 2 * win.numel() * 4 + idx.numel() * 4
    b, by = bound_ms(nbytes, 0)
    payload = idx.numel() * win.shape[2] * 4
    print(f"[p2 probe] tiles={win.shape[0]} window={win.shape[1]} "
          f"K={win.shape[2]} equal=True kernel={t_k:.3f} ms "
          f"({payload / t_k / 1e9:.2f} TB/s gathered payload, "
          f"{nbytes / t_k / 1e9:.2f} TB/s of the {nbytes / 1e6:.1f} MB the "
          f"function must move) by mode: "
          + ", ".join(f"{m} {t:.3f} ms ({payload / t / 1e9:.2f} TB/s)"
                      for m, t in t_modes.items())
          + f"; plain={t_p:.3f} ms win[t][idx[t]].sum(0)={t_l:.3f} ms "
          f"bound={b:.4f} ms by {by}", flush=True)
    # device-memory bytes of one slab-mode call: each window read once
    # (its slabs), the sums written once; the indices once per slab, from
    # L2 after the first
    for mode, plan in modes.items():
        if not plan.width:
            continue
        idx_l2 = idx.numel() * 4 * plan.slabs
        print(f"[p2 probe] {mode}: {plan.slabs} slab blocks per tile of "
              f"{plan.smem / 1024:.0f} KB shared memory; device memory "
              f"moves {nbytes / 1e6:.1f} MB a call, the blocks read "
              f"{idx_l2 / 1e6:.1f} MB of indices from L2; "
              f"{bank_wavefronts(idx, plan.width):.3f} shared-memory "
              f"wavefronts per quarter warp of gathers with these indices "
              f"(1 = no bank conflict); with a conflict-free index (every "
              f"row gathers itself) {t_id[mode]:.3f} ms "
              f"({payload / t_id[mode] / 1e9:.2f} TB/s)", flush=True)
    rows["window_gather_sum"] = {"max_abs_err": 0.0, "ms": t_k,
                                 "plain_ms": t_p, "library_ms": t_l,
                                 "bound_ms": b, "bound_by": by}
    return rows, launches


# -- phase 6: the lossless (coded-occupancy) path ------------------------------

def voxel_keys(xyz):
    """Sorted unique scalar keys of integer coordinates."""
    v = np.asarray(xyz).astype(np.int64) + (1 << 19)
    return np.unique((v[:, 0] << 42) | (v[:, 1] << 21) | v[:, 2])


class RecordOnly(dict):
    """A ``kernels.RECORD`` that keeps the inputs of the named kernels
    only."""

    def __init__(self, *names):
        super().__init__()
        self.names = names

    def setdefault(self, name, default=None):
        return super().setdefault(name, default) if name in self.names \
            else default


def run_coded(codec, frame, q, block_size, measure_k3=False):
    """compress(geom="coded") -> decompress: bins equal on both sides at
    every stage, geometry exactly lossless, K1 and K3 launched; with
    measure_k3, K3 on one frame's recorded calls (``[k3 coded]``)."""
    codec.debug, codec.debug_info, codec.debug_bins = True, [], []
    data = codec.compress(frame, q, block_size=block_size, geom="coded")
    rec = codec.decompress(data)
    codec.debug = False
    enc = [d for d in codec.debug_bins if d["side"] == "enc"]
    dec = [d for d in codec.debug_bins if d["side"] == "dec"]
    assert len(enc) == len(dec) and len(enc) % 3 == 0 and enc
    for e, d in zip(enc, dec):
        assert e["stage"] == d["stage"]
        assert np.array_equal(e["bins"], d["bins"]), \
            f"encoder/decoder context bins differ at stage {e['stage']}"
    ncand = sum(len(e["bins"]) for e in enc)
    codec.debug_info, codec.debug_bins = [], []

    src = voxel_keys(frame[:, :3])
    got = voxel_keys(rec[:, :3])
    assert rec.shape[0] == len(got), "decoded cloud holds duplicate voxels"
    assert np.array_equal(src, got), (
        f"coded geometry is not lossless: {len(src)} input voxels, "
        f"{len(got)} decoded")
    assert np.isfinite(rec).all() and rec.shape[1] == 6

    # timed run, launch counts zeroed just before
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.time()
    data2 = codec.compress(frame, q, block_size=block_size, geom="coded")
    t_enc = time.time() - t0
    t0 = time.time()
    rec2 = codec.decompress(data2)
    torch.cuda.synchronize()
    t_dec = time.time() - t0
    launches = codec_launches()
    peak = torch.cuda.max_memory_allocated()
    assert data2 == data and np.array_equal(rec2, rec), \
        "the coded path is not deterministic"
    for name in ("tap_gemm", "compact"):
        assert launches[name] > 0, f"{name} was not launched on the coded path"
    assert launches == CODED_LAUNCHES, (launches, CODED_LAUNCHES)
    if measure_k3:
        # one more frame recording K3's inputs (only K3's: K1's would hold
        # every conv input of the frame)
        kernels.RECORD = RecordOnly("compact")
        codec.decompress(codec.compress(frame, q, block_size=block_size,
                                        geom="coded"))
        calls, kernels.RECORD = kernels.RECORD.get("compact", []), None
        assert len(calls) == CODED_LAUNCHES["compact"], len(calls)
        for _ in measure_compact(calls, "coded", profile=False):
            pass
        del calls
    blocks, _ = bitstream.read_container(data)
    occ = sum(len(o) for b in blocks for o in b["occ_bytes"])
    met = pc_metrics(frame, rec, 1023, with_d2=False)
    print(f"[coded] block {block_size}: blocks={len(blocks)} stage records="
          f"{len(enc)} candidates={ncand} bins equal on both sides; voxels="
          f"{len(src)} decoded={rec.shape[0]} key sets equal; encode="
          f"{t_enc:.3f} s decode={t_dec:.3f} s bpp="
          f"{len(data) * 8 / len(frame):.4f} (occupancy streams "
          f"{occ * 8 / len(frame):.4f} bpp, {occ / len(data):.1%}) "
          f"Y_PSNR={met['sym_y_psnr']:.3f} dB max_memory_allocated="
          f"{peak / 2**30:.2f} GiB launches={launches}", flush=True)
    return data


def coded_stage_times(codec, frame, q):
    codec.profile, codec.stage_times = True, {}
    try:
        codec.decompress(codec.compress(frame, q, block_size=1024,
                                        geom="coded"))
    finally:
        codec.profile = False
    print("[coded] stage ms (block 1024, synchronized per stage): "
          + " ".join(f"{k}={v * 1e3:.1f}"
                     for k, v in codec.stage_times.items()), flush=True)


# -- phase 7: simulcast, streaming, color refit --------------------------------

def run_serving(codec, frame, data_topk):
    qs = [(0.2, 0.2), (0.5, 0.5), (1.0, 1.0)]
    t0 = time.time()
    singles = [codec.compress(frame, q, block_size=1024) for q in qs]
    t_single = time.time() - t0
    t0 = time.time()
    multi = codec.compress_multi(frame, qs, block_size=1024)
    t_multi = time.time() - t0
    assert multi == singles, "compress_multi differs from separate calls"
    print(f"[multi] 3 q's byte-identical to 3 compress calls: "
          f"compress_multi={t_multi:.3f} s, 3 x compress={t_single:.3f} s, "
          f"bytes={[len(d) for d in multi]}", flush=True)

    n = len(frame)
    frames = [frame, frame[:2 * n // 3], frame[n // 4:]]
    q = (0.5, 0.5)
    t0 = time.time()
    seq = [codec.compress(f, q, block_size=512) for f in frames]
    t_seq = time.time() - t0
    t0 = time.time()
    streamed = list(codec.compress_stream(frames, q, block_size=512, depth=2))
    t_str = time.time() - t0
    assert streamed == seq, "compress_stream differs from sequential calls"
    t0 = time.time()
    seq_rec = [codec.decompress(d) for d in seq]
    t_dseq = time.time() - t0
    t0 = time.time()
    str_rec = list(codec.decompress_stream(seq, depth=2))
    t_dstr = time.time() - t0
    assert all(np.array_equal(a, b) for a, b in zip(seq_rec, str_rec)), \
        "decompress_stream differs from sequential calls"
    print(f"[stream] 3 frames, block 512, depth 2, byte-identical: "
          f"compress_stream={t_str:.3f} s vs sequential={t_seq:.3f} s; "
          f"decompress_stream={t_dstr:.3f} s vs sequential={t_dseq:.3f} s",
          flush=True)
    del seq_rec, str_rec

    rec = codec.decompress(data_topk)
    before = pc_metrics(frame, rec, 1023, with_d2=False)["sym_y_psnr"]
    t0 = time.time()
    new, fixed = codec.refit_colors(data_topk, frame, rec=rec,
                                    resid_lam=12800.0)
    t_fit = time.time() - t0
    blocks, _ = bitstream.read_container(new)
    assert blocks[0].get("color_affine") is not None \
        or blocks[0].get("color_resid") is not None, "refit signaled nothing"
    again = codec.decompress(new)
    assert np.array_equal(again, fixed), \
        "decompress(refit container) differs from the returned reconstruction"
    assert np.array_equal(again[:, :3], rec[:, :3])
    after = pc_metrics(frame, again, 1023, with_d2=False)["sym_y_psnr"]
    resid = blocks[0].get("color_resid")
    print(f"[refit] affine={'yes' if blocks[0].get('color_affine') is not None else 'no'} "
          f"residual layer={len(resid) if resid else 0} B: container "
          f"{len(data_topk)} -> {len(new)} B "
          f"({len(new) * 8 / len(frame):.4f} bpp), Y_PSNR {before:.3f} -> "
          f"{after:.3f} dB, fit {t_fit:.2f} s; decompress(new) equals the "
          f"returned reconstruction", flush=True)


# -- phase 8: a stream written by the JAX package -----------------------------

def load_jax_stream():
    """The committed JAX-written fixture: (container bytes, its blocks, the
    JAX decode as uint8 [N, 6] = xyz, rgb * 255).  Raises when a file is
    missing, the container does not parse, or the decode's shape does not
    match the container's counts."""
    with open(JAX_STREAM, "rb") as f:
        data = f.read()
    blocks, _ = bitstream.read_container(data)
    ref = np.load(JAX_DECODED)
    if ref.dtype != np.uint8 or ref.ndim != 2 or ref.shape[1] != 6 \
            or len(ref) != sum(b["k"][2] for b in blocks):
        raise ValueError(f"{JAX_DECODED}: {ref.dtype} {ref.shape} does not "
                         f"match the container's counts")
    return data, blocks, ref


def compare_decodes(rec, ref, blocks):
    """A decoded float cloud [N, 6] against the uint8 reference decode:
    counts, whether identical (same rows in the same order), the points
    only in one of the two, and the first block (by the container's
    origins) whose points differ."""
    got = np.concatenate([rec[:, :3], np.round(rec[:, 3:6] * 255.0)],
                         1).astype(np.int64)
    want = ref.astype(np.int64)
    out = {"decoded": len(got), "reference": len(want),
           "identical": got.shape == want.shape
           and bool(np.array_equal(got, want))}
    if out["identical"]:
        return out
    rows_got = set(map(tuple, got.tolist()))
    rows_want = set(map(tuple, want.tolist()))
    vox_got = {r[:3] for r in rows_got}
    vox_want = {r[:3] for r in rows_want}
    out["only_decoded"] = len(rows_got - rows_want)
    out["only_reference"] = len(rows_want - rows_got)
    out["voxels_only_one"] = len(vox_got ^ vox_want)
    out["first_block"] = None
    for i, b in enumerate(blocks):
        lo = np.asarray(b["origin"], np.int64)
        hi = lo + (8 << b["levels"])

        def inside(a):
            return a[np.all((a[:, :3] >= lo) & (a[:, :3] < hi), axis=1)]
        if not np.array_equal(inside(got), inside(want)):
            out["first_block"] = i
            break
    return out


def _decode_indexes(codec, data):
    """(decoded cloud, the y scale indexes the decoder derived), from one
    decode with the codec's debug record on."""
    codec.debug, codec.debug_info = True, []
    try:
        rec = codec.decompress(data)
        idx = np.concatenate([d["y_idx"] for d in codec.debug_info
                              if d["side"] == "dec"])
    finally:
        codec.debug, codec.debug_info = False, []
    return rec, idx


def jax_stream_report(codec, f32_codec=None):
    """Decode the JAX-written fixture with ``codec``; one report line.  A
    decode that raises is the reported result; a bad fixture raises.  With
    ``f32_codec`` (the port on the CPU, in f32 as the stream was written)
    the line also says how many of the y scale indexes ``codec`` derives
    differ from the f32 ones, and where the first one lies: the y symbols
    decode against those indexes, so the first difference is where the
    rANS stream desyncs."""
    data, blocks, ref = load_jax_stream()
    head = (f"[jax stream] {JAX_STREAM.split(os.sep)[-1]}: {len(data)} B, "
            f"{len(blocks)} block(s), JAX decoded {len(ref)} points")
    try:
        rec, idx = _decode_indexes(codec, data)
    except Exception as exc:  # the measurement: reported, not raised
        return f"{head}; the port's decode raised {exc!r}"
    r = compare_decodes(rec, ref, blocks)
    line = (f"{head}; the port decoded {r['decoded']} points, identical to "
            f"the JAX decode: {r['identical']}")
    if not r["identical"]:
        line += (f"; {r['only_decoded']} points only in the port's decode, "
                 f"{r['only_reference']} only in JAX's "
                 f"({r['voxels_only_one']} voxels in one decode only); "
                 f"first diverging block: {r['first_block']}")
    if f32_codec is not None:
        rec32, idx32 = _decode_indexes(f32_codec, data)
        same32 = compare_decodes(rec32, ref, blocks)["identical"]
        diff = np.flatnonzero(idx != idx32)
        line += (f"; the port in f32 on the CPU: identical to the JAX "
                 f"decode: {same32}, and {len(diff)} of {len(idx)} y scale "
                 f"indexes differ from it (max |difference| "
                 f"{int(np.abs(idx - idx32).max()) if len(diff) else 0}"
                 + (f", the first at y element {int(diff[0])}" if len(diff)
                    else "") + ")")
    return line


# -- phase 9: region-candidate g_s ---------------------------------------------

REGION_SEED = 5
# launches per frame: the same layer structure as the flagship's (K1: g_a
# 4, h_a 3, h_s 1 on encode; h_s 1, g_s's 5^3 conv, three transposes and
# six head convs on decode), every level outside grandparent layout
REGION_LAUNCHES = {"tap_gemm": 19, "topk_mask": 3, "compact": 3}


def run_region(frame, q):
    """Region-candidate g_s through the codec (abl_region5's widths, the
    port's own initialization under a fixed seed: the ablation has no
    committed weights): gates, then every recorded kernel call of the
    decode against its plain version.  Returns the kernel rows of
    measure_recorded."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(REGION_SEED)
        model = UnifiedModel(dict(ABL_REGION5_CONFIG,
                                  max_batch=CODEC_MAX_BATCH))
    codec = Codec(model, device="cuda")
    codec.update()
    assert not codec.model.g_s.grand_finest
    codec.debug, codec.debug_info = True, []
    data = codec.compress(frame, q, block_size=1024)
    rec = codec.decompress(data)
    codec.debug = False
    enc = [d for d in codec.debug_info if d["side"] == "enc"]
    dec = [d for d in codec.debug_info if d["side"] == "dec"]
    assert len(enc) == len(dec) >= 1
    for e, d in zip(enc, dec):
        for key in ("y_keys", "z_sym", "y_idx", "y_sym", "scales", "means"):
            assert np.array_equal(e[key], d[key]), \
                f"region: encoder/decoder {key} differ"
    codec.debug_info = []

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    prepared_before = F.PREPARE_CALLS
    t0 = time.time()
    data2 = codec.compress(frame, q, block_size=1024)
    t_enc = time.time() - t0
    t0 = time.time()
    rec2 = codec.decompress(data2)
    torch.cuda.synchronize()
    t_dec = time.time() - t0
    launches = codec_launches()
    peak = torch.cuda.max_memory_allocated()
    assert data2 == data and np.array_equal(rec2, rec), \
        "region: the codec is not deterministic"
    blocks, _ = bitstream.read_container(data)
    k_sum = sum(b["k"][2] for b in blocks)
    assert rec.shape[0] == k_sum, (rec.shape, k_sum)
    assert np.isfinite(rec).all() and rec.shape[1] == 6
    assert F.PREPARE_CALLS == prepared_before, \
        "region: a conv prepared its weights during the frame"
    assert launches == REGION_LAUNCHES, (launches, REGION_LAUNCHES)

    codec.profile, codec.stage_times = True, {}
    try:
        codec.decompress(data)
    finally:
        codec.profile = False
    synth_ms = codec.stage_times["dec.synthesis"] * 1e3

    # where the decode's device time goes (one decode under the profiler)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        codec.decompress(data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA
                     and _device_us(e) > 0), key=_device_us, reverse=True)
    busy = sum(_device_us(e) for e in events) / 1e3
    k1 = sum(_device_us(e) for e in events if "tap_mainloop" in e.key) / 1e3
    print(f"[region] one decode under torch.profiler: wall {wall * 1e3:.1f} "
          f"ms, device busy {busy:.1f} ms, of which K1 {k1:.3f} ms; top "
          "device operations:", flush=True)
    for e in events[:8]:
        print(f"[region]   {_device_us(e) / 1e3:8.3f} ms {e.count:6d}x "
              f"{e.key[:90]}", flush=True)

    # the decode once more, recording its kernel calls
    kernels.RECORD = {}
    codec.decompress(data)
    record, kernels.RECORD = kernels.RECORD, None
    for lvl, (keys, _logits, k) in enumerate(record["topk_mask"]):
        n_valid = int(C.key_is_valid(keys).sum())
        print(f"[region] level {lvl}: {keys.shape[0]} candidate slots "
              f"(8 x {keys.shape[0] // 8} dilated parents), {n_valid} "
              f"covered candidates, keep {int(k.sum())}", flush=True)
    met = pc_metrics(frame, rec, 1023, with_d2=False)
    print(f"[region] block 1024: decoded={rec.shape[0]} (= sum k[2] {k_sum}) "
          f"encoder/decoder bit-exact; encode={t_enc:.3f} s "
          f"decode={t_dec:.3f} s dec.synthesis={synth_ms:.2f} ms "
          f"(synchronized stage) bpp={len(data) * 8 / len(frame):.4f} "
          f"D1_PSNR={met['sym_psnr_mse']:.3f} dB "
          f"Y_PSNR={met['sym_y_psnr']:.3f} dB (seeded init, no training) "
          f"max_memory_allocated={peak / 2**30:.2f} GiB launches={launches} "
          f"conv weights prepared during the frame=0", flush=True)
    convs = [m for m in codec.model.modules() if isinstance(m, _TapConv)]
    layer_of = {id(plan): (m, kind) for m in convs
                for kind, (_, plan) in m._plans.items()}
    rows = measure_recorded(record, layer_of, tag="region", profile=False)
    for name, r in rows.items():
        print(f"[region] {name}: {len(record.get(name, []))} calls, "
              f"kernel={r['ms']:.3f} ms plain={r['plain_ms']:.3f} ms "
              f"library={r['library_ms']:.3f} ms bound={r['bound_ms']:.4f} "
              f"ms max_abs_err={r['max_abs_err']:.3e}", flush=True)
    return rows


# -- phase 10: the evaluation driver -----------------------------------------

EVAL_SEQUENCE = "longdress"
EVAL_QS = [(0.0, 0.0), (0.5, 0.5), (1.0, 1.0)]
EVAL_KEYS = ("bpp", "sym_psnr_mse", "sym_y_psnr", "sym_d2_psnr", "pcqm")


def run_eval():
    """The port's driver on the flagship (a copy of the experiment in a
    temporary results directory), longdress at three q's, each row beside
    the committed one."""
    from upcc_tpu_torch import evaluate
    with open(os.path.join(EXPERIMENT, "test.csv"), newline="") as f:
        reader = csv.DictReader(f)
        committed_cols = reader.fieldnames
        committed = {(r["sequence"], float(r["q_g"]), float(r["q_a"])): r
                     for r in reader}
    tmp = tempfile.mkdtemp(prefix="upcc_eval_")
    try:
        exp = os.path.join(tmp, os.path.basename(EXPERIMENT))
        os.makedirs(exp)
        for name in ("config.yaml", "weights_bf16.msgpack",
                     "weights_bf16.msgpack.meta.json"):
            shutil.copy2(os.path.join(EXPERIMENT, name), exp)
        t0 = time.time()
        evaluate.run_testset([os.path.basename(EXPERIMENT)],
                             sequences=[EVAL_SEQUENCE], results_path=tmp,
                             with_renders=False, q_points=EVAL_QS,
                             device="cuda")
        secs = time.time() - t0
        with open(os.path.join(exp, "test.csv"), newline="") as f:
            reader = csv.DictReader(f)
            cols = reader.fieldnames
            rows = list(reader)
    finally:
        shutil.rmtree(tmp)
    assert cols == committed_cols and len(cols) == 23, cols
    assert len(rows) == len(EVAL_QS)
    for r in rows:
        ref = committed[(r["sequence"], float(r["q_g"]), float(r["q_a"]))]
        assert r["num_points"] == ref["num_points"] == "760000"
        assert r["synthetic"] == "1"
        vals = {k: float(r[k]) for k in EVAL_KEYS}
        assert all(np.isfinite(v) for v in vals.values()), vals
        print(f"[eval] {r['sequence']} q=({r['q_g']}, {r['q_a']}): "
              + " ".join(f"{k}={vals[k]:.4f} (committed "
                         f"{float(ref[k]):.4f}, diff "
                         f"{vals[k] - float(ref[k]):+.4f})"
                         for k in EVAL_KEYS)
              + f"; t_compress={float(r['t_compress']):.2f} s "
              f"t_decompress={float(r['t_decompress']):.2f} s", flush=True)
    print(f"[eval] {len(rows)} rows in {secs:.1f} s (frame, source "
          f"structures, codec and host metrics); columns equal the "
          f"committed test.csv's {len(cols)}", flush=True)


# -- main ----------------------------------------------------------------------

def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(f"[gpu] {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | {torch.cuda.get_device_name(0)}", flush=True)

    # 1. build
    build_s = kernels.build()
    print(f"[build] {len(kernels.SOURCES)} kernels in {build_s:.1f} s",
          flush=True)
    for name, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line \
                    or "Compiling entry function" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)

    # 2. kernels on edge cases
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    check_tap_gemm(gen)
    check_topk(gen)
    check_compact(gen)
    check_tile_tapconv(gen)
    check_window_gather(gen)
    if "--kernels" in sys.argv[1:]:
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # 3. the codec's main path
    torch.manual_seed(0)
    t0 = time.time()
    model = load_weights(UnifiedModel(FLAGSHIP_CONFIG), WEIGHTS)
    codec = Codec(model, device="cuda")
    codec.update()
    torch.cuda.synchronize()
    print(f"[codec] weights + tables in {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    codec.update()
    torch.cuda.synchronize()
    convs = [m for m in model.modules() if isinstance(m, _TapConv)]
    print(f"[codec] update() again {time.time() - t0:.3f} s; prepared conv "
          f"weights: {sum(len(m._plans) for m in convs)} layers, "
          f"{codec.prepared_bytes / 2**20:.1f} MiB held", flush=True)
    xyz, rgb = surface_cloud(np.random.default_rng(10), extent=1024,
                             n_target=760_000)
    frame = np.concatenate([xyz.astype(np.float32), rgb], 1)
    q = (0.5, 0.5)

    # warm-up run: check encoder/decoder bit-exactness
    codec.debug, codec.debug_info = True, []
    t0 = time.time()
    data = codec.compress(frame, q, block_size=1024)
    rec = codec.decompress(data)
    torch.cuda.synchronize()
    print(f"[codec] warm-up compress+decompress {time.time() - t0:.2f} s",
          flush=True)
    enc = [d for d in codec.debug_info if d["side"] == "enc"]
    dec = [d for d in codec.debug_info if d["side"] == "dec"]
    assert len(enc) == len(dec) >= 1
    for e, d in zip(enc, dec):
        for key in ("y_keys", "z_sym", "y_idx", "y_sym", "scales", "means"):
            assert np.array_equal(e[key], d[key]), f"encoder/decoder {key} differ"
    print(f"[codec] encoder/decoder symbols, indexes, scales and means "
          f"bit-exact over {len(enc)} block(s)", flush=True)
    codec.debug, codec.debug_info = False, []

    # timed run with the launch counts zeroed just before
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    prepared_before = F.PREPARE_CALLS
    t0 = time.time()
    data = codec.compress(frame, q, block_size=1024)
    t_enc = time.time() - t0
    t0 = time.time()
    rec = codec.decompress(data)
    torch.cuda.synchronize()
    t_dec = time.time() - t0
    launches = codec_launches()
    peak = torch.cuda.max_memory_allocated()
    blocks, _ = bitstream.read_container(data)
    k_sum = sum(b["k"][2] for b in blocks)
    assert rec.shape[0] == k_sum, (rec.shape, k_sum)
    assert np.isfinite(rec).all() and rec.shape[1] == 6
    for name in CODEC_KERNELS:
        assert launches[name] > 0, \
            f"kernel {name} was not launched on the main path"
    assert launches == TOPK_LAUNCHES, (launches, TOPK_LAUNCHES)
    assert F.PREPARE_CALLS == prepared_before, \
        "a conv prepared its weights during the frame (stale or missing plan)"
    bpp = len(data) * 8 / len(frame)
    met = pc_metrics(frame, rec, 1023, with_d2=False)
    print(f"[codec] block 1024: points={len(frame)} decoded={rec.shape[0]} "
          f"(= sum k[2] {k_sum}) encode={t_enc:.3f} s decode={t_dec:.3f} s "
          f"bpp={bpp:.4f} D1_PSNR={met['sym_psnr_mse']:.3f} dB "
          f"Y_PSNR={met['sym_y_psnr']:.3f} dB "
          f"max_memory_allocated={peak / 2**30:.2f} GiB launches={launches} "
          f"conv weights prepared during the frame=0", flush=True)

    # one more run recording every kernel call's inputs (for phase 4)
    kernels.RECORD = {}
    codec.decompress(codec.compress(frame, q, block_size=1024))
    record, kernels.RECORD = kernels.RECORD, None

    data512 = codec.compress(frame, q, block_size=512)
    rec512 = codec.decompress(data512)
    blocks512, _ = bitstream.read_container(data512)
    k512 = sum(b["k"][2] for b in blocks512)
    assert rec512.shape[0] == k512, (rec512.shape, k512)
    assert np.isfinite(rec512).all()
    print(f"[codec] block 512: blocks={len(blocks512)} decoded="
          f"{rec512.shape[0]} (= sum k[2]) bpp="
          f"{len(data512) * 8 / len(frame):.4f}", flush=True)

    # 4. recorded main-path calls: kernel vs plain, times, bounds
    layer_of = {id(plan): (m, kind) for m in convs
                for kind, (_, plan) in m._plans.items()}
    rows = measure_recorded(record, layer_of)
    del record, layer_of
    torch.cuda.synchronize()
    t0 = time.time()
    held = sum(m.prepare() for m in convs)
    torch.cuda.synchronize()
    print(f"[k1 main] the times above are with the weights prepared ahead; "
          f"preparing all {len(convs)} conv layers (block lists + packed "
          f"operands, {held / 2**20:.1f} MiB) takes "
          f"{(time.time() - t0) * 1e3:.1f} ms, once per update()", flush=True)
    for r in rows.values():
        r["bound_by"] = "bytes" if r["t_bytes"] >= r["t_ops"] else "operations"

    # 8. the JAX-written stream on the card, 9. region-candidate g_s
    f32_codec = Codec(load_weights(UnifiedModel(FLAGSHIP_CONFIG), WEIGHTS),
                      device="cpu")
    f32_codec.update()
    print(jax_stream_report(codec, f32_codec), flush=True)
    del f32_codec
    run_region(frame, q)

    # 5. the probe entry points and their two kernels
    probe_rows, probe_launches = run_probes()
    rows.update(probe_rows)
    launches.update({k: probe_launches[k] for k in probe_rows})

    # 6. the lossless path, 7. simulcast, streaming, color refit
    run_coded(codec, frame, q, 1024, measure_k3=True)
    coded_stage_times(codec, frame, q)
    run_coded(codec, frame, q, 512)
    run_serving(codec, frame, data)

    # 10. the evaluation driver against the committed RD rows
    run_eval()

    out = []
    for name, (src, replaces) in REPLACES.items():
        r = rows[name]
        assert launches[name] > 0, f"kernel {name} was launched on no path"
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]})
    print(smi)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
