#!/usr/bin/env python3
"""On-card gate of the PyTorch/CUDA port (``upcc_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # the whole check, one card
    python3 chip_smoke.py --kernels  # build + kernel checks only
    python3 chip_smoke.py --train    # build + K1w checks + phase 11 only
    python3 chip_smoke.py --parallel # build + phases 12-15 only
    python3 chip_smoke.py --oracle   # build + phases 16-17 only
    python3 chip_smoke.py --bench    # build + phase 18 only
    python3 chip_smoke.py --eval-all # build + the driver on 7 sequences

It checks; it does not time kernels.  Kernel times, rooflines and the
device's busy share come from the benchmark (``python3 -m benchmark.run
--workload <cell> --seed <n> --seconds 51 --trace 1``).  Launches and weight
preparations are read from the tracer's counters ``kernel.<name>`` and
``taps.prepared`` inside ``profiling.recording()``, summed over the frames
or steps a gate spans.  Phases, each printing its lines; any failure raises
and exits non-zero:
  1. the card's name and power limit (nvidia-smi); build the CUDA kernels
     (one nvcc per source, in parallel), print the build seconds and
     ptxas's registers, shared memory and spills per kernel entry;
  2. every kernel against its plain PyTorch version on edge-case inputs:
     K1 tap_gemm through its prepared weights at each caller layout, held
     against the dense plain version on the dense stack (f32 tolerance
     below; ragged and short row counts, unread taps, nothing read, indices
     beyond the source, and rows placed elsewhere in a larger call being
     bit-equal), K1w tap_wgrad (the same tolerance, two calls bit-equal,
     the second building its row lists again) and K1 on mirrored plans
     against the plain dgrad, K2 topk_mask in both of its modes (resident
     and streaming, on the same inputs, and streaming by shape at 40M
     candidates), K3 compact (bit for bit: empty input and output, none
     and all kept, m past n, 9 payloads in two launches, 1-, 3- and
     1200-byte rows, payloads at odd byte offsets, and a run of calls on
     one stream with n and payload counts growing and shrinking), P1
     tile_tapconv in both operand types (tolerances at P1_TOL) and P2
     window_gather_sum in its slab mode (8- and 4-float slabs, ragged
     widths) and its streaming mode (exact, bit for bit);
  3. the codec's main path at full width: the committed epoch-193 flagship
     weights, the vox10-scale synthetic frame (760k points), compress ->
     decompress at q=(0.5, 0.5), block 1024 (once with the debug record,
     once recorded by the tracer, once recording every kernel call's
     inputs), then block 512 (an 8-block group); gated: encoder/decoder
     bit-exact, the decoded count equal to the transmitted k, the launches
     per frame (K1 19, K2 3, K3 4; 61 / 0 / 10 on the coded path) and no
     conv preparing its weights during the frame (update() did);
  4. every recorded main-path kernel call against its plain version (K1:
     the prepared weights the codec used against the dense stack built from
     the layer's parameter; K2 in both modes; K3 bit for bit); each K2
     and K3 call under torch.profiler, gated to at most K2_MAX_DEVICE_OPS
     and K3_MAX_DEVICE_OPS device operations;
  5. the two probe entry points (upcc_tpu_torch.probes) at their published
     shapes, each launching its kernel; then P1 and P2 on the same full
     arrays against their plain versions (P2 in each of its modes);
  6. the lossless path at full width: compress(geom="coded") -> decompress
     at block 1024 and block 512; every stage's context bins equal on both
     sides, the decoded voxel set equal to the input's, deterministic,
     launches 61 / 0 / 10 a frame; K3 on one coded frame's 10 recorded calls
     against its plain version (``[k3 coded]``);
  7. compress_multi at three q's and compress_stream / decompress_stream
     at depth 2 over three frames, byte-identical to the sequential calls;
     refit_colors (affine + residual layer) with decompress(new container)
     equal to the returned reconstruction;
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
     bit-exact, deterministic, decoded count = sum of k[2], no conv
     preparing weights during the frame, launches per frame 19/3/4; every
     K1, K2 and K3 call of the region decode against its plain version;
     candidate counts per level and peak memory printed;
 10. ``[eval]``: the evaluation driver (upcc_tpu_torch.evaluate) on the
     flagship for longdress (rebuilt from its seed) at block 1024 and
     q = (0, 0), (0.5, 0.5), (1, 1), color refit on, native PCQM at
     200,000 points, written to a temporary results directory; each row
     beside the committed results/CVPR_inverse_scaling/test.csv row of the
     same (sequence, q_g, q_a), with the differences (reported, not
     gated); the row's 23 columns, 760,000 points and synthetic=1 are
     asserted;
 11. ``[train]``: the flagship's training step at full width (seeded init)
     on train frame 0 of make_synth (scan_like_cloud, default_rng(0), 760k
     points) cut into 128^3 cubes, the packer's fullest batch of 8 cubes
     at the trainer's auto capacity (131,072 on this set), gated: finite
     loss parts, the launches and weight preparations per step over
     TRAIN_TIMED_STEPS steps (K1 18 forward + 17 dgrad, K1w 18, 35
     preparations); every K1 dgrad (K1 on a mirrored plan) and K1w call of
     one recorded step against its plain version (K1w twice bit-equal);
     whole-step gradients against the plain autograd path on 2 cubes
     (tolerances at GRAD_TOL); on a fixed batch over 20 steps, the training
     loss from a fresh seeded init and the RD loss from the committed
     weights (both gated to fall); a Training run of 3 steps with
     validation through real bitstreams at q = (1, 1) (val.csv) and a
     resume from its checkpoint;
 12. ``[region train]``: region-candidate training at abl_region5's widths
     (seeded init) on train frame 0 cut into 64^3 cubes, the packer's
     fullest batch of 4 at the trainer's auto capacity: K1 forward / dgrad
     and K1w launches a step, every K1 dgrad and K1w call of a recorded
     step within 1e-3 x max|plain| (at least 3 of each on cross maps),
     whole-step gradients against plain autograd (GRAD_TOL), the training
     loss falling on a fixed batch (REGION_FALL_RATIO);
 13. ``[parallel dp]`` at flagship widths on [train]'s batch A and the
     next fullest B, gated where each step clips (its gradients before
     Adam, its clip norm) and on the parameters after the update, each
     tensor within TOL_SPREADS times the largest difference between
     SPREAD_RUNS sequential steps on A, at least TOL_ULPS ulps of its
     largest value: a data-parallel step at
     world size 1 on NCCL against the sequential step; two gloo ranks
     sharing cuda:0 (NCCL refuses two ranks on one card) on A and B
     against one in-process update on the mean of their gradients, and
     bit-identical state_dicts after 3 steps;
 14. ``[parallel 2d]``: the 1x2 sharded step on the same two gloo ranks
     against the sequential step on A, each rank's parameter and Adam
     bytes;
 15. ``[parallel codec]``: the flagship codec with devices=["cuda:0",
     "cuda:0"] on the vox10 frame at block 512 with MAX_GROUP 3 (restored
     after): bytes, decode and compress_multi at two q's equal to the
     sequential codec's, launches 19/3/4 a group (K1 8 and K3 1 an encode,
     K1 11 and K3 3 a decode pass).  Phases 12-15 print their seconds;
 16. ``[oracle]``: the geometry-attribution driver
     (upcc_tpu_torch.diag_geometry) on the flagship uncut with the
     committed weights, on the 8 largest 128^3 cubes of [train]'s frame
     that fit 0.9 x 131,072 points (five do), batched at capacity 262,144
     (ORACLE_BATCH_CAPACITY: at 131,072 g_a's stride-2 cap cuts this
     frame's batch), q = 1: with g_s's oracle at levels
     (), (0,), (0, 1), (0, 1, 2), once at the flagship's prune slack and
     once at ORACLE_SLACK (past every GT count, so the tie-fill keeps -1
     candidates); gated: the full oracle reconstructs the GT keys, every
     configuration decodes sum k[2] points, K1/K2/K3 launch as often as in
     the non-oracle forward, and every K2 call at an oracle level (all
     logits +-1, the kept set decided by the tie-fill by position) equals
     topk_mask_plain bit for bit; printed: peak memory, each level's
     ranking precision and D1 per configuration;
 17. ``[twins]``: the four native host libraries (rANS, octree, occupancy,
     voxelize) loaded; on the JAX fixture's frame (6,000 points, q = (0.5,
     0.5), block 128) in geom="topk" and "coded", with every library
     forced off the containers are byte-identical and decode to the same
     points through the Python twins.  Phases 16-17 print their seconds;
 18. ``[bench]``: ``upcc_tpu_torch.bench`` in process, the root bench.py's
     protocol in full (``--bench`` the same): its lines
     under ``[bench]`` (the three frames/s values, rep times, bpp, the
     vox11 frame's encode and decode groups with blocks, points, k per
     level and peak memory, launches per frame) and its gates (bit-exact
     warm-ups, decoded = sum k[2] and no weight preparation on every timed
     frame, the stream's containers byte-identical to compress(), K1/K2/K3
     in every frame, every K2 and K3 call of the vox11 warm-up bit-equal
     to its plain version); then every recorded vox11 call of K1, K2 and
     K3 against its plain version (``[k1 vox11]`` ...); the graft entry's
     training-mode forward (upcc_tpu_torch.graft_entry) at the flagship's
     widths: finite, launches GRAFT_LAUNCHES; and spawn of one rank more
     than there are cards refused before any process starts.  Prints its
     seconds.
``--eval-all`` runs phase 10's driver on the seven other sequences of the
committed test.csv (loot, soldier, redandblack at vox10; the four Owlii
sequences at vox11, block 512) at the same three q's: 21 rows, each beside
the committed row, those outside the CPU tests' tolerance (1% bpp, 0.1 dB)
marked, then EVAL_NO_RESID's rows again without the residual color layer
(the witness of why the marked rows differ); about 14 minutes of host
metrics, so not in the default run.
The whole run also asserts that each of the six kernels launched on some
path.  The last two lines are the nvidia-smi line and the result line
{"ok": true, "device": {...}}.

K1 tolerance: the kernel and the plain version both multiply the same
bf16-rounded operands exactly and sum in f32 in different orders, so
max|kernel - plain| <= 1e-3 * max|plain| + 1e-5.
"""

import csv
import itertools
import json
import math
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
from upcc_tpu_torch.probes import micro_gather, window_gather
from upcc_tpu_torch.utils import profiling
from upcc_tpu_torch.weights import (ABL_REGION5_CONFIG, FLAGSHIP_CONFIG,
                                    load_weights)

HERE = os.path.dirname(os.path.abspath(__file__))
EXPERIMENT = os.path.join(HERE, "results", "CVPR_inverse_scaling")
WEIGHTS = os.path.join(EXPERIMENT, "weights_bf16.msgpack")
JAX_STREAM = os.path.join(HERE, "tests", "fixtures",
                          "jax_stream_flagship.upcc")
JAX_DECODED = os.path.join(HERE, "tests", "fixtures",
                           "jax_stream_flagship_decoded.npy")


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def launch_counts(rec, names):
    """{kernel: launches} in a tracer record, summed over its units (the
    frames or steps a gate spans)."""
    return {name: rec.total("kernel." + name) for name in names}


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


def check_tap_wgrad(gen):
    """K1w against its plain version (the listed blocks of the dense
    gradient) per call shape, twice bit-equal (the second call building
    its row lists again); and K1 on a mirrored plan over a self map against
    the plain dgrad (a scatter)."""
    dev = "cuda"
    bf = torch.bfloat16

    def case(name, rows, n_src, kind, ks, cin, cout, p_ok=0.8, edit=None):
        w = torch.randn((ks ** 3, cin, cout), generator=gen, device=dev)
        plan = F.prepare_taps(w, kind, ks, bf)
        idx = torch.randint(0, n_src + 64, (rows, 27), generator=gen,
                            device=dev, dtype=torch.int32)
        ok = torch.rand((rows, 27), generator=gen, device=dev) < p_ok
        if edit is not None:
            edit(idx, ok)
        flat = torch.randn((n_src, plan.k_in), generator=gen,
                           device=dev).to(bf)
        dacc = torch.randn((rows, plan.k_out), generator=gen,
                           device=dev).to(bf)
        ref = plan.blocks_of(F.tap_wgrad_plain(flat, idx, ok, dacc))
        tol = 1e-3 * float(ref.abs().max()) + 1e-5
        got = F.tap_wgrad(flat, idx, ok, dacc, plan)
        drop_lists(ok)  # the second call builds its row lists again
        again = F.tap_wgrad(flat, idx, ok, dacc, plan)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        same = torch.equal(got.view(torch.int32), again.view(torch.int32))
        tiles = plan.wgrad_tiles(plan.n_col > 1).cpu().numpy()
        chunk, splits = F.wgrad_splits(rows, len(tiles),
                                       F._sm_count(flat.device))
        print(f"[k1w] {kind} k{ks} {name}: rows={rows} K_in={plan.k_in} "
              f"K_out={plan.k_out} BN={plan.bn} listed_blocks="
              f"{plan.n_blocks} tiles={len(tiles)} (single-column "
              f"{int((tiles[:, 2] == 1).sum())}) splits={splits}x{chunk} "
              f"ok density {float(ok.float().mean()):.3f} max_abs_err="
              f"{err:.3e} tol={tol:.3e} two calls bit-equal={same}",
              flush=True)
        assert err <= tol, \
            f"tap_wgrad {name} disagrees with its plain version"
        assert same, f"tap_wgrad {name}: two calls differ"
        return got, plan

    def tap_off(idx, ok):
        ok[:, 5] = False

    def all_ok(idx, ok):
        ok.fill_(True)

    def beyond(idx, ok):  # every index past the source: the clamp
        idx += 5000

    case("1024->512", 3000, 2500, "conv", 3, 128, 64)
    case("512->8 (K_out 8)", 1500, 1200, "conv", 3, 64, 1)
    case("1536->2048 (hs3)", 1024, 4096, "conv", 3, 192, 256)
    case("1536->1536 (C 192)", 777, 900, "conv", 3, 192, 192)
    case("1024->128, many splits", 40000, 20000, "down", 5, 128, 128)
    case("512->8, 40,000 rows (many splits)", 40000, 20000, "conv", 3, 64,
         1)
    case("128->1024, ragged rows", 4100, 4000, "transpose", 5, 128, 128)
    case("256->1024 (cin 4)", 1000, 1000, "grand_down", 5, 4, 128)
    case("32->1024 (K_in 32)", 1000, 1000, "down", 5, 4, 128)
    case("1024->2048 (cout 32)", 1000, 1000, "grand_transpose", 5, 128, 32)
    case("2048->1024 (cout 16)", 1001, 1000, "grand_conv", 3, 32, 16)
    case("1024->64 (cout 1, BN 64)", 1000, 1000, "grand_conv", 3, 16, 1)
    case("rows < 64", 40, 100, "conv", 3, 128, 64)
    case("rows 97", 97, 100, "conv", 3, 64, 1)
    case("a tap no row reaches", 3000, 2000, "conv", 3, 128, 64,
         edit=tap_off)
    case("all ok", 3000, 2000, "grand_conv", 3, 16, 1, edit=all_ok)
    case("every index >= n_src", 2000, 700, "conv", 3, 128, 64,
         edit=beyond)
    _, plan = case("1024->1536, odd column blocks a pair", 2000, 2000,
                   "conv", 3, 128, 192)
    t = plan.wgrad_tiles().cpu().numpy()
    assert any(a[2] == 2 and b[2] == 1 and (a[0], a[1]) == (b[0], b[1])
               for a, b in zip(t[:-1], t[1:])), \
        "no single-column tile follows a pair of its (tap, K block)"

    def sparse_taps(idx, ok):
        ok[:, 20:] = False
        ok[:4096, 3:11] = False
    case("taps missing whole steps", 9000, 800, "conv", 3, 128, 64,
         edit=sparse_taps)
    assert not case("all ok = 0", 333, 500, "conv", 3, 64, 64,
                    edit=lambda idx, ok: ok.zero_())[0].any()

    # dgrad: K1 on the mirrored plan over a self map of a random key set
    units = torch.randint(0, 48, (6000, 3), generator=gen, device=dev,
                          dtype=torch.int32)
    keys = torch.unique(C.make_keys(torch.zeros(6000, dtype=torch.int64,
                                                 device=dev), units))
    idx, ok = F.root_neighbors(keys)
    for kind, ks, cin, cout in (("conv", 3, 64, 64), ("conv", 5, 128, 128),
                                ("down", 5, 128, 128)):
        w = torch.randn((ks ** 3, cin, cout), generator=gen, device=dev)
        taps = F.prepare_train_taps(w, kind, ks, bf)
        dacc = torch.randn((keys.shape[0], taps.k_out), generator=gen,
                           device=dev).to(bf)
        got = F.tap_gemm(dacc, idx, ok, taps.plan_t())
        ref = F.tap_dgrad_plain(dacc, idx, ok, taps.plan, keys.shape[0])
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tol = 1e-3 * float(ref.abs().max()) + 1e-5
        print(f"[k1 dgrad] {kind} k{ks} self map of {keys.shape[0]} keys: "
              f"max_abs_err={err:.3e} tol={tol:.3e}", flush=True)
        assert err <= tol, "K1 on the mirrored plan is not the dgrad"


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


# -- phase 4: recorded main-path calls ---------------------------------------

def check_recorded(record, layer_of, tag="main", profile=True):
    """Every recorded call of K1, K2 and K3 against its plain version.
    layer_of: id(prepared plan) -> (layer, call shape) it was made for.
    With ``profile``, each K2 and K3 call under torch.profiler (device
    operations gated)."""
    worst = 0.0
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
        worst = max(worst, err)
        print(f"[k1 {tag}] rows={idx.shape[0]} K_in={w.shape[1]} "
              f"K_out={w.shape[2]} BN={plan.bn} listed_blocks={plan.n_blocks}"
              f" err={err:.3e} tol={tol:.3e}", flush=True)
        del got, ref, w
    print(f"[k1 {tag}] {len(record.get('tap_gemm', []))} calls, "
          f"max_abs_err={worst:.3e}", flush=True)

    for keys, logits, k in record.get("topk_mask", []):
        st = SparseTensor(keys, logits[:, None])
        ref = topk_mask_plain(keys, logits, k)
        modes = topk_modes(keys, k)
        for mode, plan in modes.items():
            got = topk_mask(st, logits, k, plan=plan)
            assert torch.equal(got, ref), \
                f"topk_mask ({mode}) differs on a {tag}-path call"
        line = (f"[k2 {tag}] n={keys.shape[0]} maxb={k.shape[0]} "
                f"kept={int(ref.sum())} bit-equal in modes "
                + ", ".join(f"{m} (grid={p.grid} per_block={p.per_block})"
                            for m, p in modes.items()))
        if profile:
            ops = device_ops(lambda: topk_mask(st, logits, k))
            line += f"; device ops per call={len(ops)}"
            if K2_MAX_DEVICE_OPS is not None:
                assert 0 < len(ops) <= K2_MAX_DEVICE_OPS, \
                    f"topk_mask ran {len(ops)} device operations in one call"
        print(line, flush=True)

    check_compact_calls(record.get("compact", []), tag, profile)


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


def check_compact_calls(calls, tag, profile=True):
    """K3 on recorded calls: bit-equal to its plain version; with
    ``profile``, each call's device operations under torch.profiler (at
    most K3_MAX_DEVICE_OPS).  The coded frame's calls are not profiled:
    late in a run, after the probes, torch.profiler on the H100 host has
    delivered windows without any device record (twice in five runs),
    which would fail the gate for want of a measurement."""
    for keys, keep, arrays, m in calls:
        got = compact(keys, keep, *arrays, out_capacity=m)
        ref = compact_plain(keys, keep, *arrays, out_capacity=m)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), \
            f"compact differs on a recorded call ({tag})"
        del got, ref
        line = (f"[k3 {tag}] n={keys.shape[0]} m={m} "
                f"kept={min(int(keep.sum()), m)} payloads={len(arrays)} "
                f"rows [{payload_rows(keys, arrays)}] bit-equal")
        if profile:
            ops = device_ops(lambda: compact(keys, keep, *arrays,
                                             out_capacity=m))
            line += f"; device ops per call={len(ops)}"
            if K3_MAX_DEVICE_OPS is not None:
                assert 0 < len(ops) <= K3_MAX_DEVICE_OPS, \
                    f"compact ran {len(ops)} device operations in one call"
        print(line, flush=True)


CODEC_KERNELS = ("tap_gemm", "topk_mask", "compact")
# launches per frame (encode + decode), top-k and coded geometry; the
# encoder's voxelization is one K3 call a group
TOPK_LAUNCHES = {"tap_gemm": 19, "topk_mask": 3, "compact": 4}
CODED_LAUNCHES = {"tap_gemm": 61, "topk_mask": 0, "compact": 10}
PROBE_KERNELS = ("tile_tapconv", "window_gather_sum")


# -- phase 5: the probe entry points -------------------------------------------

def run_probes():
    """Drive both probe entry points (each must launch its kernel), then
    hold P1 and P2 against their plain versions on the full arrays.
    Returns the probes' launches."""
    with profiling.recording() as rec:
        micro_gather.main([])
        window_gather.main([])
    launches = launch_counts(rec, PROBE_KERNELS)
    for name in PROBE_KERNELS:
        assert launches[name] > 0, f"the probes did not launch {name}"

    n_rows, tile = 1 << 19, 2048
    for dtype in (torch.bfloat16, torch.float32):
        x, idx, w = micro_gather.tapconv_inputs(n_rows, tile, dtype, "cuda")
        got = tile_tapconv(x, idx, w, tile)
        ref = tile_tapconv_plain(x, idx, w, tile)
        err = float((got - ref).abs().max())
        tol = P1_TOL[dtype] * float(ref.abs().max()) + 1e-5
        assert err <= tol, "tile_tapconv disagrees at the probe's shape"
        print(f"[p1 probe] {str(dtype).split('.')[-1]} rows={n_rows} "
              f"tile={tile} err={err:.3e} tol={tol:.3e}", flush=True)
        del x, idx, w, got, ref

    win, idx = window_gather.window_inputs(16, "cuda")
    ref = window_gather_sum_plain(win, idx)
    modes = window_modes(win)
    for mode, plan in modes.items():
        got = window_gather_sum(win, idx, plan=plan)
        assert torch.equal(got, ref), \
            f"window_gather_sum ({mode}) differs at the probe's shape"
    print(f"[p2 probe] tiles={win.shape[0]} window={win.shape[1]} "
          f"K={win.shape[2]} equal to the plain version in modes "
          + ", ".join(modes), flush=True)
    return launches


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


def run_coded(codec, frame, q, block_size, check_k3=False):
    """compress(geom="coded") -> decompress: bins equal on both sides at
    every stage, geometry exactly lossless, deterministic, launches
    CODED_LAUNCHES; with check_k3, K3 on one frame's recorded calls against
    its plain version (``[k3 coded]``)."""
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

    # the frame again, its launches counted by the tracer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profiling.recording() as counts:
        t0 = time.time()
        data2 = codec.compress(frame, q, block_size=block_size, geom="coded")
        t_enc = time.time() - t0
        t0 = time.time()
        rec2 = codec.decompress(data2)
        torch.cuda.synchronize()
        t_dec = time.time() - t0
    launches = launch_counts(counts, CODEC_KERNELS)
    peak = torch.cuda.max_memory_allocated()
    assert data2 == data and np.array_equal(rec2, rec), \
        "the coded path is not deterministic"
    for name in ("tap_gemm", "compact"):
        assert launches[name] > 0, f"{name} was not launched on the coded path"
    assert launches == CODED_LAUNCHES, (launches, CODED_LAUNCHES)
    if check_k3:
        # one more frame recording K3's inputs (only K3's: K1's would hold
        # every conv input of the frame)
        kernels.RECORD = RecordOnly("compact")
        codec.decompress(codec.compress(frame, q, block_size=block_size,
                                        geom="coded"))
        calls, kernels.RECORD = kernels.RECORD.get("compact", []), None
        assert len(calls) == CODED_LAUNCHES["compact"], len(calls)
        check_compact_calls(calls, "coded", profile=False)
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
# six head convs on decode; K3: the voxelization, three prunes), every
# level outside grandparent layout
REGION_LAUNCHES = {"tap_gemm": 19, "topk_mask": 3, "compact": 4}


def run_region(frame, q):
    """Region-candidate g_s through the codec (abl_region5's widths, the
    port's own initialization under a fixed seed: the ablation has no
    committed weights): gates, then every recorded kernel call of the
    decode against its plain version."""
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
    with profiling.recording() as counts:
        t0 = time.time()
        data2 = codec.compress(frame, q, block_size=1024)
        t_enc = time.time() - t0
        t0 = time.time()
        rec2 = codec.decompress(data2)
        torch.cuda.synchronize()
        t_dec = time.time() - t0
    launches = launch_counts(counts, CODEC_KERNELS)
    peak = torch.cuda.max_memory_allocated()
    assert data2 == data and np.array_equal(rec2, rec), \
        "region: the codec is not deterministic"
    blocks, _ = bitstream.read_container(data)
    k_sum = sum(b["k"][2] for b in blocks)
    assert rec.shape[0] == k_sum, (rec.shape, k_sum)
    assert np.isfinite(rec).all() and rec.shape[1] == 6
    assert counts.total("taps.prepared") == 0, \
        "region: a conv prepared its weights during the frame"
    assert launches == REGION_LAUNCHES, (launches, REGION_LAUNCHES)

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
          f"decode={t_dec:.3f} s bpp={len(data) * 8 / len(frame):.4f} "
          f"D1_PSNR={met['sym_psnr_mse']:.3f} dB "
          f"Y_PSNR={met['sym_y_psnr']:.3f} dB (seeded init, no training) "
          f"max_memory_allocated={peak / 2**30:.2f} GiB launches={launches} "
          f"conv weights prepared during the frame=0", flush=True)
    convs = [m for m in codec.model.modules() if isinstance(m, _TapConv)]
    layer_of = {id(plan): (m, kind) for m in convs
                for kind, (_, plan) in m._plans.items()}
    check_recorded(record, layer_of, tag="region", profile=False)


# -- phase 11: the flagship's training step ----------------------------------

# the training keys of configs/CVPR_inverse_scaling.yaml, written out (the
# GPU host has no yaml; a test holds them equal to the file); the model
# section is weights.FLAGSHIP_CONFIG
TRAIN_KEYS = {
    "experiment_name": "CVPR_inverse_scaling",
    "min_points_train": 300,
    "min_points_test": 0,
    "transforms": {"train": {
        "1_ColorJitter": {"key": "ColorJitter"},
        "2_Rotate": {"key": "RandomRotate", "block_size": 128}}},
    "q_map": {"lambda_A_min": 0, "lambda_A_max": 12800, "lambda_G_min": 0,
              "lambda_G_max": 200, "mode": "quadratic", "corner_p": 0.15},
    "epochs": 300,
    "batch_size": 8,
    "batch_bucketing": True,
    "model_learning_rate": 0.0001,
    "bottleneck_learning_rate": 0.001,
    "optimizer": "Adam",
    "scheduler_step_size": 130,
    "scheduler_gamma": 0.1,
    "clip_grad_norm": 1.0,
    "val_every": 10,
    "loss": {
        "Multiscale_FocalLoss": {"type": "Multiscale_FocalLoss",
                                 "alpha": 0.5, "gamma": 2.0},
        "ColorLoss": {"type": "ColorLoss", "loss": "L2"},
        "bpp-y": {"type": "BPPLoss", "key": "y", "weight": 1.0},
        "bpp-z": {"type": "BPPLoss", "key": "z", "weight": 1.0}},
}
# the steps over which the launches and preparations a step are counted
TRAIN_TIMED_STEPS = 5
TRAIN_FALL_STEPS = 20
# whole-step gradients, kernels against the plain autograd path, on a
# batch of 2 cubes (the plain path holds every gathered block), by L2
# norms: over all parameters ||kernel - plain|| <= GRAD_TOL * ||plain||,
# and per parameter tensor <= GRAD_TOL_EACH times its own norm.  Both
# routes multiply bf16-rounded operands but round gradients to bf16 at
# other places: the kernel route rounds each conv's output gradient before
# its dgrad and wgrad (relative 2^-9), autograd only the gradient of each
# bf16 input.  Over all parameters the first chip runs measured
# 4.9e-4 - 5.5e-4.  Per tensor the worst is h_a's first layer, whose
# gradient reaches it only through z's rounding and cancels to a few % of
# its terms: 1.6e-2 to 6.3e-2 between runs (a layer computed wrong is off
# by its whole norm)
GRAD_TOL = 1e-2
GRAD_TOL_EACH = 0.25
GRAD_BATCH = 2


def train_config(root):
    cfg = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in TRAIN_KEYS.items()}
    cfg["model"] = {k: dict(v) for k, v in FLAGSHIP_CONFIG.items()}
    cfg["results_path"] = os.path.join(root, "results")
    cfg["data_path"] = os.path.join(root, "data")
    return cfg


_TRAIN_FRAME = []


def train_frame():
    """Train frame 0 of make_synth (scan_like_cloud, default_rng(0), extent
    1024, 760,000 points), made once."""
    if not _TRAIN_FRAME:
        from upcc_tpu_torch.data.synthetic import scan_like_cloud
        _TRAIN_FRAME.append(scan_like_cloud(np.random.default_rng(0),
                                            extent=1024, n_target=760_000))
    return _TRAIN_FRAME[0]


def make_train_data(root, cube=128):
    """The training set of one vox10 frame: ``train_frame()`` cut into
    cube^3 cubes; the same frame whole as the validation set."""
    from upcc_tpu_torch.data.dataset import slice_into_cubes, write_split
    xyz, rgb = train_frame()
    cubes = slice_into_cubes(xyz, rgb, cube)
    data = os.path.join(root, "data")
    os.makedirs(data)
    write_split(os.path.join(data, "train.npz"), [c[0] for c in cubes],
                [c[1] for c in cubes])
    write_split(os.path.join(data, "val.npz"), [xyz.astype(np.int32)],
                [rgb.astype(np.float32)])
    return len(xyz), len(cubes)


def plain_autograd(fn):
    """Run ``fn`` with every conv through ``tap_gemm_plain`` on the layer's
    dense stack in the operand type (bf16 on the card) and every
    compaction through
    ``compact_plain``, differentiated by torch autograd alone."""
    from upcc_tpu_torch.models import transforms
    saved = (F._gemm, sparse.compact, transforms.compact)

    def gemm(flat, idx, ok, w, self_map=True):
        dense = w.dense.to(flat.dtype) if isinstance(w, F.TrainTaps) \
            else w
        return F.tap_gemm_plain(flat, idx, ok, dense)

    def comp(keys, keep, *arrays, out_capacity=None):
        return compact_plain(keys, keep, *arrays, out_capacity=out_capacity)
    F._gemm, sparse.compact, transforms.compact = gemm, comp, comp
    try:
        return fn()
    finally:
        F._gemm, sparse.compact, transforms.compact = saved


def drop_lists(ok):
    """Forget the K1w row lists kept on a map (ops/family.py::
    wgrad_row_lists), so that the next call builds them."""
    ok.__dict__.pop("_wgrad_row_lists", None)


def check_recorded_backward(record):
    """Every K1 dgrad call (K1 on a mirrored plan) and K1w call of one
    recorded step against its plain version (tolerance as K1's), K1w
    twice bit-equal."""
    torch.set_grad_enabled(False)
    try:
        _check_recorded_backward(record)
    finally:
        torch.set_grad_enabled(True)


def _check_recorded_backward(record):
    wgr = record.get("tap_wgrad", [])
    wg = {id(c[4]): c for c in wgr}
    worst = 0.0
    for flat, idx, ok, dacc, plan in wgr:
        got = F.tap_wgrad(flat, idx, ok, dacc, plan)
        again = F.tap_wgrad(flat, idx, ok, dacc, plan)
        dense = F.tap_wgrad_plain(flat, idx, ok, dacc)
        ref = plan.blocks_of(dense)
        err = float((got - ref).abs().max())
        tol = 1e-3 * float(ref.abs().max()) + 1e-5
        assert err <= tol, "tap_wgrad disagrees with its plain version"
        assert torch.equal(got.view(torch.int32), again.view(torch.int32)), \
            "tap_wgrad: two calls on the same inputs differ"
        del got, again, ref, dense
        worst = max(worst, err)
        dens = ok.float().mean(0)
        n, n_tiles = idx.shape[0], len(plan.wgrad_tiles(plan.n_col > 1))
        print(f"[k1w train] rows={n} K_in={plan.k_in} K_out={plan.k_out} "
              f"listed_blocks={plan.n_blocks} tiles={n_tiles} splits="
              f"{F.wgrad_splits(n, n_tiles, F._sm_count(ok.device))} "
              f"ok density {float(dens.mean()):.3f} (taps "
              f"{float(dens.min()):.3f}-{float(dens.max()):.3f}) "
              f"err={err:.3e} tol={tol:.3e}", flush=True)
    print(f"[train] tap_wgrad: {len(wgr)} calls, max_abs_err={worst:.3e}, "
          "each twice bit-equal", flush=True)

    worst, dgrads = 0.0, 0
    for g, idx, ok, plan_t in record.get("tap_gemm", []):
        if plan_t.mirror_of is None:
            continue  # a forward call
        flat, fidx, fok, dacc, plan = wg[id(plan_t.mirror_of)]
        got = F.tap_gemm(g, idx, ok, plan_t)
        ref = F.tap_dgrad_plain(dacc, fidx, fok, plan, flat.shape[0])
        err = float((got - ref).abs().max())
        tol = 1e-3 * float(ref.abs().max()) + 1e-5
        assert err <= tol, "K1 dgrad disagrees with its plain version"
        del got, ref
        worst, dgrads = max(worst, err), dgrads + 1
        print(f"[k1 dgrad train] rows={idx.shape[0]} K_in={plan_t.k_in} "
              f"K_out={plan_t.k_out} "
              f"self_map={idx.data_ptr() == fidx.data_ptr()} err={err:.3e} "
              f"tol={tol:.3e}", flush=True)
    print(f"[train] dgrad: {dgrads} calls, max_abs_err={worst:.3e}",
          flush=True)
    assert dgrads == len(wg) - 1, \
        "every layer but g_a's first must have run its dgrad"


def run_train(smi):
    """The flagship's training step at full width on one vox10 frame's
    cubes: launches and preparations a step, the recorded backward against
    its plain versions, whole-step gradients against the plain autograd
    path, the loss on a fixed batch over 20 steps, and a Training-driven
    run with validation and resume.  Returns the launches a step."""
    from upcc_tpu_torch.training.trainer import Training
    tmp = tempfile.mkdtemp(prefix="upcc_train_")
    try:
        t0 = time.time()
        n_pts, n_cubes = make_train_data(tmp)
        cfg = train_config(tmp)
        tr = Training(cfg, capacity="auto", device="cuda",
                      renders=False)
        batch = fullest_batches(tr)[0]
        st, root = tr.batch_tensors(batch)
        q, lam = tr.q_func.sample(torch.Generator().manual_seed(0),
                                  tr.batch_size)
        q, lam = q.cuda(), lam.cuda()
        gen = torch.Generator(device="cuda").manual_seed(0)
        # tap convs (the kernel-2 transposes of h_s are one dense product)
        n_layers = sum(isinstance(m, _TapConv) and not (
            m.kind == "transpose" and m.kernel_size == 2)
            for m in tr.model.modules())
        print(f"[train] {n_pts} points -> {n_cubes} cubes of 128^3 "
              f"({len(tr.train_ds)} with >= 300 points); the trainer's auto "
              f"capacity {tr.capacity}; its fullest batch of {tr.batch_size} "
              f"cubes: {int((batch[0] >= 0).sum())} points in "
              f"{cubes_in(batch)} cubes at capacity {len(batch[0])}; "
              f"{n_layers} tap conv layers; set-up "
              f"{time.time() - t0:.1f} s", flush=True)

        for _ in range(2):  # warm-up
            tr.step_fn(st, q, lam, root, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        with profiling.recording() as counts:
            for _ in range(TRAIN_TIMED_STEPS):
                t0 = time.perf_counter()
                met = tr.step_fn(st, q, lam, root, gen)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        launches = {k: v // TRAIN_TIMED_STEPS for k, v in
                    launch_counts(counts, kernels.SOURCES).items() if v}
        prepares = counts.total("taps.prepared") / TRAIN_TIMED_STEPS
        assert all(math.isfinite(float(v)) for v in met.values()), met
        assert prepares == 2 * n_layers - 1, \
            f"{prepares} weight preparations a step, not {2 * n_layers - 1}"
        for name in ("tap_gemm", "tap_wgrad", "topk_mask", "compact"):
            assert launches.get(name, 0) > 0, f"{name} was not launched"
        assert launches["tap_wgrad"] == n_layers
        assert launches["tap_gemm"] == 2 * n_layers - 1
        print(f"[train] step ms over {TRAIN_TIMED_STEPS} steps: median "
              f"{float(np.median(times)):.1f} (min {min(times):.1f}, max "
              f"{max(times):.1f}); max_memory_allocated "
              f"{peak / 2**30:.2f} GiB; launches per step {launches} "
              f"(K1 = {n_layers} forward + {n_layers - 1} dgrad); weight "
              f"preparations per step {prepares:g}; loss parts "
              + ", ".join(f"{k}={float(v):.4f}" for k, v in met.items())
              + f" | {smi}", flush=True)

        kernels.RECORD = {}
        tr.step_fn(st, q, lam, root, gen)
        record, kernels.RECORD = kernels.RECORD, None
        check_recorded_backward(record)
        del record

        check_step_gradients(tr, q, lam, "train")

        # the loss on one fixed batch, fixed q and fixed noise, over 20
        # steps, from a fresh seeded init (gated: the training loss, main +
        # aux, falls) and from the committed epoch-193 weights (a resumed
        # run, fresh Adam moments at the base rate; gated: the RD loss the
        # main parameters descend falls, while the aux loss, fitted by the
        # quantiles' own Adam, follows the density the main step moves)
        for start in ("seeded init", "epoch-193 weights"):
            del tr
            tr = Training(cfg, capacity="auto", device="cuda", renders=False)
            if start != "seeded init":
                load_weights(tr.model, WEIGHTS)
            trail = []
            for i in range(TRAIN_FALL_STEPS):
                gen.manual_seed(1)
                trail.append({k: float(v) for k, v in
                              tr.step_fn(st, q, lam, root, gen).items()})
            first, last = trail[0], trail[-1]
            rd = [t["loss"] - t["aux_loss"] for t in trail]
            print(f"[train] loss on one fixed batch over {TRAIN_FALL_STEPS} "
                  f"steps from the {start}: "
                  + ", ".join(f"{k} {first[k]:.4f} -> {last[k]:.4f}"
                              for k in first)
                  + "; RD loss (without aux) by step "
                  + " ".join(f"{v:.3f}" for v in rd), flush=True)
            assert all(math.isfinite(t["loss"]) for t in trail)
            if start == "seeded init":
                assert last["loss"] < first["loss"], \
                    "the training loss did not fall from the seeded init"
        assert rd[-1] < rd[0], "the RD loss did not fall"
        del tr, st, root

        # a Training-driven run: 3 steps, validation at q = (1, 1) through
        # real bitstreams, checkpoint, resume
        cfg.update(epochs=1, val_every=1, val_qualities=[(1, 1)])
        t0 = time.time()
        tr = Training(cfg, capacity="auto", max_steps_per_epoch=3,
                      device="cuda", renders=False)
        tr.train()
        secs = time.time() - t0
        exp = tr.results_dir
        with open(os.path.join(exp, "val.csv")) as f:
            val = list(csv.DictReader(f))
        assert len(val) == 1 and float(val[0]["bpp"]) > 0, val
        cfg["epochs"] = 2
        tr2 = Training(cfg, capacity="auto", device="cuda",
                       renders=False)
        assert tr2.start_epoch == 1 and tr2.step_fn.step == 3
        same = all(torch.equal(a, b) for a, b in zip(
            tr.model.state_dict().values(), tr2.model.state_dict().values()))
        assert same, "the resumed model differs from the checkpointed one"
        print(f"[train] Training: 3 steps + validation in {secs:.1f} s; "
              f"val.csv row q=(1, 1): bpp={float(val[0]['bpp']):.4f} "
              f"Y_PSNR={float(val[0]['sym_y_psnr']):.3f} dB "
              f"D1_PSNR={float(val[0]['sym_psnr_mse']):.3f} dB; resumed at "
              f"epoch {tr2.start_epoch}, step {tr2.step_fn.step}, parameters "
              f"equal; files {sorted(os.listdir(exp))}", flush=True)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def cubes_in(b):
    return len(set(b[0][b[0] >= 0].tolist()))


def fullest_batches(tr):
    """The epoch's batches of batch_size cubes from the packer, fullest
    first (bucketing puts the smallest cubes first; the last batches of
    the largest cubes hold fewer)."""
    return sorted((b for b in tr._batches(np.random.default_rng(0))
                   if cubes_in(b) == tr.batch_size),
                  key=lambda b: -int((b[0] >= 0).sum()))


def check_step_gradients(tr, q, lam, tag):
    """Whole-step gradients on GRAD_BATCH cubes, kernels against the plain
    autograd path (plain_autograd), gated by GRAD_TOL and GRAD_TOL_EACH."""
    small = collate_small(tr, GRAD_BATCH)
    sst, sroot = tr.batch_tensors(small)
    grads = []
    for route in ("kernel", "plain"):
        def run():
            tr.model.zero_grad(set_to_none=True)
            total, _ = tr.step_fn.loss(sst, q, lam, sroot)
            total.backward()
            return {n: p.grad.detach().clone()
                    for n, p in tr.model.named_parameters()
                    if p.grad is not None}
        with torch.random.fork_rng(devices=[0]):
            torch.cuda.manual_seed(1)
            grads.append(run() if route == "kernel"
                         else plain_autograd(run))
    assert set(grads[0]) == set(grads[1])
    rel = {n: float(torch.linalg.vector_norm(grads[0][n] - g)
                    / torch.linalg.vector_norm(g).clamp(min=1e-30))
           for n, g in grads[1].items()}
    rel_max = {n: float((grads[0][n] - g).abs().max()
                        / g.abs().max().clamp(min=1e-30))
               for n, g in grads[1].items()}
    total_rel = float(torch.sqrt(sum(
        torch.sum((grads[0][n] - g) ** 2) for n, g in grads[1].items())
        / sum(torch.sum(g ** 2) for g in grads[1].values())))
    worst = max(rel, key=rel.get)
    worst_max = max(rel_max, key=rel_max.get)
    print(f"[{tag}] whole-step gradients, kernels vs plain autograd, "
          f"{GRAD_BATCH} cubes, {len(rel)} parameters: worst "
          f"||diff||/||plain|| {rel[worst]:.3e} ({worst}; tolerance "
          f"{GRAD_TOL_EACH}), median "
          f"{float(np.median(list(rel.values()))):.3e}, over all "
          f"parameters {total_rel:.3e} (tolerance {GRAD_TOL})"
          f"; worst max|diff|/max|plain| {rel_max[worst_max]:.3e} "
          f"({worst_max})", flush=True)
    assert total_rel <= GRAD_TOL and rel[worst] <= GRAD_TOL_EACH, \
        f"{tag}: gradients disagree with the plain path"


def collate_small(tr, n):
    """A batch of the first ``n`` cubes of the set, at the packer's
    smallest ladder capacity holding them."""
    from upcc_tpu_torch.data.dataset import collate_cubes
    items = [tr.train_ds[i] for i in range(n)]
    total = sum(len(x) for x, _ in items)
    cap = next(c for c in tr._CAP_LADDER if total <= c)
    return collate_cubes(items, cap, np.random.default_rng(0))


# -- phase 10: the evaluation driver -----------------------------------------

EVAL_SEQUENCE = "longdress"
EVAL_QS = [(0.0, 0.0), (0.5, 0.5), (1.0, 1.0)]
EVAL_KEYS = ("bpp", "sym_psnr_mse", "sym_y_psnr", "sym_d2_psnr", "pcqm")
# --eval-all: the committed test.csv's seven other sequences at EVAL_QS
EVAL_ALL_SEQUENCES = ["loot", "soldier", "redandblack", "basketball_player",
                      "dancer", "exercise", "model"]
# --eval-all's witness of why rows fall outside the tolerance: these
# sequences at q = (0.5, 0.5) again without the signaled residual color
# layer (the layer came after the committed rows of soldier, redandblack
# and the Owlii sequences)
EVAL_NO_RESID = ["soldier", "redandblack", "dancer"]
# the CPU tests' tolerance of the driver against JAX's (bpp relative, dB)
EVAL_BPP_TOL, EVAL_DB_TOL = 0.01, 0.1


def run_eval(sequences=(EVAL_SEQUENCE,), tag="eval", qs=EVAL_QS,
             color_resid=True):
    """The port's driver on the flagship (a copy of the experiment in a
    temporary results directory) on ``sequences`` at ``qs``, with or
    without the residual color layer, each row beside the committed one
    (reported, not gated; the 23 columns, the sequence's point count and
    synthetic=1 are asserted)."""
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
                             sequences=list(sequences), results_path=tmp,
                             with_renders=False, q_points=qs,
                             color_resid=color_resid, device="cuda")
        secs = time.time() - t0
        with open(os.path.join(exp, "test.csv"), newline="") as f:
            reader = csv.DictReader(f)
            cols = reader.fieldnames
            rows = list(reader)
    finally:
        shutil.rmtree(tmp)
    assert cols == committed_cols and len(cols) == 23, cols
    assert len(rows) == len(qs) * len(sequences)
    outside = 0
    for r in rows:
        ref = committed[(r["sequence"], float(r["q_g"]), float(r["q_a"]))]
        spec = evaluate.TEST_SET[r["sequence"]]
        n = "760000" if spec["resolution"] <= 1023 else "1200000"
        assert r["num_points"] == ref["num_points"] == n
        assert r["synthetic"] == "1"
        vals = {k: float(r[k]) for k in EVAL_KEYS}
        assert all(np.isfinite(v) for v in vals.values()), vals
        diff = {k: vals[k] - float(ref[k]) for k in EVAL_KEYS}
        within = (abs(diff["bpp"]) <= EVAL_BPP_TOL * float(ref["bpp"])
                  and all(abs(diff[k]) <= EVAL_DB_TOL for k in
                          ("sym_psnr_mse", "sym_y_psnr", "sym_d2_psnr")))
        outside += not within
        print(f"[{tag}] {r['sequence']} q=({r['q_g']}, {r['q_a']}): "
              + " ".join(f"{k}={vals[k]:.4f} (committed "
                         f"{float(ref[k]):.4f}, diff {diff[k]:+.4f})"
                         for k in EVAL_KEYS)
              + f"; t_compress={float(r['t_compress']):.2f} s "
              f"t_decompress={float(r['t_decompress']):.2f} s"
              + ("" if within else " OUTSIDE 1% bpp / 0.1 dB"), flush=True)
    print(f"[{tag}] {len(rows)} rows in {secs:.1f} s (frame, source "
          f"structures, codec and host metrics); columns equal the "
          f"committed test.csv's {len(cols)}; {outside} row(s) outside "
          f"1% bpp / 0.1 dB of the committed row", flush=True)


# -- phases 12-15: region-candidate training and the multi-device paths ------

# abl_region5's training keys (configs/ablation/abl_region5.yaml; a test
# holds them equal) over TRAIN_KEYS; the model is weights.ABL_REGION5_CONFIG
REGION_TRAIN_KEYS = {
    "experiment_name": "abl_region5",
    "min_points_train": 100,
    "transforms": {"train": {
        "1_ColorJitter": {"key": "ColorJitter"},
        "2_Rotate": {"key": "RandomRotate", "block_size": 64}}},
    "epochs": 40,
    "batch_size": 4,
    "scheduler_step_size": 150,
    "val_every": 0,
}
REGION_TRAIN_CUBE = 64
# the region fall gate: over REGION_FALL_STEPS steps on one fixed batch,
# the mean loss of the last REGION_FALL_WINDOW steps at most
# REGION_FALL_RATIO of the first's.  From the seeded init Adam's first
# update (about lr * sign(g) on every weight) raises the loss ~13% and it
# plateaus ~15 steps before it descends, so 20 steps first against last
# leaves a margin of a few percent
REGION_FALL_STEPS = 40
REGION_FALL_WINDOW = 10
REGION_FALL_RATIO = 0.9


def region_train_config(root):
    """abl_region5's training config with its data and results under
    ``root`` (TRAIN_KEYS without the flagship's bucketing and corner
    sampling, REGION_TRAIN_KEYS over them)."""
    cfg = train_config(root)
    del cfg["batch_bucketing"], cfg["q_map"]["corner_p"]
    cfg.update({k: (dict(v) if isinstance(v, dict) else v)
                for k, v in REGION_TRAIN_KEYS.items()})
    cfg["model"] = {k: dict(v) for k, v in ABL_REGION5_CONFIG.items()}
    return cfg


def run_region_train(smi):
    """Region-candidate training at abl_region5's widths (seeded init) on
    train frame 0 cut into 64^3 cubes, the packer's fullest batch of 4 at
    the trainer's auto capacity: the launches a step, every K1 dgrad and
    K1w call of one recorded step against its plain version (at least 3 of
    each on cross maps), whole-step gradients against plain autograd, and
    the loss on a fixed batch over REGION_FALL_STEPS steps (gated to fall
    by REGION_FALL_RATIO)."""
    from upcc_tpu_torch.training.trainer import Training
    tmp = tempfile.mkdtemp(prefix="upcc_region_train_")
    try:
        t0 = time.time()
        n_pts, n_cubes = make_train_data(tmp, REGION_TRAIN_CUBE)
        cfg = region_train_config(tmp)
        tr = Training(cfg, capacity="auto", device="cuda", renders=False)
        assert not tr.model.g_s.grand_finest
        batch = fullest_batches(tr)[0]
        st, root = tr.batch_tensors(batch)
        q, lam = tr.q_func.sample(torch.Generator().manual_seed(0),
                                  tr.batch_size)
        q, lam = q.cuda(), lam.cuda()
        gen = torch.Generator(device="cuda").manual_seed(0)
        print(f"[region train] {n_pts} points -> {n_cubes} cubes of "
              f"{REGION_TRAIN_CUBE}^3 ({len(tr.train_ds)} with >= "
              f"{cfg['min_points_train']} points); auto capacity "
              f"{tr.capacity}; fullest batch of {tr.batch_size}: "
              f"{int((batch[0] >= 0).sum())} points at capacity "
              f"{len(batch[0])}; set-up {time.time() - t0:.1f} s",
              flush=True)
        for _ in range(2):  # warm-up
            tr.step_fn(st, q, lam, root, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        with profiling.recording() as counts:
            for _ in range(TRAIN_TIMED_STEPS):
                t0 = time.perf_counter()
                met = tr.step_fn(st, q, lam, root, gen)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        launches = {k: v // TRAIN_TIMED_STEPS for k, v in
                    launch_counts(counts, kernels.SOURCES).items() if v}
        assert all(math.isfinite(float(v)) for v in met.values()), met
        for name in ("tap_gemm", "tap_wgrad", "topk_mask", "compact"):
            assert launches.get(name, 0) > 0, \
                f"region train: {name} was not launched"

        kernels.RECORD = {}
        tr.step_fn(st, q, lam, root, gen)
        record, kernels.RECORD = kernels.RECORD, None
        fwd = [c for c in record["tap_gemm"] if c[3].mirror_of is None]
        dgr = [c for c in record["tap_gemm"] if c[3].mirror_of is not None]
        wgr = record["tap_wgrad"]
        print(f"[region train] step ms over {TRAIN_TIMED_STEPS} steps: "
              f"median {float(np.median(times)):.1f} (min {min(times):.1f}, "
              f"max {max(times):.1f}); max_memory_allocated "
              f"{peak / 2**30:.2f} GiB; launches a step {launches}: K1 "
              f"{len(fwd)} forward + {len(dgr)} dgrad, K1w {len(wgr)}; loss "
              "parts " + ", ".join(f"{k}={float(v):.4f}"
                                    for k, v in met.items())
              + f" | {smi}", flush=True)
        assert len(fwd) + len(dgr) == launches["tap_gemm"]
        assert len(wgr) == launches["tap_wgrad"] == len(dgr) + 1

        # every K1w and K1 dgrad call against its plain version, counting
        # those over cross maps (the three region transposes and h_s's head)
        torch.set_grad_enabled(False)
        try:
            wg = {id(c[4]): c for c in wgr}
            cross = {"K1w": 0, "K1 dgrad": 0}
            worst = 0.0
            for flat, idx, ok, dacc, plan in wgr:
                got = F.tap_wgrad(flat, idx, ok, dacc, plan)
                ref = plan.blocks_of(F.tap_wgrad_plain(flat, idx, ok, dacc))
                err = float((got - ref).abs().max())
                rel = err / max(float(ref.abs().max()), 1e-30)
                assert err <= 1e-3 * float(ref.abs().max()) + 1e-5, \
                    "region train: K1w disagrees with its plain version"
                worst = max(worst, rel)
                cross["K1w"] += idx.shape[0] != flat.shape[0]
            for g, idx, ok, plan_t in dgr:
                flat, fidx, fok, dacc, plan = wg[id(plan_t.mirror_of)]
                got = F.tap_gemm(g, idx, ok, plan_t)
                ref = F.tap_dgrad_plain(dacc, fidx, fok, plan, flat.shape[0])
                err = float((got - ref).abs().max())
                assert err <= 1e-3 * float(ref.abs().max()) + 1e-5, \
                    "region train: K1 dgrad disagrees with its plain version"
                worst = max(worst, err / max(float(ref.abs().max()), 1e-30))
                cross["K1 dgrad"] += fidx.shape[0] != flat.shape[0]
        finally:
            torch.set_grad_enabled(True)
        del record, wg
        print(f"[region train] every K1w ({len(wgr)}) and K1 dgrad "
              f"({len(dgr)}) call within 1e-3 x max|plain| (worst "
              f"{worst:.3e}); on the cross maps: "
              + ", ".join(f"{k} {n} calls" for k, n in cross.items()),
              flush=True)
        assert cross["K1w"] >= 3 and cross["K1 dgrad"] >= 3
        del fwd, dgr, wgr

        check_step_gradients(tr, q, lam, "region train")

        # the training loss on one fixed batch over REGION_FALL_STEPS steps
        del tr
        tr = Training(cfg, capacity="auto", device="cuda", renders=False)
        trail = []
        for _ in range(REGION_FALL_STEPS):
            gen.manual_seed(1)
            trail.append({k: float(v) for k, v in
                          tr.step_fn(st, q, lam, root, gen).items()})
        w = REGION_FALL_WINDOW
        fall = np.mean([t["loss"] for t in trail[-w:]]) \
            / np.mean([t["loss"] for t in trail[:w]])
        print(f"[region train] on one fixed batch over {REGION_FALL_STEPS} "
              f"steps from the seeded init, by step: training loss "
              + " ".join(f"{t['loss']:.3f}" for t in trail)
              + "; RD loss (without aux) "
              + " ".join(f"{t['loss'] - t['aux_loss']:.3f}" for t in trail)
              + "; aux " + " ".join(f"{t['aux_loss']:.3f}" for t in trail)
              + "; parts at the first and last step: "
              + ", ".join(f"{k} {trail[0][k]:.4f} -> {trail[-1][k]:.4f}"
                          for k in trail[0])
              + f"; mean training loss of the last {w} steps over the first "
              f"{w}'s {fall:.4f} (at most {REGION_FALL_RATIO})", flush=True)
        assert all(math.isfinite(t["loss"]) for t in trail)
        assert fall <= REGION_FALL_RATIO, "region train: the loss did not fall"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def flagship_step(cfg, cls=None, **kw):
    """The trainer's seeded flagship model, loss and step class (default
    TrainStep) on the card, as Training builds them."""
    from upcc_tpu_torch.training.loss import Loss
    from upcc_tpu_torch.training.train_step import TrainStep
    torch.manual_seed(cfg.get("seed", 0))
    mcfg = dict(cfg["model"], max_batch=cfg["batch_size"])
    model = UnifiedModel(mcfg).cuda()
    return (cls or TrainStep)(model, Loss(cfg["loss"], cfg["batch_size"]),
                              cfg, **kw)


def batch_inputs(cfg, arrays):
    from upcc_tpu_torch.models.unified import host_root_maps
    keys, feats = arrays
    x = SparseTensor(torch.from_numpy(keys).cuda(),
                     torch.from_numpy(feats).cuda())
    return x, host_root_maps(keys, cfg["model"], "cuda")


def params_of(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def max_diff(a, b):
    return max(float((a[n].float() - b[n].float().to(a[n].device))
                     .abs().max()) for n in a)


def ulp(x):
    """One unit in the last place of the f32 value x >= 0."""
    m = torch.tensor(float(x))
    return float(torch.nextafter(m, torch.tensor(math.inf)) - m)


# the sequential steps whose largest pairwise difference is the spread,
# and the spreads a tolerance takes: a single pair's gradient difference
# moved 3.5x between runs (4.7e-10 to 1.6e-9), and a data-parallel step's
# reached 0.70 of twice the largest of three pairs' (1.6e-9 against
# 1.2e-9); the gates' bugs (a sum for a mean, a norm missing or doubling a
# part) move gradients or the norm by far more
SPREAD_RUNS = 3
TOL_SPREADS = 4
# the floor of a tolerance, in ulps of the tensor's largest |value|: one
# rounding moves a value by an ulp, and two sequential steps may agree to
# the bit; at a one-ulp floor the 1x2 step once passed at exactly 1.00
TOL_ULPS = 4


def tolerance_ratio(got, ref, spread):
    """The largest, over tensors, of max|got - ref| over the tensor's
    tolerance: TOL_SPREADS times ``spread`` (the largest difference
    between sequential steps), at least TOL_ULPS ulps of the tensor's
    largest |value|.  At most 1 passes."""
    return max(float((got[n].float().cpu() - r.float().cpu()).abs().max())
               / max(TOL_SPREADS * spread, TOL_ULPS * ulp(r.abs().max()))
               for n, r in ref.items())


def norm_ratio(got, ref, spread):
    """|got - ref| over the clip norm's tolerance, by the same rule."""
    return abs(got - ref) / max(TOL_SPREADS * spread, TOL_ULPS * ulp(ref))


def watch_clip(step):
    """Records where ``step`` clips, before its optimizer runs: every
    gradient the optimizer holds (``pre``, on the host, by parameter name;
    a sharded leaf's: this rank's slice) and the global norm it clips by
    (``norm``).  After Adam's first update a parameter has moved by about
    lr * sign(g), which shows neither the gradient's size nor the clip."""
    main, aux = ([n for n, _ in step.model.named_parameters()
                  if (n.split(".")[-1] == "quantiles") == is_aux]
                 for is_aux in (False, True))
    log = {}
    clip = step.clip_gradients

    def spy(params):
        groups = step.optimizer.param_groups
        log["pre"] = {n: t.grad.detach().cpu()
                      for names, g in zip((main, aux), groups)
                      for n, t in zip(names, g["params"])
                      if t.grad is not None}
        norm = clip(params)
        log["norm"] = float(norm)
        return norm
    step.clip_gradients = spy
    return log


def parallel_rank(rank, world, cfg, batches, q, lam, out):
    """A rank of [parallel dp] / [parallel 2d] (two gloo ranks on one
    card): 3 data-parallel steps on its own batch, then one 1x2 sharded
    step on batch 0.  Writes its results to <out>/rank<r>.pt."""
    import hashlib
    from upcc_tpu_torch.parallel import data_parallel as dp
    from upcc_tpu_torch.parallel.model_parallel import (ShardedTrainStep,
                                                        make_mesh_2d)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q, lam = q.cuda(), lam.cuda()
    step = flagship_step(cfg, dp.DataParallelStep)
    log = watch_clip(step)
    x, root = batch_inputs(cfg, batches[rank])
    times, res = [], {}
    for s in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(x, q, lam, root, dp.noise_generator("cuda", 0, s, rank))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if s == 0:
            res["after1"] = {n: p.cpu() for n, p in
                             params_of(step.model).items()}
            res["clip1"] = dict(log)
    h = hashlib.sha256()
    for t in step.model.state_dict().values():
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    res.update(hash=h.hexdigest(), times=times)
    del step
    torch.cuda.empty_cache()
    step = flagship_step(cfg, ShardedTrainStep, mesh=make_mesh_2d(1, 2))
    res["2d_clip"] = watch_clip(step)
    x, root = batch_inputs(cfg, batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(x, q, lam, root, dp.noise_generator("cuda", 0, 0, 0))
    torch.cuda.synchronize()
    res["2d_ms"] = (time.perf_counter() - t0) * 1e3
    full = step.full_parameters()
    res["2d"] = {n: p.cpu() for n, p in full.items()} if rank == 0 else None
    res["owned"] = step.owned_bytes()
    res["full_bytes"] = sum(p.numel() * p.element_size()
                            for p in full.values())
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def run_parallel_train(smi):
    """[parallel dp] and [parallel 2d] at flagship widths on [train]'s
    batch (and the next fullest, batch B).  SPREAD_RUNS sequential steps
    give the tolerances (``tolerance_ratio``: index_add_'s atomics leave a
    step nondeterministic at f32 rounding).  Gated where each step clips
    (``watch_clip``: its gradients and clip norm) and after the update: a
    data-parallel step at world size 1 on NCCL; two gloo ranks sharing
    cuda:0 on batches A and B against one in-process update on the mean of
    A's and B's gradients (``reference_step``), and bit-identical after 3
    steps; the 1x2 sharded step on two gloo ranks against the sequential
    step."""
    from upcc_tpu_torch.parallel import data_parallel as dp
    from upcc_tpu_torch.parallel import multihost
    from upcc_tpu_torch.parallel.model_parallel import sharded
    from upcc_tpu_torch.training.trainer import Training
    from upcc_tpu_torch.ops.sparse import voxelize_host_np
    tmp = tempfile.mkdtemp(prefix="upcc_parallel_")
    try:
        t0 = time.time()
        make_train_data(tmp)
        cfg = train_config(tmp)
        tr = Training(cfg, capacity="auto", device="cuda", renders=False)
        cap = tr.capacity
        batches = [voxelize_host_np(b, x, c, cap)
                   for b, x, c in fullest_batches(tr)[:2]]
        q, lam = tr.q_func.sample(torch.Generator().manual_seed(0),
                                  tr.batch_size)
        del tr
        gen = lambda s, shard: dp.noise_generator("cuda", 0, s, shard)
        xa, ra = batch_inputs(cfg, batches[0])
        xb, rb = batch_inputs(cfg, batches[1])
        qc, lc = q.cuda(), lam.cuda()
        print(f"[parallel dp] flagship widths, batches A and B of 8 cubes at "
              f"capacity {cap}: {int((batches[0][0] != C.SENTINEL).sum())} "
              f"and {int((batches[1][0] != C.SENTINEL).sum())} voxels; "
              f"set-up {time.time() - t0:.1f} s", flush=True)

        seq, seq_clip = [], []
        with profiling.recording() as counts:
            for _ in range(SPREAD_RUNS):
                step = flagship_step(cfg)
                seq_clip.append(watch_clip(step))
                step(xa, qc, lc, ra, gen(0, 0))
                seq.append(params_of(step.model))
                del step
        pairs = list(itertools.combinations(range(SPREAD_RUNS), 2))
        spread = max(max_diff(seq[i], seq[j]) for i, j in pairs)
        gspread = max(max_diff(seq_clip[i]["pre"], seq_clip[j]["pre"])
                      for i, j in pairs)
        nspread = max(abs(seq_clip[i]["norm"] - seq_clip[j]["norm"])
                      for i, j in pairs)
        assert seq_clip[0]["norm"] > cfg["clip_grad_norm"], \
            "parallel dp: the clip does not bind"

        def clip_ratios(log, ref):
            """(gradient, norm) ratios of a clip record to ``ref``'s."""
            return (tolerance_ratio(log["pre"], ref["pre"], gspread),
                    norm_ratio(log["norm"], ref["norm"], nspread))
        launches = launch_counts(counts, kernels.SOURCES)
        for name in ("tap_gemm", "tap_wgrad", "topk_mask", "compact"):
            assert launches[name] > 0, f"parallel dp: {name} not launched"

        # world size 1 on NCCL
        multihost.initialize(f"tcp://localhost:{multihost.free_port()}", 1,
                             0, device="cuda")
        try:
            assert torch.distributed.get_backend() == "nccl"
            step = flagship_step(cfg, dp.DataParallelStep)
            log = watch_clip(step)
            step(xa, qc, lc, ra, gen(0, 0))
            got = params_of(step.model)
            nccl = (max_diff(got, seq[0]), tolerance_ratio(got, seq[0],
                                                           spread),
                    *clip_ratios(log, seq_clip[0]))
            del step, got, log
        finally:
            torch.distributed.destroy_process_group()
        print(f"[parallel dp] tolerances, each {TOL_SPREADS} times the "
              f"largest difference between {SPREAD_RUNS} sequential steps "
              f"on batch A, at least "
              f"{TOL_ULPS} ulp "
              f"of the tensor's largest |value|: the gradients where the "
              f"step clips, before the optimizer ({gspread:.3e}), the clip "
              f"norm {seq_clip[0]['norm']:.6g} (clip "
              f"{cfg['clip_grad_norm']}; {nspread:.3e}), the parameters "
              f"after the update ({spread:.3e}); the data-parallel step at "
              f"world size 1 on NCCL: gradients {nccl[2]:.3f}, norm "
              f"{nccl[3]:.3f}, parameters {nccl[1]:.3f} of a tolerance "
              f"(parameters differ by {nccl[0]:.3e})", flush=True)
        assert max(nccl[1:]) <= 1, "parallel dp: the NCCL step disagrees"

        # the in-process reference of two ranks on A and B
        step = flagship_step(cfg)
        ref_ab_clip = watch_clip(step)
        dp.reference_step(step, [(xa, qc, lc, ra, gen(0, 0)),
                                 (xb, qc, lc, rb, gen(0, 1))])
        ref_ab = params_of(step.model)
        del step, xa, xb, ra, rb
        torch.cuda.empty_cache()

        t0 = time.time()
        multihost.spawn(parallel_rank, 2, (cfg, batches, q, lam, tmp),
                        device="cuda:0", backend="gloo", timeout=600)
        secs = time.time() - t0
        out = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                          weights_only=False) for r in range(2)]
        dp_diff = (max_diff(out[0]["after1"], ref_ab),
                   tolerance_ratio(out[0]["after1"], ref_ab, spread))
        dp_clip = [clip_ratios(o["clip1"], ref_ab_clip) for o in out]
        print(f"[parallel dp] two gloo ranks sharing cuda:0 (two processes "
              f"on one card, not a multi-GPU speed): step ms rank 0 "
              + " ".join(f"{t:.1f}" for t in out[0]["times"]) + ", rank 1 "
              + " ".join(f"{t:.1f}" for t in out[1]["times"])
              + "; first step on A and B against the in-process "
              f"mean-gradient update: gradients where each rank clips "
              + " / ".join(f"{g:.3f}" for g, _ in dp_clip)
              + ", norm " + " / ".join(f"{n:.3f}" for _, n in dp_clip)
              + f", parameters {dp_diff[1]:.3f} of a tolerance (differ by "
              f"{dp_diff[0]:.3e}); after 3 steps the two state_dicts' "
              f"sha256 {out[0]['hash'][:16]} / {out[1]['hash'][:16]}; "
              f"spawned ranks {secs:.1f} s", flush=True)
        assert max(dp_diff[1], *(v for r in dp_clip for v in r)) <= 1, \
            "parallel dp: the gloo step disagrees"
        assert out[0]["hash"] == out[1]["hash"], \
            "parallel dp: the replicas differ after 3 steps"

        d2 = (max_diff(out[0]["2d"], seq[0]),
              tolerance_ratio(out[0]["2d"], seq[0], spread))
        d2_clip = []
        for r, o in enumerate(out):  # rank r holds slice r of the sharded
            ref = {n: g[..., r * (g.shape[-1] // 2):
                        (r + 1) * (g.shape[-1] // 2)]
                   if sharded(g.shape, 2) else g
                   for n, g in seq_clip[0]["pre"].items()}
            d2_clip.append(clip_ratios(o["2d_clip"],
                                       {"pre": ref,
                                        "norm": seq_clip[0]["norm"]}))
        for r, o in enumerate(out):
            params, moments = o["owned"]
            print(f"[parallel 2d] 1x2 sharded step, rank {r}: parameter "
                  f"bytes {params / 2**20:.2f} MiB, Adam moment bytes "
                  f"{moments / 2**20:.2f} MiB (whole model "
                  f"{o['full_bytes'] / 2**20:.2f} MiB); step "
                  f"{o['2d_ms']:.1f} ms (two processes on one card)",
                  flush=True)
            assert params < 0.6 * o["full_bytes"]
        print(f"[parallel 2d] against the 1x1 (sequential) step, by "
              f"[parallel dp]'s tolerances: each rank's gradient slices "
              f"where it clips " + " / ".join(f"{g:.3f}" for g, _ in d2_clip)
              + ", the norm it clips by "
              + " / ".join(f"{n:.3f}" for _, n in d2_clip)
              + f", the gathered parameters after the step {d2[1]:.3f} of a "
              f"tolerance (differ by {d2[0]:.3e})", flush=True)
        assert max(d2[1], *(v for r in d2_clip for v in r)) <= 1, \
            "parallel 2d: the sharded step disagrees"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


PARALLEL_CODEC_GROUP = 3
PARALLEL_CODEC_QS = [(0.5, 0.5), (0.1, 0.9)]


def run_parallel_codec(frame):
    """[parallel codec]: the flagship codec with devices=["cuda:0",
    "cuda:0"] (two workers, one replica) on the vox10 frame at block 512,
    MAX_GROUP lowered to 3 for the phase: bytes, decode and compress_multi
    equal to the sequential codec's; 19/3/4 launches a group."""
    from upcc_tpu_torch.codec import codec as codec_mod
    model = load_weights(UnifiedModel(FLAGSHIP_CONFIG), WEIGHTS)
    seq = Codec(model, device="cuda")
    seq.update()
    par = Codec(model, devices=["cuda:0", "cuda:0"])
    par.update()
    saved = codec_mod.MAX_GROUP
    codec_mod.MAX_GROUP = PARALLEL_CODEC_GROUP
    try:
        q, q2 = PARALLEL_CODEC_QS
        t0 = time.time()
        ref = seq.compress(frame, q, block_size=512)
        ref2 = seq.compress(frame, q2, block_size=512)
        rec_ref = seq.decompress(ref)
        t_seq = time.time() - t0
        n_enc = len(par._partition_blocks(frame, 512, 1.0)[0])
        n_dec = len(codec_mod._chunk_decode_groups(
            bitstream.read_container(ref)[0]))
        torch.cuda.synchronize()
        with profiling.recording() as counts:
            t0 = time.time()
            data = par.compress(frame, q, block_size=512)
            rec = par.decompress(data)
            torch.cuda.synchronize()
            t_par = time.time() - t0
        launches = launch_counts(counts, CODEC_KERNELS)
        multi = par.compress_multi(frame, [q, q2], block_size=512)
    finally:
        codec_mod.MAX_GROUP = saved
    want = {"tap_gemm": 8 * n_enc + 11 * n_dec, "topk_mask": 3 * n_dec,
            "compact": n_enc + 3 * n_dec}
    print(f"[parallel codec] devices ['cuda:0', 'cuda:0'] (2 workers, "
          f"{len(par._replicas)} replica), block 512, MAX_GROUP "
          f"{PARALLEL_CODEC_GROUP}: {n_enc} encode and {n_dec} decode "
          f"groups; compress + decompress {t_par:.2f} s (sequential codec, "
          f"two q's and a decode: {t_seq:.2f} s); launches {launches} "
          f"(19/3/4 a group: K1 8 and K3 1 an encode, K1 11 and K3 3 "
          f"a decode pass); "
          f"{len(data)} bytes", flush=True)
    assert data == ref, "parallel codec: bytes differ from sequential"
    assert np.array_equal(rec, rec_ref), "parallel codec: decode differs"
    assert [bytes(m) for m in multi] == [ref, ref2], \
        "parallel codec: compress_multi differs from independent compresses"
    assert launches == want, (launches, want)
    print("[parallel codec] bytes, decode and compress_multi at two q's "
          "equal to the sequential codec's", flush=True)


def run_parallel(smi, frame):
    """Phases 12-15, each with its seconds."""
    for name, fn in (("region train", lambda: run_region_train(smi)),
                     ("parallel dp + 2d", lambda: run_parallel_train(smi)),
                     ("parallel codec", lambda: run_parallel_codec(frame))):
        t0 = time.time()
        fn()
        print(f"[{name}] phase seconds {time.time() - t0:.1f}", flush=True)


# -- phases 16-17: the oracle hooks and the host-coder twins ------------------

ORACLE_CUBES = 8
ORACLE_CAPACITY = 131_072  # the cubes that fit 0.9 x this go in
# the forward's capacity: g_a keeps 0.5, 0.25, 0.125 x capacity points at
# strides 2, 4, 8, and this frame's scan-like shells keep 0.74 of their
# points at stride 2 (86,887 of the 117,963 above), so at 131,072 g_a cuts
# the batch's tail cubes and neither the GT nor sum k[2] can be reached
ORACLE_BATCH_CAPACITY = 262_144
ORACLE_Q = 1.0
# a slack past every GT count, so the oracle levels' tie-fill reaches into
# the -1 candidates
ORACLE_SLACK = (1.5, 1.25)
TWIN_SEED, TWIN_EXTENT, TWIN_POINTS = 2024, 128, 6000  # the JAX fixture's
TWIN_Q, TWIN_BLOCK = (0.5, 0.5), 128


def oracle_k2_calls(record, levels):
    """Every recorded K2 call of an oracle level (the forward's calls are
    its levels 0, 1, 2 in order) held bit for bit against topk_mask_plain
    on the same +-1 input; per oracle level (kept, +1 candidates)."""
    calls = record.get("topk_mask", [])
    assert len(calls) == 3, f"{len(calls)} K2 calls in an oracle forward"
    out = []
    for lvl in levels:
        keys, logits, k32 = calls[lvl]
        assert bool(((logits == 1) | (logits == -1)).all()), \
            f"level {lvl} logits are not the oracle's +-1"
        ref = topk_mask_plain(keys, logits, k32)
        got = topk_mask(SparseTensor(keys, logits[:, None]), logits, k32)
        assert torch.equal(got, ref), \
            f"K2 at oracle level {lvl} differs from topk_mask_plain"
        out.append((int(got.sum()),
                    int(((logits == 1) & (keys != C.SENTINEL)).sum())))
    return out


def run_oracle(smi):
    """Phase 16: the geometry-attribution driver's forward on the card
    (the flagship uncut, the committed weights, train frame 0's fullest
    128^3 cubes), gated: the full oracle reconstructs the GT keys, every
    configuration decodes sum k[2] points, K1/K2/K3 launch as often as in
    the non-oracle forward, and every K2 call at an oracle level equals
    its plain version bit for bit, at the flagship's slack and at
    ORACLE_SLACK."""
    from upcc_tpu_torch import diag_geometry as DG
    t0 = time.time()
    xyz, rgb = train_frame()
    items = DG.select_cubes(xyz, rgb, ORACLE_CUBES, ORACLE_CAPACITY)
    model = load_weights(UnifiedModel(dict(FLAGSHIP_CONFIG,
                                           max_batch=ORACLE_CUBES)),
                         WEIGHTS).to("cuda").eval()
    st, rn, gt = DG.batch_inputs(items, ORACLE_BATCH_CAPACITY, model.config,
                                 "cuda")
    q = torch.full((len(items), 2), ORACLE_Q, device="cuda")
    pyramid, lv = [], gt
    for _ in range(3):
        lv = np.unique(((lv & C.KEY_MASK) >> 3) | (lv & ~C.KEY_MASK))
        pyramid.append(len(lv))
    caps = [int(f * ORACLE_BATCH_CAPACITY) for f in model.g_a.cap_factors]
    print(f"[oracle] {len(items)} cubes of {DG.CUBE}^3 that fit 0.9 x "
          f"{ORACLE_CAPACITY}: {len(gt)} points at capacity "
          f"{ORACLE_BATCH_CAPACITY}, q = {ORACLE_Q} (cube sizes "
          f"{[len(c[0]) for c in items]}; points at strides 2, 4, 8 "
          f"{pyramid} against g_a's caps {caps}); set-up "
          f"{time.time() - t0:.1f} s", flush=True)
    assert all(n <= c for n, c in zip(pyramid, caps)), "g_a cuts the batch"
    flagship_slack = model.g_s.prune_slack
    try:
        for slack in (flagship_slack, ORACLE_SLACK):
            model.g_s.prune_slack = slack
            DG.oracle_forward(model, st, q, rn, ())  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = None
            reached = False
            for levels in DG.ORACLE_CONFIGS:
                kernels.RECORD = {}
                try:
                    with profiling.recording() as counts:
                        out = DG.oracle_forward(model, st, q, rn, levels)
                        torch.cuda.synchronize()
                    record = kernels.RECORD
                finally:
                    kernels.RECORD = None
                launches = launch_counts(counts, CODEC_KERNELS)
                if base is None:
                    base = launches
                assert launches == base, \
                    f"oracle {levels}: launches {launches} != {base}"
                pk = out["prediction"].keys
                pk = pk[pk != C.SENTINEL].cpu().numpy()
                k2 = int(out["k"][2].sum())
                assert len(pk) == k2, f"oracle {levels}: {len(pk)} != {k2}"
                if levels == (0, 1, 2):
                    assert np.array_equal(np.sort(pk), gt), \
                        "the full oracle did not reconstruct the GT keys"
                fills = oracle_k2_calls(record, levels)
                reached |= any(kept > pos for kept, pos in fills)
                del out, record
                print(f"[oracle] slack {tuple(slack)} levels {levels}: "
                      f"launches {launches}; decoded {len(pk)} = sum k[2]; "
                      f"K2 at oracle levels bit-equal to plain, (kept, +1 "
                      f"candidates) {fills}", flush=True)
            print(f"[oracle] slack {tuple(slack)}: max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
                  flush=True)
            if slack == ORACLE_SLACK:
                assert reached, "the slack never filled into the -1 ties"
    finally:
        model.g_s.prune_slack = flagship_slack

    res = DG.attribute(model, items, ORACLE_BATCH_CAPACITY, ORACLE_Q, "cuda")
    for lvl, r in enumerate(res["levels"]):
        print(f"[oracle] level {lvl}: ranking precision "
              f"{r['precision']:.4f} (candidates {r['candidates']}, k "
              f"{r['k']})", flush=True)
    assert res["configs"][(0, 1, 2)]["equals_gt"]
    for levels, r in res["configs"].items():
        assert r["decoded"] == r["k2"]
        print(f"[oracle] oracle {str(levels):10s}: D1 {r['psnr']:.2f} dB "
              f"(mse {r['mse']:.4f}, {r['decoded']} points) | {smi}",
              flush=True)
    del model, st, rn
    torch.cuda.empty_cache()


def run_twins(codec):
    """Phase 17: the four native host libraries loaded, and with each
    forced off (its Python or numpy twin instead) the containers of the
    JAX fixture's frame byte-identical in both geometry modes and decoded
    to the same points."""
    from upcc_tpu_torch.coding import occ, octree, rans
    libs = [(rans, "_lib", rans._load), (octree, "_lib", octree._load),
            (occ, "_lib", occ._load),
            (sparse, "_vox_lib", sparse._load_voxelize)]
    for mod, name, load in libs:
        assert load(), f"{mod.__name__}: the native library did not load"
    xyz, rgb = surface_cloud(np.random.default_rng(TWIN_SEED),
                             extent=TWIN_EXTENT, n_target=TWIN_POINTS)
    frame = np.concatenate([xyz.astype(np.float32), rgb], 1)
    for geom in ("topk", "coded"):
        data = codec.compress(frame, TWIN_Q, block_size=TWIN_BLOCK, geom=geom)
        rec = codec.decompress(data)
        for mod, name, _ in libs:
            setattr(mod, name, False)
        try:
            tdata = codec.compress(frame, TWIN_Q, block_size=TWIN_BLOCK,
                                   geom=geom)
            trec = codec.decompress(data)
        finally:
            for mod, name, load in libs:
                setattr(mod, name, None)
                load()
        assert tdata == data, f"{geom}: twins wrote other bytes"
        assert np.array_equal(trec, rec), \
            f"{geom}: the twins decoded other points"
        print(f"[twins] {geom}: {len(frame)} points, {len(data)} B "
              f"byte-identical, decoded {len(rec)} points identical",
              flush=True)
    for mod, name, load in libs:
        assert load(), f"{mod.__name__}: the native library did not reload"


# -- phase 18: the benchmark protocol, the graft forward ----------------------

# launches of the graft entry's training-mode forward: its 18 tap layers,
# g_s's 3 top-k prunes and 5 compactions (the non-oracle forward of [oracle])
GRAFT_LAUNCHES = {"tap_gemm": 18, "topk_mask": 3, "compact": 5}


def run_bench():
    """``upcc_tpu_torch.bench`` in process (its lines printed under
    ``[bench]``), the vox11 warm-up's recorded kernel calls against their
    plain versions, the graft entry's forward at full width, and spawn's
    refusal of more ranks than cards."""
    import contextlib
    import io
    from upcc_tpu_torch import bench, graft_entry
    from upcc_tpu_torch.parallel import multihost
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            res = bench.run(device="cuda", keep_record=True)
    finally:
        for line in buf.getvalue().splitlines():
            print(f"[bench] {line}", flush=True)

    # the vox11 frame's kernel calls (K1, K2, K3) against their plain
    # versions
    convs = [m for m in res["codec"].model.modules()
             if isinstance(m, _TapConv)]
    layer_of = {id(plan): (m, kind) for m in convs
                for kind, (_, plan) in m._plans.items()}
    record = res.pop("record") or {}
    check_recorded(record, layer_of, tag="vox11", profile=False)
    del res, record, layer_of, convs
    torch.cuda.empty_cache()

    # the graft entry's training-mode forward at the flagship's widths
    fn, args = graft_entry.entry(device="cuda")
    torch.cuda.synchronize()
    with profiling.recording() as counts:
        t0 = time.time()
        feats, lik_y = fn(*args)
        torch.cuda.synchronize()
        secs = time.time() - t0
    launches = launch_counts(counts, CODEC_KERNELS)
    assert torch.isfinite(feats).all() and torch.isfinite(lik_y).all()
    assert launches == GRAFT_LAUNCHES, (launches, GRAFT_LAUNCHES)
    print(f"[graft] entry() forward: prediction feats {tuple(feats.shape)}, "
          f"y likelihoods {tuple(lik_y.shape)} finite; launches {launches}; "
          f"{secs * 1e3:.1f} ms (first call)", flush=True)
    del fn, args, feats, lik_y

    # spawn refuses more ranks than cards before starting any process
    cards = torch.cuda.device_count()
    try:
        multihost.spawn(len, cards + 1, device="cuda")
    except RuntimeError as exc:
        assert "CUDA device" in str(exc), exc
        print(f"[bench] spawn of {cards + 1} ranks on {cards} card(s) "
              f"refused before any process: {exc}", flush=True)
    else:
        raise AssertionError("spawn started more ranks than cards")


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
    if "--bench" in sys.argv[1:]:
        t0 = time.time()
        run_bench()
        print(f"[bench] phase seconds {time.time() - t0:.1f}", flush=True)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--eval-all" in sys.argv[1:]:
        t0 = time.time()
        run_eval(EVAL_ALL_SEQUENCES, tag="eval all")
        run_eval(EVAL_NO_RESID, tag="eval no resid", qs=[(0.5, 0.5)],
                 color_resid=False)
        print(f"[eval all] phase seconds {time.time() - t0:.1f}", flush=True)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--oracle" in sys.argv[1:]:
        run_oracle(smi)
        codec = Codec(load_weights(UnifiedModel(FLAGSHIP_CONFIG), WEIGHTS),
                      device="cuda")
        codec.update()
        run_twins(codec)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--parallel" in sys.argv[1:]:
        xyz, rgb = surface_cloud(np.random.default_rng(10), extent=1024,
                                 n_target=760_000)
        run_parallel(smi, np.concatenate([xyz.astype(np.float32), rgb], 1))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    check_tap_wgrad(gen)
    if "--train" in sys.argv[1:]:
        run_train(smi)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
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

    # the frame again, its launches and preparations counted by the tracer
    torch.cuda.reset_peak_memory_stats()
    with profiling.recording() as counts:
        t0 = time.time()
        data = codec.compress(frame, q, block_size=1024)
        t_enc = time.time() - t0
        t0 = time.time()
        rec = codec.decompress(data)
        torch.cuda.synchronize()
        t_dec = time.time() - t0
    launches = launch_counts(counts, CODEC_KERNELS)
    peak = torch.cuda.max_memory_allocated()
    blocks, _ = bitstream.read_container(data)
    k_sum = sum(b["k"][2] for b in blocks)
    assert rec.shape[0] == k_sum, (rec.shape, k_sum)
    assert np.isfinite(rec).all() and rec.shape[1] == 6
    for name in CODEC_KERNELS:
        assert launches[name] > 0, \
            f"kernel {name} was not launched on the main path"
    assert launches == TOPK_LAUNCHES, (launches, TOPK_LAUNCHES)
    assert counts.total("taps.prepared") == 0, \
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

    # 4. recorded main-path calls against their plain versions
    layer_of = {id(plan): (m, kind) for m in convs
                for kind, (_, plan) in m._plans.items()}
    check_recorded(record, layer_of)
    del record, layer_of

    # 8. the JAX-written stream on the card, 9. region-candidate g_s
    f32_codec = Codec(load_weights(UnifiedModel(FLAGSHIP_CONFIG), WEIGHTS),
                      device="cpu")
    f32_codec.update()
    print(jax_stream_report(codec, f32_codec), flush=True)
    del f32_codec
    run_region(frame, q)

    # 5. the probe entry points and their two kernels
    launches.update(run_probes())

    # 6. the lossless path, 7. simulcast, streaming, color refit
    run_coded(codec, frame, q, 1024, check_k3=True)
    run_coded(codec, frame, q, 512)
    run_serving(codec, frame, data)

    # 10. the evaluation driver against the committed RD rows
    run_eval()

    # 11. the flagship's training step (K1 forward and dgrad, K1w, K2, K3)
    launches["tap_wgrad"] = run_train(smi)["tap_wgrad"]

    # 12-15. region-candidate training and the multi-device paths
    run_parallel(smi, frame)

    # 16-17. the oracle hooks on the card, the host-coder twins;
    # 18. the benchmark protocol and the graft forward
    for name, fn in (("oracle", lambda: run_oracle(smi)),
                     ("twins", lambda: run_twins(codec)),
                     ("bench", run_bench)):
        t0 = time.time()
        fn()
        print(f"[{name}] phase seconds {time.time() - t0:.1f}", flush=True)

    for name in kernels.SOURCES:
        assert launches[name] > 0, f"kernel {name} was launched on no path"
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
