#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``upcc_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # the whole check, one card
    python3 chip_smoke.py --kernels  # build + kernel checks only

Phases, each printing its lines; any failure raises and exits non-zero:
  1. the card's name and power limit (nvidia-smi); build the CUDA kernels
     (one nvcc per source, in parallel) and print the build seconds;
  2. every kernel against its plain PyTorch version on edge-case inputs:
     K1 tap_gemm at each caller layout (f32 tolerance below), K2 topk_mask
     and K3 compact (exact), P1 tile_tapconv in both operand types
     (tolerances at P1_TOL) and P2 window_gather_sum (exact);
  3. the codec's main path at full width: the committed epoch-193 flagship
     weights, the vox10-scale synthetic frame (760k points), compress ->
     decompress at q=(0.5, 0.5), block 1024 (once recording every kernel
     call's inputs, once timed with the launch counts zeroed just before),
     then block 512 (an 8-block group); checks encoder/decoder bit-exactness,
     the decoded count against the transmitted k, and that every kernel
     launched;
  4. every recorded main-path kernel call against its plain version, timed
     (kernel, plain, one library call as yardstick) beside its roofline
     bound;
  5. the two probe entry points (upcc_tpu_torch.probes) at their published
     shapes, launch counts zeroed just before; then P1 and P2 on the same
     full arrays against their plain versions, timed beside a library call
     and the bound;
  6. the lossless path at full width: compress(geom="coded") -> decompress
     at block 1024 and block 512; every stage's context bins equal on both
     sides, the decoded voxel set equal to the input's, K1 and K3 launched;
     stage times, bpp with the occupancy streams' share, peak memory;
  7. compress_multi at three q's and compress_stream / decompress_stream
     at depth 2 over three frames, byte-identical to the sequential calls
     and timed beside them; refit_colors (affine + residual layer) with
     decompress(new container) equal to the returned reconstruction.
The last three lines are the nvidia-smi line, the kernels JSON line and
the result line {"ok": true, "device": {...}}.

K1 tolerance: the kernel and the plain version both multiply the same
bf16-rounded operands exactly and sum in f32 in different orders, so
max|kernel - plain| <= 1e-3 * max|plain| + 1e-5.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from upcc_tpu_torch import kernels
from upcc_tpu_torch.codec import bitstream
from upcc_tpu_torch.codec.codec import Codec
from upcc_tpu_torch.data.synthetic import surface_cloud
from upcc_tpu_torch.eval.metrics import pc_metrics
from upcc_tpu_torch.models.unified import UnifiedModel
from upcc_tpu_torch.ops import coords as C
from upcc_tpu_torch.ops import family as F
from upcc_tpu_torch.ops.probe_kernels import (tile_tapconv,
                                              tile_tapconv_plain,
                                              window_gather_sum,
                                              window_gather_sum_plain)
from upcc_tpu_torch.ops.sparse import SparseTensor, compact, compact_plain
from upcc_tpu_torch.ops.topk import topk_mask, topk_mask_plain
from upcc_tpu_torch.probes import (PEAK_BF16, PEAK_BYTES, PEAK_TF32,
                                   micro_gather, window_gather)
from upcc_tpu_torch.weights import FLAGSHIP_CONFIG, load_weights

HERE = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(HERE, "results", "CVPR_inverse_scaling",
                       "weights_bf16.msgpack")
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


# -- phase 2: kernels on edge-case inputs ------------------------------------

def check_tap_gemm(gen):
    dev = "cuda"

    def case(name, rows, n_src, w):
        idx = torch.randint(0, n_src + 64, (rows, 27), generator=gen,
                            device=dev, dtype=torch.int32)  # some clipped
        ok = torch.rand((rows, 27), generator=gen, device=dev) < 0.8
        ok[: rows // 16] = False  # rows that read nothing
        flat = torch.randn((n_src, w.shape[1]), generator=gen,
                           device=dev).to(torch.bfloat16)
        w = w.to(torch.bfloat16).contiguous()
        got = F.tap_gemm(flat, idx, ok, w)
        ref = F.tap_gemm_plain(flat, idx, ok, w)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tol = 1e-3 * float(ref.abs().max()) + 1e-5
        print(f"[k1] {name}: rows={rows} K_in={w.shape[1]} "
              f"K_out={w.shape[2]} max_abs_err={err:.3e} tol={tol:.3e}",
              flush=True)
        assert err <= tol, f"tap_gemm {name} disagrees with its plain version"

    def rw(taps, cin, cout):
        return torch.randn((taps, cin, cout), generator=gen, device=dev) \
            * (1.0 / (taps * cin)) ** 0.5

    case("family_conv k3 1024->512", 3000, 2500,
         F._expanded_weights(rw(27, 128, 64), 3))
    case("family_conv k5 1024->1024", 2048, 2048,
         F._expanded_weights(rw(125, 128, 128), 5))
    case("family_conv k3 512->8", 1500, 1200,
         F._expanded_weights(rw(27, 64, 1), 3))
    case("family_conv k3 1536->2048 (hs3)", 1024, 4096,
         F._expanded_weights(rw(27, 192, 256), 3))
    case("family_down_conv k5 1024->128", 2000, 2000,
         F._gather_taps(rw(125, 128, 128), F._table(
             "down_tap", torch.device(dev), 5)).reshape(27, 1024, 128))
    case("family_down_conv k3 1536->192", 777, 900,
         F._gather_taps(rw(27, 192, 192), F._table(
             "down_tap", torch.device(dev), 3)).reshape(27, 1536, 192))
    wt = F._gather_taps(rw(125, 128, 128), F._table("transpose_tap",
                                                   torch.device(dev)))
    case("family_transpose_up k5 128->1024", 4100, 4000,
         wt.permute(0, 2, 1, 3).reshape(27, 128, 1024))
    for mode, ks, cin, cout in (("down", 5, 4, 128), ("transpose", 5, 128, 32),
                                ("conv", 3, 32, 16), ("conv", 3, 16, 1)):
        w = F.grand_expand_weights(rw(ks ** 3, cin, cout), ks, mode,
                                   torch.float32)
        case(f"grand {mode} {w.shape[1]}->{w.shape[2]}", 1000, 1000, w)


def check_topk(gen):
    dev = "cuda"

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
        kt = torch.tensor(k, dtype=torch.int32, device=dev)
        got = topk_mask(SparseTensor(keys, logits[:, None]), logits, kt)
        ref = topk_mask_plain(keys, logits, kt)
        torch.cuda.synchronize()
        nbad = int((got != ref).sum())
        print(f"[k2] {name}: n={keys.shape[0]} batches={len(counts)} "
              f"kept={int(got.sum())} mismatches={nbad}", flush=True)
        assert nbad == 0, f"topk_mask {name} differs from its plain version"

    counts = torch.randint(1, 40000, (63,), generator=gen,
                           device=dev).tolist()
    k = [int(c * f) for c, f in zip(counts, torch.rand(
        63, generator=gen, device=dev).tolist())]
    k[0], k[1], k[2], k[3] = 0, counts[1], counts[2] + 5, -3
    case("63 batches, k=0, k=count, k>count, k<0", counts, k + [0], 4.0)
    case("one batch, coarse ties", [300000], [123457], 1.0)
    case("tie-heavy 8 batches", [5000] * 8, [2500] * 8, 0.5)


def check_compact(gen):
    dev = "cuda"
    for n, m, p in ((1 << 21, 700000, 0.5), (100003, 2048, 0.9),
                    (5000, 6000, 0.3)):
        keys = torch.sort(torch.randint(0, 1 << 50, (n,), generator=gen,
                                        device=dev)).values
        keys[-n // 10:] = C.SENTINEL
        keep = torch.rand(n, generator=gen, device=dev) < p
        pay = (torch.randn((n, 128), generator=gen, device=dev),
               torch.randn((n, 32), generator=gen, device=dev)
               .to(torch.bfloat16),
               torch.randint(0, 1 << 30, (n,), generator=gen, device=dev,
                             dtype=torch.int32),
               torch.rand((n, 3), generator=gen, device=dev) < 0.5)
        got = compact(keys, keep, *pay, out_capacity=m)
        ref = compact_plain(keys, keep, *pay, out_capacity=m)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        print(f"[k3] n={n} m={m} kept={int(keep.sum())} payloads=4 "
              f"equal={same}", flush=True)
        assert same, "compact differs from its plain version"


# P1 tolerances, as a share of max|plain|.  bf16 operands: kernel and plain
# version multiply the same values exactly and sum in f32 in another order.
# f32 operands: the kernel rounds both operands to TF32 (relative 2^-11
# each), the plain version multiplies in full f32; over a sum of 27 * K_in
# products of random sign that is a few 1e-4 of the largest output.
P1_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-3}


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


def check_window_gather(gen):
    dev = "cuda"
    for tiles, s_rows, k in ((1, 4096, 512), (3, 1000, 64), (2, 37, 12)):
        win = torch.randn((tiles, s_rows, k), generator=gen, device=dev)
        idx = torch.randint(0, s_rows, (tiles, 27, s_rows), generator=gen,
                            device=dev, dtype=torch.int32)
        idx[:, 5] = idx[:, 6]  # repeated indices
        idx[:, :, ::7] = 0
        got = window_gather_sum(win, idx)
        ref = window_gather_sum_plain(win, idx)
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        print(f"[p2] tiles={tiles} window={s_rows} K={k}: equal={same} "
              f"(tolerance: exact)", flush=True)
        assert same, "window_gather_sum differs from its plain version"


# -- phase 4: recorded main-path calls ---------------------------------------

def measure_recorded(record):
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

    for flat, idx, ok, w in record.get("tap_gemm", []):
        got = F.tap_gemm(flat, idx, ok, w)
        ref = F.tap_gemm_plain(flat, idx, ok, w)
        err = float((got - ref).abs().max())
        tol = 1e-3 * float(ref.abs().max()) + 1e-5
        assert err <= tol, "tap_gemm disagrees with its plain version on " \
            "a main-path call"
        del got, ref
        t_k = cuda_time(lambda: F.tap_gemm(flat, idx, ok, w), 5)
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
        print(f"[k1 main] rows={rows_} K_in={w.shape[1]} K_out={w.shape[2]} "
              f"err={err:.3e} kernel={t_k:.3f} ms plain={t_p:.3f} ms "
              f"matmul={t_l:.3f} ms bound={bound_ms(nbytes, flops)[0]:.4f} ms",
              flush=True)
        add("tap_gemm", err, t_k, t_p, t_l, nbytes, flops)

    for keys, logits, k in record.get("topk_mask", []):
        st = SparseTensor(keys, logits[:, None])
        got = topk_mask(st, logits, k)
        ref = topk_mask_plain(keys, logits, k)
        assert torch.equal(got, ref), "topk_mask differs on a main-path call"
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
        print(f"[k2 main] n={n} kernel={t_k:.3f} ms plain={t_p:.3f} ms "
              f"torch.topk={t_l:.3f} ms bound={bound_ms(nbytes, 0)[0]:.4f} ms",
              flush=True)
        add("topk_mask", 0.0, t_k, t_p, t_l, nbytes, 0)

    for keys, keep, arrays, m in record.get("compact", []):
        got = compact(keys, keep, *arrays, out_capacity=m)
        ref = compact_plain(keys, keep, *arrays, out_capacity=m)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), \
            "compact differs on a main-path call"
        t_k = cuda_time(lambda: compact(keys, keep, *arrays,
                                        out_capacity=m), 10)
        t_p = cuda_time(lambda: compact_plain(keys, keep, *arrays,
                                              out_capacity=m), 3)
        t_l = cuda_time(lambda: keys[keep], 10)
        n = keys.shape[0]
        row = sum(a[0].numel() * a.element_size() for a in arrays) if n else 0
        # the function needs keep, the kept rows (up to m) and the m outputs
        kept = min(int(keep.sum()), m)
        nbytes = n + kept * (8 + row) + m * (8 + row)
        print(f"[k3 main] n={n} m={m} payloads={len(arrays)} "
              f"kernel={t_k:.3f} ms plain={t_p:.3f} ms keys[keep]={t_l:.3f} "
              f"ms bound={bound_ms(nbytes, 0)[0]:.4f} ms", flush=True)
        add("compact", 0.0, t_k, t_p, t_l, nbytes, 0)
    return rows


CODEC_KERNELS = ("tap_gemm", "topk_mask", "compact")


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
        del stack
        size = x.element_size()
        flops = 2 * n_rows * idx.shape[1] * w.shape[1] * w.shape[2]
        nbytes = (x.numel() * size + w.numel() * size + idx.numel() * 4
                  + n_rows * w.shape[2] * 4)
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32
        b, by = bound_ms(nbytes, flops, peak)
        print(f"[p1 probe] {str(dtype).split('.')[-1]} rows={n_rows} "
              f"tile={tile} err={err:.3e} tol={tol:.3e} kernel={t_k:.3f} ms "
              f"plain={t_p:.3f} ms matmul(pre-gathered stack, same type)="
              f"{t_l:.3f} ms bound={b:.4f} ms by {by}", flush=True)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += t_k
        r["plain_ms"] += t_p
        r["library_ms"] += t_l
        r["bound_ms"] += b
        del x, idx, w

    win, idx = window_gather.window_inputs(16, "cuda")
    got = window_gather_sum(win, idx)
    ref = window_gather_sum_plain(win, idx)
    assert torch.equal(got, ref), "window_gather_sum differs at the " \
        "probe's shape"
    del got, ref
    t_k = cuda_time(lambda: window_gather_sum(win, idx), 10)
    t_p = cuda_time(lambda: window_gather_sum_plain(win, idx), 3)
    il = idx.long()
    t_l = cuda_time(lambda: [win[t][il[t]].sum(0)
                             for t in range(win.shape[0])], 3)
    nbytes = 2 * win.numel() * 4 + idx.numel() * 4
    b, by = bound_ms(nbytes, 0)
    payload = idx.numel() * win.shape[2] * 4
    print(f"[p2 probe] tiles={win.shape[0]} window={win.shape[1]} "
          f"K={win.shape[2]} equal=True kernel={t_k:.3f} ms "
          f"({payload / t_k / 1e9:.2f} TB/s gathered payload) "
          f"plain={t_p:.3f} ms win[t][idx[t]].sum(0)={t_l:.3f} ms "
          f"bound={b:.4f} ms by {by}", flush=True)
    rows["window_gather_sum"] = {"max_abs_err": 0.0, "ms": t_k,
                                 "plain_ms": t_p, "library_ms": t_l,
                                 "bound_ms": b, "bound_by": by}
    return rows, launches


# -- phase 6: the lossless (coded-occupancy) path ------------------------------

def voxel_keys(xyz):
    """Sorted unique scalar keys of integer coordinates."""
    v = np.asarray(xyz).astype(np.int64) + (1 << 19)
    return np.unique((v[:, 0] << 42) | (v[:, 1] << 21) | v[:, 2])


def run_coded(codec, frame, q, block_size):
    """compress(geom="coded") -> decompress: bins equal on both sides at
    every stage, geometry exactly lossless, K1 and K3 launched."""
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
    blocks, _ = bitstream.read_container(data)
    occ = sum(len(o) for b in blocks for o in b["occ_bytes"])
    met = pc_metrics(frame, rec, 1023)
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
    before = pc_metrics(frame, rec, 1023)["sym_y_psnr"]
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
    after = pc_metrics(frame, again, 1023)["sym_y_psnr"]
    resid = blocks[0].get("color_resid")
    print(f"[refit] affine={'yes' if blocks[0].get('color_affine') is not None else 'no'} "
          f"residual layer={len(resid) if resid else 0} B: container "
          f"{len(data_topk)} -> {len(new)} B "
          f"({len(new) * 8 / len(frame):.4f} bpp), Y_PSNR {before:.3f} -> "
          f"{after:.3f} dB, fit {t_fit:.2f} s; decompress(new) equals the "
          f"returned reconstruction", flush=True)


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
            if "registers" in line or "spill" in line:
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
    print(f"[codec] weights + tables in {time.time() - t0:.1f} s", flush=True)
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
    bpp = len(data) * 8 / len(frame)
    met = pc_metrics(frame, rec, 1023)
    print(f"[codec] block 1024: points={len(frame)} decoded={rec.shape[0]} "
          f"(= sum k[2] {k_sum}) encode={t_enc:.3f} s decode={t_dec:.3f} s "
          f"bpp={bpp:.4f} D1_PSNR={met['sym_psnr_mse']:.3f} dB "
          f"Y_PSNR={met['sym_y_psnr']:.3f} dB "
          f"max_memory_allocated={peak / 2**30:.2f} GiB launches={launches}",
          flush=True)

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
    rows = measure_recorded(record)
    del record
    for r in rows.values():
        r["bound_by"] = "bytes" if r["t_bytes"] >= r["t_ops"] else "operations"

    # 5. the probe entry points and their two kernels
    probe_rows, probe_launches = run_probes()
    rows.update(probe_rows)
    launches.update({k: probe_launches[k] for k in probe_rows})

    # 6. the lossless path, 7. simulcast, streaming, color refit
    run_coded(codec, frame, q, 1024)
    coded_stage_times(codec, frame, q)
    run_coded(codec, frame, q, 512)
    run_serving(codec, frame, data)

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
