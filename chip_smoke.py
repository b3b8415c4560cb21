#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``upcc_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # the whole check, one card
    python3 chip_smoke.py --kernels  # build + kernel checks only

Phases, each printing its lines; any failure raises and exits non-zero:
  1. the card's name and power limit (nvidia-smi); build the CUDA kernels
     (one nvcc per source, in parallel) and print the build seconds;
  2. every kernel against its plain PyTorch version on edge-case inputs:
     K1 tap_gemm at each caller layout (f32 tolerance below), K2 topk_mask
     and K3 compact (exact);
  3. the codec's main path at full width: the committed epoch-193 flagship
     weights, the vox10-scale synthetic frame (760k points), compress ->
     decompress at q=(0.5, 0.5), block 1024 (once recording every kernel
     call's inputs, once timed with the launch counts zeroed just before),
     then block 512 (an 8-block group); checks encoder/decoder bit-exactness,
     the decoded count against the transmitted k, and that every kernel
     launched;
  4. every recorded main-path kernel call against its plain version, timed
     (kernel, plain, one library call as yardstick) beside its roofline
     bound.
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
from upcc_tpu_torch.ops.sparse import SparseTensor, compact, compact_plain
from upcc_tpu_torch.ops.topk import topk_mask, topk_mask_plain
from upcc_tpu_torch.weights import FLAGSHIP_CONFIG, load_weights

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s
PEAK_BF16 = 989e12     # H100 SXM dense bf16 tensor-core flop/s
WEIGHTS = os.path.join(HERE, "results", "CVPR_inverse_scaling",
                       "weights_bf16.msgpack")
REPLACES = {
    "tap_gemm": ("upcc_tpu_torch/csrc/tap_gemm.cu",
                 "upcc_tpu/ops/family.py:610"),
    "topk_mask": ("upcc_tpu_torch/csrc/topk.cu", "upcc_tpu/ops/topk.py:68"),
    "compact": ("upcc_tpu_torch/csrc/compact.cu",
                "upcc_tpu/ops/sparse.py:81"),
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


def bound_ms(nbytes, flops):
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16 * 1e3
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
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    blocks, _ = bitstream.read_container(data)
    k_sum = sum(b["k"][2] for b in blocks)
    assert rec.shape[0] == k_sum, (rec.shape, k_sum)
    assert np.isfinite(rec).all() and rec.shape[1] == 6
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was not launched on the main path"
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
    out = []
    for name, (src, replaces) in REPLACES.items():
        r = rows[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": ("bytes" if r["t_bytes"] >= r["t_ops"]
                                 else "operations"),
                    "library_ms": r["library_ms"]})
    print(smi)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
