"""Time and profile the port's codec main path on one GPU.

    python3 -m upcc_tpu_torch.profile_codec [--reps 5] [--block 1024]

The flagship model (committed epoch-193 weights) on the vox10-scale
synthetic frame (760k points) at q = (0.5, 0.5): after one warm-up,
``--reps`` timed compress + decompress pairs (host clock, each call ends
in a device synchronization), one pass with the codec's per-stage timer,
and one pass under ``torch.profiler`` giving the device time by kernel and
the device's busy share of the wall time.  Needs a CUDA device; prints the
card's name and power limit first.
"""

import argparse
import os
import subprocess
import time

import numpy as np
import torch

from .codec.codec import Codec
from .data.synthetic import surface_cloud
from .models.unified import UnifiedModel
from .weights import FLAGSHIP_CONFIG, load_weights

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(_ROOT, "results", "CVPR_inverse_scaling",
                       "weights_bf16.msgpack")


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--block", type=int, default=1024)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_codec: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    codec = Codec(load_weights(UnifiedModel(FLAGSHIP_CONFIG), WEIGHTS),
                  device="cuda")
    codec.update()
    xyz, rgb = surface_cloud(np.random.default_rng(10), extent=1024,
                             n_target=760_000)
    frame = np.concatenate([xyz.astype(np.float32), rgb], 1)
    q, bs = (0.5, 0.5), args.block

    codec.decompress(codec.compress(frame, q, block_size=bs))  # warm-up
    enc_t, dec_t = [], []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        data = codec.compress(frame, q, block_size=bs)
        t1 = time.perf_counter()
        codec.decompress(data)
        torch.cuda.synchronize()
        enc_t.append(t1 - t0)
        dec_t.append(time.perf_counter() - t1)
    print(f"[time] block {bs}, {len(frame)} points, {len(data)} bytes: "
          f"encode s {[round(t, 4) for t in enc_t]} median "
          f"{np.median(enc_t):.4f}; decode s {[round(t, 4) for t in dec_t]} "
          f"median {np.median(dec_t):.4f}", flush=True)

    codec.profile, codec.stage_times = True, {}
    codec.decompress(codec.compress(frame, q, block_size=bs))
    codec.profile = False
    for name, sec in codec.stage_times.items():
        print(f"[stage] {name:20s} {sec * 1e3:9.2f} ms", flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        codec.decompress(codec.compress(frame, q, block_size=bs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, memcpy/memset): CPU ops also carry
    # the device time of the kernels they launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in events) / 1e6
    print(f"[profile] wall {wall * 1e3:.1f} ms (under the profiler), device "
          f"busy {busy * 1e3:.1f} ms = {100 * busy / wall:.1f}% "
          f"(idle {100 * (1 - busy / wall):.1f}%)", flush=True)
    for e in sorted(events, key=_device_us, reverse=True)[:20]:
        print(f"[profile] {_device_us(e) / 1e3:9.3f} ms {e.count:6d}x "
              f"{e.key[:90]}", flush=True)
    # K1 summed over the template instances of its mainloop
    k1 = [e for e in events if "tap_mainloop_kernel" in e.key]
    print(f"[profile] K1 tap_gemm: {sum(_device_us(e) for e in k1) / 1e3:.3f} "
          f"ms in {sum(e.count for e in k1)} launches", flush=True)


if __name__ == "__main__":
    main()
