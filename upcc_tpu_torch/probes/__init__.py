"""Probe entry points: microbenchmarks of the gather primitives.

``python3 -m upcc_tpu_torch.probes.micro_gather`` and
``python3 -m upcc_tpu_torch.probes.window_gather`` are the counterparts of
the JAX package's ``scripts/micro_gather.py`` and
``scripts/prof_pallas_gather.py``.  They run on the card and raise without
one; ``--device cpu`` runs the kernels' plain versions instead (a check of
the control flow, not a measurement).  Every printed line carries the
card's name and power limit.
"""

import subprocess
import time

import torch

# published peaks of one H100 SXM (NVIDIA's data sheet), for the bounds
PEAK_BYTES = 3.35e12   # HBM3, bytes/s
PEAK_BF16 = 989e12     # dense bf16 tensor-core flop/s
PEAK_TF32 = 495e12     # dense TF32 tensor-core flop/s


def card_line(device):
    """Name and power limit of the card as nvidia-smi prints them."""
    if device.type != "cuda":
        return "cpu (plain versions, no device time)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[device.index or 0]


def time_ms(fn, reps, device):
    """Mean ms per call over ``reps`` calls after one warm-up: CUDA events
    on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
