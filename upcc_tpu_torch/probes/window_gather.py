"""Probe the windowed row gather-and-sum against a flat row gather.

    python3 -m upcc_tpu_torch.probes.window_gather [--tiles N]

Counterpart of ``scripts/prof_pallas_gather.py``: per tile, 27 row gathers
over a [4096, 512] f32 window, summed (kernel P2,
``ops/probe_kernels.py::window_gather_sum``), checked on one tile against
the plain sum, timed, and set beside the same total gather from one flat
array in device memory (``flat[idx].sum(0)``).
"""

import argparse

import torch

from .. import resolve_device
from ..ops.probe_kernels import window_gather_sum, window_gather_sum_plain
from . import PEAK_BYTES, card_line, time_ms

S_ROWS, K, TAPS = 4096, 512, 27


def window_inputs(tiles, device, seed=0, s_rows=S_ROWS, k=K):
    """win f32 [tiles, S, K] and window-local idx int32 [tiles, 27, S]."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    win = torch.randn((tiles, s_rows, k), generator=gen, device=device)
    idx = torch.randint(0, s_rows, (tiles, TAPS, s_rows), generator=gen,
                        device=device, dtype=torch.int32)
    return win, idx


def window_bound_ms(win, idx):
    """Least ms: windows and indices read once, sums written once."""
    return (2 * win.numel() * 4 + idx.numel() * 4) / PEAK_BYTES * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiles", type=int, default=16)
    ap.add_argument("--window", type=int, default=S_ROWS,
                    help="rows of one window")
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    card = card_line(device)
    with torch.no_grad():
        win, idx = window_inputs(a.tiles, device, s_rows=a.window)
        out = window_gather_sum(win, idx)
        ref = window_gather_sum_plain(win[:1], idx[:1])
        err = float((out[0] - ref[0]).abs().max() / (ref.abs().max() + 1e-9))
        print(f"[{card}] window_gather_sum correctness rel err on one tile: "
              f"{err:.3e}", flush=True)
        if err != 0.0:
            raise RuntimeError("window_gather_sum differs from the plain sum")
        ms = time_ms(lambda: window_gather_sum(win, idx), a.reps, device)
        rows = a.tiles * TAPS * a.window
        payload = rows * K * 4
        bound = window_bound_ms(win, idx)
        print(f"[{card}] window_gather_sum: {ms:.3f} ms, "
              f"{rows / ms / 1e3:.1f} M gathered rows/s, "
              f"{payload / ms / 1e6:.1f} GB/s gather payload "
              f"(bound {bound:.3f} ms by bytes)", flush=True)
        # the same total gather from one flat array in device memory
        gen = torch.Generator(device=device)
        gen.manual_seed(1)
        flat = torch.randn((a.tiles * a.window, K), generator=gen,
                           device=device)
        gidx = torch.randint(0, flat.shape[0], (rows,), generator=gen,
                             device=device)
        ms2 = time_ms(lambda: flat[gidx].sum(0), max(1, a.reps // 4), device)
        print(f"[{card}] flat row gather: {ms2:.3f} ms, "
              f"{rows / ms2 / 1e3:.1f} M rows/s, "
              f"{payload / ms2 / 1e6:.1f} GB/s payload", flush=True)
    return {"card": card, "rel_err": err, "ms": ms, "bound_ms": bound,
            "flat_ms": ms2}


if __name__ == "__main__":
    main()
