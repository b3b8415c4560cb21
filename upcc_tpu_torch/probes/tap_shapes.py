"""Time kernel K1 (``tap_gemm``) at the flagship codec's call shapes, without
the codec.

    python3 -m upcc_tpu_torch.probes.tap_shapes [--rows N] [--reps N]

Per call shape (layer kind, kernel size, cin -> cout) at ``--rows`` output
rows: random weights prepared as ``Codec.update()`` prepares them, random
neighbour indices with 80% of the taps read, the kernel held against the
dense plain version (at most 8192 rows of it), then timed beside its bound
(2 flops per nonzero weight and row that reads its tap, at the bf16 peak)
and the rate over the products of the listed blocks.  Random indices have
no locality: the codec's own calls (``chip_smoke.py``, phase 4) run
somewhat faster.
"""

import argparse

import torch

from .. import resolve_device
from ..ops import family as F
from . import PEAK_BF16, card_line, time_ms

# (name, kind, kernel, cin, cout): the conv shapes of the flagship model
SHAPES = [
    ("g_a conv1 grand down 256->1024", "grand_down", 5, 4, 128),
    ("g_a conv2/3 down 1024->128", "down", 5, 128, 128),
    ("g_a conv4 / g_s up1 conv 1024->1024", "conv", 5, 128, 128),
    ("h_a conv 1024->1536", "conv", 3, 128, 192),
    ("h_a down 1536->192", "down", 3, 192, 192),
    ("h_s conv 1536->2048", "conv", 3, 192, 256),
    ("g_s transpose 128->1024", "transpose", 5, 128, 128),
    ("g_s head conv 1024->512", "conv", 3, 128, 64),
    ("g_s head conv 512->8", "conv", 3, 64, 1),
    ("g_s grand transpose 1024->2048", "grand_transpose", 5, 128, 32),
    ("g_s grand head conv 2048->1024", "grand_conv", 3, 32, 16),
    ("g_s grand head conv 1024->64", "grand_conv", 3, 16, 1),
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=131072)
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    card = card_line(device)
    dtype = F.default_compute_dtype(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    out = []
    with torch.no_grad():
        for name, kind, ks, cin, cout in SHAPES:
            w = torch.randn((ks ** 3, cin, cout), generator=gen,
                            device=device) * (1.0 / (ks ** 3 * cin)) ** 0.5
            plan = F.prepare_taps(w, kind, ks, dtype)
            idx = torch.randint(0, a.rows, (a.rows, 27), generator=gen,
                                device=device, dtype=torch.int32)
            ok = torch.rand((a.rows, 27), generator=gen, device=device) < 0.8
            flat = torch.randn((a.rows, plan.k_in), generator=gen,
                               device=device).to(dtype)
            n = min(a.rows, 8192)
            dense = F._dense_taps(w, kind, ks).to(dtype)
            got = F.tap_gemm(flat, idx[:n], ok[:n], plan)
            ref = F.tap_gemm_plain(flat, idx[:n], ok[:n], dense)
            err = float((got - ref).abs().max())
            tol = 1e-3 * float(ref.abs().max()) + 1e-5
            if err > tol:
                raise RuntimeError(f"tap_gemm disagrees with its plain "
                                   f"version at {name}: {err} > {tol}")
            ms = time_ms(lambda: F.tap_gemm(flat, idx, ok, plan), a.reps,
                         device)
            nnz = (dense != 0).reshape(27, -1).sum(1).double()
            bound = float(2 * (ok.sum(0).double() * nnz).sum()) / PEAK_BF16 \
                * 1e3
            listed = 2.0 * a.rows * plan.n_blocks * plan.bn * plan.bk
            print(f"[{card}] {name}: rows={a.rows} BN={plan.bn} "
                  f"listed_blocks={plan.n_blocks} err={err:.3e} "
                  f"tap_gemm {ms:.3f} ms (bound {bound:.3f} ms by "
                  f"operations; {listed / ms / 1e9:.0f} TFLOP/s over the "
                  f"listed blocks)", flush=True)
            out.append({"name": name, "ms": ms, "bound_ms": bound,
                        "err": err})
            del flat, idx, ok, dense, got, ref
    return out


if __name__ == "__main__":
    main()
