"""The two probe kernels: a tile-local tap gather + product (P1) and a
windowed row gather-and-sum (P2).

Counterparts of the JAX package's two Pallas probes,
``scripts/micro_gather.py::make_pallas_tapconv`` and the ``kern`` of
``scripts/prof_pallas_gather.py``.  Neither is on a codec path; they
measure the primitives a windowed-gather conv would be built from and are
driven by ``upcc_tpu_torch/probes``.  On a CUDA tensor each wrapper
launches its kernel (``csrc/tile_tapconv.cu``, ``csrc/window_gather.cu``);
on a CPU tensor it runs the plain version beside it.
"""

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from . import tapplan


def tile_tapconv_plain(x, idx, w, tile):
    """out[r] = sum_k x[tile(r) * tile + idx[r, k]] @ w[k], taps summed in
    order in f32 (bf16 operands are widened, so their products are exact).
    x [R, K_in]; idx int32 [R, T], local to the row's tile (clipped into
    it); w [T, K_in, K_out]; R a multiple of ``tile``."""
    rows, taps = idx.shape
    nt = rows // tile
    xt = x.float().reshape(nt, tile, x.shape[1])
    it = idx.reshape(nt, tile, taps).clamp(0, tile - 1).to(torch.int64)
    tno = torch.arange(nt, device=x.device)[:, None]
    acc = torch.zeros((nt, tile, w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for k in range(taps):
        acc = acc + xt[tno, it[:, :, k]] @ w[k].float()
    return acc.reshape(rows, w.shape[-1])


def tile_tapconv(x, idx, w, tile):
    """Kernel P1 on the card.  x and w share a dtype, bf16 (exact products)
    or f32 (operands rounded to TF32 inside the kernel); f32 sums either
    way.  Returns f32 [R, K_out]."""
    if not x.is_cuda:
        return tile_tapconv_plain(x, idx, w, tile)
    rows, taps = idx.shape
    k_in, k_out = x.shape[1], w.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"tile_tapconv: expected bf16 or f32, got {x.dtype}")
    kernels.require_cuda(x, x.dtype, 2, "tile_tapconv x")
    kernels.require_cuda(w, x.dtype, 3, "tile_tapconv weights")
    kernels.require_cuda(idx, torch.int32, 2, "tile_tapconv idx")
    if (x.shape[0] != rows or w.shape[:2] != (taps, k_in) or tile < 1
            or rows % tile or k_in % 8 or k_out % 8 or not 1 <= taps <= 32):
        raise ValueError(f"tile_tapconv: bad shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, idx {tuple(idx.shape)}, "
                         f"tile {tile}")
    out = torch.empty((rows, k_out), dtype=torch.float32, device=x.device)
    if rows == 0:
        return out
    is_f32 = x.dtype == torch.float32
    # dense weights: every block listed, K-major tiles of one 128-byte row
    plan = tapplan.plan_from_dense(
        w, np.ones((taps, 1, 1), bool), k_in, k_out,
        bk=32 if is_f32 else 64)
    # f32: the kernel rounds x into this scratch (and the packed copy of w
    # in place) to TF32 before the products
    x_round = torch.empty_like(x) if is_f32 else x
    # 128-row blocks when they fill the card, else 64-row blocks
    wgs = 2 if rows >= 128 * 132 else 1
    kernels.count_launch("tile_tapconv", x, idx, w, tile)
    kernels.check(kernels.lib("tile_tapconv").upcc_tile_tapconv(
        x.data_ptr(), x_round.data_ptr(), idx.data_ptr(),
        plan.wpack.data_ptr(), plan.n_blocks, plan.tap_ptr.data_ptr(),
        plan.k0.data_ptr(), rows, k_in, k_out, taps, tile, int(is_f32),
        plan.bn, wgs, out.data_ptr(), kernels.stream_ptr(x)),
        "tile_tapconv")
    return out


def window_gather_sum_plain(win, idx):
    """out[t, s] = sum_k win[t, idx[t, k, s]], in f32, k in order from zero.
    win f32 [tiles, S, K]; idx int32 [tiles, T, S] (clipped into the
    window)."""
    tiles, s_rows, _ = win.shape
    it = idx.clamp(0, s_rows - 1).to(torch.int64)
    tno = torch.arange(tiles, device=win.device)[:, None]
    acc = torch.zeros_like(win)
    for k in range(idx.shape[1]):
        acc = acc + win[tno, it[:, k]]
    return acc


class WindowPlan(NamedTuple):
    width: int  # slab width in floats (8 or 4); 0: streaming mode
    slabs: int  # column slabs of a window (blocks per tile), 0 streaming
    last: int   # width of the last slab (4 where K % 8 == 4 at width 8)
    smem: int   # dynamic shared memory bytes of one slab block


def window_plan(s_rows, k, smem_optin):
    """Launch plan of kernel P2 for windows of ``s_rows`` rows of ``k``
    floats (k % 4 == 0): the widest slab, 8 or 4 floats (never wider than
    the row), whose S x width f32 fits ``smem_optin`` bytes of shared
    memory, a ragged last slab 4 wide; streaming mode where not even a
    4-wide slab fits."""
    for width in (8, 4):
        if width <= k and s_rows * width * 4 <= smem_optin:
            slabs = -(-k // width)
            return WindowPlan(width, slabs, k - (slabs - 1) * width,
                              s_rows * width * 4)
    return WindowPlan(0, 0, 0, 0)


def window_gather_sum(win, idx, plan=None):
    """Kernel P2 on the card with ``plan`` (a ``WindowPlan``; default
    ``window_plan`` for the card); equal to the plain version bit for bit
    (same summation order)."""
    if not win.is_cuda:
        return window_gather_sum_plain(win, idx)
    kernels.require_cuda(win, torch.float32, 3, "window_gather_sum win")
    kernels.require_cuda(idx, torch.int32, 3, "window_gather_sum idx")
    tiles, s_rows, k = win.shape
    taps = idx.shape[1]
    if (idx.shape[0] != tiles or idx.shape[2] != s_rows or k % 4 or k < 4
            or taps < 1 or tiles > 65535):
        raise ValueError(f"window_gather_sum: bad shapes win "
                         f"{tuple(win.shape)}, idx {tuple(idx.shape)}")
    out = torch.empty_like(win)
    if win.numel() == 0:
        return out
    if plan is None:
        plan = window_plan(s_rows, k, kernels.device_limits(win.device)[1])
    kernels.count_launch("window_gather_sum", win, idx)
    kernels.check(kernels.lib("window_gather_sum").upcc_window_gather_sum(
        win.data_ptr(), idx.data_ptr(), tiles, s_rows, k, taps, plan.width,
        out.data_ptr(), kernels.stream_ptr(win)),
        "window_gather_sum")
    return out
