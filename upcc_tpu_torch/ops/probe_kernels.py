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

import torch

from .. import kernels


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
            or rows % tile or k_in % 8 or k_out % 8 or taps < 1):
        raise ValueError(f"tile_tapconv: bad shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, idx {tuple(idx.shape)}, "
                         f"tile {tile}")
    out = torch.empty((rows, k_out), dtype=torch.float32, device=x.device)
    if rows == 0:
        return out
    kernels.count_launch("tile_tapconv", x, idx, w, tile)
    kernels.check(kernels.lib("tile_tapconv").upcc_tile_tapconv(
        x.data_ptr(), idx.data_ptr(), w.data_ptr(), rows, k_in, k_out, taps,
        tile, int(x.dtype == torch.float32), out.data_ptr(),
        kernels.stream_ptr(x)), "tile_tapconv")
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


def window_gather_sum(win, idx):
    """Kernel P2 on the card; equal to the plain version bit for bit (same
    summation order)."""
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
    kernels.count_launch("window_gather_sum", win, idx)
    kernels.check(kernels.lib("window_gather_sum").upcc_window_gather_sum(
        win.data_ptr(), idx.data_ptr(), tiles, s_rows, k, taps,
        out.data_ptr(), kernels.stream_ptr(win)), "window_gather_sum")
    return out
