"""Point-cloud quality metrics: D1 geometry PSNR and YUV color PSNR.

Nearest neighbours by scipy's cKDTree (exact); colors of all equidistant
nearest neighbours are averaged; BT.709 RGB->YUV; D1 is
10 log10(r^2 / mse) with the per-axis-mean squared distance, color PSNR
10 log10(1 / mse) on [0, 1] YUV; symmetric values take the worse of the
two directions.  Same conventions as the JAX package's
``eval/metrics.py::pc_metrics`` (its D2 and exact-voxel fast path are not
ported: the results are the same).
"""

import numpy as np
from scipy.spatial import cKDTree


def rgb_to_yuv_bt709(rgb01):
    rgb = np.round(np.clip(rgb01, 0.0, 1.0) * 255.0)
    y = 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
    u = -0.1146 * rgb[..., 0] - 0.3854 * rgb[..., 1] + 0.5 * rgb[..., 2]
    v = 0.5 * rgb[..., 0] - 0.4542 * rgb[..., 1] - 0.0458 * rgb[..., 2]
    yuv = np.stack([y, u, v], -1) / 255.0
    yuv[..., 1] += 0.5
    yuv[..., 2] += 0.5
    return yuv


def _directional(a_pts, a_col, b_pts, b_col, b_tree, resolution):
    k = min(8, len(b_pts))
    dist, idx = b_tree.query(a_pts, k=k)
    if k == 1:
        dist, idx = dist[:, None], idx[:, None]
    d2 = dist ** 2
    l2 = d2[:, 0] / 3.0
    out = {"mse": float(l2.mean())}
    out["psnr_mse"] = float(10 * np.log10(resolution ** 2
                                          / max(out["mse"], 1e-20)))
    if a_col is not None and b_col is not None:
        ties = (d2 - d2[:, :1]) < 1e-8
        w = ties.astype(np.float64)
        cols = (b_col[idx] * w[..., None]).sum(1) / w.sum(1, keepdims=True)
        cmse = ((rgb_to_yuv_bt709(a_col) - rgb_to_yuv_bt709(cols)) ** 2
                ).mean(axis=0)
        for i, ch in enumerate("yuv"):
            out[f"{ch}_mse"] = float(cmse[i])
            out[f"{ch}_psnr"] = float(10 * np.log10(1.0 / max(cmse[i], 1e-20)))
        out["yuv_psnr"] = float((6 * out["y_psnr"] + out["u_psnr"]
                                 + out["v_psnr"]) / 8.0)
    return out


def pc_metrics(source, reconstruction, resolution):
    """source/reconstruction: [N, 6] arrays (xyz, rgb in [0, 1]).
    Returns AB_/BA_/sym_ prefixed metrics (sym_psnr_mse is D1 PSNR,
    sym_y_psnr the Y-PSNR)."""
    src = np.asarray(source, np.float64)
    rec = np.asarray(reconstruction, np.float64)
    s_pts, s_col = src[:, :3], src[:, 3:6]
    r_pts, r_col = rec[:, :3], rec[:, 3:6]
    ab = _directional(s_pts, s_col, r_pts, r_col, cKDTree(r_pts), resolution)
    ba = _directional(r_pts, r_col, s_pts, s_col, cKDTree(s_pts), resolution)
    result = {f"AB_{k}": v for k, v in ab.items()}
    result.update({f"BA_{k}": v for k, v in ba.items()})
    for key in ["mse", "psnr_mse", "y_mse", "u_mse", "v_mse", "y_psnr",
                "u_psnr", "v_psnr", "yuv_psnr"]:
        a, b = result.get(f"AB_{key}"), result.get(f"BA_{key}")
        if a is not None and b is not None:
            result[f"sym_{key}"] = min(a, b)
    return result
