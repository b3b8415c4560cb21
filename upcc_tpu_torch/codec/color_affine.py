"""Per-frame signaled affine color correction (encoder-side refit).

The decoder's color pathway carries a small systematic, rate-dependent bias
(the synthesis head is trained across the whole q range; any one operating
point lands slightly off).  A classic codec remedy — used by e.g. VVC's
luma-mapping/chroma-scaling — is to fit a tiny signaled correction at encode
time against the original frame and apply it after decode.

Here the encoder decodes its own stream (it already runs the decoder's exact
params graph for bit-exactness), nearest-neighbor-associates decoded points
with the source in BOTH directions (the same associations the evaluation
metric uses, eval/metrics.py::_directional), and least-squares fits one
``[3, 4]`` matrix mapping decoded ``[y, u, v, 1]`` to source YUV.  The 48
bytes ride the container's first block under ``FLAG_COLOR_AFFINE``
(bitstream.py) and are counted in every reported bpp.  Fitting on the union
of both directional pair sets minimizes the sum of the AB and BA color MSEs,
so the symmetric (min-direction) YUV PSNR cannot get systematically traded
away.  The correction never touches geometry.

Numpy and scipy only; the same arithmetic as the JAX package's module of
this name, so the two write the same 48 bytes for the same inputs.
"""

import numpy as np

# BT.709 RGB->YUV (the evaluation metric's convention,
# eval/metrics.py::rgb_to_yuv_bt709, offsets 0.5 on U/V)
_FWD = np.array([[0.2126, 0.7152, 0.0722],
                 [-0.1146, -0.3854, 0.5],
                 [0.5, -0.4542, -0.0458]], np.float64)
_INV = np.linalg.inv(_FWD)
_OFS = np.array([0.0, 0.5, 0.5], np.float64)


def _to_yuv(rgb01):
    """Continuous BT.709 transform of [0,1] RGB (no grid rounding; decoded
    and source colors already live on the 8-bit grid where it matters)."""
    return np.asarray(rgb01, np.float64) @ _FWD.T + _OFS


def _to_rgb(yuv):
    return (np.asarray(yuv, np.float64) - _OFS) @ _INV.T


def fit(rec, source, source_tree=None, rec_tree=None):
    """LS-fit the [3, 4] YUV affine from a decoded frame to its source.

    rec, source: [N, 6] arrays (xyz, rgb in [0, 1]).  Optional prebuilt
    cKDTrees over the xyz columns skip the tree builds (an evaluation loop
    already holds the source tree via PreparedSource).

    Returns (W, gain): the matrix and the fitted-pair YUV MSE improvement
    (>= 0 by construction).  Returns (None, 0.0) when the fit is degenerate
    (no points / no colors) or the improvement is below float noise — the
    caller then signals nothing and the stream is unchanged.
    """
    from scipy.spatial import cKDTree

    rec = np.asarray(rec)
    source = np.asarray(source)
    if len(rec) == 0 or len(source) == 0 \
            or rec.shape[1] < 6 or source.shape[1] < 6:
        return None, 0.0
    if source_tree is None:
        source_tree = cKDTree(source[:, :3])
    if rec_tree is None:
        rec_tree = cKDTree(rec[:, :3])
    # BA pairs: each decoded point against its nearest source point
    _, i_ba = source_tree.query(rec[:, :3], k=1)
    # AB pairs: each source point against its nearest decoded point
    _, i_ab = rec_tree.query(source[:, :3], k=1)
    x = np.concatenate([_to_yuv(rec[:, 3:6]),
                        _to_yuv(rec[i_ab, 3:6])])
    t = np.concatenate([_to_yuv(source[i_ba, 3:6]),
                        _to_yuv(source[:, 3:6])])
    A = np.concatenate([x, np.ones((len(x), 1))], axis=1)
    W, *_ = np.linalg.lstsq(A, t, rcond=None)
    W = W.T  # [3, 4]
    if not np.all(np.isfinite(W)):
        return None, 0.0
    W32 = np.ascontiguousarray(W, np.float32)
    mse0 = float(((x - t) ** 2).mean())
    # judge the gain the way the metric will see it: apply the float32
    # matrix that would actually be signaled and round the corrected RGB to
    # the 8-bit grid (eval/metrics.py::rgb_to_yuv_bt709 rounds to 255ths)
    # before re-measuring — sub-quantization-step LS "gains" can vanish or
    # slightly reverse after rounding
    fixed = np.round(np.clip(apply(rec[:, 3:6], W32), 0.0, 1.0) * 255.0) \
        / 255.0
    x1 = np.concatenate([_to_yuv(fixed), _to_yuv(fixed[i_ab])])
    mse1 = float(((x1 - t) ** 2).mean())
    if mse1 >= mse0 - 1e-12:
        return None, 0.0
    return W32, mse0 - mse1


def apply(colors01, W):
    """Apply a fitted [3, 4] matrix to [N, 3] RGB colors in [0, 1]."""
    if W is None or len(colors01) == 0:
        return colors01
    yuv = _to_yuv(colors01)
    A = np.concatenate([yuv, np.ones((len(yuv), 1))], axis=1)
    rgb = _to_rgb(A @ np.asarray(W, np.float64).T)
    return np.clip(rgb, 0.0, 1.0).astype(np.float32)
