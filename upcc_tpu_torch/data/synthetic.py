"""Synthetic voxelized point clouds (numpy): surface-like clouds — an
ellipsoid shell with low-frequency displacement and smooth RGB colors."""

import numpy as np


def surface_cloud(rng, extent=128, n_target=8000, color_freq=0.05):
    """Returns (xyz int32 [N,3], rgb float32 [N,3] in [0,1]); N <= n_target."""
    n_raw = n_target * 3
    theta = rng.uniform(0, np.pi, n_raw)
    phi = rng.uniform(0, 2 * np.pi, n_raw)
    c = extent / 2.0
    radii = np.array([0.65, 0.5, 0.75]) * c
    pts = np.stack([
        radii[0] * np.sin(theta) * np.cos(phi),
        radii[1] * np.sin(theta) * np.sin(phi),
        radii[2] * np.cos(theta),
    ], axis=1)
    # low-frequency bumps so the surface is not trivially smooth
    bump = 0.12 * c * (np.sin(3 * theta) * np.cos(2 * phi))[:, None]
    pts = pts + bump * (pts / (np.linalg.norm(pts, axis=1, keepdims=True) + 1e-9))
    xyz = np.clip(np.round(pts + c), 0, extent - 1).astype(np.int32)
    xyz = np.unique(xyz, axis=0)
    if xyz.shape[0] > n_target:
        sel = rng.choice(xyz.shape[0], n_target, replace=False)
        xyz = xyz[sel]
    f = color_freq
    rgb = 0.5 + 0.5 * np.stack([
        np.sin(f * xyz[:, 0] + 0.3) * np.cos(f * xyz[:, 1]),
        np.cos(f * xyz[:, 1] + 1.1) * np.sin(f * xyz[:, 2]),
        np.sin(f * (xyz[:, 0] + xyz[:, 2]) * 0.7),
    ], axis=1)
    return xyz, rgb.astype(np.float32)
