"""Synthetic voxelized point clouds (numpy), the same draws as the JAX
package's ``data/synthetic.py``, so one seed gives byte-identical frames:

  * ``surface_cloud``: an ellipsoid shell with low-frequency displacement
    and smooth RGB colors;
  * ``scan_like_cloud``: a human-scan-like frame (deformed ellipsoid shells
    and capsule limbs, a palette texture with shading).  The evaluation
    driver builds each test sequence's frame from it, seeded by the
    sequence's name, where no PLY is at hand;
  * ``batch_of_cubes``: a padded flat batch of ``surface_cloud`` cubes."""

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


def _fourier_field(rng, n_feats, freq_lo, freq_hi):
    """Random smooth scalar field on R^3: sum of random-direction sinusoids
    with a 1/f amplitude spectrum (cheap band-limited 'Perlin-ish' noise).
    Returns f(pts[N,3] in [-1,1]^3) -> [N] roughly in [-1, 1]."""
    freqs = np.exp(rng.uniform(np.log(freq_lo), np.log(freq_hi), n_feats))
    dirs = rng.normal(size=(n_feats, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    phases = rng.uniform(0, 2 * np.pi, n_feats)
    amps = 1.0 / freqs
    amps /= np.sqrt(np.sum(amps ** 2) / 2)

    def field(pts):
        proj = pts @ (dirs.T * freqs[None, :]) * (2 * np.pi)
        return np.sin(proj + phases[None, :]) @ amps

    return field


def scan_like_cloud(rng, extent=1024, n_target=None, seed_parts=None):
    """Human-scan-like voxelized cloud: a stack of deformed ellipsoid shells
    ('torso/head') plus capsule 'limbs', displaced by random smooth noise,
    colored by a multi-region palette texture with fine detail and lambertian
    shading.  Stands in for 8iVFBv2/Owlii frames where none is at hand,
    with far more realistic geometry/color statistics than
    ``surface_cloud``: ~watertight shells, varying curvature, textured
    cloth-like color regions.

    Returns (xyz int32 [N,3] unique voxels, rgb f32 [N,3] in [0,1]).
    """
    c = extent / 2.0
    parts = []
    n_blobs = seed_parts or rng.integers(3, 6)
    heights = np.sort(rng.uniform(-0.75, 0.75, n_blobs))
    for h in heights:  # vertical stack of ellipsoids (body/head masses)
        center = np.array([rng.uniform(-0.12, 0.12), rng.uniform(-0.12, 0.12), h])
        r = np.array([rng.uniform(0.18, 0.38), rng.uniform(0.15, 0.34),
                      rng.uniform(0.14, 0.3)])
        parts.append(("ellipsoid", center, r))
    for _ in range(rng.integers(2, 5)):  # capsule limbs
        a = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3),
                      rng.uniform(-0.4, 0.6)])
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        length = rng.uniform(0.35, 0.8)
        parts.append(("capsule", a, (a + d * length, rng.uniform(0.05, 0.12))))

    # total surface area (in [-1,1] units) -> sample density ~3 per voxel^2
    vox_scale = c  # units -> voxels
    areas = []
    for kind, a, b in parts:
        if kind == "ellipsoid":
            p = 1.6075
            ap, bp, cp = (b * vox_scale) ** p
            areas.append(4 * np.pi * ((ap * bp + ap * cp + bp * cp) / 3) ** (1 / p))
        else:
            end, r = b
            areas.append(2 * np.pi * (r * vox_scale)
                         * (np.linalg.norm(end - a) + 2 * r) * vox_scale)
    areas = np.asarray(areas)
    if n_target is None:
        n_target = min(int(0.75 * areas.sum()), 1_500_000)
    total = min(int(n_target * 1.8), 4_000_000)

    disp = _fourier_field(rng, 20, 0.8, 5.0)
    pts_all, nrm_all = [], []
    for (kind, a, b), area in zip(parts, areas):
        n = max(int(total * area / areas.sum()), 64)
        if kind == "ellipsoid":
            v = rng.normal(size=(n, 3)).astype(np.float32)
            v /= np.linalg.norm(v, axis=1, keepdims=True)
            p = a + v * b  # ellipsoid surface
            nrm = v / b
        else:
            end, r = b
            t = rng.uniform(0, 1, (n, 1)).astype(np.float32)
            axis_pts = a + t * (end - a)
            v = rng.normal(size=(n, 3)).astype(np.float32)
            v /= np.linalg.norm(v, axis=1, keepdims=True)
            p = axis_pts + v * r
            nrm = v
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        # smooth displacement along the normal: bumps, folds
        d = disp(p.astype(np.float32))[:, None].astype(np.float32) * 0.06
        pts_all.append((p + nrm * d).astype(np.float32))
        nrm_all.append(nrm.astype(np.float32))
    pts = np.concatenate(pts_all)
    nrm = np.concatenate(nrm_all)

    xyz = np.clip(np.round((pts + 1.0) * c), 0, extent - 1).astype(np.int64)
    key = (xyz[:, 0] << 42) | (xyz[:, 1] << 21) | xyz[:, 2]
    _, first = np.unique(key, return_index=True)
    xyz = xyz[first].astype(np.int32)
    nrm = nrm[first]
    if len(xyz) > n_target:
        sel = rng.choice(len(xyz), n_target, replace=False)
        xyz, nrm = xyz[sel], nrm[sel]

    # palette texture: low-freq region field -> one of 4 palette colors,
    # plus fine detail noise and lambertian shading from the part normal
    pn = xyz / (extent / 2.0) - 1.0
    region = _fourier_field(rng, 10, 0.6, 2.5)(pn)
    stripes = _fourier_field(rng, 6, 3.0, 9.0)(pn)
    palette = rng.uniform(0.08, 0.95, (4, 3))
    ridx = np.clip(((region + 1) * 2).astype(np.int32), 0, 3)
    base = palette[ridx]
    base = np.where(np.abs(stripes[:, None]) < 0.15,
                    palette[(ridx + 1) % 4], base)
    detail = _fourier_field(rng, 16, 8.0, 40.0)(pn)[:, None] * 0.06
    light = rng.normal(size=3)
    light /= np.linalg.norm(light)
    shade = 0.72 + 0.28 * np.clip(nrm @ light, 0, 1)[:, None]
    rgb = np.clip(base * shade + detail, 0, 1).astype(np.float32)
    return xyz, rgb


def batch_of_cubes(rng, batch_size, extent=64, n_per=2000, capacity=None):
    """Padded flat batch: (batch int32 [M], xyz int32 [M,3], rgb f32 [M,3])."""
    bs, xs, cs = [], [], []
    for b in range(batch_size):
        xyz, rgb = surface_cloud(rng, extent, n_per)
        bs.append(np.full(xyz.shape[0], b, np.int32))
        xs.append(xyz)
        cs.append(rgb)
    b = np.concatenate(bs)
    x = np.concatenate(xs)
    c = np.concatenate(cs)
    if capacity is not None and b.shape[0] < capacity:
        pad = capacity - b.shape[0]
        b = np.concatenate([b, np.full(pad, -1, np.int32)])
        x = np.concatenate([x, np.zeros((pad, 3), np.int32)])
        c = np.concatenate([c, np.zeros((pad, 3), np.float32)])
    return b[:capacity], x[:capacity], c[:capacity]
