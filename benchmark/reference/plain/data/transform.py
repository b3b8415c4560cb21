"""Training-time augmentations on raw (numpy) cubes.

The JAX package's augmentations, in numpy (their draws from numpy
generators seeded by the config):
  * ColorJitter — brightness/contrast/saturation/hue jitter on RGB;
  * RandomRotate — random roll/pitch rotation about the cube center with
    re-quantization and dedup.

These run on the host data path (numpy), before device collation.
"""

import numpy as np


def build_transforms(config):
    out = []
    for _, item in sorted((config or {}).items()):
        key = item["key"]
        if key == "ColorJitter":
            out.append(ColorJitter(
                brightness=item.get("brightness", 0.2),
                contrast=item.get("contrast", 0.2),
                saturation=item.get("saturation", 0.2),
                hue=item.get("hue", 0.05),
                seed=item.get("seed", 0)))
        elif key == "RandomRotate":
            out.append(RandomRotate(block_size=item.get("block_size", 128),
                                    seed=item.get("seed", 0)))
        else:
            raise ValueError(f"unknown transform {key}")
    return out


def _rgb_to_hsv(rgb):
    mx = rgb.max(-1)
    mn = rgb.min(-1)
    d = mx - mn
    h = np.zeros_like(mx)
    m = d > 1e-12
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    idx = m & (mx == r)
    h[idx] = ((g - b)[idx] / d[idx]) % 6
    idx = m & (mx == g) & (mx != r)
    h[idx] = (b - r)[idx] / d[idx] + 2
    idx = m & (mx == b) & (mx != r) & (mx != g)
    h[idx] = (r - g)[idx] / d[idx] + 4
    h = h / 6.0
    s = np.where(mx > 1e-12, d / np.maximum(mx, 1e-12), 0.0)
    return np.stack([h, s, mx], -1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0] * 6.0, hsv[..., 1], hsv[..., 2]
    i = np.floor(h).astype(int) % 6
    f = h - np.floor(h)
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    table = np.stack([
        np.stack([v, t, p], -1), np.stack([q, v, p], -1),
        np.stack([p, v, t], -1), np.stack([p, q, v], -1),
        np.stack([t, p, v], -1), np.stack([v, p, q], -1)], 0)
    return table[i, np.arange(len(i))]


class ColorJitter:
    def __init__(self, brightness=0.2, contrast=0.2, saturation=0.2, hue=0.05,
                 seed=0):
        self.b, self.c, self.s, self.h = brightness, contrast, saturation, hue
        self.rng = np.random.default_rng(seed)

    def __call__(self, xyz, rgb):
        r = self.rng
        out = rgb.astype(np.float32)
        out = out * r.uniform(1 - self.b, 1 + self.b)
        out = (out - out.mean()) * r.uniform(1 - self.c, 1 + self.c) + out.mean()
        hsv = _rgb_to_hsv(np.clip(out, 0, 1))
        hsv[..., 1] = np.clip(hsv[..., 1] * r.uniform(1 - self.s, 1 + self.s), 0, 1)
        hsv[..., 0] = (hsv[..., 0] + r.uniform(-self.h, self.h)) % 1.0
        out = _hsv_to_rgb(hsv)
        return xyz, np.clip(out, 0, 1).astype(np.float32)


class RandomRotate:
    def __init__(self, block_size=128, seed=0):
        self.block_size = block_size
        self.rng = np.random.default_rng(seed)

    def __call__(self, xyz, rgb):
        roll, pitch = self.rng.uniform(-np.pi, np.pi, 2)
        cr, sr = np.cos(roll), np.sin(roll)
        cp, sp = np.cos(pitch), np.sin(pitch)
        rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
        ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        c = self.block_size / 2.0
        pts = (xyz.astype(np.float64) - c) @ (rx @ ry).T + c
        pts = np.round(pts).astype(np.int32)
        keep = np.all((pts >= 0) & (pts < self.block_size), axis=1)
        pts, rgb = pts[keep], rgb[keep]
        # dedup (re-quantization can merge voxels), first occurrence wins
        _, first = np.unique(pts, axis=0, return_index=True)
        first.sort()
        return pts[first], rgb[first]
