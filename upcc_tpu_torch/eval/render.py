"""Offscreen point-cloud rendering: 6 axis-aligned orthographic views.

The port's copy of the JAX package's ``eval/render.py``: a dependency-free
numpy z-buffer splat for qualitative images.  Saving a render imports
matplotlib, composing a figure imports PIL, both only when asked: the
image stack itself needs numpy alone.
"""

import os

import numpy as np

_VIEWS = [  # (axis to project along, sign)
    (0, +1), (0, -1), (1, +1), (1, -1), (2, +1), (2, -1),
]


def render_view(xyz, rgb, axis, sign, size=512, splat=1):
    """Orthographic z-buffer projection onto the plane normal to `axis`."""
    dims = [d for d in range(3) if d != axis]
    p = xyz.astype(np.float64)
    lo, hi = p.min(0), p.max(0)
    span = max(float((hi - lo).max()), 1.0)
    uv = (p[:, dims] - lo[dims]) / span * (size - 1)
    depth = sign * p[:, axis]
    order = np.argsort(depth)  # far to near; near overwrites
    img = np.ones((size, size, 3), np.float32)
    u = np.clip(uv[order, 0].astype(np.int32), 0, size - 1)
    v = np.clip(uv[order, 1].astype(np.int32), 0, size - 1)
    c = rgb[order].astype(np.float32)
    for du in range(-splat + 1, splat):
        for dv in range(-splat + 1, splat):
            uu = np.clip(u + du, 0, size - 1)
            vv = np.clip(v + dv, 0, size - 1)
            img[size - 1 - vv, uu] = c
    return img


def render_pointcloud(points6, path_prefix=None, size=512):
    """6 views of an [N, 6] cloud; saves <prefix>_view{i}.png when a prefix
    is given, returns the image stack [6, size, size, 3]."""
    xyz, rgb = points6[:, :3], points6[:, 3:6]
    imgs = [render_view(xyz, rgb, ax, sg, size) for ax, sg in _VIEWS]
    if path_prefix:
        os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        for i, img in enumerate(imgs):
            plt.imsave(f"{path_prefix}_view{i}.png", np.clip(img, 0, 1))
    return np.stack(imgs)


def crop_zoom_compose(image_paths, crops, out_path, zoom=2):
    """Publication-figure helper: paste zoomed crops under each render."""
    from PIL import Image
    panels = []
    for path, (x0, y0, w, h) in zip(image_paths, crops):
        img = Image.open(path).convert("RGB")
        crop = img.crop((x0, y0, x0 + w, y0 + h)).resize(
            (w * zoom, h * zoom), Image.NEAREST)
        panel = Image.new("RGB", (img.width, img.height + crop.height + 4),
                          "white")
        panel.paste(img, (0, 0))
        panel.paste(crop, ((img.width - crop.width) // 2, img.height + 4))
        panels.append(panel)
    total_w = sum(p.width for p in panels) + 4 * (len(panels) - 1)
    max_h = max(p.height for p in panels)
    sheet = Image.new("RGB", (total_w, max_h), "white")
    x = 0
    for p in panels:
        sheet.paste(p, (x, 0))
        x += p.width + 4
    sheet.save(out_path)
    return out_path
