"""Build a ready-to-run Codec from a trained experiment directory
(``results/<exp>/config.yaml`` + weights), for the file CLI and any
serving process.

The model section of ``config.yaml`` is read with ``yaml`` where that
package imports.  Where it does not, the committed flagship experiment
(a directory named as its config, ``CVPR_inverse_scaling``) takes
``weights.FLAGSHIP_CONFIG``, which a test holds equal to that YAML, and any
other experiment raises: there is no silent default.

Weight files: the full-precision ``weights.msgpack`` is preferred over the
committable bf16 snapshot ``weights_bf16.msgpack``, unless the snapshot is
newer (by the trainer's recorded step in the ``.meta.json`` sidecars, else
by mtime with a one-minute same-save window).
"""

import json
import os

from ..models.unified import UnifiedModel
from ..weights import FLAGSHIP_CONFIG, load_weights
from .codec import CODEC_MAX_BATCH, Codec

FLAGSHIP_EXPERIMENT = "CVPR_inverse_scaling"


def _read_config(exp_dir):
    path = os.path.join(exp_dir, "config.yaml")
    try:
        import yaml
    except ImportError:
        name = os.path.basename(os.path.normpath(exp_dir))
        if name != FLAGSHIP_EXPERIMENT:
            raise RuntimeError(
                f"cannot read {path}: the yaml package is not installed, and "
                f"only the {FLAGSHIP_EXPERIMENT} experiment has a built-in "
                "config") from None
        return {"model": {k: dict(v) for k, v in FLAGSHIP_CONFIG.items()}}
    with open(path) as f:
        return yaml.safe_load(f)


def _step_of(path):
    try:
        with open(path + ".meta.json") as f:
            return int(json.load(f)["step"])
    except (OSError, ValueError, KeyError):
        return None


def pick_weights(exp_dir):
    """The weight file to load from ``exp_dir``; raises when it has none."""
    wpath = os.path.join(exp_dir, "weights.msgpack")
    cpath = os.path.join(exp_dir, "weights_bf16.msgpack")
    have_w, have_c = os.path.exists(wpath), os.path.exists(cpath)
    if have_w and have_c:
        # never let a stale machine-local f32 file shadow a newer bf16
        # snapshot: arbitrate by the recorded step, else by mtime
        ws, cs = _step_of(wpath), _step_of(cpath)
        if ws is not None and cs is not None:
            pick, why = (wpath if ws >= cs else cpath), f"step {ws} < {cs}"
        else:
            wm, cm = os.path.getmtime(wpath), os.path.getmtime(cpath)
            pick = wpath if wm >= cm - 60 else cpath
            why = f"mtime {wm:.0f} < {cm:.0f}"
        if pick == cpath:
            print(f"[codec] weights.msgpack is older than the bf16 snapshot "
                  f"({why}) — using {cpath}")
        return pick
    if have_w:
        return wpath
    if have_c:
        print(f"[codec] using compact bf16 snapshot {cpath}")
        return cpath
    raise FileNotFoundError(f"no weights.msgpack or weights_bf16.msgpack in "
                            f"{exp_dir}")


def load_codec(exp_dir, device="cuda"):
    """(codec, config) for the experiment in ``exp_dir``, tables frozen."""
    cfg = _read_config(exp_dir)
    mcfg = dict(cfg["model"])
    mcfg["max_batch"] = CODEC_MAX_BATCH
    model = load_weights(UnifiedModel(mcfg), pick_weights(exp_dir))
    codec = Codec(model, device=device)
    codec.update()
    return codec, cfg
