"""Read flax msgpack weights into the frozen model (a frozen copy of the
port's ``weights.py``, reader side only).

``load_flax_msgpack`` reads a flax ``serialization.to_bytes`` file with a
small pure-Python msgpack reader (no ``msgpack``, no ``flax``); bfloat16
leaves are widened to float32 exactly.  ``params_from_jax`` maps the flax
tree onto the modules by path; every leaf must be consumed and every
parameter supplied, with equal shapes."""

import json
import struct

import numpy as np
import torch

# the model section of configs/CVPR_inverse_scaling.yaml (the flagship,
# epoch-193 weights in results/CVPR_inverse_scaling/weights_bf16.msgpack),
# written out so the GPU host needs no YAML parser; a test holds the two
# equal
FLAGSHIP_CONFIG = {
    "entropy_model": {"type": "MeanScaleHyperprior_map",
                      "C_bottleneck": 128, "C_hyper_bottleneck": 192,
                      "quantization_mode": "ste", "inverse_rescaling": True,
                      "quantization_offset": True},
    "g_a": {"C_in": 4, "N1": 128, "N2": 128, "N3": 128, "N4": 128},
    "g_s": {"C_out": 3, "N1": 128, "N2": 128, "N3": 128, "N4": 128,
            "min_one_child": True},
}


def flagship_config(width):
    """The flagship's model config at ``width`` (N1-N4 and C_bottleneck;
    C_hyper_bottleneck 1.5 x width, 192 at the flagship's 128)."""
    cfg = json.loads(json.dumps(FLAGSHIP_CONFIG))
    for part in ("g_a", "g_s"):
        cfg[part].update({f"N{i}": width for i in range(1, 5)})
    cfg["entropy_model"]["C_bottleneck"] = width
    cfg["entropy_model"]["C_hyper_bottleneck"] = width * 3 // 2
    return cfg


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def _take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def read(self):
        t = self._take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.read() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return bytes(self._take(t & 0x1F)).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        if t in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            n = self._unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[t])
            return bytes(self._take(n))
        if t in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self._unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[t])
            code = self._unpack(">b")
            return _ext(code, bytes(self._take(n)))
        if t in (0xCA, 0xCB):
            return self._unpack(">f" if t == 0xCA else ">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in ints:
            return self._unpack(ints[t])
        if 0xD4 <= t <= 0xD8:  # fixext 1/2/4/8/16
            code = self._unpack(">b")
            return _ext(code, bytes(self._take(1 << (t - 0xD4))))
        if t in (0xD9, 0xDA, 0xDB):
            n = self._unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[t])
            return bytes(self._take(n)).decode()
        if t in (0xDC, 0xDD):
            n = self._unpack(">H" if t == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if t in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if t == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def _map(self, n):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key.decode() if isinstance(key, bytes) else key] = self.read()
        return out


def _ndarray(payload):
    shape, dtype, buf = _Reader(payload).read()
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    if dtype == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        arr = np.frombuffer(buf, np.dtype(dtype)).copy()
    return arr.reshape(shape)


def _ext(code, payload):
    if code == 1:
        return _ndarray(payload)
    if code == 3:
        return _ndarray(payload)[()]
    raise ValueError(f"unsupported msgpack extension type {code}")


def _unchunk(tree):
    """flax splits arrays above 1 GiB into {'__msgpack_chunked_array__'}
    dicts; join them back."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_flax_msgpack(path):
    """Nested dict of numpy arrays (floating leaves as float32)."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    tree = _unchunk(reader.read())
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")

    def to_f32(x):
        if isinstance(x, dict):
            return {k: to_f32(v) for k, v in x.items()}
        a = np.asarray(x)
        return a.astype(np.float32) if np.issubdtype(a.dtype, np.floating) \
            else a
    return to_f32(tree)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, name))
        else:
            out[name] = v
    return out


def params_from_jax(tree, model):
    """state_dict for ``model`` from a flax parameter tree of numpy arrays.
    Raises on a leaf the model has no parameter for, on a parameter no leaf
    supplies, and on a shape mismatch."""
    leaves = _flatten(tree)
    expected = model.state_dict()
    leftover = sorted(set(leaves) - set(expected))
    missing = sorted(set(expected) - set(leaves))
    if leftover:
        raise ValueError(f"leaves with no model parameter (leftover): "
                         f"{leftover}")
    if missing:
        raise ValueError(f"model parameters with no leaf (missing): "
                         f"{missing}")
    out = {}
    for name, ref in expected.items():
        arr = np.array(leaves[name], np.float32)  # writable copy
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: shape {arr.shape} != "
                             f"{tuple(ref.shape)}")
        out[name] = torch.from_numpy(arr)
    return out


def load_weights(model, path):
    """Load a flax msgpack weight file into ``model`` (strict)."""
    model.load_state_dict(params_from_jax(load_flax_msgpack(path), model))
    return model
