"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ctypes — no
PyTorch headers, so a build takes seconds.  Libraries land in ``build/``
at the repository root (``UPCC_TORCH_BUILD`` overrides it), named by a
hash of the source and the flags, so an edited source always rebuilds.
``build()`` starts one ``nvcc`` per source, all at once.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it on the
card; ``reset_launches()`` zeroes them.  When ``RECORD`` is a dict, every
wrapper also appends its inputs under its kernel's name (``chip_smoke.py``
uses this to hold each kernel against its plain version at the shapes the
codec's main path gives it).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.environ.get("UPCC_TORCH_BUILD") or os.path.join(
    os.path.dirname(_PKG), "build")

SOURCES = {
    "tap_gemm": "csrc/tap_gemm.cu",
    "topk_mask": "csrc/topk.cu",
    "compact": "csrc/compact.cu",
    "tile_tapconv": "csrc/tile_tapconv.cu",
    "window_gather_sum": "csrc/window_gather.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
# C signatures of the exported launchers; every launcher returns the
# cudaError_t of its launches (0 = success)
_SIGNATURES = {
    "tap_gemm": {
        # flat, n_src, k_in, idx, ok, rows, taps, w, k_out, wmask, out, stream
        "upcc_tap_gemm": [_P, _I64, _I64, _P, _P, _I64, _I64, _P, _I64, _P,
                          _P, _P],
    },
    "topk_mask": {
        # keys, logits, k, n, maxb, hist, prefix, krem, counts, blk,
        # out_mask, stream
        "upcc_topk_mask": [_P, _P, _P, _I64, _I64, _P, _P, _P, _P, _P, _P,
                           _P],
    },
    "compact": {
        # keep, n, m, src, block_counts, stream
        "upcc_compact_index": [_P, _I64, _I64, _P, _P, _P],
        # keys, src, n, m, out, stream
        "upcc_compact_keys": [_P, _P, _I64, _I64, _P, _P],
        # rows, src, n, m, row_bytes, out, stream
        "upcc_compact_rows": [_P, _P, _I64, _I64, _I64, _P, _P],
    },
    "tile_tapconv": {
        # x, idx, w, rows, k_in, k_out, taps, tile, is_f32, out, stream
        "upcc_tile_tapconv": [_P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                              ctypes.c_int, _P, _P],
    },
    "window_gather_sum": {
        # win, idx, tiles, s_rows, k, taps, out, stream
        "upcc_window_gather_sum": [_P, _P, _I64, _I64, _I64, _I64, _P, _P],
    },
}

LAUNCHES = {name: 0 for name in SOURCES}
RECORD = None
BUILD_LOG = {}
_libs = {}
# the codec runs groups and frames on worker threads: the counts and the
# first-use build are shared by them
_count_lock = threading.Lock()
_build_lock = threading.Lock()


def reset_launches():
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(name, *inputs):
    """Called by a wrapper right where it launches its kernel."""
    with _count_lock:
        LAUNCHES[name] += 1
        if RECORD is not None:
            RECORD.setdefault(name, []).append(inputs)


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the GPU")
    return path


def _lib_path(name):
    src = os.path.join(_PKG, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, "cuda",
                             f"{name}-{digest.hexdigest()[:16]}.so")


def build(names=None):
    """Compile every missing kernel library (one nvcc per source, started
    together).  Returns the wall seconds spent; raises on any failure."""
    t0 = time.time()
    procs = []
    for name in names or SOURCES:
        src, out = _lib_path(name)
        if os.path.exists(out):
            continue
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        procs.append((name, tmp, out, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, out, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log.decode(errors="replace")
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)  # atomic: concurrent loaders never see half a lib
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(BUILD_LOG[n] for n in failed))
    return time.time() - t0


def lib(name):
    """The loaded ctypes library of kernel ``name`` (built if missing)."""
    handle = _libs.get(name)
    if handle is None:
        with _build_lock:  # two threads may arrive at first use: build once
            handle = _libs.get(name)
            if handle is None:
                build([name])
                handle = ctypes.CDLL(_lib_path(name)[1])
                for fn, argtypes in _SIGNATURES[name].items():
                    getattr(handle, fn).argtypes = argtypes
                    getattr(handle, fn).restype = ctypes.c_int
                _libs[name] = handle
    return handle


def check(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(tensor):
    return torch.cuda.current_stream(tensor.device).cuda_stream


def require_cuda(tensor, dtype, ndim, what):
    """Wrapper-side argument checks for a kernel input."""
    if not tensor.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor")
    if tensor.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {tensor.dtype}")
    if tensor.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got {tensor.dim()}")
    if not tensor.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if tensor.data_ptr() % 16:
        raise ValueError(f"{what}: expected 16-byte alignment")
