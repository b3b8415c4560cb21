"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ctypes — no
PyTorch headers, so a build takes seconds.  Libraries land in ``build/``
at the repository root (``UPCC_TORCH_BUILD`` overrides it), named by a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source always rebuilds.
``build()`` starts one ``nvcc`` per source, all at once.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.

Every wrapper that launches a kernel on the card adds 1 to the tracer's
counter ``kernel.<name>`` (``utils/profiling.py``: it counts inside
``profiling.recording()`` or under ``torch.profiler``, per frame or step).
When ``RECORD`` is a dict, the wrapper also appends its inputs under its
kernel's name (``chip_smoke.py`` uses this to hold each kernel against its
plain version at the shapes the codec's main path gives it).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from .utils import profiling

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.environ.get("UPCC_TORCH_BUILD") or os.path.join(
    os.path.dirname(_PKG), "build")

SOURCES = {
    "tap_gemm": "csrc/tap_gemm.cu",
    "tap_wgrad": "csrc/tap_wgrad.cu",
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
        # flat, n_src, k_in, idx, ok, rows, taps, wpack, k_out, tap_ptr,
        # blk_k0, bn, wgs, out, stream
        "upcc_tap_gemm": [_P, _I64, _I64, _P, _P, _I64, _I64, _P, _I64, _P,
                          _P, _I64, _I64, _P, _P],
    },
    "tap_wgrad": {
        # flat, n_src, k_in, idx, rows, taps, dacc, k_out, wgrad tiles,
        # n_tiles, pairs, row lists, list ends, n_blocks, bn, chunk, splits,
        # partials, tickets, out, stream
        "upcc_tap_wgrad": [_P, _I64, _I64, _P, _I64, _I64, _P, _I64, _P,
                           _I64, _I64, _P, _P, _I64, _I64, _I64, _I64, _P,
                           _P, _P, _P],
    },
    "topk_mask": {
        # keys, logits, k, n, maxb, resident, grid, per_block, histograms,
        # tie totals, out_mask, stream
        "upcc_topk_mask": [_P, _P, _P, _I64, _I64, ctypes.c_int, _I64, _I64,
                           _P, _P, _P, _P],
        # resident, maxb, per_block, out smem bytes, out blocks per SM
        "upcc_topk_fit": [ctypes.c_int, _I64, _I64, _P, _P],
    },
    "compact": {
        # keep, keys, out_keys, n, m, tile, tail blocks, status words,
        # epoch, payloads, payload descriptors, stream
        "upcc_compact": [_P, _P, _P, _I64, _I64, _I64, _I64, _P, _I64, _I64,
                         _P, _P],
        # tile, out smem bytes, out blocks per SM
        "upcc_compact_fit": [_I64, _P, _P],
    },
    "tile_tapconv": {
        # x, x_round, idx, wpack, n_blocks, tap_ptr, blk_k0, rows, k_in,
        # k_out, taps, tile, is_f32, bn, wgs, out, stream
        "upcc_tile_tapconv": [_P, _P, _P, _P, _I64, _P, _P, _I64, _I64, _I64,
                              _I64, _I64, ctypes.c_int, _I64, _I64, _P, _P],
    },
    "window_gather_sum": {
        # win, idx, tiles, s_rows, k, taps, slab width, out, stream
        "upcc_window_gather_sum": [_P, _P, _I64, _I64, _I64, _I64, _I64, _P,
                                   _P],
    },
}

RECORD = None
BUILD_LOG = {}
_libs = {}
_limits = {}
# the codec runs groups and frames on worker threads: the record and the
# first-use build are shared by them
_record_lock = threading.Lock()
_build_lock = threading.Lock()


def count_launch(name, *inputs):
    """Called by a wrapper right where it launches its kernel."""
    profiling.count("kernel." + name, 1)
    record = RECORD
    if record is not None:
        with _record_lock:
            record.setdefault(name, []).append(inputs)


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the GPU")
    return path


def _lib_path(name):
    src = os.path.join(_PKG, SOURCES[name])
    csrc = os.path.dirname(src)
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(os.path.join(csrc, h) for h in os.listdir(csrc)
                               if h.endswith(".cuh")):
        with open(path, "rb") as f:
            digest.update(f.read())
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


def device_limits(device):
    """(SMs, shared memory bytes a block may opt in to) of the card that
    holds ``device``."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    limits = _limits.get(index)
    if limits is None:
        props = torch.cuda.get_device_properties(index)
        limits = _limits[index] = (props.multi_processor_count,
                                   props.shared_memory_per_block_optin)
    return limits


def check(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(tensor):
    """The current CUDA stream of the tensor's device, as an int, without
    building the Stream object ``torch.cuda.current_stream`` returns."""
    return torch._C._cuda_getCurrentRawStream(tensor.device.index)


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
