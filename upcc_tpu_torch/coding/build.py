"""Content-hash-keyed build of the native C++ host components.

Shared libraries are built with g++ into ``build/native`` at the
repository root (``UPCC_TORCH_BUILD`` overrides the root), keyed by the
SHA-256 of the source plus the compile flags: a fresh checkout compiles
for the local microarchitecture (``-march=native``) and an edited source
always rebuilds.  ``load_native`` raises when the build fails, with
g++'s stderr; ``try_native`` turns that into one warning and ``False``,
on which each coder runs its pure-Python (or numpy) twin, which writes
the same bytes.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import warnings

from ..kernels import BUILD_DIR

_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC",
          "-std=c++17"]


def _cache_dir():
    d = os.path.join(BUILD_DIR, "native")
    os.makedirs(d, exist_ok=True)
    return d


def load_native(src_path, name):
    """Build (if needed) and dlopen the shared library for ``src_path``."""
    with open(src_path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    lib_path = os.path.join(_cache_dir(),
                            f"{name}-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(lib_path):
        # build to a temp name then rename, so concurrent processes never
        # dlopen a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_cache_dir())
        os.close(fd)
        try:
            proc = subprocess.run(["g++", *_FLAGS, src_path, "-o", tmp],
                                  capture_output=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for {src_path}:\n"
                                   + proc.stderr.decode(errors="replace"))
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(lib_path)


def try_native(src_path, name):
    """``load_native``, or ``False`` with one warning carrying the build's
    error (g++'s stderr) where the library cannot be built or loaded."""
    try:
        return load_native(src_path, name)
    except (RuntimeError, OSError) as e:
        warnings.warn(f"native {name} unavailable, running its Python "
                      f"twin (the same output, far slower):\n{e}",
                      RuntimeWarning, stacklevel=3)
        return False
