"""External anchor codecs (G-PCC, V-PCC, IT-DL-PCC) and PCQM.

The port's copy of the JAX package's ``eval/anchors.py``, on the port's
``data/ply.py``.  These shell out to the MPEG reference binaries, the
PCQM binary or an IT-DL-PCC checkout when present; where they are absent
the hooks raise ``FileNotFoundError`` (``has_gpcc()`` tells beforehand)
instead of failing mid-evaluation, and ``pcqm()`` falls back to the native
PCQM (``eval/pcqm.py``).  The binary paths come from the same environment
variables as the JAX package's: ``UPCC_TMC3``, ``UPCC_TMC2``, ``UPCC_PCQM``
and ``UPCC_ITDLPCC``.
"""

import os
import shutil
import subprocess
import tempfile

import numpy as np

from ..data.ply import read_ply, write_ply

GPCC_BIN = os.environ.get("UPCC_TMC3", "./dependencies/mpeg-pcc-tmc13/build/tmc3/tmc3")
VPCC_BIN = os.environ.get("UPCC_TMC2", "./dependencies/mpeg-pcc-tmc2/bin/PccAppEncoder")
PCQM_BIN = os.environ.get("UPCC_PCQM", "./dependencies/PCQM/build/PCQM")


def has_gpcc():
    return shutil.which(GPCC_BIN) or os.path.exists(GPCC_BIN)


def compress_gpcc(points6, q_a=34, q_g=0.75, tmp_dir=None):
    """Lossy G-PCC anchor run (octree + RAHT) at the anchor settings of the
    JAX package.  Returns (reconstruction, bpp, t_enc, t_dec)."""
    if not has_gpcc():
        raise FileNotFoundError(f"tmc3 binary not found at {GPCC_BIN}")
    import time
    tmp = tmp_dir or tempfile.mkdtemp(prefix="gpcc_")
    src = os.path.join(tmp, "in.ply")
    binf = os.path.join(tmp, "out.bin")
    rec = os.path.join(tmp, "rec.ply")
    write_ply(src, points6[:, :3], points6[:, 3:6], ascii=True)
    enc = [GPCC_BIN, "--mode=0", f"--positionQuantizationScale={q_g}",
           "--mergeDuplicatedPoints=1", "--transformType=0",
           f"--qp={q_a}", "--attribute=color",
           f"--uncompressedDataPath={src}", f"--compressedStreamPath={binf}"]
    t0 = time.time()
    subprocess.run(enc, check=True, capture_output=True)
    t1 = time.time()
    dec = [GPCC_BIN, "--mode=1", f"--compressedStreamPath={binf}",
           f"--reconstructedDataPath={rec}", "--outputBinaryPly=0"]
    subprocess.run(dec, check=True, capture_output=True)
    t2 = time.time()
    xyz, rgb = read_ply(rec)
    out = np.concatenate([xyz.astype(np.float32),
                          rgb if rgb is not None else np.zeros((len(xyz), 3),
                                                               np.float32)], 1)
    bpp = os.path.getsize(binf) * 8.0 / len(points6)
    return out, bpp, t1 - t0, t2 - t1


def pcqm(reference6, reconstruction6, tmp_dir=None, max_points=None):
    """PCQM perceptual metric.  Runs the upstream PCQM binary when one is
    installed (for cross-validation); otherwise computes the native
    from-the-paper reimplementation (``eval/pcqm.py``).  Returns
    (value, source) with source in {"binary", "native"}.  max_points bounds
    the native fallback only (the binary always sees the full clouds)."""
    if os.path.exists(PCQM_BIN):
        import re
        tmp = tmp_dir or tempfile.mkdtemp(prefix="pcqm_")
        a = os.path.join(tmp, "ref.ply")
        b = os.path.join(tmp, "rec.ply")
        write_ply(a, reference6[:, :3], reference6[:, 3:6])
        write_ply(b, reconstruction6[:, :3], reconstruction6[:, 3:6])
        proc = subprocess.run([PCQM_BIN, a, b, "-fq", "-r 0.004", "-knn 20",
                               "-rx 2.0"], capture_output=True, text=True)
        m = re.search(r"PCQM\s*:?\s*([0-9.eE+-]+)", proc.stdout)
        if m:
            return float(m.group(1)), "binary"
    from .pcqm import pcqm as pcqm_native
    return pcqm_native(reference6, reconstruction6,
                       max_points=max_points), "native"


def compress_vpcc(points6, rate_preset=1, tmp_dir=None):
    """V-PCC (tmc2) anchor hook: runs the encoder when the binary exists
    and raises cleanly otherwise.  Returns (stream path, bpp, t_enc)."""
    if not (shutil.which(VPCC_BIN) or os.path.exists(VPCC_BIN)):
        raise FileNotFoundError(f"tmc2 binary not found at {VPCC_BIN}")
    import time
    tmp = tmp_dir or tempfile.mkdtemp(prefix="vpcc_")
    src = os.path.join(tmp, "in.ply")
    binf = os.path.join(tmp, "out.bin")
    write_ply(src, points6[:, :3], points6[:, 3:6])
    t0 = time.time()
    subprocess.run([VPCC_BIN, f"--uncompressedDataPath={src}",
                    f"--compressedStreamPath={binf}",
                    f"--rateIndex={rate_preset}"], check=True,
                   capture_output=True)
    bpp = os.path.getsize(binf) * 8.0 / len(points6)
    return binf, bpp, time.time() - t0


ITDLPCC_DIR = os.environ.get("UPCC_ITDLPCC", "./dependencies/IT-DL-PCC")


def compress_itdlpcc(points6, rate=1, with_color=True, tmp_dir=None):
    """IT-DL-PCC anchor hook: shells out to the IT-DL-PCC python codec when
    its checkout and weights exist.  Returns (stream paths, bpp, t_enc)."""
    script = os.path.join(ITDLPCC_DIR, "src", "compress.py")
    if not os.path.exists(script):
        raise FileNotFoundError(f"IT-DL-PCC not found at {ITDLPCC_DIR}")
    import sys
    import time
    tmp = tmp_dir or tempfile.mkdtemp(prefix="itdlpcc_")
    src = os.path.join(tmp, "in.ply")
    write_ply(src, points6[:, :3], points6[:, 3:6])
    kind = "joint" if with_color else "geo"
    t0 = time.time()
    subprocess.run([sys.executable, script, src, tmp,
                    "--model", os.path.join(ITDLPCC_DIR, "models", kind,
                                            f"R{rate}")],
                   check=True, capture_output=True)
    outs = [os.path.join(tmp, f) for f in os.listdir(tmp) if f.endswith(".gz")]
    bits = sum(os.path.getsize(o) * 8 for o in outs)
    return outs, bits / len(points6), time.time() - t0
