"""Evaluation driver of the port: RD sweep over the (q_g, q_a) grid ->
``results/<exp>/test.csv``.

    python3 -m upcc_tpu_torch.evaluate --experiments CVPR_inverse_scaling \
        [--q_steps 11] [--sequences longdress ...] [--device cpu]

The port's counterpart of the root ``evaluate.py``, with its command line
(plus ``--device``) and its 23 ``test.csv`` columns in the same order.  Per
experiment: load the codec with ``codec/io.py::load_codec`` (on the card
unless ``--device cpu``), sweep each test sequence over the quality grid,
time compress and decompress, refit the colors (the affine and the residual
layer at the experiment's ``lambda_A(q_a)``), and score each row with D1,
D2, YUV and PCQM on the host.  A depth-1 worker thread scores row k while
the device runs row k+1; rows keep sweep order, and an exception raised in
the worker is raised again on the calling thread.

Test sequences whose PLY is absent are rebuilt from ``scan_like_cloud``,
seeded by the sequence's name, and their rows carry ``synthetic=1``.

One deliberate difference: ``--append`` (merge into an existing
``test.csv``) is decided per experiment; the root driver carries the flag,
once set by its first flush, over to the next experiment.
"""

import argparse
import csv
import os
import queue
import threading
import time

import numpy as np

TEST_SET = {
    "loot": {"resolution": 1023, "block_size": 1024, "frame": 1200},
    "longdress": {"resolution": 1023, "block_size": 1024, "frame": 1300},
    "soldier": {"resolution": 1023, "block_size": 1024, "frame": 690},
    "redandblack": {"resolution": 1023, "block_size": 1024, "frame": 1550},
    "basketball_player": {"resolution": 2047, "block_size": 512, "frame": 200},
    "dancer": {"resolution": 2047, "block_size": 512, "frame": 1},
    "exercise": {"resolution": 2047, "block_size": 512, "frame": 1},
    "model": {"resolution": 2047, "block_size": 512, "frame": 1},
}

# Anchor codecs swept over their own grids instead of the learned (q_g, q_a)
# unit grid (G-PCC: qp x positionQuantizationScale).  "gpcc_native" is the
# native octree+RAHT construction (codec/raht.py).
ANCHOR_GRIDS = {
    "gpcc_native": {"q_as": [51, 46, 40, 34, 28, 22],
                    "q_gs": [0.0625, 0.125, 0.25, 0.5, 0.75, 0.875, 0.9375]},
}


def frame_filename(sequence, spec):
    """Per-sequence PLY name: vox10 (8iVFBv2) frames carry 4-digit frame
    numbers, vox11 (Owlii) 8-digit."""
    if spec["resolution"] <= 1023:
        return f"{sequence}_vox10_{spec['frame']:04d}.ply"
    return f"{sequence}_vox11_{spec['frame']:08d}.ply"


def find_frame_path(sequence, spec, data_root="./data/raw"):
    fname = frame_filename(sequence, spec)
    dataset = "8iVFB" if spec["resolution"] <= 1023 else "Owlii"
    for sub in (sequence, dataset, ""):
        path = os.path.join(data_root, sub, fname)
        if os.path.exists(path):
            return path
    return None


def load_frame(sequence, spec, data_root="./data/raw", allow_synthetic=True):
    """(frame [N, 6], synthetic): the PLY if there is one, else a synthetic
    scan-like frame at the sequence's scale, seeded by its name (the same
    frame the JAX driver builds).  The fallback is announced, and callers
    carry ``synthetic`` into the CSV."""
    path = find_frame_path(sequence, spec, data_root)
    if path is not None:
        from .data.ply import read_ply
        xyz, rgb = read_ply(path)
        return np.concatenate([xyz.astype(np.float32), rgb], axis=1), False
    if not allow_synthetic:
        raise FileNotFoundError(
            f"no PLY for {sequence!r} ({frame_filename(sequence, spec)}) "
            f"under {data_root} and --require_real_data was given")
    print(f"WARNING: no PLY for {sequence!r} "
          f"({frame_filename(sequence, spec)}) under {data_root} — "
          "substituting a SYNTHETIC frame; CSV rows are tagged synthetic=1",
          flush=True)
    from .data.synthetic import scan_like_cloud
    n = 760_000 if spec["resolution"] <= 1023 else 1_200_000
    seed = int(np.frombuffer(sequence.encode().ljust(8, b"\0")[:8],
                             np.uint32)[0]) % (2 ** 31)
    rng = np.random.default_rng(seed)
    xyz, rgb = scan_like_cloud(rng, extent=spec["resolution"] + 1, n_target=n)
    return np.concatenate([xyz.astype(np.float32), rgb], axis=1), True


def make_pcqm(mode, pcqm_max_points):
    """The PCQM of the ``pcqm`` column.  'native': ``eval/pcqm.py`` (its
    feature weights are reconstructed from the paper, so absolute values
    need not match the PCQM binary's; comparisons within the repo are
    consistent).  'external': the PCQM binary through ``eval/anchors.py``
    where one is installed (``UPCC_PCQM``), else native, announced once.
    ``f.prepare(pc)`` builds the per-sequence reference-side structures."""
    if mode == "external":
        from .eval.anchors import pcqm as pcqm_ext
        state = {"announced": False}

        def f(pc, rec):
            val, src = pcqm_ext(pc, rec, max_points=pcqm_max_points)
            if not state["announced"]:
                print(f"[pcqm] external mode -> source: {src}")
                state["announced"] = True
            return val
        # the binary reads the reference PLY per call: nothing to cache
        f.prepare = lambda pc: pc
        return f
    from .eval.pcqm import PreparedRef, pcqm

    def f(pc, rec):
        return pcqm(pc, rec, max_points=pcqm_max_points)
    f.prepare = lambda pc: PreparedRef(pc, max_points=pcqm_max_points)
    return f


def write_testset_csv(path, rows, append=False):
    """Write sweep rows; with ``append``, merge into an existing file: rows
    of the sequences re-run here replace the old ones, every other
    sequence's rows stay, and the column sets are unioned.  Returns the
    number of old rows kept."""
    old = []
    if append and os.path.exists(path):
        with open(path, newline="") as f:
            redone = {r["sequence"] for r in rows}
            old = [r for r in csv.DictReader(f)
                   if r["sequence"] not in redone]
    fields = list(rows[0])
    for r in old:
        for k in r:
            if k not in fields:
                fields.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, restval="")
        w.writeheader()
        w.writerows(old)
        w.writerows(rows)
    return len(old)


def _sequences(sequences):
    return [(s, spec) for s, spec in TEST_SET.items()
            if not sequences or s in sequences]


def _subsample(pc, max_points):
    if max_points and len(pc) > max_points:
        pc = pc[np.random.default_rng(0).choice(len(pc), max_points,
                                                replace=False)]
    return pc


def run_anchor_testset(exp, sequences=None, with_metrics=True,
                       data_root="./data/raw", results_path="./results",
                       max_points=None, allow_synthetic=True, with_pcqm=True,
                       pcqm_max_points=200_000, pcqm_mode="native",
                       append=False):
    """Sweep an anchor codec (``ANCHOR_GRIDS``) over its grid."""
    from .codec import raht
    from .eval.metrics import PreparedSource, pc_metrics
    pcqm_fn = make_pcqm(pcqm_mode, pcqm_max_points)
    grid = ANCHOR_GRIDS[exp]
    exp_dir = os.path.join(results_path, exp)
    os.makedirs(exp_dir, exist_ok=True)
    rows = []
    for seq, spec in _sequences(sequences):
        pc, synthetic = load_frame(seq, spec, data_root,
                                   allow_synthetic=allow_synthetic)
        pc = _subsample(pc, max_points)
        src_prep = PreparedSource(pc) if with_metrics else None
        pcqm_ref = pcqm_fn.prepare(pc) \
            if (with_metrics and with_pcqm) else None
        for qg in grid["q_gs"]:
            for qa in grid["q_as"]:
                t0 = time.time()
                data = raht.compress(pc, q_g=qg, qp=qa)
                t1 = time.time()
                rec = raht.decompress(data)
                t2 = time.time()
                row = {"sequence": seq, "frameIdx": spec["frame"],
                       "q_g": qg, "q_a": qa,
                       "bpp": len(data) * 8 / len(pc),
                       "t_compress": t1 - t0, "t_decompress": t2 - t1,
                       "num_points": len(pc), "synthetic": int(synthetic)}
                if with_metrics:
                    m = pc_metrics(src_prep, rec, spec["resolution"])
                    row.update({k: v for k, v in m.items()
                                if k.startswith("sym_")})
                    if with_pcqm:
                        row["pcqm"] = pcqm_fn(pcqm_ref, rec)
                rows.append(row)
                print(f"[{exp}] {seq} qp={qa} scale={qg} "
                      f"bpp={row['bpp']:.3f}", flush=True)
    if rows:
        path = os.path.join(exp_dir, "test.csv")
        n_old = write_testset_csv(path, rows, append)
        print(f"[{exp}] wrote {path} "
              f"({n_old + len(rows)} rows, {len(rows)} new)")


def lambda_a_schedule(cfg):
    """The experiment's residual-layer weight lambda_A(q_a), from its
    ``q_map`` (the training schedule of the rate control)."""
    qmap = (cfg or {}).get("q_map", {})
    la_min = float(qmap.get("lambda_A_min", 0.0))
    la_max = float(qmap.get("lambda_A_max", 12800.0))

    def lambda_a(qa):
        if qmap.get("mode") == "exponential":
            return 2.0 ** (qa * np.log2(la_max + la_min)) + la_min - 1.0
        return qa * qa * (la_max - la_min) + la_min
    return lambda_a


class _MetricWorker:
    """One worker thread that finishes rows (color refit, metrics, PCQM,
    renders) while the caller runs the next row's device work.  At most
    one job waits; after a failure the rest are drained without work and
    the exception is raised on the caller's thread by ``put``, ``drain``
    and ``check``."""

    def __init__(self, finish):
        self.finish = finish
        self.jobs = queue.Queue(maxsize=1)
        self.errors = []
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while True:
            job = self.jobs.get()
            try:
                if job is None:
                    return
                if not self.errors:
                    self.finish(*job)
            except BaseException as e:  # raised again on the caller's thread
                self.errors.append(e)
            finally:
                self.jobs.task_done()

    def check(self):
        if self.errors:
            raise self.errors[0]

    def put(self, *job):
        self.check()
        self.jobs.put(job)

    def drain(self):
        self.jobs.join()
        self.check()

    def close(self):
        self.jobs.put(None)
        self.thread.join()


def _corner(qg, qa):
    return qg == qa and qg in (0.0, 1.0)


def run_testset(experiments, q_steps=11, sequences=None, with_metrics=True,
                data_root="./data/raw", results_path="./results",
                max_points=None, allow_synthetic=True, with_pcqm=True,
                pcqm_max_points=200_000, with_renders=True, append=False,
                pcqm_mode="native", geom="topk", color_affine=True,
                color_resid=True, device="cuda", q_points=None):
    """Sweep each experiment over ``linspace(0, 1, q_steps)`` squared (or
    the (q_g, q_a) pairs of ``q_points``) on every selected test sequence
    and write ``<results_path>/<exp>/test.csv`` (``<exp>_coded`` for
    ``geom="coded"``), flushed after each sequence.  Renders at the corner
    qualities q = (0, 0) and (1, 1) need matplotlib."""
    from .codec.io import load_codec
    from .eval.metrics import PreparedSource, pc_metrics

    pcqm_fn = make_pcqm(pcqm_mode, pcqm_max_points)
    if q_points is None:
        qs = np.linspace(0, 1, q_steps)
        q_points = [(qg, qa) for qg in qs for qa in qs]
    q_points = [(float(qg), float(qa)) for qg, qa in q_points]
    for exp in experiments:
        if exp in ANCHOR_GRIDS:
            run_anchor_testset(exp, sequences, with_metrics, data_root,
                               results_path, max_points, allow_synthetic,
                               with_pcqm, pcqm_max_points, pcqm_mode,
                               append=append)
            continue
        codec, cfg = load_codec(os.path.join(results_path, exp),
                                device=device)
        lambda_a = lambda_a_schedule(cfg)
        if geom == "coded":
            # the lossless-geometry sweep is its own RD curve: a sibling
            # experiment
            exp = exp + "_coded"
        exp_dir = os.path.join(results_path, exp)
        os.makedirs(exp_dir, exist_ok=True)
        rows = []

        def finish(row, data, rec, corner, lam_a, t_dec, seq_ctx):
            pc, prep, resolution, pcqm_ref, floor_cache = seq_ctx
            host = {}  # host seconds of this row's refit, metrics, PCQM
            if color_affine or lam_a > 0.0:
                # the encoder-side color refit consumes a self-decode, so
                # its wall time and the decode's count into t_compress
                t3 = time.time()
                stree = prep.tree if prep is not None else None
                fkey = row["q_g"]
                if lam_a > 0.0 and fkey not in floor_cache:
                    # the AB-direction floor depends on geometry only:
                    # one estimate serves a q_g's whole q_a column
                    from .codec.color_resid import estimate_ab_floor
                    floor_cache[fkey] = estimate_ab_floor(
                        rec, pc, source_tree=stree)
                data, rec = codec.refit_colors(
                    data, pc, rec=rec, source_tree=stree,
                    resid_lam=lam_a, fit_affine=color_affine,
                    resid_floor=floor_cache.get(fkey, 0.0))
                host["refit"] = time.time() - t3
                row["t_compress"] += host["refit"] + t_dec
            row["bpp"] = len(data) * 8 / row["num_points"]
            if with_metrics:
                t_host = time.time()
                m = pc_metrics(prep, rec, resolution)
                row.update({k: v for k, v in m.items()
                            if k.startswith("sym_")})
                host["metrics"] = time.time() - t_host
                if with_pcqm:
                    t_host = time.time()
                    row["pcqm"] = pcqm_fn(pcqm_ref, rec)
                    host["pcqm"] = time.time() - t_host
            if corner is not None:
                from .eval.render import render_pointcloud
                render_pointcloud(rec, path_prefix=corner)
            rows.append(row)
            print(f"[{exp}] {row['sequence']} "
                  f"q=({row['q_g']:.2f},{row['q_a']:.2f}) "
                  f"bpp={row['bpp']:.3f} enc={row['t_compress']:.2f}s "
                  f"dec={row['t_decompress']:.2f}s host "
                  + " ".join(f"{k}={v:.2f}s" for k, v in host.items()),
                  flush=True)

        worker = _MetricWorker(finish)
        exp_append = append
        try:
            for seq, spec in _sequences(sequences):
                pc, synthetic = load_frame(seq, spec, data_root,
                                           allow_synthetic=allow_synthetic)
                pc = _subsample(pc, max_points)
                seq_ctx = (pc, PreparedSource(pc) if with_metrics else None,
                           spec["resolution"],
                           pcqm_fn.prepare(pc)
                           if (with_metrics and with_pcqm) else None, {})
                for qg, qa in q_points:
                    t0 = time.time()
                    data = codec.compress(pc, q=(qg, qa),
                                          block_size=spec["block_size"],
                                          geom=geom)
                    t1 = time.time()
                    rec = codec.decompress(data)
                    t2 = time.time()
                    row = {"sequence": seq, "frameIdx": spec["frame"],
                           "q_g": round(qg, 3), "q_a": round(qa, 3),
                           "bpp": len(data) * 8 / len(pc),
                           "t_compress": t1 - t0, "t_decompress": t2 - t1,
                           "num_points": len(pc),
                           "synthetic": int(synthetic)}
                    corner = None
                    if with_renders and _corner(qg, qa):
                        corner = os.path.join(exp_dir, "renders",
                                              f"{seq}_q{qg:.2f}_{qa:.2f}")
                    lam_a = lambda_a(qa) if color_resid else 0.0
                    worker.put(row, data, rec, corner, lam_a, t2 - t1,
                               seq_ctx)
                # flush this sequence's rows once its grid is done; the
                # first flush of this experiment follows ``append``, later
                # ones merge
                worker.drain()
                if rows:
                    path = os.path.join(exp_dir, "test.csv")
                    n_old = write_testset_csv(path, rows, exp_append)
                    exp_append = True
                    print(f"[{exp}] wrote {path} "
                          f"({n_old + len(rows)} rows, {len(rows)} new)",
                          flush=True)
                    rows.clear()
        finally:
            worker.close()
        worker.check()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m upcc_tpu_torch.evaluate")
    ap.add_argument("--experiments", nargs="+",
                    default=["CVPR_inverse_scaling"])
    ap.add_argument("--q_steps", type=int, default=11)
    ap.add_argument("--sequences", nargs="*", default=None)
    ap.add_argument("--no_metrics", action="store_true")
    ap.add_argument("--max_points", type=int, default=None)
    ap.add_argument("--data_root", default="./data/raw")
    ap.add_argument("--require_real_data", action="store_true",
                    help="fail instead of substituting synthetic frames")
    ap.add_argument("--no_pcqm", action="store_true")
    ap.add_argument("--no_renders", action="store_true")
    ap.add_argument("--pcqm_max_points", type=int, default=200_000)
    ap.add_argument("--pcqm", choices=["native", "external"],
                    default="native",
                    help="'external' uses the PCQM binary (UPCC_PCQM) "
                         "where one is installed, else native")
    ap.add_argument("--append", action="store_true",
                    help="extend an existing test.csv instead of rewriting "
                         "it (rows for re-run sequences are replaced)")
    ap.add_argument("--geom", choices=["topk", "coded"], default="topk",
                    help="'coded' sweeps the lossless-geometry mode and "
                         "writes results/<exp>_coded/test.csv")
    ap.add_argument("--no_color_affine", action="store_true",
                    help="disable the signaled color affine refit")
    ap.add_argument("--no_color_resid", action="store_true",
                    help="disable the signaled residual color layer")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the codec (default: the card)")
    a = ap.parse_args(argv)
    run_testset(a.experiments, a.q_steps, a.sequences,
                with_metrics=not a.no_metrics, max_points=a.max_points,
                data_root=a.data_root,
                allow_synthetic=not a.require_real_data,
                with_pcqm=not a.no_pcqm, pcqm_max_points=a.pcqm_max_points,
                with_renders=not a.no_renders, append=a.append,
                pcqm_mode=a.pcqm, geom=a.geom,
                color_affine=not a.no_color_affine,
                color_resid=not a.no_color_resid, device=a.device)


if __name__ == "__main__":
    main()
