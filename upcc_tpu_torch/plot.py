"""Reporting of the port (the twin of the root ``plot.py``): RD curves,
(q_g, q_a) contour maps, BD-delta tables and timing.

    python3 -m upcc_tpu_torch.plot --experiments CVPR_inverse_scaling \
        [--anchor gpcc_native] [--anchor_points style|pareto] \
        [--results_path ./results]

Loads each experiment's ``results/<exp>/test.csv`` (PCQM flipped to
1-PCQM, per-dataset averaged pseudo-sequence rows appended), extracts
PCQM-Pareto fronts, draws RD figures at each method's per-dataset BD
points, writes BD-rate / BD-PSNR deltas against an anchor
(``bd_deltas.csv``) and compress / decompress times with 95% CIs
(``timing.csv``), all on ``eval/bjontegaard.py``.

The root script's pandas frames are tables here: a dict of column name ->
numpy array (floats for numeric columns, objects for text), built with the
``csv`` module, whose selections, sorts and group means follow pandas'
rules (quicksort order, NaN last, NaN-skipping means, sorted group keys),
so the CSVs equal the root script's.  matplotlib is imported by the two
figure functions only.
"""

import argparse
import csv
import math
import os
import warnings

import numpy as np

from .eval.bjontegaard import (BjontegaardModel, bd_psnr, bd_rate,
                               quality_overlap, rate_overlap)

# test-set -> sequence registry (reference plot/style.py `datasets`)
DATASETS = {
    "8iVFBv2": ["loot", "longdress", "soldier", "redandblack"],
    "Owlii": ["basketball_player", "dancer", "exercise", "model"],
}

_OURS_BD = {"8iVFBv2": [(0.1, 0.1), (0.2, 0.2), (0.4, 0.4), (1.0, 1.0)],
            "Owlii": [(0.1, 0.1), (0.2, 0.2), (0.4, 0.4), (1.0, 1.0)]}

# per-method styles + BD evaluation points (reference plot/style.py:45-152)
RUNS = {
    "CVPR_inverse_scaling": {
        "label": "Ours", "color": "tab:blue", "marker": "o",
        "linestyle": "-", "bd_points": _OURS_BD,
    },
    "CVPR_inverse_scaling_coded": {
        "label": "Ours (lossless geometry)", "color": "tab:olive",
        "marker": "*", "linestyle": "-", "bd_points": _OURS_BD,
    },
    "CVPR_inverse_nn": {
        "label": "Ours (learned rescale)", "color": "tab:orange",
        "marker": "s", "linestyle": "--", "bd_points": _OURS_BD,
    },
    "CVPR_inverse_scaling_shepard": {
        "label": "Ours (MSE+IWD)", "color": "tab:purple", "marker": "v",
        "linestyle": "-.", "bd_points": _OURS_BD,
    },
    "CVPR_inverse_scaling_256": {
        "label": "Ours (256)", "color": "tab:cyan", "marker": "^",
        "linestyle": ":", "bd_points": _OURS_BD,
    },
    # the four fixed-rate models plot as one curve per config
    **{f"CVPR_inverse_scaling_fixed_R{i}": {
        "label": f"Fixed R{i}", "color": "tab:gray", "marker": "x",
        "linestyle": ":", "bd_points": {"8iVFBv2": [(1.0, 1.0)],
                                        "Owlii": [(1.0, 1.0)]}}
       for i in range(1, 5)},
    # anchors (reference style.py:49-60; grids from evaluate.py:91-95).
    # gpcc_native is the native octree+RAHT anchor (codec/raht.py).
    "gpcc_native": {
        "label": "G-PCC (native octree+RAHT)", "color": "tab:green",
        "marker": "D", "linestyle": "--",
        "bd_points": {"8iVFBv2": [(0.5, 40), (0.75, 34), (0.875, 28),
                                  (0.9375, 22)],
                      "Owlii": [(0.25, 40), (0.5, 34), (0.75, 28),
                                (0.875, 22)]},
    },
    "IT-DL-PCC": {
        "label": "IT-DL-PCC", "color": "tab:red", "marker": "P",
        "linestyle": ":",
        "bd_points": {"8iVFBv2": [(0.001, 0.0), (0.002, 0.0), (0.004, 0.0),
                                  (0.0005, 0.0)],
                      "Owlii": [(0.001, 0.0), (0.002, 0.0), (0.004, 0.0),
                                (0.0005, 0.0)]},
    },
}

# metric -> axis label (reference plot/style.py metric_labels; pcqm is
# plotted as 1-PCQM after the load_csvs flip)
METRICS = [("sym_y_psnr", "Y-PSNR [dB]"), ("sym_psnr_mse", "D1-PSNR [dB]"),
           ("sym_yuv_psnr", "YUV-PSNR [dB]"), ("pcqm", r"$1-$PCQM")]

# Minimum shared fraction of the BD integration domain (log-rate for
# BD-PSNR, quality for BD-rate) below which the fits extrapolate and the
# deltas are reported as NaN.
BD_MIN_OVERLAP = 0.2


# -- tables: dict of column -> numpy array ------------------------------------

def _nrows(t):
    return len(next(iter(t.values()))) if t else 0


def _numeric(col):
    return col.dtype.kind in "fiub"


def _take(t, idx):
    """Rows ``idx`` (a boolean mask or positions) of every column."""
    return {k: v[idx] for k, v in t.items()}


def _column(values):
    """A float column where every value parses as a number (empty cells
    are NaN), else a text column."""
    try:
        return np.array([float(v) if v != "" else np.nan for v in values],
                        float)
    except ValueError:
        return np.array([v if v != "" else np.nan for v in values], object)


def read_table(path):
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    return {name: _column([r[i] for r in rows])
            for i, name in enumerate(header)}


def _cell(v):
    if isinstance(v, (float, np.floating)):
        return "" if math.isnan(v) else repr(float(v))
    if isinstance(v, np.integer):
        return str(int(v))
    return str(v)


def write_rows(path, rows):
    """Rows (dicts with the same keys) as a CSV: floats by repr, NaN as an
    empty cell."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(rows[0]))
        for r in rows:
            w.writerow([_cell(v) for v in r.values()])


def _concat(tables):
    """Rows of every table in order; columns in order of first appearance,
    NaN where a table lacks one."""
    cols = []
    for t in tables:
        cols += [c for c in t if c not in cols]
    out = {}
    for c in cols:
        parts = [t[c] if c in t else np.full(_nrows(t), np.nan)
                 for t in tables]
        kind = object if any(p.dtype == object for p in parts) else float
        out[c] = np.concatenate([p.astype(kind) for p in parts])
    return out


def _sort_index(v):
    """Positions of ``v`` sorted ascending, NaN last (pandas' nargsort with
    its default quicksort)."""
    v = np.asarray(v, float)
    nan = np.isnan(v)
    idx = np.arange(len(v))
    return np.concatenate([idx[~nan][np.argsort(v[~nan], kind="quicksort")],
                           idx[nan]])


def _nanmean(v):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return float(np.nanmean(v)) if len(v) else float("nan")


def _group_mean(t, keys):
    """Mean of every numeric column over the groups of ``keys`` (sorted
    by the keys, NaN keys dropped, NaN values skipped); columns: the keys,
    then the other numeric columns in order."""
    kv = np.stack([t[k] for k in keys], 1) if _nrows(t) else \
        np.zeros((0, len(keys)))
    ok = ~np.isnan(kv).any(1)
    groups = sorted({tuple(row) for row in kv[ok]})
    vals = [c for c in t if c not in keys and _numeric(t[c])]
    out = {k: np.array([g[i] for g in groups], float)
           for i, k in enumerate(keys)}
    for c in vals:
        out[c] = np.array([_nanmean(t[c][ok & (kv == g).all(1)])
                           for g in groups], float)
    return out


def _unique(col):
    seen = []
    for v in col:
        if v not in seen:
            seen.append(v)
    return seen


def dataset_of(sequence):
    for ds, seqs in DATASETS.items():
        if sequence in seqs or sequence == ds:
            return ds
    return "8iVFBv2"


def bd_points_for(exp, sequence):
    pts = RUNS.get(exp, {}).get("bd_points", _OURS_BD)
    if isinstance(pts, dict):
        return pts.get(dataset_of(sequence), next(iter(pts.values())))
    return pts


def load_csvs(experiments, results_path="./results"):
    """Load test.csvs; flip pcqm to 1-PCQM and append per-dataset averaged
    pseudo-sequence rows (reference plot.py:459-486)."""
    frames = {}
    for exp in experiments:
        path = os.path.join(results_path, exp, "test.csv")
        if not os.path.exists(path):
            continue
        df = read_table(path)
        if "pcqm" in df:
            df["pcqm"] = 1.0 - df["pcqm"]
        averaged = []
        for testset, seqs in DATASETS.items():
            sub = _take(df, np.isin(df["sequence"], seqs))
            if not _nrows(sub):
                continue
            grouped = _group_mean(sub, ["q_a", "q_g"])
            grouped["sequence"] = np.full(_nrows(grouped), testset, object)
            averaged.append(grouped)
        frames[exp] = _concat([df] + averaged) if averaged else df
    return frames


def get_pareto_df(df, metric="pcqm"):
    """Per-sequence Pareto front: walk rows by increasing bpp, keep rows
    that improve the metric (reference plot.py:438-457)."""
    keep = []
    for sequence in _unique(df["sequence"]):
        idx = np.flatnonzero(df["sequence"] == sequence)
        best = -np.inf
        for i in idx[_sort_index(df["bpp"][idx])]:
            if df[metric][i] >= best:
                best = df[metric][i]
                keep.append(i)
    return _take(df, np.array(keep, int))


def bd_curve(df, bd_points):
    """Rows nearest to each (q_g, q_a) BD point, averaged over sequences."""
    numeric = [c for c in df if _numeric(df[c])]
    rows = []
    for qg, qa in bd_points:
        dist = np.abs(df["q_g"] - qg) + np.abs(df["q_a"] - qa)
        i = np.argsort(dist, kind="quicksort")[0]
        sel = (df["q_g"] == df["q_g"][i]) & (df["q_a"] == df["q_a"][i])
        rows.append([_nanmean(df[c][sel]) for c in numeric])
    arr = np.array(rows, float).reshape(len(rows), len(numeric))
    return {c: arr[:, j] for j, c in enumerate(numeric)}


def _style(exp):
    return RUNS.get(exp, {"label": exp, "color": None, "marker": "o",
                          "linestyle": "-"})


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_rd(frames, out_dir, sequence=None, pareto=False):
    plt = _pyplot()
    os.makedirs(out_dir, exist_ok=True)
    for mkey, mlabel in METRICS:
        fig, ax = plt.subplots(figsize=(5, 4))
        drawn = False
        for exp, df in frames.items():
            if sequence:
                df = _take(df, df["sequence"] == sequence)
            if mkey not in df or not _nrows(df) or np.isnan(
                    df[mkey].astype(float)).all():
                continue
            style = _style(exp)
            if pareto and "pcqm" in df:
                front = get_pareto_df(df, metric=mkey)
                cur = _group_mean({"bpp": front["bpp"], mkey: front[mkey]},
                                  ["bpp"])
            else:
                cur = bd_curve(df, bd_points_for(exp, sequence or "loot"))
                cur = _take(cur, _sort_index(cur["bpp"]))
            if _nrows(cur) >= 2:
                model = BjontegaardModel(cur["bpp"], cur[mkey])
                xs = np.linspace(cur["bpp"].min(), cur["bpp"].max(), 50)
                ax.plot(xs, model.quality_at(xs), color=style["color"],
                        linestyle=style.get("linestyle", "-"),
                        label=style["label"])
            ax.plot(cur["bpp"], cur[mkey], style.get("marker", "o"),
                    color=style["color"],
                    label=None if _nrows(cur) >= 2 else style["label"])
            drawn = True
        if not drawn:
            plt.close(fig)
            continue
        ax.set_xlabel("bpp")
        ax.set_ylabel(mlabel)
        ax.grid(alpha=0.3)
        ax.legend()
        name = f"rd_{mkey}{'_' + sequence if sequence else ''}" \
               f"{'_pareto' if pareto else ''}.png"
        fig.savefig(os.path.join(out_dir, name), dpi=150,
                    bbox_inches="tight")
        plt.close(fig)


def plot_contours(frames, out_dir, metric="bpp"):
    """Contour of a metric over the (q_a, q_g) grid
    (reference plot.py:102-180)."""
    plt = _pyplot()
    os.makedirs(out_dir, exist_ok=True)
    for exp, df in frames.items():
        if metric not in df:
            continue
        g = _group_mean({"q_g": df["q_g"], "q_a": df["q_a"],
                         metric: df[metric]}, ["q_g", "q_a"])
        rows, cols = np.unique(g["q_g"]), np.unique(g["q_a"])
        piv = np.full((len(rows), len(cols)), np.nan)
        piv[np.searchsorted(rows, g["q_g"]),
            np.searchsorted(cols, g["q_a"])] = g[metric]
        if piv.size < 4:
            continue
        fig, ax = plt.subplots(figsize=(5, 4))
        cs = ax.contourf(cols, rows, piv, levels=15, cmap="viridis")
        fig.colorbar(cs, ax=ax, label=metric)
        ax.set_xlabel("q_a")
        ax.set_ylabel("q_g")
        fig.savefig(os.path.join(out_dir, f"contour_{metric}_{exp}.png"),
                    dpi=150, bbox_inches="tight")
        plt.close(fig)


def anchor_bd_curve(a_seq, mkey, rate_lo, rate_hi):
    """Anchor RD curve for BD integration: the Pareto front over ``mkey``
    inside the padded rate window [rate_lo / 2, 2 rate_hi] around the
    candidate curve, or the whole front where fewer than two of its rows
    fall inside (the root script's rule)."""
    front = get_pareto_df(a_seq, metric=mkey)
    win = _take(front, (front["bpp"] >= rate_lo * 0.5)
                & (front["bpp"] <= rate_hi * 2.0))
    return win if _nrows(win) >= 2 else front


def compute_bd_deltas(frames, anchor, out_dir, anchor_points="style"):
    """BD-rate / BD-PSNR of each run against the anchor run (reference
    plot.py:376-436), written to ``bd_deltas.csv``; returns the rows (a
    list of dicts), None without the anchor.  Rows carry the overlap
    fractions of the two integration domains; a delta whose domain
    overlaps less than BD_MIN_OVERLAP is NaN, and ``status`` says which
    axis failed.  anchor_points: "style" (the registry's fixed (q_g, q_a)
    pairs) or "pareto" (``anchor_bd_curve``)."""
    if anchor not in frames:
        return None
    rows = []
    a_df = frames[anchor]
    for exp, df in frames.items():
        if exp == anchor:
            continue
        for mkey, _ in METRICS:
            if mkey not in df or mkey not in a_df:
                continue
            for seq in sorted(set(df["sequence"]) & set(a_df["sequence"])):
                cb = bd_curve(_take(df, df["sequence"] == seq),
                              bd_points_for(exp, seq))
                if anchor_points == "pareto" and _nrows(cb):
                    ca = anchor_bd_curve(_take(a_df, a_df["sequence"] == seq),
                                         mkey, cb["bpp"].min(),
                                         cb["bpp"].max())
                else:
                    ca = bd_curve(_take(a_df, a_df["sequence"] == seq),
                                  bd_points_for(anchor, seq))
                if _nrows(ca) < 2 or _nrows(cb) < 2 \
                        or np.isnan(ca[mkey].astype(float)).any() \
                        or np.isnan(cb[mkey].astype(float)).any():
                    continue
                ov_r = rate_overlap(ca["bpp"], cb["bpp"])
                ov_q = quality_overlap(ca[mkey], cb[mkey])
                ok_p = ov_r >= BD_MIN_OVERLAP
                ok_r = ov_q >= BD_MIN_OVERLAP
                status = ("ok" if ok_p and ok_r else
                          "no_quality_overlap" if ok_p else
                          "no_rate_overlap" if ok_r else "no_overlap")
                rows.append({
                    "experiment": exp, "sequence": seq, "metric": mkey,
                    "bd_rate_%": bd_rate(ca["bpp"], ca[mkey], cb["bpp"],
                                         cb[mkey],
                                         min_overlap=BD_MIN_OVERLAP)
                    if ok_r else float("nan"),
                    "bd_psnr_dB": bd_psnr(ca["bpp"], ca[mkey], cb["bpp"],
                                          cb[mkey],
                                          min_overlap=BD_MIN_OVERLAP)
                    if ok_p else float("nan"),
                    "overlap_rate": ov_r,
                    "overlap_quality": ov_q,
                    "status": status,
                    "anchor_points": anchor_points,
                })
    if rows:
        os.makedirs(out_dir, exist_ok=True)
        write_rows(os.path.join(out_dir, "bd_deltas.csv"), rows)
    return rows


def compute_times(frames, out_dir):
    """Timing summary with 95% CI (reference plot.py:489-546), written to
    ``timing.csv``; returns the rows."""
    rows = []
    for exp, df in frames.items():
        for col in ("t_compress", "t_decompress"):
            if col not in df:
                continue
            v = df[col].astype(float)
            ci = 1.96 * v.std() / max(np.sqrt(len(v)), 1)
            rows.append({"experiment": exp, "phase": col,
                         "mean_s": v.mean(), "ci95_s": ci, "n": len(v)})
    if rows:
        os.makedirs(out_dir, exist_ok=True)
        write_rows(os.path.join(out_dir, "timing.csv"), rows)
    return rows


def plot_experiments(experiments, results_path="./results",
                     out_dir="./results/plots", anchor=None,
                     anchor_points="style"):
    frames = load_csvs(experiments, results_path)
    if not frames:
        print("no test.csv found for", experiments)
        return
    plot_rd(frames, out_dir)
    seqs = sorted({s for df in frames.values()
                   for s in _unique(df["sequence"])})
    for seq in seqs:
        plot_rd(frames, out_dir, sequence=seq)
    if any("pcqm" in df for df in frames.values()):
        plot_rd(frames, out_dir, pareto=True)
    plot_contours(frames, out_dir, metric="bpp")
    first = next(iter(frames.values()))
    for metric in ("sym_y_psnr", "pcqm"):
        if metric in first:
            plot_contours(frames, out_dir, metric=metric)
    if anchor:
        compute_bd_deltas(frames, anchor, out_dir,
                          anchor_points=anchor_points)
    compute_times(frames, out_dir)
    print("plots written to", out_dir)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--experiments", nargs="+",
                    default=["CVPR_inverse_scaling"])
    ap.add_argument("--anchor", default=None)
    ap.add_argument("--anchor_points", choices=["style", "pareto"],
                    default="style",
                    help="BD anchor curve: fixed style-registry pairs "
                         "(reference protocol) or the anchor grid's "
                         "Pareto front inside the candidate's rate window "
                         "(use on content the style pairs were not "
                         "calibrated for)")
    ap.add_argument("--results_path", default="./results")
    a = ap.parse_args(argv)
    anchor = a.anchor or ("gpcc_native"
                          if "gpcc_native" in a.experiments else None)
    plot_experiments(a.experiments, a.results_path, anchor=anchor,
                     anchor_points=a.anchor_points)


if __name__ == "__main__":
    main()
