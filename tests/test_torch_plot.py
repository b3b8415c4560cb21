"""The port's reporting driver (``upcc_tpu_torch.plot``) against the root
``plot.py`` on the cases of ``tests/test_eval_drivers.py`` (two synthetic
runs with an anchor, the PCQM flip and per-dataset averages, the Pareto
front, the BD anchor's Pareto mode) plus a case with PCQM, both datasets
and empty cells: the port's ``bd_deltas.csv`` and ``timing.csv`` equal the
root script's (text cells equal, numbers within 1e-9 relative, empty cells
where the root's are), its tables equal the root's frames, and it writes
the same figure files; it runs with pandas unimportable."""

import csv
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import plot as root_plot  # noqa: E402

from upcc_tpu_torch import plot as port_plot  # noqa: E402

REL = 1e-9


def _num(cell):
    try:
        return float(cell)
    except ValueError:
        return None


def assert_csv_equal(a, b):
    with open(a, newline="") as f:
        ra = list(csv.reader(f))
    with open(b, newline="") as f:
        rb = list(csv.reader(f))
    assert ra[0] == rb[0] and len(ra) == len(rb) > 1
    for row_a, row_b in zip(ra[1:], rb[1:]):
        for ca, cb in zip(row_a, row_b):
            na, nb = _num(ca), _num(cb)
            if na is None or nb is None or ca == "" or cb == "":
                assert ca == cb, (ca, cb)
            else:
                assert na == pytest.approx(nb, rel=REL, abs=1e-300), (ca, cb)


def assert_table_equal(table, df):
    assert list(table) == list(df.columns)
    for col in df.columns:
        want = df[col].to_numpy()
        got = table[col]
        assert len(got) == len(want), col
        if want.dtype.kind in "fiu":
            np.testing.assert_allclose(got.astype(float),
                                       want.astype(float), rtol=REL,
                                       equal_nan=True, err_msg=col)
        else:
            for g, w in zip(got, want):
                if isinstance(w, float) and np.isnan(w):
                    assert isinstance(g, float) and np.isnan(g), col
                else:
                    assert g == w, col


def two_runs(root):
    """test_plot_experiments' two runs, the second 0.5 dB better."""
    for exp, off in [("CVPR_inverse_scaling", 0.0), ("CVPR_inverse_nn", 0.5)]:
        rows = []
        for qg in [0.1, 0.2, 0.4, 1.0]:
            for qa in [0.1, 0.2, 0.4, 1.0]:
                bpp = 0.2 + 0.5 * qg + 0.3 * qa
                rows.append({"sequence": "mini", "frameIdx": 0,
                             "q_g": qg, "q_a": qa, "bpp": bpp,
                             "t_compress": 0.5, "t_decompress": 0.3,
                             "sym_y_psnr": 28 + 6 * qa + off,
                             "sym_psnr_mse": 60 + 10 * qg + off})
        os.makedirs(root / exp)
        pd.DataFrame(rows).to_csv(root / exp / "test.csv", index=False)
    return ["CVPR_inverse_scaling", "CVPR_inverse_nn"], \
        "CVPR_inverse_scaling", "style"


def both_datasets(root):
    """A run and the G-PCC anchor on two sequences of each dataset, PCQM
    and YUV columns, seeded noise, varying times and one empty D2 cell
    (the root script's figures fail on an empty cell of a plotted
    metric)."""
    rng = np.random.default_rng(3)
    for exp, off in [("CVPR_inverse_scaling", 0.0), ("gpcc_native", -1.0)]:
        rows = []
        for seq in ["loot", "soldier", "dancer", "model"]:
            for qg in [0.0, 0.25, 0.5, 0.75, 1.0]:
                for qa in [0.0, 0.5, 1.0]:
                    bpp = 0.1 + 0.8 * qg ** 1.5 + 0.4 * qa \
                        + 0.01 * rng.random()
                    rows.append({
                        "sequence": seq, "frameIdx": 1, "q_g": qg,
                        "q_a": qa, "bpp": bpp,
                        "t_compress": 1.0 + rng.random(),
                        "t_decompress": 0.2 + 0.1 * rng.random(),
                        "sym_y_psnr": 26 + 8 * qa + off + rng.random(),
                        "sym_psnr_mse": 58 + 12 * qg + off + rng.random(),
                        "sym_yuv_psnr": 30 + 6 * qa + off,
                        "sym_d2_psnr": 62 + 12 * qg + off,
                        "pcqm": 0.02 - 0.01 * qa * qg + 0.001 * rng.random(),
                        "num_points": 760000, "synthetic": 1})
        rows[7]["sym_d2_psnr"] = None
        os.makedirs(root / exp)
        pd.DataFrame(rows).to_csv(root / exp / "test.csv", index=False)
    return ["CVPR_inverse_scaling", "gpcc_native"], "gpcc_native", "pareto"


@pytest.mark.parametrize("case", [two_runs, both_datasets])
def test_plot_experiments_writes_the_root_scripts_files(tmp_path, case):
    exps, anchor, mode = case(tmp_path / "results")
    out = {}
    for name, mod in (("root", root_plot), ("port", port_plot)):
        out[name] = tmp_path / name
        mod.plot_experiments(exps, results_path=str(tmp_path / "results"),
                             out_dir=str(out[name]), anchor=anchor,
                             anchor_points=mode)
    for f in ("bd_deltas.csv", "timing.csv"):
        assert_csv_equal(out["port"] / f, out["root"] / f)
    assert sorted(os.listdir(out["port"])) == sorted(os.listdir(out["root"]))
    assert any(f.startswith("rd_") for f in os.listdir(out["port"]))
    for name in ("root", "port"):
        for exp in exps:
            assert (out[name] / f"contour_bpp_{exp}.png").exists()


@pytest.mark.parametrize("case", [two_runs, both_datasets])
def test_load_csvs_equals_the_root_frames(tmp_path, case):
    exps, _, _ = case(tmp_path)
    ref = root_plot.load_csvs(exps, results_path=str(tmp_path))
    got = port_plot.load_csvs(exps, results_path=str(tmp_path))
    assert list(got) == list(ref)
    for exp in exps:
        assert_table_equal(got[exp], ref[exp])
        for mkey, _ in port_plot.METRICS:
            if mkey in ref[exp]:
                assert_table_equal(port_plot.get_pareto_df(got[exp], mkey),
                                   root_plot.get_pareto_df(ref[exp], mkey))
        for seq in set(ref[exp].sequence):
            pts = port_plot.bd_points_for(exp, seq)
            assert pts == root_plot.bd_points_for(exp, seq)
            sub = ref[exp][ref[exp].sequence == seq]
            assert_table_equal(port_plot.bd_curve(port_plot._take(
                got[exp], got[exp]["sequence"] == seq), pts),
                root_plot.bd_curve(sub, pts))


def test_load_csvs_pcqm_flip_and_dataset_averages(tmp_path):
    """test_eval_drivers' case: 1-PCQM and one averaged row per (q_a,
    q_g) named after the dataset, equal to the root's frame."""
    rows = []
    for seq in ["loot", "longdress"]:
        for qg in [0.2, 1.0]:
            rows.append({"sequence": seq, "q_g": qg, "q_a": qg,
                         "bpp": 0.5 * qg, "pcqm": 0.02 - 0.01 * qg,
                         "sym_y_psnr": 25 + 5 * qg})
    d = tmp_path / "run"
    d.mkdir()
    pd.DataFrame(rows).to_csv(d / "test.csv", index=False)
    got = port_plot.load_csvs(["run"], results_path=str(tmp_path))["run"]
    assert_table_equal(got, root_plot.load_csvs(
        ["run"], results_path=str(tmp_path))["run"])
    loot = got["sequence"] == "loot"
    assert np.isclose(got["pcqm"][loot].max(), 1 - 0.01)
    assert (got["sequence"] == "8iVFBv2").sum() == 2


def test_pareto_front_extraction():
    df = pd.DataFrame({"sequence": ["a"] * 5,
                       "bpp": [0.1, 0.2, 0.3, 0.4, 0.5],
                       "pcqm": [0.90, 0.95, 0.93, 0.96, 0.94]})
    table = {c: df[c].to_numpy() for c in df.columns}
    front = port_plot.get_pareto_df(table)
    assert front["bpp"].tolist() == [0.1, 0.2, 0.4]
    assert_table_equal(front, root_plot.get_pareto_df(df))


@pytest.mark.parametrize("mode", ["style", "pareto"])
def test_bd_anchor_modes_equal_the_root(tmp_path, mode):
    """test_bd_anchor_pareto_mode's curves: a narrow low-rate candidate,
    an anchor grid whose style pairs land at high rates."""
    rows = [{"sequence": "loot", "q_g": qg, "q_a": qa, "bpp": 0.3 + 0.7 * qg,
             "sym_y_psnr": 24 + 6 * qg}
            for qg, qa in root_plot._OURS_BD["8iVFBv2"]]
    arows = [{"sequence": "loot", "q_g": qg, "q_a": qa,
              "bpp": 12 * qg ** 2 + (51 - qa) * 0.02,
              "sym_y_psnr": 18 + 14 * qg + (51 - qa) * 0.1}
             for qg in [0.0625, 0.125, 0.25, 0.5, 0.75, 0.875, 0.9375]
             for qa in [51, 46, 40, 34, 28, 22]]
    frames = {"ours": pd.DataFrame(rows), "gpcc_native": pd.DataFrame(arows)}
    tables = {k: {c: v[c].to_numpy() for c in v.columns}
              for k, v in frames.items()}
    root_plot.compute_bd_deltas(frames, "gpcc_native", str(tmp_path / "r"),
                                anchor_points=mode)
    got = port_plot.compute_bd_deltas(tables, "gpcc_native",
                                      str(tmp_path / "p"), anchor_points=mode)
    assert_csv_equal(tmp_path / "p" / "bd_deltas.csv",
                     tmp_path / "r" / "bd_deltas.csv")
    with open(tmp_path / "r" / "bd_deltas.csv", newline="") as f:
        assert [r["status"] for r in got] == [
            r["status"] for r in csv.DictReader(f)]


def test_plot_cli_runs_without_pandas_or_jax(tmp_path):
    """``python3 -m upcc_tpu_torch.plot`` in a fresh process with pandas,
    jax and upcc_tpu unimportable writes the CSVs."""
    two_runs(tmp_path / "results")
    code = """
import runpy, sys
banned = ("pandas", "jax", "jaxlib", "flax", "upcc_tpu")
def blocked(name):
    return name.split(".")[0] in banned
for name in list(sys.modules):
    if blocked(name):
        del sys.modules[name]
class Block:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.argv = ["plot", "--experiments", "CVPR_inverse_scaling",
            "CVPR_inverse_nn", "--anchor", "CVPR_inverse_scaling",
            "--results_path", "results"]
runpy.run_module("upcc_tpu_torch.plot", run_name="__main__")
assert not any(blocked(n) for n in sys.modules)
"""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    plots = tmp_path / "results" / "plots"
    assert (plots / "bd_deltas.csv").exists()
    assert (plots / "timing.csv").exists()
