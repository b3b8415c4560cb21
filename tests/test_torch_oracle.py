"""g_s's oracle hooks and the geometry-attribution driver against the JAX
package, on the CPU at N=16 with the JAX init's parameters carried across.

At a level in ``oracle_levels`` the top-k ranks +1 for candidates in the
GT level and -1 for the rest, so the kept set is decided by the top-k's
tie-fill by position.  Kept keys (each level's candidates, which are the
previous level's kept rows expanded, and the prediction) must equal JAX's
exactly; features and logits, summed in other orders in f32, within
rtol 1e-3 / atol 1e-4 (the tolerances of ``test_torch_model.py``).  The
driver's numbers are held against the formulas of
``scripts/diag_geometry.py`` applied to the JAX forward, to 1e-6."""

import numpy as np
import pytest
import torch

import upcc_tpu  # noqa: F401
import jax
import jax.numpy as jnp

from upcc_tpu.data.synthetic import batch_of_cubes
from upcc_tpu.models.unified import UnifiedModel as JModel
from upcc_tpu.models.unified import host_root_maps as j_roots
from upcc_tpu.ops import coords as JC
from upcc_tpu.ops.sparse import SparseTensor as JST, voxelize_host_np
from upcc_tpu_torch import diag_geometry as DG
from upcc_tpu_torch.models.unified import UnifiedModel as TModel
from upcc_tpu_torch.models.unified import host_root_maps as t_roots
from upcc_tpu_torch.models.unified import occupancy_color_features
from upcc_tpu_torch.ops.sparse import SparseTensor as TST, downsample_keys
from upcc_tpu_torch.weights import params_from_jax

torch.set_num_threads(2)

CFG = {
    "max_batch": 2,
    "g_a": {"C_in": 4, "N1": 16, "N2": 16, "N3": 16, "N4": 16},
    "g_s": {"C_out": 3, "N1": 16, "N2": 16, "N3": 16, "N4": 16},
    "entropy_model": {"C_bottleneck": 16, "C_hyper_bottleneck": 24,
                      "quantization_mode": "ste", "inverse_rescaling": True,
                      "quantization_offset": True},
}
# the region ablation at the widths of test_torch_region.py
REGION_GS = {"C_out": 3, "N1": 16, "N2": 16, "N3": 16, "N4": 16,
             "region_candidates": True}
CAP = 2048
Q = 1.0
SLACK = (1.5, 1.25)
RTOL, ATOL = 1e-3, 1e-4


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _cfg(**gs):
    return dict(CFG, g_s=dict(CFG["g_s"], **gs))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(4)
    b, x, c = batch_of_cubes(rng, 2, extent=32, n_per=500, capacity=CAP)
    keys, feats = voxelize_host_np(b, x, c, CAP)
    return keys, feats, [(x[b == i], c[b == i]) for i in range(2)]


def _init(cfg, keys, feats):
    jm = JModel(cfg)
    xj = JST(jnp.asarray(keys), jnp.asarray(feats))
    q = jnp.full((2, 2), Q, jnp.float32)
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0),
                               "noise": jax.random.PRNGKey(1)}, xj, q,
                              q)["params"]
    return params


@pytest.fixture(scope="module")
def params(batch):
    keys, feats, _ = batch
    return _init(CFG, keys, feats)


def _jax_forward(cfg, params, keys, feats, levels):
    jm = JModel(cfg)
    xj = JST(jnp.asarray(keys), jnp.asarray(feats))
    q = jnp.full((2, 2), Q, jnp.float32)
    root = j_roots(keys, cfg)
    return jax.jit(lambda p: jm.apply(
        {"params": p}, xj, q, q, training=False, root_nbrs=root,
        oracle_levels=levels))(params)


def _port_model(cfg, params):
    tm = TModel(cfg)
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tm))
    return tm.eval()


def _port_forward(tm, keys, feats, levels):
    st = TST(T(keys), T(feats))
    q = torch.full((2, 2), Q)
    return DG.oracle_forward(tm, st, q, t_roots(keys, tm.config), levels)


def _compare(ref, got):
    """Kept keys exact at every level, features and logits within f32
    tolerance, the same counts."""
    np.testing.assert_array_equal(N(got["k"]), np.asarray(ref["k"]))
    for lvl, (rc, gc) in enumerate(zip(ref["candidates"],
                                       got["candidates"])):
        np.testing.assert_array_equal(N(gc.keys), np.asarray(rc.keys),
                                      err_msg=f"candidates of level {lvl}")
        np.testing.assert_allclose(N(gc.feats.float()),
                                   np.asarray(rc.feats, np.float32),
                                   RTOL, ATOL)
    for rl, gl in zip(ref["occ_logits"], got["occ_logits"]):
        np.testing.assert_allclose(N(gl), np.asarray(rl), RTOL, ATOL)
    np.testing.assert_array_equal(N(got["prediction"].keys),
                                  np.asarray(ref["prediction"].keys))
    np.testing.assert_allclose(N(got["prediction"].feats),
                               np.asarray(ref["prediction"].feats),
                               RTOL, ATOL)


@pytest.mark.parametrize("levels", [(0,), (0, 1), (0, 1, 2)])
@pytest.mark.parametrize("min_one_child", [True, False])
@pytest.mark.parametrize("slack", [(1.0, 1.0), SLACK])
def test_oracle_forward_matches_jax(batch, params, levels, min_one_child,
                                    slack):
    keys, feats, _ = batch
    cfg = _cfg(min_one_child=min_one_child, prune_slack=list(slack))
    ref = _jax_forward(cfg, params, keys, feats, levels)
    got = _port_forward(_port_model(cfg, params), keys, feats, levels)
    _compare(ref, got)
    gt = keys[keys != JC.SENTINEL]
    pk = N(got["prediction"].keys)
    pk = pk[pk != JC.SENTINEL]
    assert len(pk) == int(N(got["k"])[2].sum())
    if levels == (0, 1, 2):
        # the full oracle reconstructs the GT keys, slack or not
        np.testing.assert_array_equal(np.sort(pk), gt)


def test_oracle_keeps_the_learned_logits_and_ext_keep_first(batch, params):
    """The returned logits are the learned ones whatever the oracle; an
    ext_keep mask at a level overrides the oracle there."""
    keys, feats, _ = batch
    tm = _port_model(_cfg(min_one_child=True), params)
    plain = _port_forward(tm, keys, feats, ())
    orc = _port_forward(tm, keys, feats, (0,))
    np.testing.assert_array_equal(N(orc["occ_logits"][0]),
                                  N(plain["occ_logits"][0]))
    cvalid = N(plain["candidates"][0].keys) != JC.SENTINEL
    ext = torch.from_numpy(cvalid.copy())  # keep every valid candidate
    with torch.no_grad():
        st = TST(T(keys), T(feats))
        rn = t_roots(keys, tm.config)
        y, k = tm.g_a(occupancy_color_features(st), root_nbr=rn["ga"])
        y_hat, _ = tm.entropy_model(y, torch.full((2, 2), Q),
                                    training=False, root_nbr=rn["z"])
        p1 = downsample_keys(st.keys)
        gtp = [downsample_keys(p1), p1, st.keys]
        _, cands, _ = tm.g_s(y_hat, k, oracle_gt=gtp, oracle_levels=(0,),
                             ext_keep=(ext,), num_levels=2)
    # level 1's candidates are the 8 children of every valid level-0 one
    assert (N(cands[1].keys) != JC.SENTINEL).sum() == 8 * cvalid.sum()


def test_region_oracle_matches_jax(batch):
    keys, feats, _ = batch
    cfg = dict(CFG, g_s=REGION_GS)
    params = _init(cfg, keys, feats)
    for levels in [(0, 1), (0, 1, 2)]:
        ref = _jax_forward(cfg, params, keys, feats, levels)
        got = _port_forward(_port_model(cfg, params), keys, feats, levels)
        _compare(ref, got)
    pk = N(got["prediction"].keys)
    np.testing.assert_array_equal(np.sort(pk[pk != JC.SENTINEL]),
                                  keys[keys != JC.SENTINEL])


# -- the driver ----------------------------------------------------------------

def _script_precision(out, n_batch):
    """scripts/diag_geometry.py's ranking precision, on a JAX forward."""
    ks = np.asarray(out["k"])
    res = []
    for lvl, (cand, logits, gt) in enumerate(zip(
            out["candidates"], out["occ_logits"], out["gt_pyramid"])):
        ck = np.asarray(cand.keys)
        lg = np.asarray(logits)
        gk = np.sort(np.asarray(gt))
        idx = np.minimum(np.searchsorted(gk, ck), len(gk) - 1)
        occ = (gk[idx] == ck) & (ck != np.iinfo(np.int64).max)
        bt = np.asarray(JC.key_batch(cand.keys))
        valid = ck != np.iinfo(np.int64).max
        hits = tot = 0
        for bi in range(n_batch):
            m = (bt == bi) & valid
            kk = int(ks[lvl, bi])
            if kk <= 0 or m.sum() == 0:
                continue
            sel = np.argsort(-lg[m])[:kk]
            hits += occ[m][sel].sum()
            tot += kk
        res.append(hits / max(tot, 1))
    return res


def _script_d1(out, gt_keys, n_batch):
    """scripts/diag_geometry.py's d1_of, on a JAX forward."""
    from scipy.spatial import cKDTree
    xh = out["prediction"]
    keys = np.asarray(xh.keys)
    ok = keys != np.iinfo(np.int64).max
    bt = np.asarray(JC.key_batch(xh.keys))[ok]
    pts = np.asarray(JC.key_units(xh.keys))[ok]
    gkeys = np.asarray(gt_keys)
    gok = gkeys != np.iinfo(np.int64).max
    gbt = np.asarray(JC.key_batch(gkeys))[gok]
    gpts = np.asarray(JC.key_units(gkeys))[gok]
    se, n = 0.0, 0
    for bi in range(n_batch):
        r = pts[bt == bi].astype(np.float64)
        g = gpts[gbt == bi].astype(np.float64)
        if not len(r) or not len(g):
            continue
        tg, tr = cKDTree(g), cKDTree(r)
        dab = tr.query(g, k=1)[0] ** 2
        dba = tg.query(r, k=1)[0] ** 2
        se += max(dab.mean(), dba.mean()) * len(g)
        n += len(g)
    mse = se / max(n, 1)
    return 10 * np.log10(3 * 1023.0 ** 2 / max(mse, 1e-12)), mse


def test_driver_numbers_match_the_script_on_jax(batch, params):
    keys, feats, items = batch
    cfg = _cfg(min_one_child=True)
    tm = _port_model(cfg, params)
    got = DG.attribute(tm, items, CAP, Q, device="cpu")
    assert got["points"] == int((keys != JC.SENTINEL).sum())
    ref0 = _jax_forward(cfg, params, keys, feats, ())
    prec = _script_precision(ref0, 2)
    assert [r["precision"] for r in got["levels"]] == \
        pytest.approx(prec, rel=1e-6)
    assert [r["k"] for r in got["levels"]] == \
        [int(v) for v in np.asarray(ref0["k"]).sum(1)]
    for levels in DG.ORACLE_CONFIGS:
        ref = ref0 if not levels else \
            _jax_forward(cfg, params, keys, feats, levels)
        psnr, mse = _script_d1(ref, keys, 2)
        r = got["configs"][levels]
        assert r["mse"] == pytest.approx(mse, rel=1e-6, abs=1e-12)
        assert r["psnr"] == pytest.approx(psnr, rel=1e-6)
        assert r["decoded"] == r["k2"]
    assert got["configs"][(0, 1, 2)]["equals_gt"]
    assert got["configs"][(0, 1, 2)]["mse"] == 0.0


def test_select_cubes_fits_the_capacity():
    rng = np.random.default_rng(0)
    xyz = rng.integers(0, 512, (20000, 3)).astype(np.int32)
    rgb = rng.random((20000, 3)).astype(np.float32)
    items = DG.select_cubes(xyz, rgb, 8, 6000)
    sizes = [len(c[0]) for c in items]
    assert len(items) <= 8 and sum(sizes) <= 0.9 * 6000
    assert sizes == sorted(sizes, reverse=True)


def test_driver_cli_on_a_synthetic_set(tmp_path, monkeypatch, capsys):
    """The CLI end to end on the CPU: a make_synth directory, the N=16
    config written beside carried weights, the four configurations
    printed."""
    import json

    from upcc_tpu_torch.data.make_synth import build
    from upcc_tpu_torch.weights import save_flax_msgpack
    data = tmp_path / "synth"
    build(str(data), train_frames=1, val_frames=1, test_frames=1,
          extent=128, points=3000, verbose=False)
    rng = np.random.default_rng(1)
    b, x, c = batch_of_cubes(rng, 1, extent=32, n_per=300, capacity=512)
    keys, feats = voxelize_host_np(b, x, c, 512)
    cfg = dict(CFG, max_batch=1)
    tm = _port_model(cfg, _init(cfg, keys, feats))
    exp = tmp_path / "results" / "tiny"
    exp.mkdir(parents=True)
    save_flax_msgpack(tm, str(exp / "weights_bf16.msgpack"), "bfloat16")
    conf = tmp_path / "tiny.yaml"
    conf.write_text(json.dumps({
        "experiment_name": "tiny", "results_path": str(tmp_path / "results"),
        "data_path": str(data), "model": {k: v for k, v in CFG.items()
                                          if k != "max_batch"}}))
    DG.main(["--config", str(conf), "--n_cubes", "1", "--capacity", "4096",
             "--device", "cpu"])
    out = capsys.readouterr().out
    assert "level 2: ranking precision" in out
    for levels in DG.ORACLE_CONFIGS:
        assert f"oracle {str(levels):10s}: D1" in out
