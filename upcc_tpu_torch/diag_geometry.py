"""Geometry-error attribution: which synthesis level's occupancy
misrankings cost D1.

Runs the training-style forward (rounded quantization) of a trained model
on the largest 128^3 cubes of validation frame 0 that jointly fit 0.9 x
the capacity, with g_s's oracle prune (``SparseSynthesisTransform``'s
``oracle_levels``: the top-k ranks GT membership instead of the learned
logits) switched on per level, and reports the learned heads' ranking
precision per level and the pooled symmetric chamfer MSE with its
frame-scale D1 PSNR (peak 1023) per oracle configuration.  ``attribute``
returns the numbers; the CLI prints them:

    python3 -m upcc_tpu_torch.diag_geometry [--config configs/CVPR_inverse_scaling.yaml]
        [--n_cubes 8] [--capacity 131072] [--q 1.0] [--device cuda]
        [--data_path DIR]

The config is read with ``yaml`` where it imports; without it only the
flagship's config (``CVPR_inverse_scaling.yaml``) is known, as
``weights.FLAGSHIP_CONFIG``.  The weights are the experiment's committed
``weights_bf16.msgpack``.  ``--data_path`` takes any dataset directory with
a ``val.npz`` (``python3 -m upcc_tpu_torch.data.make_synth`` makes one);
nothing is downloaded.
"""

import argparse
import os

import numpy as np
import torch

from . import resolve_device
from .data.dataset import StaticDataset, collate_cubes, slice_into_cubes
from .models.unified import UnifiedModel, host_root_maps
from .ops import coords as C
from .ops.sparse import from_points_host
from .weights import FLAGSHIP_CONFIG, load_weights

ORACLE_CONFIGS = ((), (0,), (0, 1), (0, 1, 2))
CUBE = 128
PEAK = 1023.0


def select_cubes(xyz, rgb, n_cubes, capacity, cube=CUBE):
    """The largest cube^3 cubes of the frame that jointly fit 0.9 x
    ``capacity`` (headroom for g_s's candidate expansion), at most
    ``n_cubes``."""
    cubes = sorted(slice_into_cubes(xyz, rgb, cube), key=lambda c: -len(c[0]))
    items, tot = [], 0
    for cb in cubes:
        if len(items) == n_cubes:
            break
        if tot + len(cb[0]) <= 0.9 * capacity:
            items.append(cb)
            tot += len(cb[0])
    return items


def _valid_np(keys):
    keys = np.asarray(keys)
    return keys, keys != C.SENTINEL


def _batch_np(keys):
    """Batch index of each key (garbage for SENTINEL slots)."""
    return (keys >> C.BATCH_SHIFT).astype(np.int32)


def _units_np(keys):
    return C.morton_decode_np(keys & C.KEY_MASK)


def ranking_precision(candidate_keys, logits, gt_keys, k, n_batch):
    """Share of each batch's top-k(batch) candidates by learned logit that
    are GT voxels, pooled over the batches: (precision, valid candidates,
    sum of k)."""
    ck, valid = _valid_np(candidate_keys)
    lg = np.asarray(logits)
    gk = np.sort(np.asarray(gt_keys))
    idx = np.minimum(np.searchsorted(gk, ck), len(gk) - 1)
    occ = (gk[idx] == ck) & valid
    bt = _batch_np(ck)
    hits = tot = 0
    for bi in range(n_batch):
        m = (bt == bi) & valid
        kk = int(k[bi])
        if kk <= 0 or m.sum() == 0:
            continue
        sel = np.argsort(-lg[m])[:kk]
        hits += occ[m][sel].sum()
        tot += kk
    return hits / max(tot, 1), int(valid.sum()), int(np.sum(k))


def chamfer_d1(pred_keys, gt_keys, n_batch):
    """Pooled two-sided chamfer MSE between GT and reconstruction, per
    batch the larger of the two directions weighted by its GT count;
    returns (D1 PSNR at peak 1023, mse)."""
    from scipy.spatial import cKDTree
    keys, ok = _valid_np(pred_keys)
    gkeys, gok = _valid_np(gt_keys)
    bt, pts = _batch_np(keys[ok]), _units_np(keys[ok])
    gbt, gpts = _batch_np(gkeys[gok]), _units_np(gkeys[gok])
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
    return 10 * np.log10(3 * PEAK ** 2 / max(mse, 1e-12)), mse


def oracle_forward(model, st, q, root_nbrs, oracle_levels):
    """The eval-mode forward (rounded latents) with g_s's oracle at
    ``oracle_levels``.  Lambda only rides along to the output dict's
    ``q_map``, which nothing here reads, so q stands in for it."""
    with torch.no_grad():
        return model(st, q, q, training=False, root_nbrs=root_nbrs,
                     oracle_levels=oracle_levels)


def batch_inputs(items, capacity, config, device):
    """The forward's inputs for the cubes ``items`` (a list of (xyz,
    rgb)) batched at ``capacity``: (SparseTensor, host root maps on
    ``device``, the sorted GT keys as numpy)."""
    b, x, c = collate_cubes(items, capacity)
    st = from_points_host(b, x, c, capacity=capacity, device=device)
    keys_np = st.keys.cpu().numpy()
    rn = host_root_maps(keys_np, config, device=device)
    return st, rn, keys_np[keys_np != C.SENTINEL]


def attribute(model, items, capacity, q=1.0, device="cuda",
              configs=ORACLE_CONFIGS):
    """Ranking precision per level of the learned heads and D1 per oracle
    configuration on the cubes ``items`` (a list of (xyz, rgb)), batched
    at ``capacity``; ``model`` is a ``UnifiedModel`` on ``device`` whose
    ``max_batch`` is at least ``len(items)``.  Returns {"points",
    "levels": [{"precision", "candidates", "k"} per level], "configs":
    {levels: {"psnr", "mse", "decoded", "k2", "equals_gt"}}}."""
    dev = resolve_device(device)
    n_batch = len(items)
    st, rn, gt = batch_inputs(items, capacity, model.config, dev)
    qt = torch.full((n_batch, 2), float(q), dtype=torch.float32, device=dev)
    out = {"points": int(len(gt)), "levels": [], "configs": {}}
    for levels in configs:
        res = oracle_forward(model, st, qt, rn, levels)
        k = res["k"].cpu().numpy()[:, :n_batch]
        if levels == ():
            for lvl, (cand, logits, gtl) in enumerate(zip(
                    res["candidates"], res["occ_logits"],
                    res["gt_pyramid"])):
                prec, ncand, ksum = ranking_precision(
                    cand.keys.cpu(), logits.float().cpu(), gtl.cpu(),
                    k[lvl], n_batch)
                out["levels"].append({"precision": float(prec),
                                      "candidates": ncand, "k": ksum})
        pk = res["prediction"].keys.cpu().numpy()
        pk = pk[pk != C.SENTINEL]
        psnr, mse = chamfer_d1(pk, gt, n_batch)
        out["configs"][tuple(levels)] = {
            "psnr": float(psnr), "mse": float(mse), "decoded": int(len(pk)),
            "k2": int(k[2].sum()),
            "equals_gt": bool(np.array_equal(np.sort(pk), gt))}
        del res
    return out


def read_config(path):
    """The experiment config: YAML through the yaml package, else the
    flagship's built-in config when ``path`` names it."""
    try:
        import yaml
    except ImportError:
        if os.path.basename(path) != "CVPR_inverse_scaling.yaml":
            raise RuntimeError(f"cannot read {path}: the yaml package is not "
                               "installed, and only CVPR_inverse_scaling.yaml"
                               " has a built-in config") from None
        return {"experiment_name": "CVPR_inverse_scaling",
                "results_path": "./results",
                "data_path": "./data/datasets/synth_128",
                "model": {k: dict(v) for k, v in FLAGSHIP_CONFIG.items()}}
    with open(path) as f:
        return yaml.safe_load(f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/CVPR_inverse_scaling.yaml")
    ap.add_argument("--n_cubes", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=131072)
    ap.add_argument("--q", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data_path", default=None,
                    help="dataset directory holding val.npz (default: the "
                         "config's data_path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = read_config(args.config)
    mcfg = dict(cfg["model"])
    mcfg["max_batch"] = args.n_cubes
    snap = os.path.join(cfg.get("results_path", "./results"),
                        cfg["experiment_name"], "weights_bf16.msgpack")
    model = load_weights(UnifiedModel(mcfg), snap).to(dev).eval()
    print("loaded", snap)
    ds = StaticDataset(args.data_path or cfg["data_path"], "val",
                       min_points=0)
    items = select_cubes(*ds[0], args.n_cubes, args.capacity)
    print("cube sizes:", [len(c[0]) for c in items])
    res = attribute(model, items, args.capacity, args.q, dev)
    for lvl, r in enumerate(res["levels"]):
        print(f"level {lvl}: ranking precision {r['precision']:.4f} "
              f"(candidates {r['candidates']}, k {r['k']})")
    for levels, r in res["configs"].items():
        print(f"oracle {str(levels):10s}: D1 {r['psnr']:6.2f} dB  "
              f"(mse {r['mse']:.3f})", flush=True)


if __name__ == "__main__":
    main()
