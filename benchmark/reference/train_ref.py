"""The training step's reference: the benchmark's weights, the batches of
the port's data pipeline worked out again, and the first steps of the
frozen plain model and optimizer on them, with the numbers that judge
the port's first steps against them.

The batches follow the port's ``Training._batches`` rule (greedy packing
over the epoch's shuffled order, size-sorted windows, the capacity
ladder) over the frozen dataset and augmentations, whose draws advance
with every cube read, as the port's do.  The noise and the q draws come
from generators seeded by the epoch, as the port's trainer seeds its own.
"""

import numpy as np
import torch

from .plain.data.dataset import StaticDataset, collate_cubes
from .plain.data.q_func import QFunc
from .plain.data.transform import build_transforms
from .plain.models.unified import UnifiedModel, host_root_maps
from .plain.ops import family as F
from .plain.ops.sparse import SparseTensor, voxelize_host_np
from .plain.training.loss import Loss
from .plain.training.train_step import TrainStep

CAP_LADDER = (8192, 12288, 16384, 24576, 32768, 49152, 65536, 98304,
              131072)


def model_config(cfg):
    mcfg = {k: dict(v) for k, v in cfg["model"].items()}
    mcfg["max_batch"] = cfg["batch_size"]
    return mcfg


def make_weights(cfg, seed):
    """The model's initial parameters from ``seed`` (the frozen model's own
    initialization under a seeded generator), as a CPU state dict."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = UnifiedModel(model_config(cfg))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def dataset(cfg, data_path):
    return StaticDataset(data_path, "train",
                         min_points=cfg.get("min_points_train", 0),
                         transforms=build_transforms(
                             cfg.get("transforms", {}).get("train")))


def auto_capacity(ds, batch_size):
    """The trainer's automatic capacity: any single cube plus a typical
    batch with slack, a power of two."""
    counts = np.diff(ds.offsets)[ds.indices]
    need = int(max(1.1 * counts.max(), 1.3 * batch_size * counts.mean()))
    return max(1024, 1 << int(np.ceil(np.log2(need))))


def batches(ds, cfg, capacity, rng):
    """The epoch's collated batches (b, xyz, rgb), in order."""
    bs = cfg["batch_size"]
    sizes = np.diff(ds.offsets)[ds.indices]
    order = rng.permutation(len(ds))
    if cfg.get("batch_bucketing", False):
        w = 8 * bs
        order = np.concatenate([
            win[np.argsort(sizes[win], kind="stable")]
            for win in np.array_split(order, max(1, len(order) // w))])
    i = 0
    while i < len(order):
        items, total = [], 0
        while (i < len(order) and len(items) < bs
               and (not items or total + sizes[order[i]] <= capacity)):
            items.append(ds[order[i]])
            total += sizes[order[i]]
            i += 1
        cap = capacity
        if cfg.get("batch_bucketing", False):
            cap = next((c for c in CAP_LADDER if total <= c <= capacity),
                       capacity)
        yield collate_cubes(items, cap, rng)


def replay_batches(cfg, data_path, epochs_before, epoch, n_steps):
    """The first ``n_steps`` batches of ``epoch`` after whole epochs
    ``epochs_before`` have drawn theirs; with the dataset's size."""
    ds = dataset(cfg, data_path)
    cap = auto_capacity(ds, cfg["batch_size"])
    for e in epochs_before:
        for _ in batches(ds, cfg, cap, np.random.default_rng(e)):
            pass
    gen = batches(ds, cfg, cap, np.random.default_rng(epoch))
    return [next(gen) for _ in range(n_steps)], len(ds)


def adam_first_grads(optimizer, names):
    """Each parameter's first gradient as Adam received it, worked out
    from its first moment after one step: m = (1 - beta1) g."""
    out = {}
    for group in optimizer.param_groups:
        beta1 = group["betas"][0]
        for p in group["params"]:
            out[names[id(p)]] = optimizer.state[p]["exp_avg"].detach() \
                / (1.0 - beta1)
    return out


def run_steps(cfg, weights, batch_list, epoch, steps_per_epoch, device):
    """The frozen model's steps from ``weights`` on ``batch_list``: (each
    step's loss, the first gradients as Adam got them, each parameter's
    change after the last step)."""
    F.full_f32()
    model = UnifiedModel(model_config(cfg)).to(device)
    model.load_state_dict(weights)
    model.train()
    names = {id(p): n for n, p in model.named_parameters()}
    step = TrainStep(model, Loss(cfg["loss"], max_batch=cfg["batch_size"]),
                     cfg, steps_per_epoch)
    qf = QFunc(cfg["q_map"])
    gen_q = torch.Generator().manual_seed(epoch)
    gen_noise = torch.Generator(device=device).manual_seed(epoch)
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses, first = [], None
    for b, x, c in batch_list:
        keys, feats = voxelize_host_np(b, x, c, len(b))
        st = SparseTensor(keys=torch.from_numpy(keys).to(device),
                          feats=torch.from_numpy(feats).to(device))
        root = host_root_maps(keys, cfg["model"], device)
        q, lam = qf.sample(gen_q, cfg["batch_size"])
        metrics = step(st, q.to(device), lam.to(device), root, gen_noise)
        losses.append(float(metrics["loss"]))
        if first is None:
            first = adam_first_grads(step.optimizer, names)
    delta = {n: (p.detach() - p0[n]) for n, p in model.named_parameters()}
    return losses, first, delta


def _norm(t):
    return float(torch.linalg.vector_norm(t.double()))


def _leaf_gaps(side, ref, leaves):
    """Each leaf's ||side - ref|| over the larger of its and the median
    leaf's reference norm."""
    nr = {n: _norm(ref[n]) for n in leaves}
    med = float(np.median(list(nr.values())))
    return {n: _norm(side[n].double() - ref[n].double())
            / max(nr[n], med, 1e-30) for n in leaves}


def step_gaps(port, ref):
    """The numbers that judge the port's first steps: ``port`` and ``ref``
    are (losses, first gradients, changes) of the same steps from the same
    weights.

    A leaf's gap is the norm of the difference of the two sides' first
    gradient (of its change after the steps) over the reference's norm of
    that leaf or of the median leaf, whichever is larger, so a gradient or
    a step of the wrong sign reads about 2 and one left out about 1.
    grad_diff and update_diff: the worst leaf's (named by ``*_leaf``);
    ``*_median``: the median leaf's.  The change leaves out leaves whose
    reference gradient is under a thousandth of the median leaf's: Adam
    moves them by round-off alone.  loss_gap: the largest relative gap of
    a step's loss."""
    lp, gp, dp = port
    lr, gr, dr = ref
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lp, lr))
    grad = _leaf_gaps(gp, gr, list(gr))
    ngr = {n: _norm(g) for n, g in gr.items()}
    gmed = float(np.median(list(ngr.values())))
    moved = [n for n in gr if ngr[n] >= 1e-3 * gmed]
    update = _leaf_gaps(dp, dr, moved)
    worst_g, worst_u = max(grad, key=grad.get), max(update, key=update.get)
    return {"loss_gap": loss_gap, "grad_diff": grad[worst_g],
            "update_diff": update[worst_u], "leaves_moved": len(moved),
            "leaves": len(gr), "grad_diff_leaf": worst_g,
            "grad_diff_median": float(np.median(list(grad.values()))),
            "update_diff_leaf": worst_u,
            "update_diff_median": float(np.median(list(update.values())))}


def batch_rows_differ(port_batches, ref_batches):
    """Rows of the collated batches that differ between the two sides (a
    batch of another length counts all its rows)."""
    bad = 0
    for pb, rb in zip(port_batches, ref_batches):
        if len(pb[0]) != len(rb[0]):
            bad += max(len(pb[0]), len(rb[0]))
            continue
        same = (pb[0] == rb[0]) & np.all(pb[1] == rb[1], axis=1) \
            & np.all(pb[2] == rb[2], axis=1)
        bad += int((~same).sum())
    return bad + abs(len(port_batches) - len(ref_batches))
