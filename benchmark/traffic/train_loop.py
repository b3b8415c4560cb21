"""Training traffic: the port's ``Training`` runs its sequential step loop
(pack, collate and augment the epoch's cubes, voxelize on the host, root
maps, ``step_fn``) epoch after epoch over a fixed corpus.

Traffic keys: ``corpus`` (``generator``, a function of the frozen
``reference/plain/data/synthetic.py``; ``frames`` drawn from
``default_rng(seed0 + i)``; ``extent``, ``points``, ``cube_size``): the
same cubes for every seed, which sets the epoch numbers (and so the
order, the augmentations, q and the noise) and the initial weights;
``checked_steps``, the first steps the reference follows (traced in a
traced run); ``limits`` of the comparison.

Set-up warms up every shape over one whole epoch, then puts the model back
to the seed's weights and the optimizer to its empty state, and runs the
checked steps; the window continues the same loop.
"""

import gc
import os
import sys
import time
from collections import deque

import numpy as np
import torch

from benchmark.core import device as dv
from benchmark.core.harness import phase
from benchmark.core.trace import span, traced as trace_window
from benchmark.reference import train_ref, work
from benchmark.reference.plain.data import synthetic
from benchmark.reference.plain.data.dataset import (slice_into_cubes,
                                                    write_split)

PIPELINE_DEPTH = 2  # the trainer's own: losses are read one step late


def write_corpus(spec, path):
    """The corpus's cubes as the split caches ``Training`` reads."""
    gen = getattr(synthetic, spec["generator"])
    pts, cols = [], []
    for i in range(spec["frames"]):
        xyz, rgb = gen(np.random.default_rng(spec["seed0"] + i),
                       extent=spec["extent"], n_target=spec["points"])
        for cx, cc in slice_into_cubes(xyz, rgb, spec["cube_size"]):
            pts.append(cx)
            cols.append(cc)
    os.makedirs(path, exist_ok=True)
    write_split(os.path.join(path, "train.npz"), pts, cols)
    # the trainer opens a validation split; the loop never validates
    write_split(os.path.join(path, "val.npz"), pts[:1], cols[:1])


def train_config(ctx):
    cfg = {k: v for k, v in ctx.config.items()
           if k not in ("source", "reduced", "assumed", "precision",
                        "deployment")}
    cfg["data_path"] = os.path.join(ctx.tmpdir, "data")
    cfg["results_path"] = os.path.join(ctx.tmpdir, "results")
    cfg["seed"] = ctx.seed
    return cfg


class State:
    pass


def _epoch_steps(st, epoch, spans=False):
    t = st.trainer
    batches = t._batches(np.random.default_rng(epoch))
    if spans:
        batches = _spanned(batches, "collate+augment")
    return t._seq_steps(epoch, batches)


def _spanned(gen, name):
    while True:
        with span(name):
            item = next(gen, None)
        if item is None:
            return
        yield item


def _wrap(obj, attr, name):
    """Run ``obj.<attr>`` inside a trace span; returns the undo."""
    fn = getattr(obj, attr)

    def run(*a, **k):
        with span(name):
            return fn(*a, **k)

    setattr(obj, attr, run)
    return lambda: setattr(obj, attr, fn)


def setup(ctx):
    from upcc_tpu_torch import kernels
    from upcc_tpu_torch.training.trainer import Training
    st = State()
    st.cfg = train_config(ctx)
    st.device = ctx.device
    with phase("corpus"):
        write_corpus(ctx.traffic["corpus"], st.cfg["data_path"])
    with phase("Training()"):
        if ctx.device.type == "cuda":
            kernels.build(["tap_gemm", "tap_wgrad", "topk_mask", "compact"])
        st.trainer = t = Training(st.cfg, capacity="auto",
                                  device=ctx.device, renders=False)
    with phase("weights"):
        st.weights = train_ref.make_weights(st.cfg, ctx.seed)
        t.model.load_state_dict(st.weights)
    t.model.train()
    st.warm_epoch, st.epoch = ctx.seed, ctx.seed + 1
    with phase("warm-up epoch"):
        _drain(_epoch_steps(st, st.warm_epoch))
    # back to the seed's weights and a fresh optimizer
    t.model.load_state_dict(st.weights)
    t.step_fn.optimizer.state.clear()
    t.step_fn.step = 0
    st.batches = []
    record = t.batch_tensors

    def recording(batch, capacity=None):
        st.batches.append(tuple(np.array(a) for a in batch))
        return record(batch, capacity)

    t.batch_tensors = recording
    n = ctx.traffic["checked_steps"]
    st.losses = []
    if ctx.trace:
        undo = [_wrap(t, "batch_tensors", "voxelize+root maps"),
                _wrap(t.step_fn, "loss", "forward"),
                _wrap(t.step_fn, "update", "clip+adam")]
        st.steps = _epoch_steps(st, st.epoch, spans=True)
        out = {}
        with trace_window(ctx.tmpdir, out, ctx.device):
            _checked_steps(st, n)
        st.trace = out["trace"]
        for u in undo:
            u()
    else:
        st.steps = _epoch_steps(st, st.epoch)
        _checked_steps(st, n)
    t.batch_tensors = record
    return st


def _checked_steps(st, n):
    t = st.trainer
    opt = t.step_fn.optimizer
    for k in range(n):
        with span("step"):
            st.losses.append(next(st.steps)["loss"])
        if k == 0:
            st.first = {}
            names = {id(p): name for name, p in t.model.named_parameters()}
            for group in opt.param_groups:
                beta1 = group["betas"][0]
                for p in group["params"]:
                    m = opt.state[p].get("exp_avg")
                    st.first[names[id(p)]] = torch.zeros_like(p) \
                        if m is None else m.detach() / (1.0 - beta1)
    st.losses = [float(v) for v in st.losses]
    st.after = {name: p.detach().clone()
                for name, p in t.model.named_parameters()}


def _drain(steps):
    pending = deque()
    for m in steps:
        pending.append(m["loss"])
        if len(pending) >= PIPELINE_DEPTH:
            float(pending.popleft())
    while pending:
        float(pending.popleft())


def window(st, seconds):
    pending, losses = deque(), []
    units, epoch = 0, st.epoch
    t0 = time.perf_counter()
    while True:
        m = next(st.steps, None)
        if m is None:
            epoch += 1
            st.steps = _epoch_steps(st, epoch)
            continue
        pending.append(m["loss"])
        units += 1
        if len(pending) >= PIPELINE_DEPTH:
            losses.append(float(pending.popleft()))
        if time.perf_counter() - t0 >= seconds:
            break
    while pending:
        losses.append(float(pending.popleft()))
    dv.sync(st.device)
    elapsed = time.perf_counter() - t0
    return {"elapsed": elapsed, "units": units,
            "failed": int(sum(not np.isfinite(v) for v in losses))}


def end_to_end(st, win):
    return {"step_ms": 1e3 * win["elapsed"] / win["units"]}


def traced(st, ctx):
    n = ctx.traffic["checked_steps"]
    return {"trace": st.trace, "units": n, "stage_s": {},
            "unit_s": st.trace.window_s / n}


def judge(st, ctx):
    """Free the port, replay the checked steps' batches and run them
    through the frozen model and optimizer from the same weights."""
    port_delta = {n: (p.cpu() - st.weights[n]) for n, p in st.after.items()}
    port = (st.losses, {n: g.cpu() for n, g in st.first.items()}, port_delta)
    st.trainer = st.steps = st.after = st.first = None
    gc.collect()
    dv.free(ctx.device)
    n = ctx.traffic["checked_steps"]
    ref_batches, n_items = train_ref.replay_batches(
        st.cfg, st.cfg["data_path"], [st.warm_epoch], st.epoch, n)
    counts = {}
    with work.counting(counts):
        losses, first, delta = train_ref.run_steps(
            st.cfg, st.weights, ref_batches, st.epoch,
            max(1, n_items // st.cfg["batch_size"]), ctx.device)
    gaps = train_ref.step_gaps(
        port, (losses, {k: v.cpu() for k, v in first.items()},
               {k: v.cpu() for k, v in delta.items()}))
    lim = ctx.traffic["limits"]
    checks = [("batch_rows_differ",
               train_ref.batch_rows_differ(st.batches, ref_batches), 0)]
    checks += [(k, gaps[k], v) for k, v in lim.items()]
    print("reported, not compared: " + ", ".join(
        f"{k} {v!r}" for k, v in gaps.items() if k not in lim),
        file=sys.stderr)
    return checks, counts
