"""Training driver: config -> folders -> train/val loop -> checkpoints (the
JAX package's ``training/trainer.py``).

  * results/<experiment>/{config.yaml, ckpts/, weights.msgpack,
    weights_bf16.msgpack (+ .meta.json sidecars), val.csv}
  * two Adam groups (main vs the bottleneck's quantiles), StepLR in
    steps, clipping by global norm, one random quality q per step
  * resume from the newest ``torch.save`` checkpoint, else a warm start
    from the bf16 snapshot (fresh Adam moments, the schedule fast-forwarded
    to the snapshot's step)
  * size-bucketed greedy batching; each step voxelizes on the host and
    builds the root neighbour maps there
  * data parallelism under a process group (``data_parallel``: "auto",
    the default, uses every rank of a world of more than one; False trains
    each rank alone): each rank runs one batch of a group of world-size
    batches at the group's largest capacity and voxelizes only its own,
    the gradients are averaged before the update
    (``parallel/data_parallel.py``); a trailing group of fewer batches runs
    on every rank, each batch in turn, still averaged, so the replicas stay
    bit-identical.  Only the primary rank writes checkpoints, exports,
    val.csv and renders, and validates
  * every ``val_every`` epochs, validation through the real codec
    (compress -> bytes -> decompress) at the four corner qualities into
    val.csv

The trainer takes a config dict; only the command line
(``python3 -m upcc_tpu_torch.train``) reads YAML.  Training on the card
runs with TF32 off, as a CUDA ``Codec`` leaves the process (validation
builds one): the GDN and MLP products stay f32 in every step.
"""

import copy
import csv
import itertools
import json
import os
import time
from collections import deque

import numpy as np
import torch

from .. import resolve_device
from ..data.dataset import StaticDataset, collate_cubes
from ..data.q_func import QFunc
from ..data.transform import build_transforms
from ..models.unified import UnifiedModel, host_root_maps
from ..ops.sparse import SparseTensor, voxelize_host_np
from ..parallel import data_parallel as dp
from ..parallel.multihost import barrier, is_primary, world
from ..utils import profiling
from ..weights import load_weights, save_flax_msgpack
from .loss import Loss
from .train_step import TrainStep


class Training:
    # capacity ladder of size-bucketed batching (the JAX package's)
    _CAP_LADDER = (8192, 12288, 16384, 24576, 32768, 49152, 65536, 98304,
                   131072)
    # metrics are read one step late, so the host prepares the next batch
    # while the device runs this one
    _PIPELINE_DEPTH = 2

    def __init__(self, config, capacity="auto", max_steps_per_epoch=None,
                 device="cuda", config_text=None, renders=True):
        """config: the experiment's dict (as the YAML holds it);
        config_text: that YAML's text, copied to the results directory
        (else the dict is written there as JSON)."""
        cfg = self.config = config
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.experiment = cfg.get("experiment_name", "exp")
        self.results_dir = os.path.join(cfg.get("results_path", "./results"),
                                        self.experiment)
        self.ckpt_dir = os.path.join(self.results_dir, "ckpts")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        if is_primary():
            with open(os.path.join(self.results_dir, "config.yaml"),
                      "w") as f:
                f.write(config_text if config_text is not None
                        else json.dumps(cfg, indent=1))
        self.batch_size = cfg.get("batch_size", 8)
        self.capacity = capacity
        self.epochs = cfg.get("epochs", 300)
        self.val_every = cfg.get("val_every", 10)
        self.max_steps_per_epoch = max_steps_per_epoch
        self.renders = renders

        mcfg = dict(cfg["model"])
        mcfg["max_batch"] = self.batch_size
        torch.manual_seed(cfg.get("seed", 0))
        self.model = UnifiedModel(mcfg).to(self.device)
        self.loss_obj = Loss(cfg["loss"], max_batch=self.batch_size)
        self.q_func = QFunc(cfg["q_map"])

        transforms = build_transforms(cfg.get("transforms", {}).get("train"))
        data_path = cfg.get("data_path")
        self.train_ds = StaticDataset(
            data_path, "train", min_points=cfg.get("min_points_train", 0),
            transforms=transforms) if data_path else None
        self.val_ds = StaticDataset(
            data_path, "val", min_points=cfg.get("min_points_test", 0)) \
            if data_path else None
        if self.capacity == "auto":
            if self.train_ds is not None and len(self.train_ds):
                # cover any single cube plus a typical batch with slack
                counts = np.diff(self.train_ds.offsets)[self.train_ds.indices]
                need = int(max(1.1 * counts.max(),
                               1.3 * self.batch_size * counts.mean()))
                self.capacity = max(1024, 1 << int(np.ceil(np.log2(need))))
            else:
                self.capacity = 65536
            print(f"auto capacity: {self.capacity}")
        self.steps_per_epoch = max(1, (len(self.train_ds) if self.train_ds
                                       else 1000) // self.batch_size)
        dp_cfg = cfg.get("data_parallel", "auto")
        n_ranks = world()[1]
        self.n_dp = n_ranks if dp_cfg in ("auto", True) and n_ranks > 1 \
            else 1
        step_cls = TrainStep
        if self.n_dp > 1:
            self.dp_mesh = dp.make_mesh(self.n_dp)
            step_cls = dp.DataParallelStep
            if is_primary():
                print(f"data-parallel training over {self.n_dp} ranks "
                      f"(global batch {self.n_dp * self.batch_size} cubes)")
        self.step_fn = step_cls(self.model, self.loss_obj, cfg,
                                self.steps_per_epoch)
        self.start_epoch = 0
        self._maybe_resume()
        if self.n_dp > 1:
            dp.broadcast_state(self.model)

    # ---- checkpointing --------------------------------------------------

    def save_checkpoint(self, epoch):
        if not is_primary():
            return
        step = self.step_fn.step
        torch.save({"model": self.model.state_dict(),
                    "optimizer": self.step_fn.optimizer.state_dict(),
                    "step": step, "epoch": epoch},
                   os.path.join(self.ckpt_dir, f"ckpt_{epoch:03d}.pt"))
        # rolling weight exports in the JAX package's formats, with the
        # step sidecars load_codec arbitrates staleness by
        for name, dtype in (("weights.msgpack", "float32"),
                            ("weights_bf16.msgpack", "bfloat16")):
            path = os.path.join(self.results_dir, name)
            save_flax_msgpack(self.model, path, dtype)
            with open(path + ".meta.json", "w") as f:
                json.dump({"epoch": epoch, "step": step}, f)
        self._prune_checkpoints()

    def _prune_checkpoints(self, keep_last=3):
        """Keep the newest ``keep_last`` plus every val_every-th epoch."""
        every = int(self.config.get("val_every", 10))
        entries = sorted(e for e in os.listdir(self.ckpt_dir)
                         if e.startswith("ckpt_"))
        for e in entries[:-keep_last]:
            try:
                ep = int(e.split("_")[1].split(".")[0])
            except (IndexError, ValueError):
                continue
            if every > 0 and ep % every == 0:
                continue
            os.remove(os.path.join(self.ckpt_dir, e))

    def _maybe_resume(self):
        entries = sorted(e for e in os.listdir(self.ckpt_dir)
                         if e.startswith("ckpt_") and e.endswith(".pt"))
        if not entries:
            self._maybe_warm_start()
            return
        latest = os.path.join(self.ckpt_dir, entries[-1])
        payload = torch.load(latest, map_location=self.device,
                             weights_only=True)
        self.model.load_state_dict(payload["model"])
        self.step_fn.optimizer.load_state_dict(payload["optimizer"])
        self.step_fn.step = int(payload["step"])
        self.start_epoch = int(payload["epoch"]) + 1
        print(f"resumed from {latest} at epoch {self.start_epoch}")

    def _maybe_warm_start(self):
        """Without a checkpoint: parameters from the committed bf16
        snapshot, fresh Adam moments (Adam's own count from 0), and the
        schedule's step fast-forwarded to the snapshot's."""
        snap = os.path.join(self.results_dir, "weights_bf16.msgpack")
        if not os.path.isfile(snap):
            return
        load_weights(self.model, snap)
        meta_path = snap + ".meta.json"
        if os.path.isfile(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            epoch, step = int(meta["epoch"]), int(meta["step"])
            self.start_epoch = epoch + 1
        else:  # no sidecar: infer from the validation trail
            epoch = 0
            val_csv = os.path.join(self.results_dir, "val.csv")
            if os.path.isfile(val_csv):
                with open(val_csv) as f:
                    rows = [r for r in f.read().splitlines()[1:] if r]
                if rows:
                    epoch = max(int(r.split(",")[0]) for r in rows) + 1
            step = epoch * self.steps_per_epoch
            self.start_epoch = epoch
        self.step_fn.step = step
        print(f"warm-started from {snap} at epoch {self.start_epoch} "
              f"(step {step}; fresh optimizer moments)")

    # ---- loops -----------------------------------------------------------

    def _batches(self, rng):
        """Greedy capacity packing over the shuffled order: up to
        batch_size cubes while they fit the capacity.  With
        ``batch_bucketing`` the order is sorted by size within windows of
        8 * batch_size cubes and each batch padded to the smallest ladder
        capacity that holds it."""
        ds = self.train_ds
        sizes = np.diff(ds.offsets)[ds.indices]
        order = rng.permutation(len(ds))
        bucketing = bool(self.config.get("batch_bucketing", False))
        if bucketing:
            w = 8 * self.batch_size
            order = np.concatenate([
                win[np.argsort(sizes[win], kind="stable")]
                for win in np.array_split(order, max(1, len(order) // w))])
        i = 0
        while i < len(order):
            # runs inside the step that consumes the batch
            with profiling.span("train.collate"):
                items, total = [], 0
                while (i < len(order) and len(items) < self.batch_size
                       and (not items
                            or total + sizes[order[i]] <= self.capacity)):
                    items.append(ds[order[i]])
                    total += sizes[order[i]]
                    i += 1
                cap = self.capacity
                if bucketing:
                    cap = next((c for c in self._CAP_LADDER
                                if total <= c <= self.capacity),
                               self.capacity)
                batch = collate_cubes(items, cap, rng)
            yield batch

    def batch_tensors(self, batch, capacity=None):
        """(x, root maps) of a collated batch on the training device:
        voxelized once on the host, at ``capacity`` (default the batch's
        own)."""
        with profiling.span("train.voxelize"):
            b, x, c = batch
            keys, feats = voxelize_host_np(b, x, c, capacity or len(b))
            st = SparseTensor(keys=torch.from_numpy(keys).to(self.device),
                              feats=torch.from_numpy(feats).to(self.device))
            return st, host_root_maps(keys, self.config["model"],
                                      self.device)

    def _seq_step(self, batch, gen_q, gen_noise):
        st, root = self.batch_tensors(batch)
        q, lam = self.q_func.sample(gen_q, self.batch_size)
        return self.step_fn(st, q.to(self.device), lam.to(self.device), root,
                            gen_noise)

    def _step_span(self):
        """The root span of a step (``train.step``), under the step's
        number; the batch is pulled inside it, so its collation is a
        child."""
        return profiling.span("train.step", unit=self.step_fn.step)

    def _seq_steps(self, epoch, batches):
        """The epoch's steps on one device; yields each step's metrics."""
        gen_q = torch.Generator().manual_seed(epoch)
        gen_noise = torch.Generator(device=self.device).manual_seed(epoch)
        batches = iter(batches)
        for step in itertools.count():
            if self.max_steps_per_epoch and step >= self.max_steps_per_epoch:
                return
            with self._step_span() as root:
                batch = next(batches, None)
                if batch is None:
                    root.drop()
                    return
                metrics = self._seq_step(batch, gen_q, gen_noise)
            yield metrics

    def _shard_step(self, batch, capacity, q, lam, epoch, step, shard):
        """One data-parallel step on ``batch`` with the draws of group
        ``step``'s shard ``shard``."""
        st, root = self.batch_tensors(batch, capacity)
        gen = dp.noise_generator(self.device, epoch, step, shard)
        return self.step_fn(st, q.to(self.device), lam.to(self.device),
                            root, gen)

    def _dp_steps(self, epoch, batches):
        """The epoch's data-parallel steps: groups of n_dp batches (every
        rank collates all of them, so the transforms' draws stay in step,
        and voxelizes its own); yields each step's metrics."""
        lo, _ = dp.local_dp_rows(self.dp_mesh)
        batches = iter(batches)
        for step in itertools.count():
            if self.max_steps_per_epoch and step >= self.max_steps_per_epoch:
                return
            with self._step_span() as root:
                group = list(itertools.islice(batches, self.n_dp))
                if not group:
                    root.drop()
                    return
                q, lam = dp.group_draws(self.q_func, len(group),
                                        self.batch_size, epoch, step)
                full = len(group) == self.n_dp
                if full:
                    cap = max(len(b) for b, _, _ in group)
                    metrics = self._shard_step(group[lo], cap, q[lo], lam[lo],
                                               epoch, step, lo)
                else:
                    # trailing remainder: every rank runs each batch in
                    # turn, the first in this step
                    metrics = self._shard_step(group[0], None, q[0], lam[0],
                                               epoch, step, 0)
            yield metrics
            if full:
                continue
            for i in range(1, len(group)):
                with self._step_span():
                    metrics = self._shard_step(group[i], None, q[i], lam[i],
                                               epoch, step, i)
                yield metrics

    def train_epoch(self, epoch):
        rng = np.random.default_rng(epoch)
        self.model.train()
        losses, pending = [], deque()
        t0 = time.time()
        steps = (self._dp_steps if self.n_dp > 1 else self._seq_steps)(
            epoch, self._batches(rng))
        for metrics in steps:
            pending.append(metrics)
            if len(pending) >= self._PIPELINE_DEPTH:
                losses.append(float(pending.popleft()["loss"]))
        while pending:
            losses.append(float(pending.popleft()["loss"]))
        return {"loss": float(np.mean(losses)) if losses else float("nan"),
                "time": time.time() - t0}

    def val_epoch(self, epoch):
        """Full-codec validation at the four corner qualities (a copy of
        the model; the training model is left as it is), on the primary
        rank only."""
        if not is_primary():
            return []
        from ..codec.codec import Codec
        from ..eval.metrics import pc_metrics
        codec = Codec(copy.deepcopy(self.model), device=self.device)
        codec.update()
        render_dir = os.path.join(self.results_dir, "renders_val")
        rows = []
        max_items = self.config.get("val_max_items", None)
        n_val = len(self.val_ds) if self.val_ds else 0
        if max_items is not None:
            n_val = min(n_val, int(max_items))
        qs = self.config.get("val_qualities",
                             [(0, 0), (0, 1), (1, 0), (1, 1)])
        for i in range(n_val):
            xyz, rgb = self.val_ds[i]
            pc = np.concatenate([xyz.astype(np.float32), rgb], axis=1)
            res = float(xyz.max()) or 1.0
            for qg, qa in qs:
                data = codec.compress(pc, q=(qg, qa), block_size=1024)
                rec = codec.decompress(data)
                m = pc_metrics(pc, rec, resolution=res, with_d2=False)
                rows.append({"epoch": epoch, "item": i, "q_g": qg,
                             "q_a": qa, "bpp": len(data) * 8 / len(pc),
                             "sym_y_psnr": m["sym_y_psnr"],
                             "sym_psnr_mse": m["sym_psnr_mse"]})
                if self.renders and i == 0 and qg == qa:
                    from ..eval.render import render_pointcloud
                    render_pointcloud(rec, path_prefix=os.path.join(
                        render_dir, f"ep{epoch:03d}_q{qg}{qa}"))
        if rows:
            path = os.path.join(self.results_dir, "val.csv")
            write_header = not os.path.exists(path)
            with open(path, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(rows[0]))
                if write_header:
                    w.writeheader()
                w.writerows(rows)
        return rows

    def train(self):
        for epoch in range(self.start_epoch, self.epochs):
            m = self.train_epoch(epoch)
            print(f"epoch {epoch}: loss {m['loss']:.3f} ({m['time']:.0f}s)",
                  flush=True)
            if self.val_ds and self.val_every and \
                    (epoch + 1) % self.val_every == 0:
                self.val_epoch(epoch)
            self.save_checkpoint(epoch)
            # the other ranks leave the epoch once its checkpoint exists,
            # so a resume on any rank reads the same one
            barrier()
