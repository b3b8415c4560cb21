"""The control of the comparison that decides ``correct``: the reference put
in the port's place, its tap products computed with fp8 (e4m3, scaled per
tensor) operands instead of the bf16 the configurations state, judged by
the same numbers against the reference.  Its readings are the upper ends
the limits are set below; the benchmark's own runs never run it.

    python3 -m benchmark.control --workload <name> --seeds 1,2,3
        [--fault half_batch|negated_update]

runs on the first CUDA card and prints one JSON line a seed with the
numbers the cell compares.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fp8_e4m3(x):
    """x rounded to fp8 e4m3 under a per-tensor scale that maps its largest
    magnitude to 448; the gradient passes straight through."""
    amax = x.detach().abs().max().clamp(min=1e-30)
    s = 448.0 / amax
    q = (x.detach() * s).to(torch.float8_e4m3fn).float() / s
    return x + (q - x).detach()


class lowered:
    """Within the block, the frozen engine's operands go through
    ``fp8_e4m3``."""

    def __enter__(self):
        from benchmark.reference.plain.ops import family as F
        self.F, self.prev = F, F.OPERANDS
        F.OPERANDS = fp8_e4m3

    def __exit__(self, *exc):
        self.F.OPERANDS = self.prev


def codec_readings(config, traffic, seed, device, root=ROOT):
    """The codec numbers (``codec_ref.GAPS``) of the control against the
    reference over the cell's frames at ``seed``: its decoded frames, and
    its blocks' y and z bytes as its own symbols and indexes give them."""
    from benchmark.reference import codec_ref
    from benchmark.reference.plain.models.unified import UnifiedModel
    from benchmark.reference.plain.weights import load_weights
    from benchmark.traffic.codec_loop import make_frames
    model = UnifiedModel(config["model"])
    load_weights(model, os.path.join(root, config["weights"]))
    model = model.to(device).eval()
    q, block = tuple(traffic["q"]), traffic["block_size"]
    out = dict.fromkeys(codec_ref.GAPS, 0.0)
    for frame in make_frames(traffic["frames"], seed):
        ref_blocks, ctl_blocks = [], []
        ref = codec_ref.roundtrip(model, frame, q, block, device,
                                  blocks=ref_blocks)
        with lowered():
            ctl = codec_ref.roundtrip(model, frame, q, block, device,
                                      blocks=ctl_blocks)
        for k, v in codec_ref.frame_gaps(ctl, ctl_blocks, ref,
                                         ref_blocks).items():
            out[k] = max(out[k], v)
    return out


def half_batch(batches):
    """The fault that leaves out the second half of every batch's cubes
    (their rows become padding), the loss's mean taken over the rest."""
    out = []
    for b, x, c in batches:
        keep = b < max(1, (int(b.max()) + 1) // 2)
        out.append((np.where(keep, b, -1).astype(b.dtype), x, c))
    return out


class negated_update:
    """Within the block, the frozen step hands Adam its gradients negated,
    so every step goes the wrong way."""

    def __enter__(self):
        from benchmark.reference.plain.training.train_step import TrainStep
        self.cls, self.prev = TrainStep, TrainStep.update
        prev = self.prev

        def update(step, metrics):
            for group in step.optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.neg_()
            return prev(step, metrics)

        TrainStep.update = update

    def __exit__(self, *exc):
        self.cls.update = self.prev


FAULTS = ("half_batch", "negated_update")


def train_readings(config, traffic, seed, device, tmpdir, fault=None):
    """The training numbers (``train_ref.step_gaps``) of the control, or
    of the reference with ``fault`` (one of ``FAULTS``) planted, against
    the reference over the cell's checked steps at ``seed`` (the batches
    of the epoch after one whole warm-up epoch, as a run has them)."""
    from benchmark.reference import train_ref
    from benchmark.traffic import train_loop

    class Ctx:
        pass

    ctx = Ctx()
    ctx.config, ctx.tmpdir, ctx.seed = config, tmpdir, seed
    cfg = train_loop.train_config(ctx)
    if not os.path.exists(os.path.join(cfg["data_path"], "train.npz")):
        train_loop.write_corpus(traffic["corpus"], cfg["data_path"])
    n = traffic["checked_steps"]
    batches, n_items = train_ref.replay_batches(cfg, cfg["data_path"],
                                                [seed], seed + 1, n)
    weights = train_ref.make_weights(cfg, seed)
    spe = max(1, n_items // cfg["batch_size"])

    def side(batch_list):
        losses, first, delta = train_ref.run_steps(cfg, weights, batch_list,
                                                   seed + 1, spe, device)
        return (losses, {k: v.cpu() for k, v in first.items()},
                {k: v.cpu() for k, v in delta.items()})

    ref = side(batches)
    if fault == "half_batch":
        return train_ref.step_gaps(side(half_batch(batches)), ref)
    with negated_update() if fault == "negated_update" else lowered():
        return train_ref.step_gaps(side(batches), ref)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", choices=FAULTS, default=None,
                    help="read this fault of a training cell instead of "
                         "the control")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.control: needs a CUDA card", file=sys.stderr)
        return 3
    import tempfile
    from benchmark.core import manifest as mf
    man = mf.Manifest(ROOT)
    work = man.workload(args.workload)
    config = man.config(work["config"])
    traffic = mf.traffic(work["traffic"])
    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmpdir:
        for s in args.seeds.split(","):
            seed = int(s)
            if traffic["driver"] == "train_loop":
                r = train_readings(config, traffic, seed, device, tmpdir,
                                   args.fault)
            else:
                r = codec_readings(config, traffic, seed, device)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": args.fault or "fp8_e4m3", **r}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
