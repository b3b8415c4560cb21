"""CLI: python3 -m upcc_tpu_torch.train --config configs/CVPR_inverse_scaling.yaml

Trains the experiment a YAML config describes and writes
results/<experiment>/{config.yaml, ckpts/, weights.msgpack,
weights_bf16.msgpack, val.csv}; a second run resumes from the newest
checkpoint.  Only this command reads YAML (the yaml package must be
installed where it runs); ``training.trainer.Training`` takes the dict.

Several processes, one device each, train data-parallel under torchrun:

    torchrun --nproc_per_node=4 -m upcc_tpu_torch.train --config ... \\
        --multihost

``--multihost`` joins the process group from torchrun's environment
(``parallel/multihost.py``; NCCL on CUDA devices, rank i on cuda:i of its
host, gloo with ``--device cpu``); without that environment it does
nothing.
"""

import argparse

from .training.trainer import Training


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--capacity", default="auto",
                    help="static per-batch point capacity (int or 'auto')")
    ap.add_argument("--max_steps_per_epoch", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no_renders", action="store_true",
                    help="skip the validation renders (they need matplotlib)")
    ap.add_argument("--multihost", action="store_true",
                    help="join the process group torchrun describes "
                         "(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, "
                         "LOCAL_RANK) before training; no-op when unset")
    args = ap.parse_args(argv)
    import yaml
    with open(args.config) as f:
        text = f.read()
    device = args.device
    if args.multihost:
        from .parallel import multihost
        if multihost.initialize(device=device):
            device = multihost.rank_device(device)
            rank, n = multihost.world()
            print(f"multihost: rank {rank} of {n} on {device}", flush=True)
    cap = args.capacity if args.capacity == "auto" else int(args.capacity)
    try:
        Training(yaml.safe_load(text), capacity=cap,
                 max_steps_per_epoch=args.max_steps_per_epoch,
                 device=device, config_text=text,
                 renders=not args.no_renders).train()
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
