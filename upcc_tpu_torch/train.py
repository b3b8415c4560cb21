"""CLI: python3 -m upcc_tpu_torch.train --config configs/CVPR_inverse_scaling.yaml

Trains the experiment a YAML config describes (on one device) and writes
results/<experiment>/{config.yaml, ckpts/, weights.msgpack,
weights_bf16.msgpack, val.csv}; a second run resumes from the newest
checkpoint.  Only this command reads YAML (the yaml package must be
installed where it runs); ``training.trainer.Training`` takes the dict.
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
    args = ap.parse_args(argv)
    import yaml
    with open(args.config) as f:
        text = f.read()
    cap = args.capacity if args.capacity == "auto" else int(args.capacity)
    Training(yaml.safe_load(text), capacity=cap,
             max_steps_per_epoch=args.max_steps_per_epoch,
             device=args.device, config_text=text,
             renders=not args.no_renders).train()


if __name__ == "__main__":
    main()
