"""Multi-rank dry run on the CPU (the port's twin of the root
``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(n)`` spawns ``n`` CPU ranks over gloo and runs one
data-parallel training step at tiny widths (N=16), then with ``n >= 2``
one 2-D step on an (n // 2) x 2 (data x model) mesh; rank 0 prints each
step's loss.  Raises if a rank fails or a loss is not finite.

    python3 -m upcc_tpu_torch.parallel.dryrun 4
"""

import math
import sys

import numpy as np
import torch

CONFIG = {
    "max_batch": 1,
    "g_a": {"C_in": 4, "N1": 16, "N2": 16, "N3": 16, "N4": 16},
    "g_s": {"C_out": 3, "N1": 16, "N2": 16, "N3": 16, "N4": 16,
            "min_one_child": True},
    "entropy_model": {"C_bottleneck": 16, "C_hyper_bottleneck": 24,
                      "quantization_mode": "ste", "inverse_rescaling": True,
                      "quantization_offset": True},
}
LOSS = {
    "focal": {"type": "Multiscale_FocalLoss", "alpha": 0.5, "gamma": 2.0},
    "color": {"type": "ColorLoss", "loss": "L2"},
    "bpp-y": {"type": "BPPLoss", "key": "y", "weight": 1.0},
    "bpp-z": {"type": "BPPLoss", "key": "z", "weight": 1.0},
}
RATES = {"model_learning_rate": 1e-4, "bottleneck_learning_rate": 1e-3}
CAP = 512


def _rank_main(rank, world):
    from ..data.synthetic import batch_of_cubes
    from ..models.unified import UnifiedModel, host_root_maps
    from ..ops.sparse import SparseTensor, voxelize_host_np
    from ..training.loss import Loss
    from .data_parallel import DataParallelStep
    from .model_parallel import ShardedTrainStep, make_mesh_2d
    torch.set_num_threads(1)
    rng = np.random.default_rng(1)
    shards = [batch_of_cubes(rng, 1, extent=16, n_per=200, capacity=CAP)
              for _ in range(world)]

    def inputs(shard):
        keys, feats = voxelize_host_np(*shards[shard], CAP)
        x = SparseTensor(torch.from_numpy(keys), torch.from_numpy(feats))
        q = torch.full((1, 2), 0.5)
        return (x, q, torch.ones((1, 2)), host_root_maps(keys, CONFIG),
                torch.Generator().manual_seed(shard))

    def model():
        torch.manual_seed(0)
        return UnifiedModel(CONFIG)

    steps = [("data-parallel", world, lambda: DataParallelStep(
        model(), Loss(LOSS, max_batch=1), RATES), rank)]
    if world >= 2:
        mesh = make_mesh_2d(world // 2, 2)
        steps.append((f"2-D {world // 2}x2", world // 2,
                      lambda: ShardedTrainStep(
                          model(), Loss(LOSS, max_batch=1), RATES, mesh),
                      rank // 2))
    for name, n_data, make, shard in steps:
        step = make()
        loss = float(step(*inputs(shard))["loss"])
        if not math.isfinite(loss):
            raise FloatingPointError(f"{name} step: loss {loss}")
        if rank == 0:
            print(f"dryrun: {name} step over {world} ranks ({n_data} data "
                  f"shards): loss {loss:.6f}", flush=True)


def dryrun_multichip(n_devices, timeout=600):
    from .multihost import spawn
    spawn(_rank_main, n_devices, device="cpu", timeout=timeout)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
