"""A frozen plain copy of ``upcc_tpu_torch``'s model code, for the
benchmark's reference.

Copied from the port's ``ops/``, ``models/``, ``weights.py``,
``training/loss.py``, ``training/train_step.py`` and ``data/`` modules, with
every hand-written kernel replaced by its plain PyTorch version (the tap
gather-GEMM, the per-batch top-k, the compaction) and the native voxelizer
by its numpy path.  It imports nothing of the port, so a later change to
the port cannot move the reference the port is judged against.
"""

import torch


def resolve_device(device):
    """torch.device for ``device``; raises when CUDA is asked for and
    absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda is not "
                           "available")
    return dev
