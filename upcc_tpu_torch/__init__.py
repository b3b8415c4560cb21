"""upcc_tpu_torch — the PyTorch/CUDA port of upcc_tpu.

The learned joint geometry+color point-cloud codec of ``upcc_tpu``, run
with PyTorch on an NVIDIA Hopper GPU.  The package mirrors the JAX
package's layout (``ops/``, ``models/``, ``coding/``, ``codec/``) so each
module's counterpart sits at the same relative path.  Plain tensor code is
PyTorch; the three device ops the codec leans on — the 27-tap brick
gather-GEMM, the exact per-batch top-k and the stable compaction — and the
two gather probes are hand-written CUDA kernels (``csrc/*.cu``), built by
``nvcc`` at first use (``kernels.py``).  On CPU tensors every kernel
wrapper runs its plain PyTorch version instead, which is what the parity
tests exercise.

Entry points: ``upcc_tpu_torch.codec.io.load_codec(exp_dir)`` or
``upcc_tpu_torch.codec.codec.Codec(model, device="cuda")``; the file CLI
``python3 -m upcc_tpu_torch.compress``; the probes
``python3 -m upcc_tpu_torch.probes.<name>``.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device):
    """torch.device for ``device``; raises when CUDA is asked for and absent
    (no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev
