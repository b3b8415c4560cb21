"""Driver entry points of the port (the twin of the root
``__graft_entry__.py``): the flagship's training-mode forward and the
multi-rank dry run.

``entry(device="cuda")`` returns ``(fn, example_args)``: ``fn(keys, feats,
q, lam)`` is the flagship's forward in training mode (``UnifiedModel`` at
N=128, C_hyper_bottleneck 192, ``min_one_child``, seeded init) and returns
the prediction's features and y's likelihoods; ``example_args`` is a batch
of two synthetic cubes (``batch_of_cubes(default_rng(0), 2, extent=64,
n_per=3000, capacity=8192)``) with q = 0.5 and lambda = 1.  On the card
the forward runs kernels K1, K2 and K3.  ``dryrun_multichip(n)`` is
``parallel/dryrun.py``'s.
"""

import numpy as np
import torch

from . import resolve_device
from .parallel.dryrun import dryrun_multichip  # noqa: F401 (re-export)

NOISE_SEED = 2


def _build(flagship=True, extent=64, n_per=3000, cap=8192, batch=2,
           device="cuda"):
    """(model, x, q, lam): the seeded model (N=128 flagship, else N=16)
    on ``device``, the input cubes as a SparseTensor, q and lambda."""
    from .data.synthetic import batch_of_cubes
    from .models.unified import UnifiedModel
    from .ops.sparse import from_points
    from .weights import flagship_config

    dev = resolve_device(device)
    cfg = dict(flagship_config(128 if flagship else 16), max_batch=batch)
    torch.manual_seed(0)
    model = UnifiedModel(cfg).to(dev)
    b, x, c = batch_of_cubes(np.random.default_rng(0), batch, extent=extent,
                             n_per=n_per, capacity=cap)
    st = from_points(torch.from_numpy(b).to(dev), torch.from_numpy(x).to(dev),
                     torch.from_numpy(c).to(dev), capacity=cap)
    q = torch.full((batch, 2), 0.5, device=dev)
    lam = torch.full((batch, 2), 1.0, device=dev)
    return model, st, q, lam


def make_forward(model):
    """fn(keys, feats, q, lam) -> (prediction feats, y likelihoods): the
    training-mode forward, its noise drawn from a generator seeded with
    NOISE_SEED on every call."""
    from .ops.sparse import SparseTensor

    def fwd(keys, feats, q, lam):
        gen = torch.Generator(device=keys.device).manual_seed(NOISE_SEED)
        out = model(SparseTensor(keys=keys, feats=feats, stride=1), q, lam,
                    training=True, generator=gen)
        return out["prediction"].feats, out["likelihoods"]["y"]

    return fwd


def entry(device="cuda"):
    """(fn, example_args): the flagship codec's training-mode forward."""
    model, st, q, lam = _build(device=device)
    return make_forward(model), (st.keys, st.feats, q, lam)
