"""The port's import surface against the JAX package's: every name a JAX
subpackage ``__init__`` exports resolves in the port's twin, under its own
name or through the one map of JAX-idiom names below; the accessors of
``SparseTensor`` and the conv initializers equal JAX's; and importing the
package (or any subpackage) in a fresh process imports no jax and starts
no build."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import upcc_tpu  # noqa: F401
import jax
import jax.numpy as jnp

from upcc_tpu.ops import conv as JConv
from upcc_tpu.ops.sparse import SparseTensor as JST
from upcc_tpu_torch.ops import conv as TConv
from upcc_tpu_torch.ops.sparse import SparseTensor as TST

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ["codec", "coding", "data", "eval", "models", "models.entropy",
               "ops", "parallel", "training", "utils"]
# JAX idiom with no torch counterpart -> the port's name that does its work
IDIOM = {
    "make_train_step": "TrainStep", "TrainState": "TrainStep",
    "make_dp_train_step": "DataParallelStep",
    "shard_batch": "DataParallelStep",
    "make_sharded_train_step": "ShardedTrainStep",
    "shard_inputs": "ShardedTrainStep", "shard_state": "sharded",
}


def _exports(sub):
    """Names bound by the import statements of upcc_tpu/<sub>/__init__.py."""
    path = os.path.join(ROOT, "upcc_tpu", *sub.split("."), "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    return [a.asname or a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_export_resolves_in_the_port(sub):
    import importlib
    port = importlib.import_module(f"upcc_tpu_torch.{sub}")
    missing = [n for n in _exports(sub)
               if not hasattr(port, n) and not hasattr(port, IDIOM.get(n, n))]
    assert not missing, f"upcc_tpu_torch.{sub} lacks {missing}"


def test_idiom_map_is_used_and_names_port_classes():
    from upcc_tpu_torch import parallel, training
    exported = {n for s in SUBPACKAGES for n in _exports(s)}
    for jax_name, port_name in IDIOM.items():
        assert jax_name in exported
        assert hasattr(training, port_name) or hasattr(parallel, port_name)


def test_documented_imports_work():
    from upcc_tpu_torch.codec import Codec
    from upcc_tpu_torch.models import UnifiedModel
    from upcc_tpu_torch.ops import SparseTensor, compact, topk_mask
    from upcc_tpu_torch.utils.misc import AverageMeter
    assert all((Codec, UnifiedModel, SparseTensor, compact, topk_mask,
                AverageMeter))


def _fresh(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# run in a child: a compiler launch (nvcc, g++) fails, and the modules
# new since the start are listed
_CHILD = """
import json, os, subprocess, sys
run, popen = subprocess.run, subprocess.Popen
def guard(real):
    def call(args, *a, **k):
        prog = os.path.basename(str(args[0] if isinstance(args, (list, tuple))
                                    else args).split()[0])
        if prog in ("nvcc", "g++", "gcc", "c++", "cc"):
            raise AssertionError("a build was started: %r" % (args,))
        return real(args, *a, **k)
    return call
subprocess.run, subprocess.Popen = guard(run), guard(popen)
before = set(sys.modules)
import importlib
for name in {names!r}:
    importlib.import_module(name)
print(json.dumps(sorted(set(sys.modules) - before)))
"""


def test_import_upcc_tpu_torch_is_light():
    new = _fresh(_CHILD.format(names=["upcc_tpu_torch"]))
    ours = [m for m in new if m.split(".")[0] in
            ("upcc_tpu_torch", "upcc_tpu", "jax", "flax", "jaxlib")]
    assert ours == ["upcc_tpu_torch"], ours


def test_subpackages_import_in_a_fresh_process_without_jax_or_builds():
    names = [f"upcc_tpu_torch.{s}" for s in SUBPACKAGES] + \
        ["upcc_tpu_torch.diag_geometry"]
    for name in names:  # each alone: an import cycle shows in one of them
        new = _fresh(_CHILD.format(names=[name]))
        bad = [m for m in new if m.split(".")[0] in ("upcc_tpu", "jax",
                                                     "flax", "jaxlib")]
        assert not bad, (name, bad)


# -- SparseTensor accessors, conv init ---------------------------------------

def _tensors():
    rng = np.random.default_rng(3)
    from upcc_tpu.ops.coords import BATCH_SHIFT, SENTINEL, morton_encode_np
    units = rng.integers(0, 200, (50, 3))
    batch = rng.integers(0, 3, 50).astype(np.int64)
    keys = np.unique(morton_encode_np(units) | (batch << BATCH_SHIFT))
    keys = np.concatenate([keys, np.full(14, SENTINEL, np.int64)])
    feats = rng.normal(size=(len(keys), 5)).astype(np.float32)
    return (JST(jnp.asarray(keys), jnp.asarray(feats), stride=4),
            TST(torch.from_numpy(keys), torch.from_numpy(feats), stride=4))


def test_sparse_tensor_accessors_match_jax():
    js, ts = _tensors()
    assert ts.num_channels == js.num_channels == 5
    np.testing.assert_array_equal(ts.units.numpy(), np.asarray(js.units))
    np.testing.assert_array_equal(ts.coordinates().numpy(),
                                  np.asarray(js.coordinates()))
    assert ts.coordinates().dtype == torch.int32
    n_valid = int((np.asarray(js.keys) != np.iinfo(np.int64).max).sum())
    assert int(ts.count()) == int(js.count()) == n_valid
    np.testing.assert_array_equal(ts.mask_feats().numpy(),
                                  np.asarray(js.mask_feats()))


@pytest.mark.parametrize("ks,cin,cout", [(3, 4, 6), (5, 16, 8), (1, 3, 2)])
def test_conv_init_matches_jax_shapes_and_scale(ks, cin, cout):
    assert TConv.conv_param_shapes(ks, cin, cout) == \
        JConv.conv_param_shapes(ks, cin, cout)
    gen = torch.Generator().manual_seed(0)
    w, b = TConv.init_conv_weights(gen, ks, cin, cout)
    jw, jb = JConv.init_conv_weights(jax.random.PRNGKey(0), ks, cin, cout)
    assert tuple(w.shape) == jw.shape and tuple(b.shape) == jb.shape
    assert w.dtype == torch.float32 and not b.any()
    w2, _ = TConv.init_conv_weights(torch.Generator().manual_seed(0), ks, cin,
                                    cout)
    assert torch.equal(w, w2)
    if w.numel() >= 1000:  # variance over the fan-in, as JAX's
        fan_in = ks ** 3 * cin
        assert float(w.std()) == pytest.approx(fan_in ** -0.5, rel=0.1)
        assert float(np.std(np.asarray(jw))) == pytest.approx(
            fan_in ** -0.5, rel=0.1)
    wb, _ = TConv.init_conv_weights(gen, ks, cin, cout, torch.bfloat16)
    assert wb.dtype == torch.bfloat16
