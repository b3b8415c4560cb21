"""Shared pieces of the benchmark's CPU tests: the cells' configurations and
traffic cut to sizes a CPU test holds (width 16, frames of a few thousand
points), and a run of the harness past its look for a card.

Run them from the repository root:

    python -m pytest benchmark/tests -q

Tests marked ``card`` need a CUDA card and skip without one.
"""

import json
import os
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def tiny_weights(tmp_path_factory):
    """(model config, flax msgpack path) of a width-16 flagship model."""
    from upcc_tpu_torch.models.unified import UnifiedModel
    from upcc_tpu_torch.weights import flagship_config, save_flax_msgpack
    cfg = flagship_config(16)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = UnifiedModel(cfg)
    path = str(tmp_path_factory.mktemp("weights") / "w16.msgpack")
    save_flax_msgpack(model, path)
    return cfg, path


def load(name):
    with open(os.path.join(ROOT, name)) as f:
        return json.load(f)


def tiny_codec(cell, model_cfg=None, weights=None):
    """(config, traffic) of a codec cell at a CPU test's size."""
    config = load("benchmark/configs/flagship_codec.json")
    if model_cfg is not None:
        config["model"], config["weights"] = model_cfg, weights
    traffic = load(f"benchmark/traffic/{cell}.json")
    traffic["frames"] = dict(traffic["frames"], extent=128, points=3000)
    traffic["block_size"] = 64
    return config, traffic


def tiny_train(model_cfg):
    config = load("benchmark/configs/flagship_train.json")
    config["model"], config["batch_size"] = model_cfg, 2
    traffic = load("benchmark/traffic/train_flagship_b8.json")
    traffic["corpus"] = dict(traffic["corpus"], extent=128, points=6000,
                             cube_size=64)
    return config, traffic


def run_cell(cell, config, traffic, tmp_path, seed=2 ** 31 + 7,
             seconds=0.5, trace=False, capsys=None):
    """The harness's run of ``cell`` on the CPU past its look for a card;
    returns (exit code, the result line's object or None)."""
    from benchmark.core import harness
    from benchmark.core import manifest as mf
    torch.set_num_threads(2)
    man = mf.Manifest(ROOT)
    ctx = harness.Context(ROOT, cell, seed, seconds, trace,
                          torch.device("cpu"), config, traffic,
                          str(tmp_path))
    rc = harness._run(ctx, man, mf.driver(traffic["driver"]),
                      time.perf_counter())
    line = None
    if capsys is not None:
        out = capsys.readouterr().out.strip().splitlines()
        line = json.loads(out[-1]) if rc == 0 and out else None
    return rc, line
