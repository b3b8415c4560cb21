"""The port's Training under a process group: two gloo ranks on the CPU at
N=16 on a make_synth dataset this test writes (10 cubes, so an epoch is
two data-parallel steps and a trailing group of one batch); only rank 0
writes; replicas stay bit-identical through a resume.  Also: the trainer
refuses a CUDA device where there is none."""

import os

import pytest
import torch

from upcc_tpu_torch.data.dataset import StaticDataset
from upcc_tpu_torch.data.make_synth import build
from upcc_tpu_torch.parallel import multihost
from upcc_tpu_torch.training.trainer import Training
from test_torch_train import LOSS
import torch_dist_ranks as ranks

MODEL = {
    "g_a": {"C_in": 4, "N1": 16, "N2": 16, "N3": 16, "N4": 16},
    "g_s": {"C_out": 3, "N1": 16, "N2": 16, "N3": 16, "N4": 16,
            "min_one_child": True},
    "entropy_model": {"C_bottleneck": 16, "C_hyper_bottleneck": 24,
                      "quantization_mode": "ste", "inverse_rescaling": True,
                      "quantization_offset": True},
}
CAPACITY = 4096


def _config(tmp_path):
    data = str(tmp_path / "synth")
    build(data, train_frames=1, val_frames=1, test_frames=0, extent=96,
          points=4000, cube_size=32, verbose=False)
    return {
        "experiment_name": "dp_exp", "results_path": str(tmp_path / "res"),
        "model": MODEL, "data_path": data, "min_points_train": 50,
        "q_map": {"lambda_A_min": 0, "lambda_A_max": 12800,
                  "lambda_G_min": 0, "lambda_G_max": 200,
                  "mode": "quadratic"},
        "batch_size": 2, "val_every": 1, "val_max_items": 1,
        "val_qualities": [(1, 1)], "loss": LOSS, "capacity": CAPACITY,
    }


def test_training_on_two_ranks(tmp_path):
    cfg = _config(tmp_path)
    assert len(StaticDataset(cfg["data_path"], "train",
                             min_points=cfg["min_points_train"])) == 10
    multihost.spawn(ranks.train_rank, 2, (cfg, str(tmp_path)), device="cpu")
    out = ranks.load(str(tmp_path), 2)
    for o in out:
        first = o["first"]
        assert first["n_dp"] == 2
        # 5 batches: two groups of two (one batch a rank, at the group's
        # largest capacity), then the trailing batch on both ranks
        assert first["updates"] == 3
        assert first["capacities"] == [CAPACITY] * 3
        assert o["resumed"]["start_epoch"] == 1
        assert o["resumed"]["updates"] == 3
        assert o["second"]["updates"] == 6
    for key in ("model", "adam"):
        assert out[0]["first"][key] == out[1]["first"][key], key
    # the resumed replicas read the same checkpoint, and stay equal
    assert out[0]["resumed"]["model"] == out[1]["resumed"]["model"] \
        == out[0]["first"]["model"]
    assert out[0]["second"]["model"] == out[1]["second"]["model"]
    assert out[1]["written"] == []
    w0 = set(out[0]["written"])
    exp = "dp_exp"
    for name in ("config.yaml", "val.csv", os.path.join("ckpts",
                                                        "ckpt_000.pt"),
                 os.path.join("ckpts", "ckpt_001.pt")):
        assert os.path.join(exp, name) in w0, name
    assert any(n.startswith(os.path.join(exp, "weights.msgpack.")) for n in w0)
    assert any(n.startswith(os.path.join(exp, "weights_bf16.msgpack."))
               for n in w0)
    res = tmp_path / "res" / "dp_exp"
    rows = (res / "val.csv").read_text().splitlines()
    assert len(rows) == 3  # header + one row an epoch, from rank 0 alone
    assert sorted(os.listdir(res / "ckpts")) == ["ckpt_000.pt",
                                                 "ckpt_001.pt"]


def test_training_refuses_cuda_without_a_card(tmp_path):
    """device="cuda" without CUDA raises resolve_device's error, as Codec
    does, before anything is written."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    cfg = {"model": MODEL, "results_path": str(tmp_path / "res"),
           "q_map": {"lambda_A_min": 0, "lambda_A_max": 1,
                     "lambda_G_min": 0, "lambda_G_max": 1,
                     "mode": "quadratic"}, "loss": LOSS}
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        Training(cfg, device="cuda")
    assert not (tmp_path / "res").exists()


@pytest.mark.parametrize("joined", [False, True])
def test_train_cli_multihost(tmp_path, monkeypatch, joined):
    """``--multihost`` joins the group torchrun describes and trains on the
    rank's device; without torchrun's environment it changes nothing."""
    import json

    from upcc_tpu_torch import train as cli
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    seen = {}

    class Stub:
        def __init__(self, config, **kw):
            seen.update(kw, config=config)

        def train(self):
            seen["trained"] = True
    monkeypatch.setattr(cli, "Training", Stub)
    joins = []
    if joined:
        def initialize(device):
            joins.append(device)
            return True
        monkeypatch.setattr(multihost, "initialize", initialize)
        monkeypatch.setattr(multihost, "world", lambda: (1, 2))
    path = tmp_path / "c.yaml"
    path.write_text(json.dumps({"model": MODEL}))
    cli.main(["--config", str(path), "--device", "cpu", "--multihost",
              "--max_steps_per_epoch", "2"])
    assert seen["trained"] and seen["config"] == {"model": MODEL}
    assert seen["device"] == (torch.device("cpu") if joined else "cpu")
    assert seen["max_steps_per_epoch"] == 2
    assert joins == (["cpu"] if joined else [])
