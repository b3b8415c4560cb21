"""The control comes out not correct: the reference with fp8 operands in
the port's place fails one of each cell's numbers, by the limits the
cells' traffic files hold.  At a test's size on the CPU: the committed
flagship weights on a 3,000-point frame for the codec cells, a width-16
model on a corpus of small cubes for the training cell."""

import pytest
import torch

from benchmark import control
from conftest import load, tiny_codec, tiny_train


def _fails(readings, limits):
    return any(readings[k] > v for k, v in limits.items())


@pytest.mark.parametrize("cell", ["codec_vox10_encdec",
                                  "codec_vox10_decode"])
def test_codec_control_is_not_correct(cell):
    torch.set_num_threads(2)
    config, traffic = tiny_codec(cell)
    traffic["frames"] = dict(traffic["frames"], count=1)
    traffic["block_size"] = 128
    r = control.codec_readings(config, traffic, 5, torch.device("cpu"))
    assert _fails(r, traffic["limits"]), r


def test_train_control_is_not_correct(tiny_weights, tmp_path):
    torch.set_num_threads(2)
    config, traffic = tiny_train(tiny_weights[0])
    r = control.train_readings(config, traffic, 5, torch.device("cpu"),
                               str(tmp_path))
    assert _fails(r, traffic["limits"]), r


@pytest.mark.parametrize("fault", control.FAULTS)
def test_train_fault_in_the_reference_is_not_correct(fault, tiny_weights,
                                                     tmp_path):
    torch.set_num_threads(2)
    config, traffic = tiny_train(tiny_weights[0])
    r = control.train_readings(config, traffic, 5, torch.device("cpu"),
                               str(tmp_path), fault=fault)
    assert _fails(r, traffic["limits"]), r


def test_control_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert control.main(["--workload", "codec_vox10_encdec",
                         "--seeds", "1"]) == 3
    assert capsys.readouterr().out == ""


def test_limits_lie_in_the_traffic_files():
    codec = {"count_gap", "geom_gap", "color_gap", "fields_differ",
             "rate_gap"}
    for cell, keys in (("codec_vox10_encdec", codec),
                       ("codec_vox10_decode", codec),
                       ("train_flagship_b8",
                        {"grad_diff", "grad_diff_median",
                         "update_diff"})):
        assert set(load(f"benchmark/traffic/{cell}.json")["limits"]) == keys
