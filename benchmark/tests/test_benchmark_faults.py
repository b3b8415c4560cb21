"""Runs of the harness past its look for a card, on the CPU at a test's
size: a sound run comes out correct, and a run with the timed path broken
underneath comes out not correct, once for each fault a cell can have.

Codec cells: an answer altered where it is produced (the decoded colors,
the decoded points), and every scale index off by the same steps in the
encoder and the decoder (the frame still decodes right; its streams
grow).  The training cell: a step that returns its state unchanged, half
of the batch left out with the mean taken over the rest, a step against
the gradient.  One card, so no exchange between cards to leave out."""

import numpy as np
import pytest
import torch

from conftest import load, run_cell, tiny_codec, tiny_train

MAN = load("BENCHMARK.json")

CODEC_CELLS = ["codec_vox10_encdec", "codec_vox10_decode"]


@pytest.mark.parametrize("cell", CODEC_CELLS)
def test_codec_sound_run_is_correct(cell, tiny_weights, tmp_path, capsys):
    config, traffic = tiny_codec(cell, *tiny_weights)
    rc, line = run_cell(cell, config, traffic, tmp_path, capsys=capsys)
    assert rc == 0 and line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {
        m["name"] for m in MAN["end_to_end"]
        if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", CODEC_CELLS)
@pytest.mark.parametrize("fault", ["colors", "points"])
def test_codec_altered_answer_is_not_correct(cell, fault, tiny_weights,
                                             tmp_path, capsys, monkeypatch):
    from upcc_tpu_torch.codec.codec import Codec
    fetch = Codec._fetch_points

    def altered(self, blks, st):
        out = fetch(self, blks, st)
        if fault == "colors":
            out[::2, 3] = np.where(out[::2, 3] < 0.5, out[::2, 3] + 16 / 255,
                                   out[::2, 3] - 16 / 255)
            return out
        return out[: len(out) - max(1, len(out) // 50)]

    monkeypatch.setattr(Codec, "_fetch_points", altered)
    config, traffic = tiny_codec(cell, *tiny_weights)
    rc, line = run_cell(cell, config, traffic, tmp_path, capsys=capsys)
    assert rc == 0 and line["correct"] is False


def test_codec_scale_indexes_off_on_both_sides_is_not_correct(
        tmp_path, capsys, monkeypatch):
    from upcc_tpu_torch.models.entropy import gaussian
    build = gaussian.build_indexes
    monkeypatch.setattr(gaussian, "build_indexes",
                        lambda scales, table=None: torch.clamp(
                            build(scales, table) + 4, max=63))
    cell = "codec_vox10_encdec"
    config, traffic = tiny_codec(cell)  # the committed weights
    rc, line = run_cell(cell, config, traffic, tmp_path, capsys=capsys)
    assert rc == 0 and line["correct"] is False
    checks = line["checks"]
    assert checks["geom_gap"]["value"] == checks["color_gap"]["value"] == 0
    assert checks["rate_gap"]["value"] > checks["rate_gap"]["limit"]


def test_codec_traced_run_reads_its_layers(tiny_weights, tmp_path, capsys):
    cell = "codec_vox10_encdec"
    config, traffic = tiny_codec(cell, *tiny_weights)
    rc, line = run_cell(cell, config, traffic, tmp_path, trace=True,
                        capsys=capsys)
    assert rc == 0 and line["correct"] is True
    # the CPU has no device trace, peaks or kernels: those readers find
    # nothing and their metrics stay out of the line
    assert {"host_ms.codec", "coder_ms.codec", "model_ms.codec"} \
        <= set(line["metrics"])
    assert "k1_roofline.codec" not in line["metrics"]
    assert line["device"]["window_s"] > 0
    assert len(line["breakdown"]["idle_gaps"]) <= 10


def test_train_sound_run_is_correct(tiny_weights, tmp_path, capsys):
    config, traffic = tiny_train(tiny_weights[0])
    rc, line = run_cell("train_flagship_b8", config, traffic, tmp_path,
                        capsys=capsys)
    assert rc == 0 and line["correct"] is True
    assert set(line["metrics"]) == {"step_ms", "setup_s"}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "negated_update"])
def test_train_fault_is_not_correct(fault, tiny_weights, tmp_path, capsys,
                                    monkeypatch):
    from upcc_tpu_torch.training.train_step import TrainStep
    from upcc_tpu_torch.training.trainer import Training
    if fault == "state_unchanged":
        monkeypatch.setattr(TrainStep, "update",
                            lambda self, metrics: metrics)
    elif fault == "negated_update":
        update = TrainStep.update

        def negated(self, metrics):
            for p in self.model.parameters():
                if p.grad is not None:
                    p.grad.neg_()
            return update(self, metrics)

        monkeypatch.setattr(TrainStep, "update", negated)
    else:
        inner = Training.batch_tensors

        def half(self, batch, capacity=None):
            b, x, c = batch
            keep = b < max(1, (b.max() + 1) // 2)
            b = np.where(keep, b, -1).astype(b.dtype)
            return inner(self, (b, x, c), capacity)

        monkeypatch.setattr(Training, "batch_tensors", half)
    config, traffic = tiny_train(tiny_weights[0])
    rc, line = run_cell("train_flagship_b8", config, traffic, tmp_path,
                        capsys=capsys)
    assert rc == 0 and line["correct"] is False
