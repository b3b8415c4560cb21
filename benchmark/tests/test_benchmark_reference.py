"""The reference agrees with the port on the CPU at width 16: one small
frame's encode and decode bit for bit (both in f32 here) and its blocks'
headers and stream bytes, one training step's loss, first gradients and
update within f32 rounding; its rate estimate is the port coder's length
within a byte; and its operation counts are those of the model's
definition."""

import numpy as np
import torch

from benchmark.reference import codec_ref, rate, train_ref, work
from benchmark.reference.plain.models.unified import UnifiedModel as RefModel
from benchmark.traffic.codec_loop import make_frames


def test_codec_frame_matches_the_port(tiny_weights):
    from upcc_tpu_torch.codec.codec import Codec
    from upcc_tpu_torch.models.unified import UnifiedModel
    from upcc_tpu_torch.weights import load_weights
    torch.set_num_threads(2)
    cfg, path = tiny_weights
    frame = make_frames({"generator": "surface_cloud", "count": 1,
                         "extent": 128, "points": 4000}, 9)[0]
    codec = Codec(load_weights(UnifiedModel(cfg), path), device="cpu")
    codec.update()
    data = codec.compress(frame, (0.5, 0.5), block_size=64)
    port = codec.decompress(data)
    from benchmark.reference.plain.weights import load_weights as rl
    model = rl(RefModel(cfg), path).eval()
    counts, blocks = {}, []
    ref = codec_ref.roundtrip(model, frame, (0.5, 0.5), 64,
                              torch.device("cpu"), counts, blocks)
    assert np.array_equal(port, ref)
    assert codec_ref.decoded_gaps(port, ref) == (0.0, 0.0)
    assert rate.block_gaps(rate.container_blocks(data), blocks) == (0, 0.0)
    # one record a K1 launch of a top-k frame: 8 in the encode, 11 in the
    # decode (the launch counts the card's gates hold)
    assert len(counts["enc"]["records"]) == 8
    assert len(counts["dec"]["records"]) == 11
    for c in counts.values():
        assert c["model_flops"] >= sum(work.flops(r) for r in c["records"])


def test_gaps_see_a_moved_voxel_and_a_color():
    ref = np.array([[1, 2, 3, 0.5, 0.5, 0.5], [4, 5, 6, 0.2, 0.2, 0.2]],
                   np.float32)
    port = ref.copy()
    port[1, 3] += 2 / 255
    assert codec_ref.decoded_gaps(port, ref) == (0.0, 2 / 6)
    port[0, 0] += 1
    g, _ = codec_ref.decoded_gaps(port, ref)
    assert g == 1.0


def test_structural_count_of_a_record():
    rec = {"pass": "fwd", "taps": 2, "k_in": 8, "k_out": 16, "n_src": 10,
           "rows": 4, "pairs": np.array([3, 1]), "nnz": np.array([20, 40])}
    assert work.flops(rec) == 2 * (3 * 20 + 1 * 40)
    assert work.nbytes(rec) == 4 * 2 * 5 + 10 * 8 * 2 + 60 * 2 + 4 * 16 * 4
    peaks = {"bf16_flops": 1e12, "hbm_bytes": 1e9}
    assert work.bound_s([rec], peaks) == work.nbytes(rec) / 1e9


def test_training_step_matches_the_port(tiny_weights, tmp_path):
    from upcc_tpu_torch.training.trainer import Training
    from benchmark.traffic import train_loop
    from conftest import tiny_train
    torch.set_num_threads(2)
    config, traffic = tiny_train(tiny_weights[0])

    class Ctx:
        pass

    ctx = Ctx()
    ctx.config, ctx.tmpdir, ctx.seed = config, str(tmp_path), 5
    cfg = train_loop.train_config(ctx)
    train_loop.write_corpus(traffic["corpus"], cfg["data_path"])
    weights = train_ref.make_weights(cfg, 5)
    t = Training(cfg, capacity="auto", device="cpu", renders=False)
    t.model.load_state_dict(weights)
    seen = []
    inner = t.batch_tensors
    t.batch_tensors = lambda b, cap=None: (seen.append(b), inner(b, cap))[1]
    m = next(t._seq_steps(6, t._batches(np.random.default_rng(6))))
    opt = t.step_fn.optimizer
    names = {id(p): n for n, p in t.model.named_parameters()}
    port = ([float(m["loss"])], train_ref.adam_first_grads(opt, names),
            {n: p.detach() - weights[n]
             for n, p in t.model.named_parameters()})
    batches, n_items = train_ref.replay_batches(cfg, cfg["data_path"], [], 6,
                                                1)
    assert train_ref.batch_rows_differ(seen, batches) == 0
    ref = train_ref.run_steps(cfg, weights, batches, 6,
                              max(1, n_items // cfg["batch_size"]),
                              torch.device("cpu"))
    gaps = train_ref.step_gaps(port, ref)
    assert gaps["loss_gap"] < 1e-6
    assert gaps["grad_diff"] < 1e-4
    assert gaps["update_diff"] < 1e-4


def test_rate_tables_and_estimate_are_the_port_coders(tiny_weights):
    from upcc_tpu_torch.coding import rans
    from upcc_tpu_torch.models.entropy import bottleneck as pb
    from upcc_tpu_torch.models.entropy import gaussian as pg
    from benchmark.reference.plain.weights import load_weights as rl
    model = rl(RefModel(tiny_weights[0]), tiny_weights[1])
    bn = model.entropy_model.bottleneck
    for mine, port in ((rate.gaussian_tables(), pg.build_cdf_tables()),
                       (rate.bottleneck_tables(bn), pb.build_cdf_tables(
                           {n: p.detach().numpy()
                            for n, p in bn.named_parameters()},
                           bn.channels))):
        assert np.array_equal(mine["length"], port["cdf_length"])
        assert np.array_equal(mine["offset"], port["offset"])
        for i, n in enumerate(mine["length"]):
            assert np.array_equal(mine["cdf"][i, :n], port["cdf"][i, :n])
    t = rate.gaussian_tables()
    tt = {k: torch.as_tensor(v) for k, v in t.items()}
    pt = pg.build_cdf_tables()
    rng = np.random.default_rng(0)
    for rows, width in ((0, 1), (300, 1), (4000, 3), (3000, 400)):
        idx = rng.integers(0, 64, (rows, 8)).astype(np.int32)
        vals = np.round(rng.normal(0, 1, (rows, 8)) * width
                        * pg.default_scale_table()[idx]).astype(np.int32)
        n = len(rans.encode_with_indexes(vals.reshape(-1), idx.reshape(-1),
                                         pt["cdf"], pt["cdf_length"],
                                         pt["offset"]))
        est = rate.stream_bytes(rate.row_bits(
            torch.as_tensor(vals), torch.as_tensor(idx), tt), [0, rows])[0]
        assert abs(n - est) <= rate.STREAM_SLACK, (rows, width, n, est)


def test_rate_gaps_see_a_field_and_a_stream():
    ref = [{"origin": (0, 0, 0), "n_y": 5, "n_z": 1, "k": (1, 2, 3),
            "y_bytes": 1000.0, "z_bytes": 100.0}]
    side = [dict(ref[0])]
    assert rate.block_gaps(side, ref) == (0, 0.0)
    side[0]["y_bytes"] += 2.0  # within a byte a stream
    assert rate.block_gaps(side, ref) == (0, 0.0)
    side[0]["y_bytes"] += 11.0
    assert rate.block_gaps(side, ref)[1] == 11.0 / 1100
    side[0]["k"] = (1, 2, 4)
    assert rate.block_gaps(side, ref)[0] == 1
    assert rate.block_gaps(side + side, ref)[0] == 2
