"""Prepared tap weights of the port (``ops/tapplan.py``) on the CPU.

The block list and packed operands that kernel K1 walks are plain Python and
torch, so they are held here against the dense plain version (1e-6 of the
largest output: the same products, laid back into a dense stack), against the
JAX package's ``_tap_scan_gemm`` (rtol 1e-4, atol 1e-5, as
tests/test_torch_ops.py: the two differ in the order of f32 sums), and
against their own contract: the list covers every nonzero weight, is
tap-major then K-major, comes from the static tables and not from values,
and a cached plan never outlives the weights it was made from."""

import copy

import numpy as np
import pytest
import torch

import upcc_tpu  # noqa: F401  (enables jax x64)
import jax
import jax.numpy as jnp

from upcc_tpu.ops import family as JF
from upcc_tpu_torch.codec.codec import Codec
from upcc_tpu_torch.data.synthetic import surface_cloud
from upcc_tpu_torch.models import layers as L
from upcc_tpu_torch.models.unified import UnifiedModel
from upcc_tpu_torch.ops import coords as TC
from upcc_tpu_torch.ops import family as TF
from upcc_tpu_torch.ops import tapplan
from upcc_tpu_torch.probes import tap_shapes

torch.set_num_threads(2)
RTOL, ATOL = 1e-4, 1e-5

# the seven call shapes of tap_gemm: (kind, kernel, cin, cout); widths chosen
# so that K blocks straddle slots, leave a K tail and a ragged last column
# block
SHAPES = [("conv", 3, 6, 5), ("conv", 5, 16, 24), ("down", 5, 12, 7),
          ("transpose", 5, 20, 3), ("grand_conv", 3, 3, 2),
          ("grand_transpose", 5, 8, 4), ("grand_down", 5, 4, 16)]
IDS = [f"{k}-k{ks}" for k, ks, _, _ in SHAPES]

CFG = {
    "max_batch": 8,
    "g_a": {"C_in": 4, "N1": 16, "N2": 16, "N3": 16, "N4": 16},
    "g_s": {"C_out": 3, "N1": 16, "N2": 16, "N3": 16, "N4": 16,
            "min_one_child": True},
    "entropy_model": {
        "C_bottleneck": 16, "C_hyper_bottleneck": 24,
        "quantization_mode": "ste", "inverse_rescaling": True,
        "quantization_offset": True,
    },
}


def T(x):
    return torch.from_numpy(np.array(x))


def _weights(kind, ks, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((ks ** 3, cin, cout)).astype(np.float32)


def _call(rng, k_in, rows=70, n_src=90):
    flat = rng.standard_normal((n_src, k_in)).astype(np.float32)
    idx = rng.integers(0, n_src + 30, (rows, 27)).astype(np.int32)  # clipped
    ok = rng.random((rows, 27)) < 0.7
    return flat, idx, ok


@pytest.mark.parametrize("kind,ks,cin,cout", SHAPES, ids=IDS)
def test_planned_plain_matches_dense_and_jax(kind, ks, cin, cout):
    w = T(_weights(kind, ks, cin, cout))
    plan = TF.prepare_taps(w, kind, ks)
    dense = TF._dense_taps(w, kind, ks)
    assert (plan.taps, plan.k_in, plan.k_out) == tuple(dense.shape)
    flat, idx, ok = _call(np.random.default_rng(ks), plan.k_in)
    got = TF.tap_gemm(T(flat), T(idx), T(ok), plan).numpy()
    ref = TF.tap_gemm_plain(T(flat), T(idx), T(ok), dense).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    jref = jax.jit(lambda *a: JF._tap_scan_gemm(
        a[0], flat.shape[0], *a[1:], jnp.float32))(flat, idx, ok,
                                                   dense.numpy())
    np.testing.assert_allclose(got, np.asarray(jref), RTOL, ATOL)


@pytest.mark.parametrize("kind,ks,cin,cout", SHAPES, ids=IDS)
def test_block_list_covers_every_nonzero_weight_in_order(kind, ks, cin, cout):
    w = T(_weights(kind, ks, cin, cout))
    plan = TF.prepare_taps(w, kind, ks)
    dense = TF._dense_taps(w, kind, ks).clone()
    assert torch.equal(plan.dense(), dense)
    ptr, tap, k0 = plan.blk_ptr, plan.blk_tap, plan.blk_k0
    assert ptr[0] == 0 and ptr[-1] == len(tap) == len(k0) == plan.n_blocks
    assert len(ptr) == -(-plan.k_out // plan.bn) + 1
    for col in range(plan.n_col):
        sl = slice(ptr[col], ptr[col + 1])
        pairs = list(zip(tap[sl], k0[sl]))
        assert pairs == sorted(set(pairs)), "tap-major, K-major, no repeats"
        tp = plan.tap_ptr[col].numpy()
        for t in range(plan.taps):
            assert (tap[tp[t]:tp[t + 1]] == t).all()
        assert tp[0] == ptr[col] and tp[-1] == ptr[col + 1]
        for t, k in pairs:
            blk = dense[t, k:k + plan.bk, col * plan.bn:(col + 1) * plan.bn]
            assert blk.any(), "a listed block holds no weight"
            blk.zero_()
    assert not dense.any(), "a nonzero weight lies outside the listed blocks"
    assert plan.wpack.shape == (plan.n_blocks, plan.bn, plan.bk)
    assert plan.n_blocks <= 27 * -(-plan.k_in // plan.bk) * plan.n_col


@pytest.mark.parametrize("kind,ks,cin,cout", SHAPES, ids=IDS)
def test_block_list_comes_from_tables_not_values(kind, ks, cin, cout):
    plans = [TF.prepare_taps(w, kind, ks) for w in (
        T(_weights(kind, ks, cin, cout)), torch.ones(ks ** 3, cin, cout),
        torch.zeros(ks ** 3, cin, cout))]
    for other in plans[1:]:
        for name in ("blk_ptr", "blk_tap", "blk_k0"):
            np.testing.assert_array_equal(getattr(plans[0], name),
                                          getattr(other, name))
        assert torch.equal(plans[0].tap_ptr, other.tap_ptr)


@pytest.mark.parametrize("k_out,bn", [
    (2048, 128), (1536, 128), (192, 128), (128, 128), (104, 128), (64, 64),
    (40, 64), (32, 32), (8, 32)])
def test_column_block_rule(k_out, bn):
    assert tapplan.choose_bn(k_out) == bn


@pytest.mark.parametrize("kind,ks,cin,cout,listed,of", [
    ("conv", 3, 192, 192, 1080, 7776), ("conv", 3, 128, 64, 288, 1728),
    ("conv", 3, 64, 1, 64, 216),
    ("grand_conv", 3, 32, 16, 384, 6912),
    ("grand_transpose", 5, 128, 32, 720, 6912),
    ("grand_down", 5, 4, 128, 144, 864)])
def test_flagship_lists_skip_the_structural_zeros(kind, ks, cin, cout, listed,
                                                  of):
    """Block counts at the flagship's widths (the list alone, no weights)."""
    struct = TF._tap_table_np(kind, ks) >= 0
    k_in, k_out = struct.shape[1] * cin, struct.shape[2] * cout
    bn = tapplan.choose_bn(k_out)
    ptr, tap, k0 = tapplan.block_list(struct, cin, cout, bn, tapplan.TAP_BK)
    assert len(tap) == listed
    assert 27 * -(-k_in // tapplan.TAP_BK) * (len(ptr) - 1) == of


def test_tap_shapes_probe_runs_on_the_cpu():
    """The K1 shape probe at the flagship's widths: on the CPU it holds the
    planned plain version against the dense one (no device time)."""
    out = tap_shapes.main(["--device", "cpu", "--rows", "40", "--reps", "1"])
    assert len(out) == len(tap_shapes.SHAPES)
    assert all(r["err"] <= 1e-5 and r["bound_ms"] > 0 for r in out)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tap_shapes.main(["--rows", "8"])


def _conv_setup():
    rng = np.random.default_rng(3)
    xyz = rng.integers(0, 20, (300, 3))
    keys = np.unique(TC.morton_encode_np(xyz.astype(np.int32)))
    keys = np.concatenate([keys, np.full(16, TC.SENTINEL, np.int64)])
    fm = TF.build_family(T(keys), parent_cap=len(keys))
    feats = T(rng.standard_normal((len(keys), 6)).astype(np.float32))
    valid = T(keys != TC.SENTINEL)
    return fm, feats, valid


def _follows(layer, fm, feats, valid):
    """The layer's output (through its cached plan) against the conv on
    its current raw parameter."""
    got = layer(fm, feats, valid)
    w = layer.w.detach().float()
    ref = TF.family_conv(fm, feats, valid, w, layer.kernel_size)
    if layer.b is not None:
        ref = (ref + layer.b.detach().float()) * valid[:, None]
    np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), 1e-6, 1e-6)
    return got.detach().clone()


@pytest.mark.parametrize("how", ["in_place", "load_state_dict", "to_dtype",
                                 "new_storage", "data_write_then_prepare"])
def test_cached_plan_follows_the_weights(how):
    torch.manual_seed(0)
    fm, feats, valid = _conv_setup()
    layer = L.FamilyConv(6, 5, 3)
    first = _follows(layer, fm, feats, valid)
    # the cache serves inference (gradients off); with gradients on a
    # trainable layer prepares its weights afresh for the step
    with torch.no_grad():
        plan = layer.taps()
        assert layer.taps() is plan, "an unchanged parameter keeps its plan"
    assert isinstance(layer.taps(), TF.TrainTaps)
    if how == "in_place":
        with torch.no_grad():
            layer.w.mul_(2.0)
    elif how == "load_state_dict":
        state = {k: v.clone() for k, v in layer.state_dict().items()}
        state["w"] = torch.randn_like(state["w"])
        layer.load_state_dict(state)
    elif how == "to_dtype":
        layer = layer.to(torch.float64)
        with torch.no_grad():
            layer.w.add_(0.5)
        layer = layer.to(torch.float32)
    elif how == "new_storage":  # what Module.to(device) does to a parameter
        layer.w.data = layer.w.data * -1.5
    else:
        # a write through .data bypasses the version counter: prepare()
        # (Codec.update() calls it on every layer) rebuilds the plan
        layer.w.data.mul_(3.0)
        assert layer.prepare() > 0
    with torch.no_grad():
        assert layer.taps() is not plan
    second = _follows(layer, fm, feats, valid)
    assert not torch.allclose(first, second)


@pytest.mark.parametrize("update", [False, True], ids=["no_update", "update"])
def test_codec_follows_changed_weights(update):
    """Change conv weights after Codec.update(): with or without another
    update() the codec computes what a codec built from the changed model
    computes."""
    torch.manual_seed(1)
    model = UnifiedModel(CFG)
    with torch.no_grad():  # a fresh init quantizes to all-zero symbols
        for m in model.modules():
            if isinstance(m, L._TapConv):
                m.w.mul_(4.0)
                if m.b is not None:
                    m.b.normal_(0.0, 0.5)
    codec = Codec(model, device="cpu")
    codec.update()
    assert codec.prepared_bytes > 0
    convs = [m for m in model.modules() if isinstance(m, L._TapConv)]
    assert all(m._plans for m in convs if m.kernel_size != 2)
    xyz, rgb = surface_cloud(np.random.default_rng(5), extent=48,
                             n_target=900)
    frame = np.concatenate([xyz.astype(np.float32), rgb], 1)
    q = (0.5, 0.5)

    def encode(c):
        """Container bytes and the entropy parameters behind them (floats
        that pass through h_a's and h_s's tap convs)."""
        c.debug, c.debug_info = True, []
        data = c.compress(frame, q, block_size=64)
        c.debug = False
        enc = [d for d in c.debug_info if d["side"] == "enc"]
        return data, np.concatenate([d["means"].ravel() for d in enc]), \
            np.concatenate([d["scales"].ravel() for d in enc])

    _, means0, scales0 = encode(codec)
    with torch.no_grad():
        model.g_a.conv2.w.mul_(1.5)
        model.entropy_model.ha1.w.mul_(-2.0)
        model.entropy_model.hs3.w.add_(0.05)
    state = copy.deepcopy(model.state_dict())
    if update:
        codec.update()
    fresh_model = UnifiedModel(CFG)
    fresh_model.load_state_dict(state)
    fresh = Codec(fresh_model, device="cpu")
    fresh.update()
    data, means, scales = encode(codec)
    fdata, fmeans, fscales = encode(fresh)
    assert data == fdata
    np.testing.assert_array_equal(means, fmeans)
    np.testing.assert_array_equal(scales, fscales)
    assert means0.any() and scales0.any()
    assert means.shape != means0.shape or not np.array_equal(means, means0)
    np.testing.assert_array_equal(codec.decompress(data),
                                  fresh.decompress(data))
