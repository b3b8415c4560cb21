"""Parity of the PyTorch port's ops (keys, sets, family convs, top-k) with
the JAX package, on the CPU at small sizes.

Integer outputs must be equal; float conv outputs agree at f32 with JAX's
`highest` matmul precision (tests/conftest.py) to rtol 1e-4, atol 1e-5 —
the two differ only in the order of f32 sums."""

import numpy as np
import pytest
import torch

import upcc_tpu  # noqa: F401  (enables jax x64)
import jax
import jax.numpy as jnp

from upcc_tpu.ops import coords as JC
from upcc_tpu.ops import family as JF
from upcc_tpu.ops import sparse as JS
from upcc_tpu.ops import topk as JT
from upcc_tpu_torch.ops import coords as TC
from upcc_tpu_torch.ops import family as TF
from upcc_tpu_torch.ops import sparse as TS
from upcc_tpu_torch.ops import topk as TT

torch.set_num_threads(2)
RTOL, ATOL = 1e-4, 1e-5


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _keys(seed, n=400, extent=24, cap=512, batches=1):
    """Sorted, dedup'd, sentinel-padded keys from random points (host)."""
    rng = np.random.default_rng(seed)
    xyz = rng.integers(0, extent, (n, 3)).astype(np.int32)
    b = rng.integers(0, batches, n).astype(np.int32)
    keys, _ = JS.voxelize_host_np(b, xyz, np.zeros((n, 1), np.float32), cap)
    return keys


def _eq(a, b):
    np.testing.assert_array_equal(N(a), N(b))


def test_morton_and_keys_match_jax():
    rng = np.random.default_rng(0)
    units = rng.integers(0, 1 << 19, (1000, 3)).astype(np.int32)
    batch = rng.integers(0, 64, 1000).astype(np.int32)
    jk = JC.make_keys(jnp.asarray(batch), jnp.asarray(units))
    tk = TC.make_keys(T(batch), T(units))
    _eq(tk, jk)
    _eq(TC.key_units(tk), JC.key_units(jk))
    _eq(TC.key_batch(tk), JC.key_batch(jk))
    _eq(TC.morton_encode_np(units), JC.morton_encode_np(units))
    _eq(TC.morton_decode_np(N(tk)), JC.morton_decode_np(N(jk)))
    for ks in (2, 3, 5):
        _eq(TC.kernel_offsets(ks), JC.kernel_offsets(ks))


def _compact_payloads(rng, n, kinds):
    out = []
    for kind in kinds:
        if kind == "f32":
            a = rng.standard_normal((n, 5)).astype(np.float32)
            a[::7] = -0.0
        elif kind == "i32":
            a = rng.integers(0, 1000, n).astype(np.int32)
        elif kind == "i32x2":
            a = rng.integers(-(1 << 30), 1 << 30, (n, 2)).astype(np.int32)
        elif kind == "bool":
            a = rng.random(n) < 0.5
        elif kind == "boolx3":
            a = rng.random((n, 3)) < 0.5
        else:  # u8x5
            a = rng.integers(0, 256, (n, 5)).astype(np.uint8)
        out.append(a)
    return out


# (out_capacity, keep probability, payload kinds); the first three are
# the original cases, kept under their ids
_COMPACT_CASES = {
    "None": (None, 0.6, ("f32", "i32")),
    "100": (100, 0.6, ("f32", "i32")),
    "700": (700, 0.6, ("f32", "i32")),
    "none_kept": (300, 0.0, ("f32", "i32")),
    "all_kept": (None, 1.0, ("f32", "i32")),
    "all_kept_m_lt_n": (333, 1.0, ("f32", "i32")),
    "m_lt_kept": (50, 0.8, ("f32", "i32x2")),
    "m_gt_n": (1000, 0.5, ("f32", "i32")),
    "m_zero": (0, 0.5, ("f32", "i32")),
    "keys_only": (400, 0.5, ()),
    "mixed_dtypes": (500, 0.4, ("bool", "boolx3", "i32x2", "u8x5", "f32",
                                "i32")),
}


@pytest.mark.parametrize("case", list(_COMPACT_CASES))
def test_compact_matches_jax(case):
    """compact_plain (what ``compact`` runs on the CPU) against the
    reference's compact, bit for bit (dtype, shape and bytes)."""
    out_capacity, p, kinds = _COMPACT_CASES[case]
    rng = np.random.default_rng(1)
    keys = _keys(1, n=500, cap=640)
    keep = rng.random(640) < p
    arrays = _compact_payloads(rng, 640, kinds)
    jout = jax.jit(lambda k, m, *a: JS.compact(
        k, m, *a, out_capacity=out_capacity))(keys, keep, *arrays)
    tout = TS.compact(T(keys), T(keep), *map(T, arrays),
                      out_capacity=out_capacity)
    assert len(tout) == len(jout) == 1 + len(kinds)
    for a, b in zip(tout, jout):
        a, b = N(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        _eq(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("n,m", [(0, 0), (0, 7), (9, 0)])
def test_compact_plain_empty(n, m):
    """Empty input or output (which the reference's gather formulation does
    not take): SENTINEL keys and zero rows, or nothing."""
    keys = torch.full((n,), 5, dtype=torch.int64)
    keep = torch.ones(n, dtype=torch.bool)
    f = torch.ones((n, 3), dtype=torch.bfloat16)
    out_keys, out_f = TS.compact_plain(keys, keep, f, out_capacity=m)
    assert out_keys.shape == (m,) and out_f.shape == (m, 3)
    assert out_f.dtype == torch.bfloat16 and not out_f.any()
    assert (out_keys == TC.SENTINEL).all() if n == 0 else \
        out_keys.numel() == 0


def test_down_and_upsample_keys_match_jax():
    keys = _keys(2, n=600, extent=40, cap=1024, batches=3)
    _eq(TS.downsample_keys(T(keys), 300),
        jax.jit(lambda k: JS.downsample_keys(k, 300))(keys))
    _eq(TS.upsample_children_keys(T(keys)),
        jax.jit(JS.upsample_children_keys)(keys))


def test_voxelize_host_matches_jax():
    rng = np.random.default_rng(3)
    xyz = rng.integers(0, 50, (3000, 3)).astype(np.int32)
    b = rng.integers(0, 4, 3000).astype(np.int32)
    f = rng.random((3000, 3)).astype(np.float32)
    for cap in (4096, 1000):
        tk, tf = TS.voxelize_host_np(b, xyz, f, cap)
        jk, jf = JS.voxelize_host_np(b, xyz, f, cap)
        _eq(tk, jk)
        _eq(tf, jf)


def test_static_tables_are_verbatim():
    for a, b in zip(TF._derive_tables(), JF._derive_tables()):
        _eq(a, b)
    for ks in (3, 5):
        _eq(TF._slot_tap_table(ks), JF._slot_tap_table(ks))
    for ks, mode in ((3, "conv"), (5, "transpose"), (5, "down")):
        _eq(TF._grand_tap_table(ks, mode), JF._grand_tap_table(ks, mode))


@pytest.mark.parametrize("cap", [512, 64])
def test_build_family_and_find_match_jax(cap):
    keys = _keys(4, n=450, cap=512, batches=2)
    jfm = jax.jit(lambda k: JF.build_family(k, parent_cap=cap))(keys)
    tfm = TF.build_family(T(keys), parent_cap=cap)
    for name in ("parent_keys", "point_parent", "point_slot", "nbr_idx",
                 "nbr_ok"):
        _eq(getattr(tfm, name), getattr(jfm, name))
    q = _keys(5, n=300, cap=512, batches=2)
    for a, b in zip(TF.find(T(keys), T(q)), JF.find(jnp.asarray(keys), q)):
        _eq(a, b)


def test_pyramid_and_host_root_match_jax():
    keys = _keys(6, n=900, extent=60, cap=1024, batches=2)
    caps = [512, 256, 128]
    _, ri, ro = JF.host_root_neighbors(keys, 3, 128, caps)
    _, ti, to = TF.host_root_neighbors(keys, 3, 128, caps)
    _eq(ti, ri)
    _eq(to, ro)
    for root in (None, (ri, ro)):
        jl = jax.jit(lambda k, r: JF.pyramid(k, caps, root_nbr=r))(keys, root)
        tl = TF.pyramid(T(keys), caps, root_nbr=None if root is None
                        else (T(ri), T(ro)))
        for a, b in zip(tl, jl):
            for key in b:
                if key == "nbr":
                    _eq(a[key][0], b[key][0])
                    _eq(a[key][1], b[key][1])
                else:
                    _eq(a[key], b[key])


def test_bricks_match_jax():
    keys, jfm, tfm = _family_pair(19)
    rng = np.random.default_rng(19)
    f = rng.standard_normal((keys.shape[0], 3)).astype(np.float32)
    valid = keys != TC.SENTINEL
    jb = jax.jit(JF.to_brick)(jfm, f)
    tb = TF.to_brick(tfm, T(f))
    _eq(tb[:-1], jb[:-1])  # the dump row's content is unspecified
    _eq(TF.from_brick(tfm, tb, T(valid)),
        jax.jit(JF.from_brick)(jfm, jb, jnp.asarray(valid)))


def _family_pair(seed, cap=256, extent=20, n=300):
    keys = _keys(seed, n=n, extent=extent, cap=cap)
    jfm = jax.jit(lambda k: JF.build_family(k, parent_cap=cap))(keys)
    tfm = TF.build_family(T(keys), parent_cap=cap)
    return keys, jfm, tfm


@pytest.mark.parametrize("ks", [3, 5])
def test_family_conv_matches_jax(ks):
    keys, jfm, tfm = _family_pair(7)
    rng = np.random.default_rng(ks)
    f = rng.standard_normal((keys.shape[0], 6)).astype(np.float32)
    w = rng.standard_normal((ks ** 3, 6, 5)).astype(np.float32)
    valid = keys != TC.SENTINEL
    ref = jax.jit(lambda fm, f, w: JF.family_conv(
        fm, f, jnp.asarray(valid), w, ks, compute_dtype=jnp.float32))(
        jfm, f, w)
    got = TF.family_conv(tfm, T(f), T(valid), T(w), ks)
    np.testing.assert_allclose(N(got), np.asarray(ref), RTOL, ATOL)


@pytest.mark.parametrize("ks", [3, 5])
def test_family_down_conv_matches_jax(ks):
    keys, jfm, tfm = _family_pair(8)
    rng = np.random.default_rng(10 + ks)
    f = rng.standard_normal((keys.shape[0], 4)).astype(np.float32)
    w = rng.standard_normal((ks ** 3, 4, 7)).astype(np.float32)
    valid = keys != TC.SENTINEL
    ref = jax.jit(lambda fm, f, w: JF.family_down_conv(
        fm, f, jnp.asarray(valid), w, ks, compute_dtype=jnp.float32))(
        jfm, f, w)
    got = TF.family_down_conv(tfm, T(f), T(valid), T(w), ks)
    np.testing.assert_allclose(N(got), np.asarray(ref), RTOL, ATOL)


@pytest.mark.parametrize("ks", [2, 5])
def test_family_transpose_up_matches_jax(ks):
    keys = _keys(9, n=200, cap=256)
    jnbr = jax.jit(JF.root_neighbors)(keys)
    tnbr = TF.root_neighbors(T(keys))
    _eq(tnbr[0], jnbr[0])
    _eq(tnbr[1], jnbr[1])
    rng = np.random.default_rng(20 + ks)
    f = rng.standard_normal((256, 5)).astype(np.float32)
    w = rng.standard_normal((ks ** 3, 5, 3)).astype(np.float32)
    valid = keys != TC.SENTINEL
    ref = jax.jit(lambda n, f, w: JF.family_transpose_up(
        n, f, jnp.asarray(valid), w, ks, compute_dtype=jnp.float32))(
        jnbr, f, w)
    got = TF.family_transpose_up(tnbr, T(f), T(valid), T(w), ks)
    np.testing.assert_allclose(N(got), np.asarray(ref), RTOL, ATOL)


@pytest.mark.parametrize("mode,ks", [("conv", 3), ("transpose", 5),
                                     ("down", 5)])
def test_grand_apply_matches_jax(mode, ks):
    keys = _keys(11, n=150, extent=16, cap=256)
    jnbr = jax.jit(JF.root_neighbors)(keys)
    tnbr = TF.root_neighbors(T(keys))
    n_in, _ = JF._GRAND_SLOTS[mode]
    rng = np.random.default_rng(30 + ks)
    brick = rng.standard_normal((256, n_in, 3)).astype(np.float32)
    brick[keys == TC.SENTINEL] = 0
    w = rng.standard_normal((ks ** 3, 3, 2)).astype(np.float32)
    ref = jax.jit(lambda n, b, w: JF.grand_apply(
        n, b, w, ks, mode, compute_dtype=jnp.float32))(jnbr, brick, w)
    got = TF.grand_apply(tnbr, T(brick), T(w), ks, mode)
    np.testing.assert_allclose(N(got), np.asarray(ref), RTOL, ATOL)


def test_tap_gemm_plain_matches_jax_scan():
    rng = np.random.default_rng(12)
    flat = rng.standard_normal((90, 24)).astype(np.float32)
    idx = rng.integers(0, 120, (70, 27)).astype(np.int32)  # some clipped
    ok = rng.random((70, 27)) < 0.7
    w = rng.standard_normal((27, 24, 16)).astype(np.float32)
    ref = jax.jit(lambda *a: JF._tap_scan_gemm(a[0], 90, *a[1:],
                                               jnp.float32))(flat, idx, ok, w)
    got = TF.tap_gemm(T(flat), T(idx), T(ok), T(w))
    np.testing.assert_allclose(N(got), np.asarray(ref), RTOL, ATOL)


def test_member_brick_and_derive_match_jax():
    keys = _keys(13, n=500, extent=30, cap=512, batches=2)
    pk, pp, sl = jax.jit(lambda k: JF.parents_of(k, 256))(keys)
    jroot = jax.jit(JF.root_neighbors)(pk)
    valid = keys != TC.SENTINEL
    jb = jax.jit(lambda a, b: JF.member_brick(a, b, jnp.asarray(valid), 256,
                                              512))(pp, sl)
    tb = TF.member_brick(T(pp), T(sl), T(valid), 256, 512)
    _eq(tb[:256], jb[:256])  # the dump row's content is unspecified
    jd = jax.jit(JF.derive_self_neighbors)(keys, pp, sl, jroot)
    td = TF.derive_self_neighbors(T(keys), T(pp), T(sl),
                                  (T(jroot[0]), T(jroot[1])))
    _eq(td[0], jd[0])
    _eq(td[1], jd[1])


def _topk_case(seed, counts, k, quant, tail=37):
    rng = np.random.default_rng(seed)
    keys = []
    for b, n in enumerate(counts):
        m = np.sort(rng.choice(1 << 18, n, replace=False)).astype(np.int64)
        keys.append(m | (np.int64(b) << TC.BATCH_SHIFT))
    keys = np.concatenate(keys + [np.full(tail, TC.SENTINEL, np.int64)])
    logits = np.round(rng.standard_normal(len(keys)) * quant) / quant
    logits = logits.astype(np.float32)
    logits[::13] = -0.0
    logits[1::13] = 0.0
    return keys, logits, np.asarray(k, np.int32)


@pytest.mark.parametrize("case", ["ties", "edges", "63_batches",
                                  "main_path_form"])
def test_topk_mask_matches_jax(case):
    if case == "ties":
        keys, logits, k = _topk_case(14, [300, 500], [120, 250], 1.0)
    elif case == "edges":  # k = 0, k = count, k > count, k < 0
        keys, logits, k = _topk_case(15, [50, 60, 70, 80], [0, 60, 500, -2],
                                     2.0)
    elif case == "main_path_form":
        # as the decoder calls it: one populated batch among maxb = 64,
        # every other k = 0, tie-heavy logits with -0.0 and +0.0
        keys, logits, k = _topk_case(19, [3000], [1111] + [0] * 63, 0.5)
    else:
        rng = np.random.default_rng(16)
        counts = rng.integers(1, 60, 63)
        k = [int(c * f) for c, f in zip(counts, rng.random(63))] + [0]
        keys, logits, k = _topk_case(17, counts, k, 3.0)
    jst = JS.SparseTensor(keys=jnp.asarray(keys), feats=jnp.zeros((len(keys), 1)))
    ref = jax.jit(JT.topk_mask)(jst, logits, k)
    tst = TS.SparseTensor(keys=T(keys), feats=torch.zeros(len(keys), 1))
    got = TT.topk_mask(tst, T(logits), T(k))
    _eq(got, ref)
    # the kept count per batch is exactly min(max(k, 0), count)
    b = keys[keys != TC.SENTINEL] >> TC.BATCH_SHIFT
    kept = np.bincount(b[N(got)[keys != TC.SENTINEL]], minlength=len(k))
    cnt = np.bincount(b, minlength=len(k))
    _eq(kept, np.minimum(np.maximum(k, 0), cnt))


def test_prune_matches_jax():
    keys = _keys(18, n=300, cap=512)
    rng = np.random.default_rng(18)
    keep = rng.random(512) < 0.5
    f = rng.standard_normal((512, 3)).astype(np.float32)
    jst = JS.SparseTensor(keys=jnp.asarray(keys), feats=jnp.asarray(f))
    ref = jax.jit(lambda s, m: JT.prune(s, m, 200))(jst, keep)
    got = TT.prune(TS.SparseTensor(T(keys), T(f)), T(keep), 200)
    _eq(got.keys, ref.keys)
    _eq(got.feats, ref.feats)
