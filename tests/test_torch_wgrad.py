"""Kernel K1w's work decomposition on the CPU: the wgrad tile list, the
per-tap row lists, the split rule, and dW re-assembled from them (summed
in split order, as the kernel does) against ``tap_wgrad_plain`` and JAX's
vjp of ``_tap_scan_gemm``.  The kernel itself runs on the card
(``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from upcc_tpu.ops import family as JF

from upcc_tpu_torch.ops import family as F
from upcc_tpu_torch.ops import tapplan

torch.set_num_threads(2)

# (kind, kernel size, cin, cout) of every tap conv of the flagship's
# training step (grand layouts as the step runs them), and g_a's first
# layer outside grand layout (K_in 32)
FLAGSHIP = [("grand_down", 5, 4, 128), ("down", 5, 4, 128),
            ("down", 5, 128, 128), ("conv", 5, 128, 128),
            ("transpose", 5, 128, 128), ("conv", 3, 128, 64),
            ("conv", 3, 64, 1), ("grand_transpose", 5, 128, 32),
            ("grand_conv", 3, 32, 16), ("grand_conv", 3, 16, 1),
            ("conv", 3, 128, 192), ("down", 3, 192, 192),
            ("conv", 3, 192, 256)]
# small call shapes of every kind (those of tests/test_torch_train.py)
SHAPES = [("conv", 3, 4, 6), ("conv", 5, 4, 4), ("down", 5, 4, 8),
          ("transpose", 5, 8, 4), ("grand_conv", 3, 2, 2),
          ("grand_transpose", 5, 4, 2), ("grand_down", 5, 2, 4)]


def T(a):
    return torch.from_numpy(np.asarray(a))


def _blocks(kind, ks, cin, cout):
    struct = F._tap_table_np(kind, ks) >= 0
    n_in, n_out = struct.shape[1:]
    bn = tapplan.choose_bn(n_out * cout)
    return tapplan.block_list(struct, cin, cout, bn, tapplan.TAP_BK)


def _check_tiles(tiles, ptr, tap, k0, pairs):
    col = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
    seen = np.zeros(len(tap), int)
    for t_tap, t_k0, nblk, c0, p0, c1, p1, pad in tiles:
        assert nblk in ((1, 2) if pairs else (1,)) and pad == 0
        for c, p in ((c0, p0), (c1, p1))[:nblk]:
            # the list position points back to the block's (tap, K, column)
            assert (tap[p], k0[p], col[p]) == (t_tap, t_k0, c)
            seen[p] += 1
        if nblk == 1:
            assert c1 == -1 and p1 == -1
        else:
            assert c1 > c0
    assert (seen == 1).all()  # every listed block exactly once
    # ordered by tap, then K, then column; a single-column tile only ends
    # its (tap, K) pair
    key = [(t[0], t[1], t[3]) for t in tiles]
    assert key == sorted(key)
    if pairs:
        for a, b in zip(tiles[:-1], tiles[1:]):
            if a[2] == 1:
                assert (a[0], a[1]) != (b[0], b[1])


@pytest.mark.parametrize("pairs", [True, False])
@pytest.mark.parametrize("kind,ks,cin,cout", FLAGSHIP)
def test_wgrad_tiles_cover_flagship_blocks(kind, ks, cin, cout, pairs):
    ptr, tap, k0 = _blocks(kind, ks, cin, cout)
    tiles = tapplan.wgrad_tile_list(ptr, tap, k0, pairs)
    _check_tiles(tiles, ptr, tap, k0, pairs)
    if pairs:  # pairs halve the tiles of every (tap, K) pair, rounding up
        runs = np.unique(np.stack([tap, k0]), axis=1, return_counts=True)[1]
        assert len(tiles) == int(np.sum(-(-runs // 2)))


@pytest.mark.parametrize("kind,ks,cin,cout", SHAPES)
def test_plan_wgrad_tiles_cached_across_plans(kind, ks, cin, cout):
    """A plan's tiles match its block list; a second plan of the same slot
    structure (the next training step's) gets the same tensor back."""
    rng = np.random.default_rng(0)
    w = T(rng.normal(size=(ks ** 3, cin, cout)).astype(np.float32))
    plan = F.prepare_train_taps(w, kind, ks).plan
    tiles = plan.wgrad_tiles()
    _check_tiles(tiles.numpy(), plan.blk_ptr, plan.blk_tap, plan.blk_k0,
                 True)
    again = F.prepare_train_taps(w * 2, kind, ks).plan
    assert again is not plan and again.wgrad_tiles() is tiles
    assert again.wgrad_tiles(pairs=False) is not tiles


def test_wgrad_row_lists_equal_nonzero():
    rng = np.random.default_rng(1)
    ok = rng.random((300, 27)) < 0.45
    ok[:, 4] = False  # a tap no row reaches
    ok[:, 9] = True   # a tap every row reaches
    okt = T(ok)
    lists, ends = F.wgrad_row_lists(okt)
    assert lists.dtype == torch.int32 and lists.shape == (27 * 300 + 1,)
    for t in range(27):
        want = np.nonzero(ok[:, t])[0]
        base, count = _tap_range(ends, t, 300)
        assert count == len(want)
        np.testing.assert_array_equal(
            lists[1 + base:1 + base + count].numpy() - t * 300, want)
    # kept with the map: a second call returns the same lists, an update
    # of the map builds them afresh
    assert F.wgrad_row_lists(okt)[0] is lists
    okt[0, 4] = True
    again, ends2 = F.wgrad_row_lists(okt)
    assert again is not lists and _tap_range(ends2, 4, 300)[1] == 1


def _tap_range(ends, t, rows):
    """(first entry, count) of tap t in the flat row lists."""
    base = int(ends[t * rows - 1]) if t else 0
    return base, int(ends[(t + 1) * rows - 1]) - base


@pytest.mark.parametrize("rows", [1, 63, 64, 65, 40_000])
@pytest.mark.parametrize("n_tiles", [1, 64, 1008])
def test_wgrad_splits_cover_rows(rows, n_tiles):
    for per_sm in (1, 2, 4, 8, 16):
        chunk, splits = F.wgrad_splits(rows, n_tiles, 132, per_sm)
        assert chunk % F.WGRAD_ROWS == 0 and 1 <= splits <= 65535
        covered = np.zeros(rows, int)
        for s in range(splits):
            lo, hi = s * chunk, min((s + 1) * chunk, rows)
            assert lo < hi  # no split starts past the rows
            covered[lo:hi] += 1
        assert (covered == 1).all()
        if splits > 1:
            assert chunk >= F.WGRAD_MIN_CHUNK
    # few tiles and many rows split; many tiles do not
    assert F.wgrad_splits(40_000, 64, 132)[1] > 1
    assert F.wgrad_splits(40_000, 1008, 132)[1] == 1


def _assemble(flat, idx, ok, dacc, plan, pairs, chunk, splits):
    """dW's listed blocks as the kernel composes them: per tile and split,
    the split's range of the tap's row list, summed over splits in
    order."""
    n_src, bk, bn = flat.shape[0], plan.bk, plan.bn
    lists, ends = F.wgrad_row_lists(ok)
    pad_f = torch.nn.functional.pad(flat, (0, bk))
    pad_d = torch.nn.functional.pad(dacc, (0, bn))
    out = torch.full((plan.n_blocks, bk, bn), float("nan"))
    for tap, k0, nblk, c0, p0, c1, p1, _ in plan.wgrad_tiles(pairs).tolist():
        base, count = _tap_range(ends, tap, ok.shape[0])
        rows_t = lists[1 + base:1 + base + count].long() - tap * ok.shape[0]
        for c, p in ((c0, p0), (c1, p1))[:nblk]:
            total = torch.zeros((bk, bn))
            for s in range(splits):
                r = rows_t[s * chunk:(s + 1) * chunk]
                if len(r) == 0:
                    break
                src = idx[r, tap].long().clamp(max=n_src - 1)
                a = pad_f[src, k0:k0 + bk]
                total = total + a.T @ pad_d[r, c * bn:(c + 1) * bn]
            out[p] = total
    return out


@pytest.mark.parametrize("kind,ks,cin,cout", SHAPES + [("down", 5, 4, 16)])
def test_wgrad_decomposition_matches_plain_and_jax(kind, ks, cin, cout):
    rng = np.random.default_rng(3)
    rows, n_src = 320, 200
    w = T(rng.normal(size=(ks ** 3, cin, cout)).astype(np.float32))
    plan = F.prepare_train_taps(w, kind, ks).plan
    flat = rng.normal(size=(n_src, plan.k_in)).astype(np.float32)
    idx = rng.integers(0, n_src + 8, (rows, 27)).astype(np.int32)  # clamp
    ok = rng.random((rows, 27)) < 0.6
    ok[:, 13] = False
    dacc = rng.normal(size=(rows, plan.k_out)).astype(np.float32)
    dense = F.tap_wgrad_plain(T(flat), T(idx), T(ok), T(dacc))
    _, vjp = jax.vjp(lambda f, wd: JF._tap_scan_gemm(
        f, n_src, jnp.asarray(idx), jnp.asarray(ok), wd, jnp.float32),
        jnp.asarray(flat), jnp.zeros(dense.shape, jnp.float32))
    jd_w = torch.from_numpy(np.array(vjp(jnp.asarray(dacc))[1]))
    ref, jref = plan.blocks_of(dense), plan.blocks_of(jd_w)
    n_tiles = len(plan.wgrad_tiles())
    chunk, splits = F.wgrad_splits(rows, n_tiles, 1000, min_chunk=64)
    assert (chunk, splits) == (64, 5)
    for pairs in (True, False):
        got = _assemble(T(flat), T(idx), T(ok), T(dacc), plan, pairs, chunk,
                        splits)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got, jref, rtol=1e-5, atol=1e-4)
