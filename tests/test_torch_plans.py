"""The launch planners of kernels K2 (``ops/topk.py::topk_plan``), K3
(``ops/sparse.py::compact_plan``) and P2 (``ops/probe_kernels.py::window_plan``):
pure Python, so the CPU tests reach what the CUDA kernels are launched with
— modes, grids, tiles, vector widths, slab widths and shared-memory sizes —
at fixed SM counts and shared-memory limits."""

import pytest
import torch

from upcc_tpu_torch.ops import probe_kernels as PK
from upcc_tpu_torch.ops import sparse as TS
from upcc_tpu_torch.ops import topk as TT

H100_SMS, H100_OPTIN = 132, 232448  # SMs, opt-in shared bytes per block


@pytest.mark.parametrize("maxb", [1, 2, 3, 5, 63, 64, 1023, 1024])
def test_topk_resident_slice_is_16_byte_aligned(maxb):
    """The slice after the histograms and per-batch arrays takes 16-byte
    vector accesses."""
    assert TT.topk_smem(maxb, 0, True) % 16 == 0
    assert TT.topk_smem(maxb, 0, True) >= TT.TOPK_WIN * 1024 + 20 * maxb


@pytest.mark.parametrize("n,maxb,sms,optin,resident,grid,per_block", [
    # the main path's three calls on an H100 (maxb 64)
    (262_144, 64, H100_SMS, H100_OPTIN, True, 64, 4096),
    (1_048_576, 64, H100_SMS, H100_OPTIN, True, 128, 8192),
    (4_194_304, 64, H100_SMS, H100_OPTIN, True, 128, 32768),
    # the last n a resident grid holds (9 chunks a block), and one more
    (9 * 4096 * 132, 64, H100_SMS, H100_OPTIN, True, 132, 36864),
    (9 * 4096 * 132 + 1, 64, H100_SMS, H100_OPTIN, False, 119, 40960),
    # chip_smoke.py's streaming case, its maxb 1023 case and its calls
    # with growing maxb on one stream
    (40_000_003, 1, H100_SMS, H100_OPTIN, False, 132, 303104),
    (128_777, 1023, H100_SMS, H100_OPTIN, True, 32, 4096),
    (600_777, 2, H100_SMS, H100_OPTIN, True, 74, 8192),
    # a few candidates, a card with fewer SMs, less shared memory
    (5, 1, H100_SMS, H100_OPTIN, True, 1, 4096),
    (1_000_000, 64, 114, H100_OPTIN, True, 82, 12288),
    (1_000_000, 1024, 132, 101_376, True, 123, 8192),
    (1_000_000, 1024, 132, 49_152, False, 123, 8192),
    (400_000, 64, 132, 101_376, True, 98, 4096),
])
def test_topk_plan(n, maxb, sms, optin, resident, grid, per_block):
    plan = TT.topk_plan(n, maxb, sms, optin)
    assert (plan.resident, plan.grid, plan.per_block) == (
        resident, grid, per_block)
    assert plan.per_block % TT.TOPK_CHUNK == 0 and plan.grid <= sms
    assert plan.grid * plan.per_block >= n > (plan.grid - 1) * plan.per_block
    assert plan.smem == TT.topk_smem(maxb, plan.per_block, plan.resident)
    assert plan.smem + TT.TOPK_STATIC_SMEM <= optin
    assert plan.hist == 4 * 256 * maxb


@pytest.mark.parametrize("maxb,sms,optin", [
    (64, H100_SMS, H100_OPTIN), (1, 132, H100_OPTIN), (1024, 132, H100_OPTIN),
    (64, 114, 101_376), (7, 16, 49_152)])
def test_topk_plan_resident_boundary(maxb, sms, optin):
    """Resident exactly while a block's slice fits the shared memory left
    beside the histograms and per-batch arrays."""
    room = (optin - TT.TOPK_STATIC_SMEM - TT.topk_smem(maxb, 0, False)) // 6
    room -= room % TT.TOPK_CHUNK
    last = sms * room
    assert TT.topk_plan(last, maxb, sms, optin).resident
    over = TT.topk_plan(last + 1, maxb, sms, optin)
    assert not over.resident and over.smem == TT.topk_smem(maxb, 0, False)


@pytest.mark.parametrize("s_rows,k,optin,width,slabs,last", [
    (4096, 512, H100_OPTIN, 8, 64, 8),          # the probe's shape: 128 KB
    (4096, 64, H100_OPTIN, 8, 8, 8),
    (4096, 96, H100_OPTIN, 8, 12, 8),
    (4096, 12, H100_OPTIN, 8, 2, 4),            # a ragged 4-wide last slab
    (37, 12, H100_OPTIN, 8, 2, 4),
    (4096, 48, H100_OPTIN, 8, 6, 8),
    (4000, 64, H100_OPTIN, 8, 8, 8),
    (5120, 64, H100_OPTIN, 8, 8, 8),
    (4096, 520, H100_OPTIN, 8, 65, 8),
    (4096, 4, H100_OPTIN, 4, 1, 4),             # never wider than the row
    (7264, 64, H100_OPTIN, 8, 8, 8),            # the widest 8-float slab
    (7265, 64, H100_OPTIN, 4, 16, 4),           # from here 4-float slabs
    (10000, 12, H100_OPTIN, 4, 3, 4),
    (14528, 64, H100_OPTIN, 4, 16, 4),          # the last window that fits
    (14529, 64, H100_OPTIN, 0, 0, 0),           # streaming mode
    (20000, 64, H100_OPTIN, 0, 0, 0),
    (4096, 512, 101_376, 4, 128, 4),            # less shared memory
])
def test_window_plan(s_rows, k, optin, width, slabs, last):
    plan = PK.window_plan(s_rows, k, optin)
    assert (plan.width, plan.slabs, plan.last) == (width, slabs, last)
    if width:
        assert plan.smem == s_rows * width * 4 <= optin
        assert (slabs - 1) * width + last == k and 0 < last <= width
        assert last % 4 == 0
    else:
        assert plan.smem == 0 and s_rows * 16 > optin


def test_topk_stream_buffers_keep_tie_totals_apart():
    """Per stream, K2's histograms (which must be zero on entry) and its
    per-block tie totals (left behind by every call) are two buffers, each
    grown on its own: a later call with more batches never reads an earlier
    call's tie totals as counts."""
    hist, totals, key = {}, {}, (0, 0)
    small = TT.topk_plan(600_000, 1, H100_SMS, H100_OPTIN)
    big = TT.topk_plan(600_000, 8, H100_SMS, H100_OPTIN)
    h1 = TT._buffer(hist, key, small.hist, "cpu")
    t1 = TT._buffer(totals, key, small.grid, "cpu")
    t1.fill_(7)
    h2 = TT._buffer(hist, key, big.hist, "cpu")
    assert h2.numel() == big.hist > h1.numel() and not h2.any()
    assert TT._buffer(totals, key, big.grid, "cpu") is t1
    assert TT._buffer(hist, key, small.hist, "cpu") is h2


@pytest.mark.parametrize("n,m,sms,optin,tile,tiles,tail", [
    # the main path's three top-k calls on an H100
    (262_144, 131_072, H100_SMS, H100_OPTIN, 1024, 256, 64),
    (1_048_576, 262_144, H100_SMS, H100_OPTIN, 1024, 1024, 128),
    (4_194_304, 1_048_576, H100_SMS, H100_OPTIN, 4096, 1024, 264),
    # the least n with 4 tiles of 4096 an SM, one less; the same for 2048
    (527 * 4096 + 1, 1000, H100_SMS, H100_OPTIN, 4096, 528, 1),
    (527 * 4096, 1000, H100_SMS, H100_OPTIN, 2048, 1054, 1),
    (527 * 2048 + 1, 5000, H100_SMS, H100_OPTIN, 2048, 528, 3),
    (527 * 2048, 5000, H100_SMS, H100_OPTIN, 1024, 1054, 3),
    # nothing to scan (tail blocks only), a few rows, the largest m
    (0, 1000, H100_SMS, H100_OPTIN, 1024, 0, 1),
    (5, 5, H100_SMS, H100_OPTIN, 1024, 1, 1),
    (100, 2 ** 31 - 1, H100_SMS, H100_OPTIN, 1024, 1, 264),
    # fewer SMs; a shared-memory limit the 4096-row list does not fit
    (1_000_000, 1_000_000, 16, H100_OPTIN, 4096, 245, 32),
    (4_194_304, 1000, H100_SMS, 8192, 2048, 2048, 1),
])
def test_compact_plan_tiles(n, m, sms, optin, tile, tiles, tail):
    plan = TS.compact_plan(n, m, (), sms, optin)
    assert (plan.tile, plan.tiles, plan.tail) == (tile, tiles, tail)
    assert plan.tile in TS.COMPACT_TILES and plan.tile % TS.COMPACT_THREADS == 0
    assert plan.tiles * plan.tile >= n > (plan.tiles - 1) * plan.tile
    assert 1 <= plan.tail <= 2 * sms
    assert plan.smem == 4 * plan.tile <= optin
    assert plan.status == plan.tiles


@pytest.mark.parametrize("row_bytes,align,unit,lanes", [
    (512, 16, 16, 32),   # f32 [.., 128]: one warp a row
    (256, 16, 16, 16),   # bf16 [.., 128]
    (64, 16, 16, 4),     # bf16 [.., 32]
    (8, 16, 4, 2),       # int64
    (4, 16, 4, 1),       # int32
    (2, 16, 1, 2),
    (1, 16, 1, 1),       # bool
    (3, 16, 1, 4),       # bool [.., 3]: 3 of 4 lanes
    (12, 16, 4, 4),
    (48, 16, 16, 4),
    (24, 8, 4, 8),
    (6, 16, 1, 8),
    (1200, 16, 16, 32),  # 75 units: 32 lanes loop over the row
    (2048, 16, 16, 32),
    (16, 4, 4, 4),       # a view at a 4-byte offset
    (16, 2, 1, 16),      # a view at a 2-byte offset
    (5, 1, 1, 8),        # a view at an odd offset
    (64, 8, 4, 16),
])
def test_compact_plan_units(row_bytes, align, unit, lanes):
    """The widest unit dividing both the row bytes and the pointers, and
    the power of two of lanes that covers a row's units (at most 32)."""
    plan = TS.compact_plan(1000, 1000, ((row_bytes, align),), H100_SMS,
                           H100_OPTIN)
    assert (plan.units, plan.lanes) == ((unit,), (lanes,))
    assert row_bytes % unit == 0 and align % unit == 0
    units = row_bytes // unit
    assert lanes == 32 or lanes // 2 < units <= lanes


@pytest.mark.parametrize("payloads,groups", [
    (0, ((0, 0),)),          # keys only: one launch
    (1, ((0, 1),)),
    (3, ((0, 3),)),          # the finest level's feats and parent links
    (8, ((0, 8),)),          # as many as one launch's parameters hold
    (9, ((0, 8), (8, 9))),
    (17, ((0, 8), (8, 16), (16, 17))),
])
def test_compact_plan_splits_past_the_descriptor_limit(payloads, groups):
    rows = tuple((4 * (i + 1), 16) for i in range(payloads))
    plan = TS.compact_plan(50_000, 40_000, rows, H100_SMS, H100_OPTIN)
    assert plan.groups == groups
    assert all(end - first <= TS.COMPACT_MAX_PAYLOADS
               for first, end in plan.groups)
    assert len(plan.units) == len(plan.lanes) == payloads


def test_compact_status_words_per_stream():
    """K3's status words: one buffer per (device, stream), at least one
    word per tile, a new epoch per launch that no word of another launch
    carries; growing keeps the epochs rising, other streams have buffers
    of their own, and the buffer is zeroed when the epochs run out."""
    store, a, b = {}, (0, 11), (0, 22)
    small = TS.compact_plan(262_144, 131_072, (), H100_SMS, H100_OPTIN)
    big = TS.compact_plan(4_194_304, 1_048_576, (), H100_SMS, H100_OPTIN)
    assert small.status == 256 and big.status == 1024
    buf1, e1 = TS._status_words(store, a, small.status, "cpu")
    assert buf1.numel() == 256 and buf1.dtype == torch.int64
    assert not buf1.any() and e1 == 1
    buf1.fill_(e1 << 32)  # what a launch leaves behind
    buf2, e2 = TS._status_words(store, a, small.status, "cpu")
    assert buf2 is buf1 and e2 == 2
    grown, e3 = TS._status_words(store, a, big.status, "cpu")
    assert grown.numel() == 1024 and not grown.any() and e3 == 3
    other, e_other = TS._status_words(store, b, small.status, "cpu")
    assert other.data_ptr() != grown.data_ptr() and e_other == 1
    assert TS._status_words(store, a, small.status, "cpu")[0] is grown
    # the epochs run out: zeroed, counted from 1 again
    grown.fill_(-1)
    store[a][1] = TS.EPOCH_MAX
    again, e = TS._status_words(store, a, small.status, "cpu")
    assert again is grown and e == 1 and not again.any()
