"""Region-candidate g_s through the port's codec on the CPU at N=16: the
encoder does not depend on the candidate mode, the ``gs.region.*``
counters against sizes worked out from the keys, the dilation cap from the
configuration, the two spans of each level and their synchronization under
``Codec.profile``; the dilation in one pass over the 27 neighbours."""

import numpy as np
import pytest
import torch
import torch.utils._python_dispatch

from upcc_tpu_torch.codec.codec import Codec
from upcc_tpu_torch.data.synthetic import surface_cloud
from upcc_tpu_torch.models import transforms
from upcc_tpu_torch.models.unified import UnifiedModel
from upcc_tpu_torch.ops import coords as C
from upcc_tpu_torch.ops import sparse as S
from upcc_tpu_torch.utils import profiling as P
from upcc_tpu_torch.weights import flagship_config

torch.set_num_threads(2)

Q = (0.5, 0.5)
REGION = ("gs.region.dilate", "gs.region.maps")
COUNTERS = ("gs.region.dilated", "gs.region.clipped", "gs.region.covered",
            "gs.region.kept")


def region_config(factor=3.0, width=16):
    cfg = flagship_config(width)
    cfg["g_s"].update(min_one_child=False, region_candidates=True,
                      region_dilate_factor=factor)
    return cfg


def make_codec(cfg):
    """A codec on the seeded width-16 flagship parameters: the candidate
    mode is a g_s flag over the same parameter tree."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        state = UnifiedModel(flagship_config(16)).state_dict()
    model = UnifiedModel(cfg)
    model.load_state_dict(state)
    c = Codec(model, device="cpu")
    c.update()
    return c


@pytest.fixture(scope="module")
def codecs():
    return make_codec(flagship_config(16)), make_codec(region_config())


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(11)
    parts = []
    for off in (0, 96):
        xyz, rgb = surface_cloud(rng, extent=64, n_target=1500)
        parts.append(np.concatenate(
            [(xyz + np.array([[off, 0, 0]])).astype(np.float32), rgb], 1))
    return np.concatenate(parts)


@pytest.fixture(scope="module")
def data(codecs, frame):
    return codecs[1].compress(frame, Q, block_size=64)


def test_region_container_equals_the_8child_container(codecs, frame, data):
    assert codecs[0].compress(frame, Q, block_size=64) == data
    assert len(codecs[1].decompress(data)) > 0


def dilated_count(keys):
    """Distinct 27-neighbours inside the coordinate range of a key set's
    valid keys, in numpy."""
    keys = np.asarray(keys)
    keys = keys[keys != C.SENTINEL]
    batch = keys >> C.BATCH_SHIFT
    units = C.morton_decode_np(keys & C.KEY_MASK).astype(np.int64)
    seen = set()
    for e in C.kernel_offsets(3):
        nu = units + e
        ok = ((nu >= 0) & (nu < (1 << C.COORD_BITS))).all(1)
        seen.update(zip(batch[ok].tolist(), *nu[ok].T.tolist()))
    return len(seen)


def decode_seen(codec, data, monkeypatch):
    """Decode under a recording; per level, the sizes worked out from the
    keys g_s saw: (dilated, clipped, covered, kept)."""
    levels = []
    dilate, topk, compact = (transforms.dilate_keys, transforms.topk_mask,
                             transforms.compact)

    def spy_dilate(keys, capacity, **kw):
        n = dilated_count(keys.numpy())
        levels.append([n, max(n - capacity, 0)])
        return dilate(keys, capacity, **kw)

    def spy_topk(cand, logits, k):
        levels[-1].append(int(C.key_is_valid(cand.keys).sum()))
        return topk(cand, logits, k)

    def spy_compact(keys, keep, *args, **kw):
        levels[-1].append(int(keep.sum()))
        return compact(keys, keep, *args, **kw)

    monkeypatch.setattr(transforms, "dilate_keys", spy_dilate)
    monkeypatch.setattr(transforms, "topk_mask", spy_topk)
    monkeypatch.setattr(transforms, "compact", spy_compact)
    with P.recording() as rec:
        out = codec.decompress(data)
    monkeypatch.undo()
    return out, rec, levels


def test_region_counters_equal_the_sizes_of_the_keys(codecs, data,
                                                     monkeypatch):
    _, rec, levels = decode_seen(codecs[1], data, monkeypatch)
    assert levels and len(levels) % 3 == 0
    (counts,) = rec.counts.values()
    for j, name in enumerate(COUNTERS):
        assert counts[name] == sum(lv[j] for lv in levels), name
    assert counts["gs.region.kept"] > 0
    assert counts["gs.region.covered"] > counts["gs.region.kept"]
    assert "gs.generated" not in counts


@pytest.mark.parametrize("factor,clips", [(0.5, True), (27.0, False)])
def test_dilate_factor_from_the_config_sets_the_clip(data, factor, clips,
                                                     monkeypatch):
    codec = make_codec(region_config(factor))
    assert codec.model.g_s.region_dilate_factor == factor
    _, rec, levels = decode_seen(codec, data, monkeypatch)
    (counts,) = rec.counts.values()
    assert (counts["gs.region.clipped"] > 0) == clips
    assert counts["gs.region.clipped"] == sum(lv[1] for lv in levels)
    assert counts["gs.region.dilated"] == sum(lv[0] for lv in levels)


def test_default_factor_clips_nothing_here(codecs, data):
    with P.recording() as rec:
        codecs[1].decompress(data)
    (counts,) = rec.counts.values()
    assert counts["gs.region.dilated"] > 0
    assert counts["gs.region.clipped"] == 0


def test_region_spans_once_a_level_under_the_synthesis(codecs, data):
    with P.recording() as rec:
        codecs[1].decompress(data)
    ids = {s.id: s for s in rec.spans}
    synth = [s for s in rec.spans if s.name == "dec.synthesis"]
    (root,) = [s for s in rec.spans if s.name == "codec.decompress"]
    assert synth
    for name in REGION:
        mine = [s for s in rec.spans if s.name == name]
        assert len(mine) == 3 * len(synth), name
        for s in mine:
            assert ids[s.parent].name == "dec.synthesis"
            assert s.unit == root.unit


def test_8child_decode_records_no_region_span_or_sync(codecs, frame,
                                                      monkeypatch):
    data = codecs[0].compress(frame, Q, block_size=64)

    def refuse(*a, **k):
        raise AssertionError("synchronized")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    with P.recording() as rec:
        codecs[0].decompress(data)
    names = {s.name for s in rec.spans}
    (counts,) = rec.counts.values()
    assert "dec.synthesis" in names and not names & set(REGION)
    assert not set(counts) & set(COUNTERS)


def test_sync_spans_synchronize_only_inside_a_profiled_stage(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: calls.append(dev))
    card = torch.device("cuda", 0)
    with P.synchronizing(card):
        with P.span("a", sync=True):  # not recording: nothing
            pass
        with P.recording():
            with P.span("b"):
                pass
            with P.span("c", sync=True):
                assert calls == [card]
        assert calls == [card, card]
        with P.synchronizing(torch.device("cpu")), P.recording():
            with P.span("d", sync=True):
                pass
    with P.recording():
        with P.span("e", sync=True):
            pass
    assert calls == [card, card]


def test_profiled_region_stage_hands_its_device_to_the_spans(
        codecs, data, monkeypatch):
    seen = []
    real = P.synchronizing

    def spy(device):
        seen.append(device)
        return real(device)

    monkeypatch.setattr(P, "synchronizing", spy)
    codec = codecs[1]
    codec.profile, codec.stage_times = True, {}
    try:
        with P.recording():
            codec.decompress(data)
    finally:
        codec.profile = False
    assert seen and set(seen) == {codec.device}
    seen.clear()
    with P.recording():
        codec.decompress(data)
    assert not seen


class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("n,cap_factor", [(300, 27), (300, 2), (5, 3)])
def test_dilation_is_one_pass_over_the_27_neighbours(n, cap_factor):
    """The dilation equals the 27 neighbour shifts deduplicated, clip
    included, in a number of operations that does not grow with the
    neighbours (on the card a shift a neighbour made the decode
    host-bound: some 1,900 launches a level)."""
    rng = np.random.default_rng(n)
    keys = []
    for b in range(2):
        u = rng.integers(0, 40, (n, 3))
        u[0] = 0  # the border of the coordinate range
        keys.append(np.unique(C.morton_encode_np(u))
                    | (np.int64(b) << C.BATCH_SHIFT))
    keys = torch.from_numpy(np.concatenate(
        keys + [np.full(17, C.SENTINEL, np.int64)]))
    cap = cap_factor * keys.shape[0]
    shifts = torch.stack([C.shift_units(keys, tuple(int(v) for v in d))[0]
                          for d in C.kernel_offsets(3)], 1).reshape(-1)
    ref, total = S._dedup_sorted(shifts, cap, total=True)
    with _CountOps() as ops:
        got, got_total = S.dilate_keys(keys, cap, total=True)
    assert torch.equal(got, ref) and int(got_total) == int(total)
    assert int(total) == dilated_count(keys.numpy())
    assert ops.n < 200
