"""Octree family (brick) convolutions — the port's sparse conv engine.

Children of one parent are packed into a dense [P, 8, C] brick; a
kernel-<=5 conv at the child level only touches children of the parent's
27 neighbours, so every conv is 27 brick-row gathers plus one
[8C_in, 8C_out] product per neighbour offset, with the kernel's taps laid
into the (slot_in, slot_out) structure.  The only integer search is the
27-neighbourhood map of the coarsest level; finer maps derive from it
through static tables.  At the decoder's finest level the same engine runs
on grandparent bricks ([G, 64, C]).

``tap_gemm`` — the gather-GEMM under every conv here — is kernel K1 on the
card (``csrc/tap_gemm.cu``) and ``tap_gemm_plain`` on the CPU.  Both take a
layer's weights prepared once (``prepare_taps`` -> ``ops/tapplan.py``); each
conv below accepts the raw [K^3, cin, cout] parameter or its TapPlan.

Training differentiates the convs through ``TapGemm`` (prepared per step by
``prepare_train_taps``): the input gradient is K1 again on the layer's
mirrored, transposed plan, the weight gradient kernel K1w ``tap_wgrad``
(``csrc/tap_wgrad.cu``), beside their plain versions ``tap_dgrad_plain``
and ``tap_wgrad_plain``.  Operand types on the card: flat and the weights
bf16, as in K1's forward; the output gradient rounded to bf16 as the
dgrad's A operand and the wgrad's B operand; f32 accumulation, dW in f32.
On the CPU every operand stays f32.
"""

import dataclasses
import functools

import numpy as np
import torch

from .. import kernels
from ..utils import profiling
from . import coords as C
from . import tapplan
from .scan import cumsum_i32
from .sparse import take_rows
from .topk import _buffer


def default_compute_dtype(device):
    """bf16 operands on the card (tensor cores, f32 accumulation); f32 on
    the CPU."""
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


def find(keys, queries):
    """(idx int32, found bool) of each query key in sorted ``keys``; idx is
    clipped to a valid gather index even when not found."""
    idx = torch.searchsorted(keys, queries.contiguous())
    idx = idx.clamp(max=keys.shape[0] - 1)
    found = (keys[idx] == queries) & C.key_is_valid(queries)
    return idx.to(torch.int32), found


_EPS_OFFSETS = np.stack(np.meshgrid(*([np.arange(-1, 2)] * 3), indexing="ij"),
                        axis=-1).reshape(-1, 3)  # [27, 3]


@dataclasses.dataclass
class FamilyMap:
    """Parent-space structure of a sorted point set.

    parent_keys: int64[P] sorted dedup'd parents (sentinel padded)
    point_parent: int32[N] index into parent_keys per point (P if clipped)
    point_slot:  int32[N] child slot (morton & 7) per point
    nbr_idx:     int32[P, 27] parent-neighbourhood indices into parent_keys
    nbr_ok:      bool[P, 27]
    contiguous:  points are the full child expansion in slot order (point i
                 is child i&7 of parent i>>3): brick packing is a reshape
    """

    parent_keys: torch.Tensor
    point_parent: torch.Tensor
    point_slot: torch.Tensor
    nbr_idx: torch.Tensor
    nbr_ok: torch.Tensor
    contiguous: bool = False

    @property
    def num_parents(self):
        return self.parent_keys.shape[0]


@functools.lru_cache(maxsize=None)
def _table(name, device, *args):
    """Static numpy tables as device tensors, built once per device."""
    if name == "eps":
        arr = _EPS_OFFSETS
    elif name == "ecode":
        arr = _ECODE
    elif name == "slot2":
        arr = _SLOT2
    elif name == "slot_tap":
        arr = _slot_tap_table(*args)
    elif name == "grand_tap":
        arr = _grand_tap_table(*args)
    elif name == "transpose_tap":
        arr = _transpose_tap_table()
    else:
        arr = _down_tap_table(*args)
    t = torch.as_tensor(np.ascontiguousarray(arr))
    return t.to(torch.int64 if name != "eps" else torch.int32).to(device)


def _neighbor_queries(parent_keys):
    """All 27 neighbour keys of every parent: [P, 27]."""
    b = parent_keys & ~C.KEY_MASK
    u = C.key_units(parent_keys)  # [P, 3]
    nu = u[:, None, :] + _table("eps", parent_keys.device)[None]  # [P, 27, 3]
    ok = (nu >= 0).all(-1) & (nu < (1 << C.COORD_BITS)).all(-1) \
        & C.key_is_valid(parent_keys)[:, None]
    nk = torch.where(ok, b[:, None] | C.morton_encode(nu.clamp(min=0)),
                     C.sentinel_like(parent_keys))
    return nk, ok


def _parent_neighbors(parent_keys):
    """27-neighbourhood map of a sorted parent key set (the only search)."""
    nk, _ = _neighbor_queries(parent_keys)
    idx, found = find(parent_keys, nk.reshape(-1))
    return idx.reshape(nk.shape), found.reshape(nk.shape)


def _derive_tables():
    """Static [8, 27] tables for neighbour-map derivation: for (slot, eps)
    the parent-level offset code and the target child slot."""
    ecode = np.zeros((8, 27), np.int32)
    slot2 = np.zeros((8, 27), np.int32)
    for s in range(8):
        sv = np.array([(s >> 2) & 1, (s >> 1) & 1, s & 1])
        for ei, e in enumerate(_EPS_OFFSETS):
            t = sv + e
            pe = np.floor_divide(t, 2)
            sl = t - 2 * pe
            ecode[s, ei] = (pe[0] + 1) * 9 + (pe[1] + 1) * 3 + (pe[2] + 1)
            slot2[s, ei] = (sl[0] << 2) | (sl[1] << 1) | sl[2]
    return ecode, slot2


_ECODE, _SLOT2 = _derive_tables()


def parents_of(keys, parent_cap):
    """(parent_keys, point_parent, point_slot) of a sorted key set."""
    dev = keys.device
    fm = build_family(keys, parent_cap=parent_cap,
                      nbr=(torch.zeros((parent_cap, 27), dtype=torch.int32,
                                       device=dev),
                           torch.zeros((parent_cap, 27), dtype=torch.bool,
                                       device=dev)))
    return fm.parent_keys, fm.point_parent, fm.point_slot


def member_brick(point_parent, point_slot, valid, p_cap, n_members):
    """[P+1, 8] int32: index of the member at (parent, slot), else
    n_members.  Invalid rows go to the dump row P."""
    n = point_parent.shape[0]
    dev = point_parent.device
    out = torch.full(((p_cap + 1) * 8,), n_members, dtype=torch.int32,
                     device=dev)
    row = torch.where(valid, point_parent.clamp(max=p_cap), p_cap)
    vals = torch.where(valid, torch.arange(n, dtype=torch.int32, device=dev),
                       n_members)
    out[row.to(torch.int64) * 8 + point_slot.to(torch.int64)] = vals
    return out.reshape(p_cap + 1, 8)


def derive_neighbors(q_parent, q_slot, q_valid, parent_nbr, target_brick,
                     n_targets):
    """27-neighbourhood of query nodes into a target set, derived from the
    shared parent level's self map.  Queries and targets both live one
    octree level below P; target membership is ``target_brick``
    (member_brick).  Returns (idx int32[N, 27], ok bool[N, 27])."""
    p_nbr_idx, p_nbr_ok = parent_nbr
    p_cap = p_nbr_idx.shape[0]
    dev = q_parent.device
    pp = q_parent.clamp(max=p_cap - 1).to(torch.int64)
    rows_idx = p_nbr_idx[pp]          # [N, 27]
    rows_ok = p_nbr_ok[pp]
    qs = q_slot.to(torch.int64)
    ecode = _table("ecode", dev)[qs]  # [N, 27] per-slot column permutation
    tgt_parent = torch.gather(rows_idx, 1, ecode)
    tgt_ok = torch.gather(rows_ok, 1, ecode)
    s2 = _table("slot2", dev)[qs]
    flat = target_brick.reshape(-1)
    idx = flat[tgt_parent.clamp(max=p_cap).to(torch.int64) * 8 + s2]
    ok = tgt_ok & (idx < n_targets) & q_valid[:, None] \
        & (q_parent < p_cap)[:, None]
    return idx.clamp(max=n_targets - 1), ok


def derive_self_neighbors(keys, point_parent, point_slot, parent_nbr):
    """Self 27-neighbourhood map of a set S ⊆ children(P), derived from P's
    own self map — no search."""
    n = keys.shape[0]
    valid = C.key_is_valid(keys)
    p_cap = parent_nbr[0].shape[0]
    sb = member_brick(point_parent, point_slot, valid, p_cap, n)
    return derive_neighbors(point_parent, point_slot, valid, parent_nbr, sb, n)


def pyramid(keys, caps, skip_finest_nbr=False, root_nbr=None):
    """Octree level pyramid with derived neighbour maps, finest first:
    [{keys, pp (parent link into the next level), sl, nbr (self map)}].
    root_nbr: optional host-computed (idx, ok) self map of the coarsest
    level (host_root_neighbors) replacing the device search."""
    levels = [{"keys": keys}]
    cur = keys
    for cap in caps:
        pk, pp, sl = parents_of(cur, cap)
        levels[-1]["pp"] = pp
        levels[-1]["sl"] = sl
        levels.append({"keys": pk})
        cur = pk
    levels[-1]["nbr"] = root_nbr if root_nbr is not None \
        else root_neighbors(levels[-1]["keys"])
    stop = 1 if skip_finest_nbr else 0
    for i in range(len(levels) - 2, stop - 1, -1):
        levels[i]["nbr"] = derive_self_neighbors(
            levels[i]["keys"], levels[i]["pp"], levels[i]["sl"],
            levels[i + 1]["nbr"])
    return levels


def root_neighbors(keys):
    """Self map by direct search — used once, at the coarsest level."""
    return _parent_neighbors(keys)


def _dedup_sorted(m):
    """np.unique of a non-decreasing array, without its sort."""
    keep = np.ones(len(m), bool)
    np.not_equal(m[1:], m[:-1], out=keep[1:])
    return np.compress(keep, m)


def host_levels(keys_np, level_caps):
    """Exact octree downsamples on the host (numpy): the input's valid keys,
    then the sorted unique keys of each coarser level, batch bits preserved,
    level ``i + 1`` cut to its first ``level_caps[i]`` keys (None: uncut)
    before the next level derives from it.  The shift map keeps a key
    array's order, so once the valid keys are sorted (voxelization leaves
    them so; other input is sorted once) each level is one pass of adjacent
    dedup."""
    m = np.asarray(keys_np)
    m = m[m != C.SENTINEL]
    out = [m]
    if not np.all(m[1:] >= m[:-1]):
        m = np.sort(m)
    for lc in level_caps:
        m = _dedup_sorted((m & ~C.KEY_MASK) | ((m & C.KEY_MASK) >> 3))[:lc]
        out.append(m)
    return out


# per axis (x, y, z): the key bits of its unit coordinate
_AXIS_BITS = [np.int64(sum(1 << (3 * i + s) for i in range(C.COORD_BITS)))
              for s in (2, 1, 0)]


def host_self_map(m, cap):
    """27-neighbourhood self map of one level's sorted valid keys ``m``,
    padded to ``cap``: each axis steps by one in Morton space (a dilated
    add and subtract on its bits), then one searchsorted.  Returns (keys,
    idx int32, found bool); idx is clipped to a row of ``m`` where not
    found."""
    sent = C.SENTINEL
    n = len(m)
    keys = np.full(cap, sent, np.int64)
    keys[:n] = m
    code = m & C.KEY_MASK
    nk = (m & ~C.KEY_MASK).reshape(n, 1, 1, 1)
    ok = np.ones((n, 1, 1, 1), bool)
    for axis, bits in enumerate(_AXIS_BITS):
        a = code & bits
        low = bits & -bits
        part = np.stack([(a - low) & bits, a, ((a | ~bits) + low) & bits], 1)
        valid = np.stack([a != 0, np.ones(n, bool), a != bits], 1)
        shape = [n, 1, 1, 1]
        shape[axis + 1] = 3
        nk = nk | part.reshape(shape)
        ok = ok & valid.reshape(shape)
    nk = np.where(ok, nk, sent).reshape(n, 27)   # _EPS_OFFSETS' order
    ii = np.minimum(np.searchsorted(m, nk.reshape(-1)), max(n - 1, 0)) \
        .astype(np.int32).reshape(nk.shape)
    ff = (m[ii] == nk) & (nk != sent) if n else np.zeros(nk.shape, bool)
    idx = np.zeros((cap, 27), np.int32)
    found = np.zeros((cap, 27), bool)
    idx[:n] = ii
    found[:n] = ff
    return keys, idx, found


def host_root_neighbors(keys_np, levels_down, cap, level_caps=None):
    """Host (numpy) twin of the pyramid root: downsample ``levels_down``
    octree levels (truncating at every level's cap exactly as the device
    pyramid does), pad to ``cap`` and build the 27-neighbourhood self map
    (``host_self_map``).  Returns (keys, idx int32, found bool)."""
    if level_caps is None:
        level_caps = [cap] * levels_down
    m = host_levels(keys_np, level_caps[:levels_down])[-1]
    return host_self_map(m[:cap], cap)


def transpose_cover_table():
    """Static bool [27, 8]: whether child slot s of an output parent at
    offset eps from an input parent receives any kernel-5 transpose tap
    (|slot - 2 eps| <= 2 per axis).  Region-candidate g_s marks with it
    which children of the dilated parent set the transpose reaches."""
    tab = np.zeros((27, 8), bool)
    for ei, e in enumerate(_EPS_OFFSETS):
        for s in range(8):
            sv = np.array([(s >> 2) & 1, (s >> 1) & 1, s & 1])
            if np.all(np.abs(sv - 2 * e) <= 2):
                tab[ei, s] = True
    return tab


def cross_neighbors(out_parent_keys, in_parent_keys):
    """27-neighbourhood map (idx int32, found bool) [P_out, 27] from output
    parents into a *different* sorted input parent set."""
    nk, _ = _neighbor_queries(out_parent_keys)
    idx, found = find(in_parent_keys, nk.reshape(-1))
    return idx.reshape(nk.shape), found.reshape(nk.shape)


def build_family(keys, parent_cap=None, parent_keys=None, nbr=None):
    """FamilyMap of a sorted key set.  Pass parent_keys (and optionally a
    precomputed (nbr_idx, nbr_ok)) to skip the dedup and/or the search."""
    dev = keys.device
    valid = C.key_is_valid(keys)
    morton = keys & C.KEY_MASK
    slot = torch.where(valid, morton & 7, 0).to(torch.int32)
    pkey = torch.where(valid, (keys & ~C.KEY_MASK) | (morton >> 3),
                       C.sentinel_like(keys))
    if parent_keys is None:
        parent_cap = parent_cap or keys.shape[0]
        pvalid = C.key_is_valid(pkey)
        new = torch.ones_like(pvalid)
        new[1:] = pkey[1:] != pkey[:-1]
        new = new & pvalid
        pidx = cumsum_i32(new) - 1
        pidx = torch.where(pvalid, pidx, parent_cap)
        # rows past the capacity and repeated parents land in dump row cap
        dest = torch.where(new, pidx, parent_cap).clamp(max=parent_cap)
        pk = torch.full((parent_cap + 1,), C.SENTINEL, dtype=torch.int64,
                        device=dev)
        pk[dest.to(torch.int64)] = pkey
        parent_keys = pk[:parent_cap]
        point_parent = pidx.clamp(max=parent_cap).to(torch.int32)
    else:
        i, f = find(parent_keys, pkey)
        point_parent = torch.where(f, i, parent_keys.shape[0]).to(torch.int32)
    if nbr is None:
        nbr_idx, nbr_ok = _parent_neighbors(parent_keys)
    else:
        nbr_idx, nbr_ok = nbr
    return FamilyMap(parent_keys=parent_keys, point_parent=point_parent,
                     point_slot=slot, nbr_idx=nbr_idx, nbr_ok=nbr_ok)


def child_family(parent_keys, nbr=None):
    """FamilyMap of the full child expansion of ``parent_keys`` (all 8
    slots of every parent, in order) — zero search, zero dedup."""
    p = parent_keys.shape[0]
    ar = torch.arange(8 * p, dtype=torch.int32, device=parent_keys.device)
    if nbr is None:
        nbr_idx, nbr_ok = _parent_neighbors(parent_keys)
    else:
        nbr_idx, nbr_ok = nbr
    return FamilyMap(parent_keys=parent_keys, point_parent=ar >> 3,
                     point_slot=ar & 7, nbr_idx=nbr_idx, nbr_ok=nbr_ok,
                     contiguous=True)


def to_brick(fm: FamilyMap, feats):
    """Pack point features into the dense [P+1, 8, C] brick (row P is the
    dump row for clipped parents) by an index scatter plus a row gather;
    a reshape for contiguous families."""
    p = fm.num_parents
    c = feats.shape[-1]
    if fm.contiguous:
        return torch.cat([feats.reshape(p, 8, c),
                          feats.new_zeros((1, 8, c))], dim=0)
    n = feats.shape[0]
    dev = feats.device
    idx = torch.full(((p + 1) * 8,), n, dtype=torch.int64, device=dev)
    idx[fm.point_parent.to(torch.int64) * 8 + fm.point_slot.to(torch.int64)] \
        = torch.arange(n, dtype=torch.int64, device=dev)
    fpad = torch.cat([feats, feats.new_zeros((1, c))], dim=0)
    return take_rows(fpad, idx).reshape(p + 1, 8, c)


def from_brick(fm: FamilyMap, brick, valid):
    """Read per-point rows back out of a brick tensor."""
    out = take_rows(brick.reshape(-1, brick.shape[-1]),
                    fm.point_parent.to(torch.int64) * 8 + fm.point_slot)
    return out * valid[:, None].to(out.dtype)


def _slot_tap_table(kernel_size):
    """Static [27, 8, 8] table: tap index into the K^3 kernel for
    (parent-offset eps, slot_in, slot_out), or -1 if the tap is outside the
    kernel.  delta = 2*eps + slot_in - slot_out per axis."""
    r = kernel_size // 2
    k = kernel_size
    tab = np.full((27, 8, 8), -1, np.int32)
    for ei, e in enumerate(_EPS_OFFSETS):
        for si in range(8):
            s_in = np.array([(si >> 2) & 1, (si >> 1) & 1, si & 1])
            for so in range(8):
                s_out = np.array([(so >> 2) & 1, (so >> 1) & 1, so & 1])
                d = 2 * e + s_in - s_out
                if np.all(np.abs(d) <= r):
                    di = (d[0] + r) * k * k + (d[1] + r) * k + (d[2] + r)
                    tab[ei, si, so] = di
    return tab


def _transpose_tap_table():
    """[27, 8]: kernel-5 generative transpose tap for (eps, child slot);
    delta = slot - 2*eps per axis, valid when |delta| <= 2."""
    tab = np.full((27, 8), -1, np.int32)
    for ei, e in enumerate(_EPS_OFFSETS):
        for s in range(8):
            sv = np.array([(s >> 2) & 1, (s >> 1) & 1, s & 1])
            d = sv - 2 * e
            if np.all(np.abs(d) <= 2):
                tab[ei, s] = (d[0] + 2) * 25 + (d[1] + 2) * 5 + (d[2] + 2)
    return tab


def _down_tap_table(kernel_size):
    """[27, 8]: stride-2 conv tap for (eps, child slot); delta = 2*eps + s."""
    r = kernel_size // 2
    k = kernel_size
    tab = np.full((27, 8), -1, np.int32)
    for ei, e in enumerate(_EPS_OFFSETS):
        for s in range(8):
            sv = np.array([(s >> 2) & 1, (s >> 1) & 1, s & 1])
            d = 2 * e + sv
            if np.all(np.abs(d) <= r):
                tab[ei, s] = (d[0] + r) * k * k + (d[1] + r) * k + (d[2] + r)
    return tab


class _GatherTaps(torch.autograd.Function):
    """``_gather_taps`` with its gradient as one product: dW = onehot(tab)
    @ g.  Autograd's own gradient of the index would add the repeats of
    each tap (up to thousands in the grandparent tables) one after
    another."""

    @staticmethod
    def forward(ctx, weights, tab):
        ctx.save_for_backward(tab)
        ctx.k = weights.shape[0]
        return _gather_taps(weights.detach(), tab)

    @staticmethod
    def backward(ctx, g):
        (tab,) = ctx.saved_tensors
        k = ctx.k
        cin, cout = g.shape[-2], g.shape[-1]
        onehot = torch.nn.functional.one_hot(
            torch.where(tab >= 0, tab, k).reshape(-1), k + 1).T.to(g.dtype)
        dw = onehot @ g.reshape(-1, cin * cout)
        return dw[:k].reshape(k, cin, cout), None


def _gather_taps(weights, tab):
    """weights [K^3, Cin, Cout] indexed by a tap table (-1 -> zeros)."""
    if torch.is_grad_enabled() and weights.requires_grad:
        return _GatherTaps.apply(weights, tab)
    cin, cout = weights.shape[1], weights.shape[2]
    wpad = torch.cat([weights, weights.new_zeros((1, cin, cout))], dim=0)
    return wpad[tab]  # index -1 reads the appended zero block


def _expanded_weights(weights, kernel_size):
    """weights [K^3, Cin, Cout] -> [27, 8*Cin, 8*Cout] slot-pair matrices."""
    w = _gather_taps(weights, _table("slot_tap", weights.device, kernel_size))
    cin, cout = weights.shape[1], weights.shape[2]
    return w.permute(0, 1, 3, 2, 4).reshape(27, 8 * cin, 8 * cout)


# -- K1: the tap gather-GEMM -------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tap_table_np(kind, kernel_size):
    """The static tap table of a call shape as [27, n_in, n_out]."""
    if kind == "conv":
        return _slot_tap_table(kernel_size)
    if kind == "down":
        return _down_tap_table(kernel_size)[:, :, None]
    if kind == "transpose":
        assert kernel_size == 5
        return _transpose_tap_table()[:, None, :]
    return _grand_tap_table(kernel_size, kind[len("grand_"):])


def _dense_taps(weights, kind, kernel_size):
    """weights [K^3, cin, cout] -> the dense [27, n_in*cin, n_out*cout]
    stack of a call shape (structural zeros filled in)."""
    cin, cout = weights.shape[1], weights.shape[2]
    dev = weights.device
    if kind == "conv":
        return _expanded_weights(weights, kernel_size)
    if kind == "down":
        wt = _gather_taps(weights, _table("down_tap", dev, kernel_size))
        return wt.reshape(27, 8 * cin, cout)
    if kind == "transpose":
        wt = _gather_taps(weights, _table("transpose_tap", dev))
        # [27, Cin, 8*Cout] with the output slot-major
        return wt.permute(0, 2, 1, 3).reshape(27, cin, 8 * cout)
    return grand_expand_weights(weights, kernel_size, kind[len("grand_"):],
                                weights.dtype)


def prepare_taps(weights, kind, kernel_size, compute_dtype=None):
    """Prepare a layer's parameter [K^3, cin, cout] for ``tap_gemm`` at one
    call shape (``kind``: "conv", "down", "transpose" or "grand_" + the
    ``grand_apply`` mode): operands rounded to the compute dtype, packed
    into the nonzero blocks the static table lists
    (``ops/tapplan.py``).  Done once per layer by ``Codec.update()``; the
    convs below also take the raw parameter and prepare it per call.  Each
    preparation adds 1 to the tracer's counter ``taps.prepared``, which a
    run that must not prepare weights per call (the codec after
    ``update()``) reads."""
    profiling.count("taps.prepared", 1)
    compute_dtype = compute_dtype or default_compute_dtype(weights.device)
    dense = _dense_taps(weights, kind, kernel_size).to(compute_dtype)
    return tapplan.plan_from_dense(
        dense, _tap_table_np(kind, kernel_size) >= 0, weights.shape[1],
        weights.shape[2])


def _as_plan(weights, kind, kernel_size, compute_dtype):
    if isinstance(weights, (tapplan.TapPlan, TrainTaps)):
        return weights
    return prepare_taps(weights, kind, kernel_size, compute_dtype)


def tap_gemm_plain(flat, nbr_idx, nbr_ok, wstack):
    """acc[r] = sum_k (flat[idx[r, k]] * ok[r, k]) @ wstack[k], in f32, taps
    summed in order.  flat [n_src, K_in]; wstack a dense [T, K_in, K_out]
    stack, or a TapPlan whose listed blocks are laid back into one."""
    if isinstance(wstack, tapplan.TapPlan):
        wstack = wstack.dense()
    n_src = flat.shape[0]
    rows, taps = nbr_idx.shape
    flat = flat.float()
    wstack = wstack.float()
    idx = nbr_idx.clamp(max=n_src - 1).to(torch.int64)
    acc = torch.zeros((rows, wstack.shape[-1]), dtype=torch.float32,
                      device=flat.device)
    for k in range(taps):
        nb = flat[idx[:, k]] * nbr_ok[:, k, None].to(torch.float32)
        acc = acc + nb @ wstack[k]
    return acc


def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def tap_gemm(flat, nbr_idx, nbr_ok, weights):
    """The gather-GEMM under every family conv (kernel K1 on the card).

    flat: [n_src, K_in]; nbr_idx int32 / nbr_ok bool [rows, T] (indices are
    clipped to n_src-1); weights: a TapPlan (``prepare_taps``); on CPU
    tensors also a dense [T, K_in, K_out] stack.  Returns f32
    [rows, K_out].  On CUDA tensors flat and the weights must be bf16, K_in
    and K_out multiples of 8."""
    if not flat.is_cuda:
        return tap_gemm_plain(flat, nbr_idx, nbr_ok, weights)
    plan = weights
    if not isinstance(plan, tapplan.TapPlan):
        raise TypeError("tap_gemm: on the card the weights must be prepared "
                        "(prepare_taps)")
    rows, taps = nbr_idx.shape
    n_src, k_in = flat.shape
    k_out = plan.k_out
    kernels.require_cuda(flat, torch.bfloat16, 2, "tap_gemm flat")
    kernels.require_cuda(plan.wpack, torch.bfloat16, 3, "tap_gemm weights")
    kernels.require_cuda(nbr_idx, torch.int32, 2, "tap_gemm idx")
    kernels.require_cuda(nbr_ok, torch.bool, 2, "tap_gemm ok")
    if ((plan.taps, plan.k_in) != (taps, k_in) or taps > 32
            or nbr_ok.shape != (rows, taps) or plan.bk != tapplan.TAP_BK
            or k_in % 8 or k_out % 8 or not 1 <= n_src < 2 ** 31):
        raise ValueError(f"tap_gemm: bad shapes flat {tuple(flat.shape)}, "
                         f"w {(plan.taps, plan.k_in, k_out)}, "
                         f"idx {tuple(nbr_idx.shape)}")
    out = torch.empty((rows, k_out), dtype=torch.float32, device=flat.device)
    if rows == 0:
        return out
    # 128-row tiles when they fill the card twice over, else 64-row tiles
    # (the row tile never changes an output value, see ops/tapplan.py)
    wgs = 2 if -(-rows // 128) * plan.n_col >= 2 * _sm_count(flat.device) \
        else 1
    kernels.count_launch("tap_gemm", flat, nbr_idx, nbr_ok, plan)
    kernels.check(kernels.lib("tap_gemm").upcc_tap_gemm(
        flat.data_ptr(), n_src, k_in, nbr_idx.data_ptr(), nbr_ok.data_ptr(),
        rows, taps, plan.wpack.data_ptr(), k_out, plan.tap_ptr.data_ptr(),
        plan.k0.data_ptr(), plan.bn, wgs, out.data_ptr(),
        kernels.stream_ptr(flat)), "tap_gemm")
    return out


# -- K1's backward ----------------------------------------------------------
#
# Training differentiates every conv through ``TapGemm``, which saves only
# ``flat``, the map and the prepared weights, never the 27 gathered blocks
# (the role of the JAX package's ``conv_remat``).
#
# dgrad: dflat[s] = sum over (r, k) with idx[r, k] = s, ok[r, k] of
#   dacc[r] @ W[k]^T.  On a self map of one key set (rows and sources are
#   the same set; ``_EPS_OFFSETS`` is lexicographic over {-1, 0, 1}^3, so
#   offset 26-k is minus offset k) ok[r, k] implies idx[idx[r, k], 26-k] =
#   r, and the sum is K1 itself on the same map with the mirrored,
#   transposed stack W_T[k] = W[26-k]^T (``tapplan.transposed_plan``).  A
#   cross map (rows of another set, the flagship's h_s head) first gets its
#   transposed map by one scatter (``transposed_map``; exact because a
#   neighbour map sends distinct rows of one tap to distinct sources).
# wgrad: dW[k] = sum_r ok[r, k] flat[idx[r, k]]^T @ dacc[r], only for the
#   blocks the plan lists: kernel K1w ``tap_wgrad`` (``csrc/tap_wgrad.cu``).
#
# Operand types on the card: flat and the weights are bf16 as in K1's
# forward; dacc is rounded to bf16 as the dgrad's A operand and as the
# wgrad's B operand; both accumulate in f32, and dW is f32.  On the CPU
# every operand stays f32.

def tap_dgrad_plain(dacc, nbr_idx, nbr_ok, wstack, n_src):
    """dflat [n_src, K_in] f32 of ``tap_gemm``: for every tap,
    dflat[idx[r, k]] += ok[r, k] * dacc[r] @ W[k]^T (a scatter-add over
    any map).  wstack: a dense [T, K_in, K_out] stack or a TapPlan."""
    if isinstance(wstack, tapplan.TapPlan):
        wstack = wstack.dense()
    wstack = wstack.float()
    dacc = dacc.float()
    idx = nbr_idx.clamp(max=n_src - 1).to(torch.int64)
    out = torch.zeros((n_src, wstack.shape[1]), dtype=torch.float32,
                      device=dacc.device)
    for k in range(nbr_idx.shape[1]):
        g = dacc * nbr_ok[:, k, None].to(torch.float32)
        out.index_add_(0, idx[:, k], g @ wstack[k].T)
    return out


def tap_wgrad_plain(flat, nbr_idx, nbr_ok, dacc):
    """dW [T, K_in, K_out] f32 of ``tap_gemm``: dW[k] = sum_r ok[r, k] *
    flat[idx[r, k]]^T @ dacc[r], every block."""
    n_src = flat.shape[0]
    flat = flat.float()
    dacc = dacc.float()
    idx = nbr_idx.clamp(max=n_src - 1).to(torch.int64)
    return torch.stack([
        (flat[idx[:, k]] * nbr_ok[:, k, None].to(torch.float32)).T @ dacc
        for k in range(nbr_idx.shape[1])])


# K1w's grid is (wgrad tiles) x (row splits): each split covers a fixed
# range of its tap's row list, a multiple of WGRAD_ROWS entries (whole
# stages of the kernel), and the last split of a tile to finish adds the
# splits' partial sums in split order (no float atomics: equal inputs give
# equal bits).  The split count comes from rows alone, never from the
# device.
WGRAD_ROWS = 64
WGRAD_MIN_CHUNK = 1024  # rows a split at least covers
WGRAD_PER_SM = 8        # thread blocks an SM the grid aims at


def wgrad_splits(rows, n_tiles, sms, per_sm=WGRAD_PER_SM,
                 min_chunk=WGRAD_MIN_CHUNK):
    """(chunk, splits) of a K1w call: split s covers list entries
    [s * chunk, min((s + 1) * chunk, rows)); at most ``per_sm`` thread
    blocks an SM over the (tile, split) grid and splits of at least
    ``min_chunk`` rows (a call whose tiles alone fill the card has one)."""
    want = max(1, min(per_sm * sms // max(n_tiles, 1), rows // min_chunk))
    chunk = -(-max(rows, 1) // want)
    chunk = -(-chunk // WGRAD_ROWS) * WGRAD_ROWS
    return chunk, max(1, -(-rows // chunk))


def wgrad_row_lists(nbr_ok):
    """K1w's per-tap row lists, on the device and without a host sync:
    (lists int32 [T * rows + 1], ends int64 [T * rows]), tap-major.  ends
    is the running count of ok^T flattened, so tap t's count is
    ends[(t + 1) rows - 1] - ends[t rows - 1] (the second term 0 for t =
    0); its rows with ok[r, t], ascending, are lists[1 + ends[t rows - 1] +
    i] - t rows for i < count (entry 0 takes the writes of the rows the tap
    misses).  Built once per map: kept on ``nbr_ok`` with its version, so
    the layers of a step that share a map share the lists."""
    hit = getattr(nbr_ok, "_wgrad_row_lists", None)
    if hit is not None and hit[0] == nbr_ok._version:
        return hit[1], hit[2]
    rows, taps = nbr_ok.shape
    ok_t = nbr_ok.t().reshape(-1)
    ends = torch.cumsum(ok_t, 0)
    lists = torch.empty(taps * rows + 1, dtype=torch.int32,
                        device=nbr_ok.device)
    lists.scatter_(0, ends * ok_t, _arange(taps * rows, nbr_ok.device))
    nbr_ok._wgrad_row_lists = (nbr_ok._version, lists, ends)
    return lists, ends


_aranges = {}


def _arange(n, device):
    """int32 [0, n) on ``device``, a view of one kept buffer."""
    buf = _aranges.get(device)
    if buf is None or buf.numel() < n:
        buf = _aranges[device] = torch.arange(
            max(n, 1 << 20), dtype=torch.int32, device=device)
    return buf[:n]


# K1w's per-tile tickets per (device, stream): zero on entry, and the
# kernel leaves them zero
_tickets = {}


def tap_wgrad(flat, nbr_idx, nbr_ok, dacc, plan):
    """The listed blocks of dW, f32 [n_blocks, bk, bn] (K by N, the plan's
    list order): kernel K1w on the card, ``tap_wgrad_plain`` on the CPU.
    On CUDA tensors flat and dacc must be bf16.  The kernel walks each
    tap's row list (``wgrad_row_lists``) in tiles of up to two column
    blocks of one (tap, K block) pair (one where the plan has a single
    column block), split by ``wgrad_splits``."""
    if not flat.is_cuda:
        return plan.blocks_of(tap_wgrad_plain(flat, nbr_idx, nbr_ok, dacc))
    rows, taps = nbr_idx.shape
    n_src, k_in = flat.shape
    kernels.require_cuda(flat, torch.bfloat16, 2, "tap_wgrad flat")
    kernels.require_cuda(dacc, torch.bfloat16, 2, "tap_wgrad dacc")
    kernels.require_cuda(nbr_idx, torch.int32, 2, "tap_wgrad idx")
    kernels.require_cuda(nbr_ok, torch.bool, 2, "tap_wgrad ok")
    if ((plan.taps, plan.k_in, plan.k_out) != (taps, k_in, dacc.shape[1])
            or dacc.shape[0] != rows or nbr_ok.shape != (rows, taps)
            or plan.bk != tapplan.TAP_BK or plan.bn not in (32, 64, 128)
            or k_in % 8 or plan.k_out % 8 or not 1 <= n_src < 2 ** 31
            or rows >= 2 ** 31 - 1):
        raise ValueError(f"tap_wgrad: bad shapes flat {tuple(flat.shape)}, "
                         f"dacc {tuple(dacc.shape)}, idx "
                         f"{tuple(nbr_idx.shape)}, plan "
                         f"{(plan.taps, plan.k_in, plan.k_out, plan.bn)}")
    nb = plan.n_blocks
    dev = flat.device
    out = torch.empty((nb, plan.bk, plan.bn), dtype=torch.float32,
                      device=dev)
    if nb == 0:
        return out
    if rows == 0:
        return out.zero_()
    pairs = plan.n_col > 1  # one column block: nothing to pair
    tiles = plan.wgrad_tiles(pairs)
    n_tiles = tiles.shape[0]
    chunk, splits = wgrad_splits(rows, n_tiles, _sm_count(dev))
    lists, ends = wgrad_row_lists(nbr_ok)
    stream = kernels.stream_ptr(flat)
    part = tickets = None
    if splits > 1:
        part = torch.empty((splits, nb, plan.bk, plan.bn),
                           dtype=torch.float32, device=dev)
        tickets = _buffer(_tickets, (dev.index, stream), n_tiles, dev)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    kernels.count_launch("tap_wgrad", flat, nbr_idx, nbr_ok, dacc, plan)
    kernels.check(kernels.lib("tap_wgrad").upcc_tap_wgrad(
        flat.data_ptr(), n_src, k_in, nbr_idx.data_ptr(), rows, taps,
        dacc.data_ptr(), plan.k_out, tiles.data_ptr(), n_tiles, int(pairs),
        lists.data_ptr(), ends.data_ptr(), nb, plan.bn, chunk, splits,
        ptr(part), ptr(tickets), out.data_ptr(), stream), "tap_wgrad")
    return out


def transposed_map(nbr_idx, nbr_ok, n_src):
    """The map (idx int32, ok bool) [n_src, T] under which K1 with the
    mirrored stack computes the dgrad of a *cross* map: source s, tap
    T-1-k reads the row r with idx[r, k] = s.  One scatter; requires that
    no two rows of a tap reach the same source (true of neighbour maps)."""
    rows, taps = nbr_idx.shape
    dev = nbr_idx.device
    mirror = torch.arange(taps - 1, -1, -1, dtype=torch.int64, device=dev)
    dest = nbr_idx.to(torch.int64) * taps + mirror[None, :]
    dest = torch.where(nbr_ok, dest, n_src * taps).reshape(-1)
    row = torch.arange(rows, dtype=torch.int32, device=dev)[:, None] \
        .expand(rows, taps).reshape(-1)
    idx = torch.zeros(n_src * taps + 1, dtype=torch.int32, device=dev)
    ok = torch.zeros(n_src * taps + 1, dtype=torch.bool, device=dev)
    idx[dest] = row
    ok[dest] = True  # the dump slot n_src * taps is cut off below
    return (idx[:-1].reshape(n_src, taps).contiguous(),
            ok[:-1].reshape(n_src, taps).contiguous())


@dataclasses.dataclass
class TrainTaps:
    """A layer's weights prepared for one training step: ``dense`` the
    [T, K_in, K_out] f32 stack attached to the parameter (autograd carries
    dW back through ``_dense_taps``), ``plan`` the forward operands, and the
    mirrored plan of the dgrad, built at first use in the backward."""

    dense: torch.Tensor
    plan: tapplan.TapPlan
    struct: np.ndarray
    cin: int
    cout: int
    compute_dtype: torch.dtype
    _plan_t: tapplan.TapPlan = None

    @property
    def k_out(self):
        return self.plan.k_out

    def plan_t(self):
        if self._plan_t is None:
            profiling.count("taps.prepared", 1)
            self._plan_t = tapplan.transposed_plan(
                self.dense.detach().to(self.compute_dtype), self.struct,
                self.cin, self.cout)
            self._plan_t.mirror_of = self.plan
        return self._plan_t


def prepare_train_taps(weights, kind, kernel_size, compute_dtype=None):
    """``prepare_taps`` for a training step: the same plan, plus the dense
    stack kept attached to ``weights`` (once per layer and step)."""
    profiling.count("taps.prepared", 1)
    compute_dtype = compute_dtype or default_compute_dtype(weights.device)
    dense = _dense_taps(weights, kind, kernel_size).float()
    struct = _tap_table_np(kind, kernel_size) >= 0
    plan = tapplan.plan_from_dense(dense.detach().to(compute_dtype), struct,
                                   weights.shape[1], weights.shape[2])
    return TrainTaps(dense, plan, struct, weights.shape[1], weights.shape[2],
                     compute_dtype)


class TapGemm(torch.autograd.Function):
    """``tap_gemm`` with K1's backward: dgrad by K1 on the mirrored plan,
    wgrad by K1w, laid back into the dense stack."""

    @staticmethod
    def forward(ctx, flat, dense, nbr_idx, nbr_ok, taps, self_map):
        # ``dense`` (taps.dense) is an input only so that autograd hands
        # its gradient on to the layer's parameter; the product reads the
        # prepared plan
        ctx.save_for_backward(flat, nbr_idx, nbr_ok)
        ctx.taps, ctx.self_map = taps, self_map
        return tap_gemm(flat, nbr_idx, nbr_ok, taps.plan)

    @staticmethod
    def backward(ctx, dacc):
        flat, nbr_idx, nbr_ok = ctx.saved_tensors
        taps = ctx.taps
        g = dacc.to(flat.dtype).contiguous()
        dflat = ddense = None
        if ctx.needs_input_grad[0]:
            idx, ok = (nbr_idx, nbr_ok) if ctx.self_map else \
                transposed_map(nbr_idx, nbr_ok, flat.shape[0])
            dflat = tap_gemm(g, idx, ok, taps.plan_t()).to(flat.dtype)
        if ctx.needs_input_grad[1]:
            ddense = taps.plan.lay(tap_wgrad(flat, nbr_idx, nbr_ok, g,
                                             taps.plan))
        return dflat, ddense, None, None, None, None


def _gemm(flat, nbr_idx, nbr_ok, weights, self_map=True):
    """K1 under a conv: through ``TapGemm`` when the weights are prepared
    for training and gradients are on, else ``tap_gemm``."""
    if isinstance(weights, TrainTaps):
        if torch.is_grad_enabled():
            return TapGemm.apply(flat, weights.dense, nbr_idx, nbr_ok,
                                 weights, self_map)
        weights = weights.plan
    return tap_gemm(flat, nbr_idx, nbr_ok, weights)


# -- convs over bricks -------------------------------------------------------


def family_conv(fm_in: FamilyMap, in_feats, in_valid, weights, kernel_size,
                out_fm: FamilyMap = None, out_keys_valid=None,
                nbr_cross=None, compute_dtype=None):
    """Sparse conv (stride 1, odd kernel <= 5) over bricks.

    out_fm: FamilyMap of the output set (None: the input set).  nbr_cross:
    optional (idx, ok) mapping output parents into input parents.  Returns
    per-point output features (f32) aligned with the output set."""
    compute_dtype = compute_dtype or default_compute_dtype(in_feats.device)
    if out_fm is None:
        out_fm = fm_in
    nbr_idx, nbr_ok = (fm_in.nbr_idx, fm_in.nbr_ok) if nbr_cross is None \
        else nbr_cross
    brick = to_brick(fm_in, in_feats * in_valid[:, None].to(in_feats.dtype))
    p_in = fm_in.num_parents
    p_out = nbr_idx.shape[0]
    cin = in_feats.shape[-1]
    plan = _as_plan(weights, "conv", kernel_size, compute_dtype)
    cout = plan.k_out // 8
    flat = brick[:p_in].reshape(p_in, 8 * cin).to(compute_dtype)
    acc = _gemm(flat, nbr_idx, nbr_ok, plan, self_map=nbr_cross is None)
    if out_fm.contiguous and out_fm.num_parents == p_out:
        out = acc.reshape(p_out * 8, cout)
    else:
        out_brick = torch.cat([acc.reshape(p_out, 8, cout),
                               acc.new_zeros((1, 8, cout))], dim=0)
        out = take_rows(out_brick.reshape(-1, cout),
                        out_fm.point_parent.clamp(max=p_out).to(torch.int64)
                        * 8 + out_fm.point_slot)
    if out_keys_valid is not None:
        out = out * out_keys_valid[:, None].to(out.dtype)
    return out


def family_transpose_up(fm_parent_nbr, in_feats, in_valid, weights,
                        kernel_size, compute_dtype=None, self_map=True):
    """Generative transposed conv stride 2 (kernel 2 or 5) onto the full
    child expansion of the map's rows (the input set for a self map).
    Returns f32 child features [8*rows, Cout] aligned with
    upsample_children_keys(row keys)."""
    compute_dtype = compute_dtype or default_compute_dtype(in_feats.device)
    n = in_feats.shape[0]
    x = (in_feats * in_valid[:, None].to(in_feats.dtype)).to(compute_dtype)
    if kernel_size == 2:
        cout = weights.shape[-1]
        # out[8u + s] = in[u] @ W[s]: one product, zero gathers; operands
        # rounded to the compute dtype, accumulated in f32
        w = weights.to(compute_dtype).float()
        out = torch.einsum("nc,scd->nsd", x.float(), w)
        return out.reshape(8 * n, cout)
    assert kernel_size == 5
    nbr_idx, nbr_ok = fm_parent_nbr
    plan = _as_plan(weights, "transpose", kernel_size, compute_dtype)
    n_out = nbr_idx.shape[0]
    acc = _gemm(x, nbr_idx, nbr_ok, plan, self_map)
    return acc.reshape(8 * n_out, plan.k_out // 8)


# -- grandparent-brick ("grand") kernels -------------------------------------
#
# At the decoder's finest level the candidate set is millions of rows while
# its grandparent set G (two octree levels up) is ~64x smaller.  Folding both
# child levels into the brick ([G, 64, C]) makes convs gather 27 G-rows;
# the slot-pair tap matrices get denser-looking but mostly zero, which K1
# skips block by block.

_GRAND_SLOTS = {"conv": (64, 64), "transpose": (8, 64), "down": (64, 8)}


def _grand_axes(v, n):
    """Per-axis position of slot v within its grandparent (n=64) or parent
    (n=8) cell, following the (x<<2 | y<<1 | z) slot bit convention."""
    if n == 64:
        hi, lo = v >> 3, v & 7
        return np.array([2 * ((hi >> 2) & 1) + ((lo >> 2) & 1),
                         2 * ((hi >> 1) & 1) + ((lo >> 1) & 1),
                         2 * (hi & 1) + (lo & 1)])
    return np.array([(v >> 2) & 1, (v >> 1) & 1, v & 1])


def _grand_tap_table(kernel_size, mode):
    """Static [27, n_in, n_out] tap index into the K^3 kernel for
    (G-offset eps, slot_in, slot_out), -1 outside the kernel:
      conv:      delta = 4e + v_in - v_out
      transpose: delta = v_out - 2*v_in - 4e
      down:      delta = 4e + v_in - 2*v_out"""
    r = kernel_size // 2
    k = kernel_size
    n_in, n_out = _GRAND_SLOTS[mode]
    tab = np.full((27, n_in, n_out), -1, np.int32)
    for ei, e in enumerate(_EPS_OFFSETS):
        for si in range(n_in):
            vi = _grand_axes(si, n_in)
            for so in range(n_out):
                vo = _grand_axes(so, n_out)
                if mode == "conv":
                    d = 4 * e + vi - vo
                elif mode == "transpose":
                    d = vo - 2 * vi - 4 * e
                else:
                    d = 4 * e + vi - 2 * vo
                if np.all(np.abs(d) <= r):
                    tab[ei, si, so] = (d[0] + r) * k * k + (d[1] + r) * k \
                        + (d[2] + r)
    return tab


def grand_expand_weights(weights, kernel_size, mode, compute_dtype):
    """weights [K^3, cin, cout] -> [27, n_in*cin, n_out*cout]."""
    tab = _table("grand_tap", weights.device, kernel_size, mode)
    n_in, n_out = tab.shape[1], tab.shape[2]
    cin, cout = weights.shape[1], weights.shape[2]
    w = _gather_taps(weights, tab)  # [27, n_in, n_out, cin, cout]
    return w.permute(0, 1, 3, 2, 4).reshape(
        27, n_in * cin, n_out * cout).to(compute_dtype)


def grand_apply(g_nbr, in_brick, weights, kernel_size, mode,
                compute_dtype=None):
    """Conv/transpose/down-conv in grandparent-brick layout.

    g_nbr: (idx, ok) self map of the G key set; in_brick: [G, n_in, cin]
    with zeros at invalid slots.  Returns [G, n_out, cout] f32."""
    compute_dtype = compute_dtype or default_compute_dtype(in_brick.device)
    nbr_idx, nbr_ok = g_nbr
    g = nbr_idx.shape[0]
    n_in, n_out = _GRAND_SLOTS[mode]
    cin = in_brick.shape[-1]
    plan = _as_plan(weights, "grand_" + mode, kernel_size, compute_dtype)
    flat = in_brick.reshape(in_brick.shape[0], n_in * cin)[:g] \
        .to(compute_dtype).contiguous()
    acc = _gemm(flat, nbr_idx, nbr_ok, plan)
    return acc.reshape(g, n_out, plan.k_out // n_out)


def family_down_conv(fm_in: FamilyMap, in_feats, in_valid, weights,
                     kernel_size, compute_dtype=None):
    """Strided (stride 2) conv; output set = fm_in.parent_keys.
    out[p] = sum_delta in[2p + delta] W[delta] — one brick pass."""
    compute_dtype = compute_dtype or default_compute_dtype(in_feats.device)
    brick = to_brick(fm_in, in_feats * in_valid[:, None].to(in_feats.dtype))
    p = fm_in.num_parents
    cin = in_feats.shape[-1]
    plan = _as_plan(weights, "down", kernel_size, compute_dtype)
    flat = brick[:p].reshape(p, 8 * cin).to(compute_dtype)
    acc = _gemm(flat, fm_in.nbr_idx, fm_in.nbr_ok, plan)
    return acc * C.key_is_valid(fm_in.parent_keys)[:, None].to(acc.dtype)
