"""Prepared tap weights: the operand layout and block list of kernel K1.

Every learned conv of the codec is ``tap_gemm``: 27 gathered row tiles times
27 weight matrices ``W[k]`` of shape [K_in, K_out] = [n_in * cin,
n_out * cout], where (tap, slot_in, slot_out) selects one [cin, cout]
matrix of the layer's [K^3, cin, cout] parameter or a structural zero (the
static tables ``slot_tap``, ``down_tap``, ``transpose_tap``, ``grand_tap``
hold -1 there).  Most slot pairs are structural zeros: 7/8 of a kernel-3
child conv, over 98% of a grandparent-layout conv.

A ``TapPlan`` is that stack prepared once per layer for the kernel:

* ``wpack`` [n_blocks, BN, BK]: only the structurally nonzero
  [BK x BN] blocks of the stack, each stored K-major (row = output column,
  K contiguous: the B operand layout of the tensor-core mainloop), zero
  padded at the K and N edges;
* the block list in CSR form per column block: ``blk_ptr`` [n_col + 1],
  ``blk_tap`` / ``blk_k0`` [n_blocks], **tap-major then K-major** inside a
  column block, which is the plain version's summation order among the
  nonzero products; ``tap_ptr`` [n_col, T + 1] is the same list indexed by
  (column block, tap) for the kernel, which skips whole taps no row of its
  tile reads.

The list comes from the tables, never from the weight values, so it does
not change with training.  The kernel walks it: there is no dense mask and
no per-call scan.

Tile rule.  BK is one 128-byte shared-memory row: 64 bf16 (32 for the f32
probe variant).  BN = min(128, K_out rounded up to 32), whatever the slot
width: a 128-wide block that spans several output slots (cout = 64, 32, 16,
1) or straddles slot edges (cout = 192) lists the union of their taps, so it
multiplies some structural zeros, but it runs the tensor cores at 1.5 to 3
times the rate of slot-aligned 64- or 32-wide blocks and gathers each A tile
for fewer column blocks.  Measured on an NVIDIA H100 80GB HBM3 (700 W) at
the flagship's shapes, the wide blocks won at every shape with 8192 rows or
more (PERF.md, Findings).

Neither BN nor the row tile changes the value of an output element: its
f32 sum runs over the same nonzero products in the same order (tap, then K
in steps of 16), and the extra products of a union block are exact zeros.
"""

import dataclasses
import functools

import numpy as np
import torch

TAP_BK = 64  # elements of one K block for 2-byte operands


def choose_bn(k_out):
    """Column-block width of a stack with K_out columns."""
    return min(128, -(-k_out // 32) * 32)


def block_list(struct, cin, cout, bn, bk):
    """Nonzero [bk x bn] blocks of a stack with slot structure ``struct``
    (bool [T, n_in, n_out]: slot pair present) and slot widths cin, cout.
    Returns int32 arrays (blk_ptr [n_col + 1], blk_tap, blk_k0), ordered by
    column block, then tap, then K."""
    struct = np.asarray(struct, bool)
    taps, n_in, n_out = struct.shape
    k_in, k_out = n_in * cin, n_out * cout
    nkb, ncol = -(-k_in // bk), -(-k_out // bn)
    nz = np.zeros((ncol, taps, nkb), bool)
    for kb in range(nkb):
        si0, si1 = kb * bk // cin, (min((kb + 1) * bk, k_in) - 1) // cin
        rows = struct[:, si0:si1 + 1].any(1)  # [T, n_out]
        for col in range(ncol):
            so0 = col * bn // cout
            so1 = (min((col + 1) * bn, k_out) - 1) // cout
            nz[col, :, kb] = rows[:, so0:so1 + 1].any(1)
    col, tap, kb = np.nonzero(nz)  # lexicographic: col, tap, kb
    ptr = np.zeros(ncol + 1, np.int64)
    np.cumsum(np.bincount(col, minlength=ncol), out=ptr[1:])
    return (ptr.astype(np.int32), tap.astype(np.int32),
            (kb * bk).astype(np.int32))


def wgrad_tile_list(blk_ptr, blk_tap, blk_k0, pairs=True):
    """The work list of kernel K1w (the weight gradient of K1) for a block
    list: int32 [n_tiles, 8] rows (tap, first K, blocks, column 0, list
    position 0, column 1, list position 1, 0), ordered by tap, then K, then
    column.  A tile is one (tap, K block) pair and up to two of its listed
    column blocks (one with ``pairs`` False); a pair with an odd number of
    column blocks ends in a single-column tile.  Unused fields are -1."""
    col = np.repeat(np.arange(len(blk_ptr) - 1), np.diff(blk_ptr))
    order = np.lexsort((col, blk_k0, blk_tap))
    tap, k0, col = blk_tap[order], blk_k0[order], col[order]
    n = len(order)
    new = np.ones(n, bool)
    new[1:] = (tap[1:] != tap[:-1]) | (k0[1:] != k0[:-1])
    rank = np.arange(n) - np.maximum.accumulate(np.where(new, np.arange(n),
                                                         0))
    first = np.nonzero(rank % (2 if pairs else 1) == 0)[0]
    nxt = np.minimum(first + 1, max(n - 1, 0))
    two = bool(pairs) & (first + 1 < n) & ~new[nxt]
    tiles = np.full((len(first), 8), -1, np.int32)
    tiles[:, 0], tiles[:, 1] = tap[first], k0[first]
    tiles[:, 2] = 1 + two
    tiles[:, 3], tiles[:, 4] = col[first], order[first]
    tiles[two, 5], tiles[two, 6] = col[nxt[two]], order[nxt[two]]
    tiles[:, 7] = 0
    return tiles


@dataclasses.dataclass
class TapPlan:
    """One layer's prepared tap weights (see the module docstring)."""

    k_in: int
    k_out: int
    taps: int
    bn: int
    bk: int
    blk_ptr: np.ndarray   # int32 [n_col + 1]
    blk_tap: np.ndarray   # int32 [n_blocks]
    blk_k0: np.ndarray    # int32 [n_blocks]
    wpack: torch.Tensor   # [n_blocks, bn, bk], the compute dtype
    tap_ptr: torch.Tensor  # int32 [n_col, taps + 1], on wpack's device
    k0: torch.Tensor       # int32 [n_blocks], on wpack's device
    # set on a transposed plan: the forward plan it mirrors
    mirror_of: "TapPlan" = dataclasses.field(default=None, repr=False)

    @property
    def n_col(self):
        return len(self.blk_ptr) - 1

    @property
    def n_blocks(self):
        return len(self.blk_tap)

    @property
    def nbytes(self):
        return sum(t.numel() * t.element_size()
                   for t in (self.wpack, self.tap_ptr, self.k0))

    def _index(self):
        dev = self.wpack.device
        col = np.repeat(np.arange(self.n_col), np.diff(self.blk_ptr))
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        return as_t(self.blk_tap), as_t(self.blk_k0 // self.bk), as_t(col)

    def dense(self):
        """The [T, K_in, K_out] stack rebuilt from the listed blocks (every
        unlisted block is zero)."""
        return self.lay(self.wpack.transpose(1, 2))

    def lay(self, blocks):
        """A dense [T, K_in, K_out] stack holding ``blocks`` [n_blocks, bk,
        bn] (K by N, in list order) at the listed places, zero elsewhere;
        the parts of edge blocks beyond K_in or K_out are dropped."""
        nkb, ncol = -(-self.k_in // self.bk), self.n_col
        out = blocks.new_zeros((self.taps, nkb, self.bk, ncol, self.bn))
        tap, kb, col = self._index()
        out[tap, kb, :, col, :] = blocks
        return out.reshape(self.taps, nkb * self.bk, ncol * self.bn)[
            :, :self.k_in, :self.k_out]

    def blocks_of(self, stack):
        """The listed [bk, bn] blocks (K by N) of a dense [T, K_in, K_out]
        stack, zero padded at the K and N edges: [n_blocks, bk, bn]."""
        nkb, ncol = -(-self.k_in // self.bk), self.n_col
        wp = torch.nn.functional.pad(
            stack, (0, ncol * self.bn - self.k_out, 0, nkb * self.bk
                    - self.k_in)).reshape(self.taps, nkb, self.bk, ncol,
                                          self.bn)
        tap, kb, col = self._index()
        return wp[tap, kb, :, col, :]

    def wgrad_tiles(self, pairs=True):
        """``wgrad_tile_list`` of this plan on its device.  Cached by the
        block list, which ``_block_list_of`` hands to every plan of one
        slot structure: training prepares its plans afresh each step and
        never rebuilds this."""
        key = (id(self.blk_tap), self.wpack.device, bool(pairs))
        hit = _WGRAD_TILES.get(key)
        if hit is None or hit[0] is not self.blk_tap:
            hit = _WGRAD_TILES[key] = (self.blk_tap, torch.as_tensor(
                wgrad_tile_list(self.blk_ptr, self.blk_tap, self.blk_k0,
                                pairs), device=self.wpack.device))
        return hit[1]


# (block list's tap array, device, pairs) -> (that array, the tile list);
# holding the array keeps its id from being reused
_WGRAD_TILES = {}


@functools.lru_cache(maxsize=256)
def _block_list_of(struct_bytes, shape, cin, cout, bn, bk):
    """``block_list`` cached by the slot structure (the lists depend on
    the call shape alone; training prepares every layer each step)."""
    struct = np.frombuffer(struct_bytes, bool).reshape(shape)
    out = block_list(struct, cin, cout, bn, bk)
    for a in out:
        a.setflags(write=False)
    return out


def plan_from_dense(wstack, struct, cin, cout, bk=TAP_BK):
    """Pack a dense [T, K_in, K_out] stack whose slot structure is
    ``struct`` (bool [T, n_in, n_out], with K_in = n_in * cin and K_out =
    n_out * cout): the block list comes from ``struct``, the tiles from the
    stack."""
    taps, k_in, k_out = wstack.shape
    assert struct.shape[1] * cin == k_in and struct.shape[2] * cout == k_out
    bn = choose_bn(k_out)
    struct = np.ascontiguousarray(struct, bool)
    ptr, tap, k0 = _block_list_of(struct.tobytes(), struct.shape, cin, cout,
                                  bn, bk)
    nkb, ncol = -(-k_in // bk), len(ptr) - 1
    dev = wstack.device
    col = np.repeat(np.arange(ncol), np.diff(ptr))
    wp = torch.nn.functional.pad(
        wstack, (0, ncol * bn - k_out, 0, nkb * bk - k_in))
    wp = wp.reshape(taps, nkb, bk, ncol, bn)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
    tiles = wp[as_t(tap), as_t(k0 // bk), :, as_t(col), :]  # [nb, bk, bn]
    wpack = tiles.transpose(1, 2).contiguous()
    # per (column block, tap) ranges of the list
    tap_ptr = np.zeros((ncol, taps + 1), np.int64)
    np.cumsum(np.bincount(col * taps + tap, minlength=ncol * taps)
              .reshape(ncol, taps), axis=1, out=tap_ptr[:, 1:])
    tap_ptr += ptr[:-1, None]
    return TapPlan(
        k_in=k_in, k_out=k_out, taps=taps, bn=bn, bk=bk, blk_ptr=ptr,
        blk_tap=tap, blk_k0=k0, wpack=wpack,
        tap_ptr=torch.as_tensor(tap_ptr.astype(np.int32), device=dev),
        k0=torch.tensor(k0, device=dev))


def transposed_plan(wstack, struct, cin, cout, bk=TAP_BK):
    """The plan of the mirrored, transposed stack ``W_T[k] = W[T-1-k]^T``
    (slot structure ``struct[::-1]`` with slots in and out swapped): run on
    a self neighbour map, whose tap T-1-k undoes tap k, K1 with it computes
    the gradient of K1's input (see ``ops/family.py``)."""
    struct = np.ascontiguousarray(np.asarray(struct, bool)[::-1]
                                  .transpose(0, 2, 1))
    return plan_from_dense(wstack.flip(0).transpose(1, 2), struct, cout, cin,
                           bk)
