"""Block-parallel inference: groups of blocks over several devices (the JAX
package's ``parallel/block_parallel.py``).

Blocks are independent bitstreams and ride batched device passes in
groups of up to 63 (``codec/codec.py``).  ``parallel_map_blocks`` runs the
groups concurrently, assigned round-robin to the listed devices, one
worker thread per listed entry; each worker places its group's device work
on its device, and its host entropy coding overlaps the other workers'
device time.  Results come back in submission order, so the bitstream is
the sequential path's, byte for byte.

Unlike the JAX function, a device listed twice gets two workers (the JAX
function runs one worker a distinct device), so the dispatch also runs on
one card or on the CPU; the bytes are the same either way.
"""

import contextvars
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def round_robin_devices(n, devices):
    return [devices[i % len(devices)] for i in range(n)]


def parallel_map_blocks(fn, blocks, devices):
    """``[fn(block, device) for block, device in zip(blocks, round robin
    over devices)]``, one worker thread per listed device; results in
    block order."""
    devs = round_robin_devices(len(blocks), devices)
    n_workers = min(len(devices), len(blocks))
    if n_workers <= 1:
        return [fn(blk, dev) for blk, dev in zip(blocks, devs)]
    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        # each call runs in a copy of the caller's context (its open
        # tracer span, ``utils/profiling.py``)
        futures = [pool.submit(contextvars.copy_context().run, fn, blk, dev)
                   for blk, dev in zip(blocks, devs)]
        return [f.result() for f in futures]


def shard_points_by_block(xyz, block_size):
    """(order, bounds, mins): the permutation that sorts points by block
    (lexicographic block index), the block boundaries in it and the
    cloud's minimum corner."""
    mins = xyz.min(axis=0)
    bidx = (xyz - mins) // block_size
    order = np.lexsort((bidx[:, 2], bidx[:, 1], bidx[:, 0]))
    sorted_idx = bidx[order]
    change = np.any(np.diff(sorted_idx, axis=0) != 0, axis=1)
    bounds = np.concatenate([[0], np.where(change)[0] + 1, [len(xyz)]])
    return order, bounds, mins
