"""The port's two probe kernels' plain versions against the JAX package's
Pallas probe kernels run in interpret mode on the CPU, and the probe entry
points' control flow at a small size.

``scripts/micro_gather.py`` is imported by path with ``pallas_call``
wrapped to interpret; the ``kern`` of ``scripts/prof_pallas_gather.py`` is
a closure inside its ``main()``, so its lines are restated here under the
same wrapper, beside the script's own numpy reference."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import upcc_tpu  # noqa: F401
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from upcc_tpu_torch import kernels
from upcc_tpu_torch.ops.probe_kernels import (tile_tapconv,
                                              tile_tapconv_plain,
                                              window_gather_sum,
                                              window_gather_sum_plain)
from upcc_tpu_torch.probes import micro_gather, window_gather
from upcc_tpu_torch.utils import profiling

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_micro_gather():
    """scripts/micro_gather.py with its pallas_call run in interpret mode
    (nothing under scripts/ changes; the module's import runs no bench)."""
    spec = importlib.util.spec_from_file_location(
        "jax_micro_gather", os.path.join(ROOT, "scripts", "micro_gather.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    interp = type("InterpretedPallas", (), {})()
    for name in dir(pl):
        if not name.startswith("__"):
            setattr(interp, name, getattr(pl, name))
    interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mod.pl = interp
    return mod


def _tapconv_case(seed, rows, k, kout, taps, tile):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    w = rng.standard_normal((taps, k, kout)).astype(np.float32)
    idx = rng.integers(0, tile, (rows, taps)).astype(np.int32)
    idx[::3, 1] = idx[::3, 0]  # repeated source rows
    return x, idx, w


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_tile_tapconv_matches_pallas(jax_micro_gather, dtype, rtol):
    """P1's plain version against the interpreted Pallas kernel at R=256,
    TILE=128, K=KOUT=128, 27 taps.  f32: both sum 27 * 128 f32 products,
    in another order (1e-5 of the largest output).  bf16: the Pallas kernel
    multiplies bf16 operands as the backend does, the plain version widens
    them and multiplies exactly (1e-2 of the largest output)."""
    rows, k, kout, taps, tile = 256, 128, 128, 27, 128
    x, idx, w = _tapconv_case(0, rows, k, kout, taps, tile)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    f = jax_micro_gather.make_pallas_tapconv(rows, k, kout, taps, tile, jdt)
    ref = np.asarray(jax.jit(f)(jnp.asarray(x).astype(jdt), jnp.asarray(idx),
                                jnp.asarray(w).astype(jdt)))
    got = tile_tapconv_plain(torch.from_numpy(x).to(tdt),
                             torch.from_numpy(idx),
                             torch.from_numpy(w).to(tdt), tile).numpy()
    assert got.shape == ref.shape == (rows, kout) and got.dtype == np.float32
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


@pytest.mark.parametrize("tiles,tile,k,kout", [(3, 64, 16, 24), (1, 40, 8, 8),
                                               (5, 7, 32, 16)])
def test_tile_tapconv_plain_matches_numpy(tiles, tile, k, kout):
    """Against a per-row numpy sum in float64, at tile sizes that are no
    multiple of the kernel's 128-row block; the wrapper on CPU tensors is
    the plain version."""
    rows = tiles * tile
    x, idx, w = _tapconv_case(tiles, rows, k, kout, 27, tile)
    base = (np.arange(rows) // tile * tile)[:, None]
    ref = np.einsum("rtk,tko->ro", x[base + idx].astype(np.float64),
                    w.astype(np.float64))
    got = tile_tapconv(torch.from_numpy(x), torch.from_numpy(idx),
                       torch.from_numpy(w), tile).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    # indices outside the tile are clipped into it, never read past it
    wild = idx.copy()
    wild[0, 0], wild[1, 1] = tile + 5, -3
    clipped = np.clip(wild, 0, tile - 1)
    np.testing.assert_array_equal(
        tile_tapconv_plain(torch.from_numpy(x), torch.from_numpy(wild),
                           torch.from_numpy(w), tile).numpy(),
        tile_tapconv_plain(torch.from_numpy(x), torch.from_numpy(clipped),
                           torch.from_numpy(w), tile).numpy())


def test_window_gather_matches_pallas():
    """P2's plain version against the probe's kernel (restated from
    scripts/prof_pallas_gather.py:37-53, interpreted) and against the
    script's own numpy reference (:57-61): exact in f32, since all three
    add the 27 gathered rows in tap order from zero."""
    _window_gather_case(S=64, K=128, seed=0)


def test_window_gather_ragged_width_matches_pallas():
    """K = 12: ragged against the kernel's 8-float slabs (a 4-wide last
    slab on the card); the same exact agreement, with rows of -0.0."""
    _window_gather_case(S=48, K=12, seed=1, negative_zero=True)


def _window_gather_case(S, K, seed, negative_zero=False):
    T, ntiles = 27, 3
    rng = np.random.default_rng(seed)
    win = rng.standard_normal((ntiles, S, K)).astype(np.float32)
    if negative_zero:
        win[:, ::5] = -0.0
    idx = rng.integers(0, S, (ntiles, T, S)).astype(np.int32)
    idx[:, 4] = idx[:, 5]  # repeated indices
    if negative_zero:
        idx[:, :, ::7] = 0  # every tap reads row 0, all -0.0: sums +0.0

    def kern(idx_ref, win_ref, out_ref):
        w = win_ref[0]
        acc = jnp.zeros((S, K), dtype=jnp.float32)
        for k in range(T):
            ii = jnp.broadcast_to(idx_ref[0, k, :][:, None], (S, K))
            g = jnp.take_along_axis(w, ii, axis=0)
            acc = acc + g
        out_ref[0] = acc

    f = pl.pallas_call(
        kern, grid=(ntiles,),
        in_specs=[pl.BlockSpec((1, T, S), lambda t: (t, 0, 0)),
                  pl.BlockSpec((1, S, K), lambda t: (t, 0, 0))],
        out_specs=pl.BlockSpec((1, S, K), lambda t: (t, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((ntiles, S, K), jnp.float32),
        interpret=True)
    ref = np.asarray(jax.jit(f)(jnp.asarray(idx), jnp.asarray(win)))
    got = window_gather_sum(torch.from_numpy(win),
                            torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, ref)
    refacc = np.zeros((S, K), np.float32)
    for k in range(T):
        refacc += win[0][idx[0, k]]
    np.testing.assert_array_equal(got[0], refacc)
    np.testing.assert_array_equal(
        window_gather_sum_plain(torch.from_numpy(win[:1]),
                                torch.from_numpy(idx[:1])).numpy()[0], refacc)
    # bit for bit with the numpy sum from zero: a sum of -0.0 rows is
    # +0.0 (XLA folds the Pallas kernel's zero start away and gives -0.0,
    # equal in value, which is all assert_array_equal asks above)
    np.testing.assert_array_equal(got[0].view(np.int32),
                                  refacc.view(np.int32))


def test_wrappers_need_the_card_for_cuda_tensors():
    """On the CPU the wrappers run the plain versions and count no launch;
    kernels.py knows both kernels' sources and signatures."""
    x, idx, w = _tapconv_case(1, 64, 8, 8, 27, 32)
    with profiling.recording() as rec:
        tile_tapconv(torch.from_numpy(x), torch.from_numpy(idx),
                     torch.from_numpy(w), 32)
        window_gather_sum(torch.zeros((1, 8, 4)),
                          torch.zeros((1, 27, 8), dtype=torch.int32))
    assert rec.counts == {}
    for name in ("tile_tapconv", "window_gather_sum"):
        assert os.path.exists(os.path.join(
            os.path.dirname(kernels.__file__), kernels.SOURCES[name]))
        assert name in kernels._SIGNATURES


def test_count_launch_is_thread_safe():
    """The codec's worker threads share the tracer's launch counter and
    the record of inputs: many threads, a short switch interval, no lost
    update."""
    import sys
    import threading
    n_threads, n_each = 16, 2000
    old = sys.getswitchinterval()
    kernels.RECORD = {}
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            threads = [threading.Thread(target=lambda: [
                kernels.count_launch("compact", i) for i in range(n_each)])
                for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
        assert rec.total("kernel.compact") == n_threads * n_each
        assert len(kernels.RECORD["compact"]) == n_threads * n_each
    finally:
        sys.setswitchinterval(old)
        kernels.RECORD = None


def test_probe_entry_points_run_on_cpu(capsys):
    """Both entry points at a small size with --device cpu (the plain
    versions): every line carries the device tag, the window probe's check
    is exact, and without a card the default device raises."""
    out = micro_gather.main(["--device", "cpu", "--rows", "256", "--tile",
                             "64", "--reps", "1"])
    assert [r["k"] for r in out["row_gather"]] == [8, 32, 128, 512, 128]
    assert [r["dtype"] for r in out["tile_tapconv"]] == [
        "float32", "bfloat16", "bfloat16 plain"]
    res = window_gather.main(["--device", "cpu", "--tiles", "2", "--window",
                              "32", "--reps", "1"])
    assert res["rel_err"] == 0.0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert len(lines) == 11 and all(ln.startswith("[cpu") for ln in lines)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            window_gather.main(["--tiles", "1", "--window", "8"])
    with pytest.raises(SystemExit):
        micro_gather.main(["--device", "cpu", "--rows", "100", "--tile", "64"])
