"""Port vs JAX: ``bin_surfels_stream`` and the duplicate expansion (K3).

Both packages bin the same numpy inputs (the JAX preprocess output), so
the integer results must be equal, value for value: ``sorted_surfel``,
``tile_offsets``, ``demand`` and ``overflow``. The plain K3 arithmetic is
held against the Pallas ``_expand_stream`` (interpret mode) on the same
gathered table. The CUDA kernel is held against its plain version on a card
by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streetunveiler_tpu.ops.rasterizer import RasterizeSettings as JSettings
from streetunveiler_tpu.ops.rasterizer import tiles as jtiles
from streetunveiler_tpu.ops.rasterizer.preprocess import \
    preprocess_surfels as jpre
from streetunveiler_torch import trace
from streetunveiler_torch.ops.rasterizer import tiles as ttiles

torch.set_num_threads(1)

W, H = 64, 48


def random_scene(n=300, seed=0, W=64, H=48, f=50.0, zspread=(3.0, 12.0)):
    rng = np.random.default_rng(seed)
    means = np.stack([
        rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
        rng.uniform(*zspread, n)], axis=1).astype(np.float32)
    scales = rng.uniform(0.05, 0.6, (n, 2)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.05, 0.95, n).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return (means, scales, quats, opac, cols), np.eye(4, dtype=np.float32), K


@pytest.fixture(scope="module")
def binning_inputs():
    """(center2d, ext, depth, valid, cull) as numpy, from JAX."""
    args, w2c, K = random_scene()
    sur = jpre(*map(jnp.asarray, args), jnp.asarray(w2c), jnp.asarray(K),
               JSettings(width=W, height=H))
    return tuple(np.array(x) for x in (sur.center2d, sur.ext, sur.depth,
                                       sur.valid, sur.cull))


def bin_both(inputs, cap, use_cull, max_tiles=256):
    c2d, ext, depth, valid, cull = inputs
    jb = jtiles.bin_surfels_stream(
        *map(jnp.asarray, (c2d, ext, depth, valid)), W, H, 32, 16, cap,
        max_tiles, cull=jnp.asarray(cull) if use_cull else None,
        interpret=True)
    tb = ttiles.bin_surfels_stream(
        *map(torch.as_tensor, (c2d, ext, depth, valid)), W, H, 32, 16, cap,
        max_tiles, cull=torch.as_tensor(cull) if use_cull else None)
    return jb, tb


def assert_same_stream(jb, tb):
    np.testing.assert_array_equal(tb.sorted_surfel.numpy(),
                                  np.asarray(jb.sorted_surfel))
    np.testing.assert_array_equal(tb.tile_offsets.numpy(),
                                  np.asarray(jb.tile_offsets))
    assert int(tb.demand) == int(jb.demand)
    assert bool(tb.overflow) == bool(jb.overflow)
    assert (tb.tiles_x, tb.tiles_y) == (jb.tiles_x, jb.tiles_y)
    assert tb.sorted_surfel.dtype == tb.tile_offsets.dtype == torch.int32


@pytest.mark.parametrize("use_cull", [True, False])
def test_stream_matches_jax(binning_inputs, use_cull):
    jb, tb = bin_both(binning_inputs, 64 * 1024, use_cull)
    assert_same_stream(jb, tb)
    assert not bool(tb.overflow)
    assert int(tb.tile_offsets[-1]) == int(tb.demand) > 0


def test_overflow_drops_farthest(binning_inputs):
    """A capacity far below demand: the same truncated stream (the
    farthest surfels' duplicates dropped), ``overflow`` set, exact
    uncapped ``demand``."""
    jb, tb = bin_both(binning_inputs, 256, True)
    assert_same_stream(jb, tb)
    assert bool(tb.overflow) and int(tb.demand) > 256
    assert int(tb.tile_offsets[-1]) == 256
    # the kept duplicates are the nearest surfels' ones
    depth = binning_inputs[2]
    kept = np.unique(tb.sorted_surfel.numpy())
    full = bin_both(binning_inputs, 64 * 1024, True)[1]
    dropped = np.setdiff1d(np.unique(full.sorted_surfel.numpy()[
        :int(full.tile_offsets[-1])]), kept)
    assert depth[kept].max() <= depth[dropped].min()


def test_max_tiles_per_surfel_caps_runs(binning_inputs):
    jb, tb = bin_both(binning_inputs, 64 * 1024, True, max_tiles=2)
    assert_same_stream(jb, tb)


def _ranked_table(inputs, use_cull):
    c2d, ext, depth, valid, cull = map(torch.as_tensor, inputs)
    return ttiles.ranked_table(c2d, ext, depth, valid, W, H, 32, 16,
                               cull=cull if use_cull else None)


@pytest.mark.parametrize("use_cull", [True, False])
@pytest.mark.parametrize("cap", [64 * 1024, 256])
def test_plain_k3_matches_pallas_expand(binning_inputs, use_cull, cap):
    tbl, dup_start = _ranked_table(binning_inputs, use_cull)
    n = tbl.shape[0]
    tiles_x, n_tiles = 2, 6
    capp = -(-cap // ttiles.EXP_BLK) * ttiles.EXP_BLK
    # the TPU path's gathered rows: marks + cumsum rank, clipped take
    marks = np.zeros(capp, np.int32)
    pos = dup_start.numpy()[1:-1]
    np.add.at(marks, pos[pos < capp], 1)
    rank = np.minimum(np.cumsum(marks), n - 1)
    g = tbl.numpy()[rank]
    total = min(int(dup_start[-1]), cap)
    jt, js = jtiles._expand_stream(jnp.asarray(g), jnp.int32(total), tiles_x,
                                   32, 16, n, n_tiles, use_cull,
                                   interpret=True)
    tt, ts = ttiles.expand_rows_plain(torch.as_tensor(g),
                                      torch.tensor(total, dtype=torch.int32),
                                      tiles_x, n, n_tiles, use_cull)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # and the whole plain K3 (rank + gather + arithmetic)
    pt, ps = ttiles.expand_duplicates_plain(tbl, dup_start, cap, tiles_x,
                                            n_tiles, use_cull)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert (pt.numpy()[total:] == n_tiles).all()


def test_cpu_binning_launches_no_kernel(binning_inputs):
    trace.reset_launch_counts()
    bin_both(binning_inputs, 64 * 1024, True)
    assert trace.launch_counts["expand"] == 0
