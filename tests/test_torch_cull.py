"""The binning's conic cull kernel (``csrc/cull_sm90.cuh``, wrapper
``tiles.cull_rects_cuda``): the tile rectangles and the exact conic tile
test in one pass, writing the per-surfel table ``tiles.rank_table``
gathers.

On the CPU:

* a numpy model of the kernel's compaction (each rect position's place
  in the compact list from a passing and a failing counter, its nibble
  in w0 or w1) gives ``conic_cull``'s sort-based words
  (``tiles.pack_positions``) and passing count for all 65,536 pass masks,
  at rect_nt 0, 1, 5 and 16; the kernel's tile stepping along the rect's
  rows is ``conic_cull``'s divmod;
* the wrapper refuses a CPU tensor, a wrong dtype, shape or contiguity
  before it loads the library;
* ``ranked_table`` on CPU tensors launches nothing and gives the bits of
  ``tile_rects`` + ``conic_cull`` + the table's gather as they were
  composed before the kernel.

On a card (``card``: they skip without one): the kernel against its plain
version on the same CUDA tensors, bit for bit: the table (w0 and w1 on
small rows, 0 elsewhere), ``dup_start``, every column of the ranked table
K3 reads, and the whole ``StreamBinning`` of ``bin_surfels_stream`` and of
a row slab of ``bin_slab_from_inputs``. Cases: the 1M-surfel street at
1920x1280, at 1920x1080 (a partial last tile row), ``max_tiles_per_surfel``
2, and hand-built rows (NaN and inf coefficients, A = 0, det = 0, rect_nt
0, 1, 16 and 17, the image border, the partial tile row) at N = 1, 17 and
1001. Run them on the card with ``python3 -m pytest --noconftest -p
no:cacheprovider tests/test_torch_cull.py`` (this file imports nothing of
JAX).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from streetunveiler_torch import trace
from streetunveiler_torch.ops.rasterizer import tiles
from streetunveiler_torch.ops.rasterizer.preprocess import \
    preprocess_surfels

torch.set_num_threads(1)

KMAX = tiles.CULL_KMAX
POPC = np.array([bin(i).count("1") for i in range(1 << KMAX)], np.int64)


def model_compaction(masks, rect_nt):
    """The kernel's compaction in numpy, for a small surfel whose tests
    of the rect positions k < rect_nt passed as the bits of ``masks``
    [M]: position k goes to the next passing place where its bit is set,
    else to popc(mask) + the failing ones before it, as nibble k of w0
    (places 0-7) or w1 (8-15). → (passing count, w0, w1 as uint32)."""
    mask = masks & ((1 << rect_nt) - 1)
    passing, fail = np.zeros_like(mask), POPC[mask]
    w0 = np.zeros_like(mask)
    w1 = np.zeros_like(mask)
    for k in range(KMAX):
        bit = (mask >> k) & 1
        place = np.where(bit == 1, passing, fail)
        passing, fail = passing + bit, fail + 1 - bit
        nib = k << (4 * (place & 7))
        w0 |= np.where(place < 8, nib, 0)
        w1 |= np.where(place < 8, 0, nib)
    return POPC[mask], w0.astype(np.uint32), w1.astype(np.uint32)


@pytest.mark.parametrize("rect_nt", [0, 1, 5, 16])
def test_compaction_is_the_stable_sort(rect_nt):
    masks = np.arange(1 << KMAX, dtype=np.int64)
    nt, w0, w1 = model_compaction(masks, rect_nt)
    k = torch.arange(KMAX)
    passk = (((torch.from_numpy(masks)[:, None] >> k) & 1).bool()
             & (k < rect_nt))
    want0, want1 = tiles.pack_positions(passk)
    assert np.array_equal(nt, passk.sum(dim=1).numpy())
    assert np.array_equal(w0, want0.numpy().view(np.uint32))
    assert np.array_equal(w1, want1.numpy().view(np.uint32))


def test_rect_stepping_is_divmod():
    """The kernel steps its tile along the rect's rows (dx += 1, a new
    row at max(nx, 1)); ``conic_cull`` takes divmod(k, max(nx, 1))."""
    for nx in range(-2, KMAX + 2):
        nxc = max(nx, 1)
        dx = dy = 0
        for k in range(KMAX):
            q, r = tiles._divmod_small(torch.tensor(k), torch.tensor(nxc))
            assert (dx, dy) == (int(r), int(q))
            dx += 1
            if dx == nxc:
                dx, dy = 0, dy + 1


def good_inputs(n=5):
    return dict(cull=torch.zeros(n, 11), center2d=torch.zeros(n, 2),
                ext=torch.zeros(n, 2), valid=torch.ones(n, dtype=torch.bool))


BAD = {
    "cpu": (ValueError, "CUDA", lambda a: a),
    "dtype_cull": (TypeError, "float32",
                   lambda a: {**a, "cull": a["cull"].double()}),
    "dtype_valid": (TypeError, "bool",
                    lambda a: {**a, "valid": a["valid"].int()}),
    "shape_cull": (ValueError, "bad shapes",
                   lambda a: {**a, "cull": torch.zeros(5, 10)}),
    "shape_ext": (ValueError, "bad shapes",
                  lambda a: {**a, "ext": torch.zeros(4, 2)}),
    "empty": (ValueError, "bad shapes", lambda a: good_inputs(0)),
    "contiguity": (ValueError, "contiguous",
                   lambda a: {**a, "center2d": torch.zeros(2, 5).T}),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_refuses_bad_inputs(case):
    exc, match, make = BAD[case]
    a = make(good_inputs())
    with pytest.raises(exc, match=match):
        tiles.cull_rects_cuda(a["cull"], a["center2d"], a["ext"],
                              a["valid"], 64, 48, 32, 16)


def screen(n, width, height, focal, seed, device="cpu"):
    """A random scene's ``SurfelScreen`` from the port's preprocess."""
    from streetunveiler_torch.ops.rasterizer import RasterizeSettings
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    means = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                      rng.uniform(-1, 12, n)], 1)
    K = f32([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]])
    return preprocess_surfels(
        f32(means), f32(rng.uniform(0.02, 0.6, (n, 2))),
        f32(rng.normal(size=(n, 4))), f32(rng.uniform(0.02, 0.95, n)),
        f32(np.zeros((n, 3))), f32(np.eye(4)), K,
        RasterizeSettings(width=width, height=height))


def ranked_before(sur, width, height, mtps, use_cull):
    """``ranked_table`` as it was composed before the kernel: the rects,
    the cull's columns, one table gathered into depth rank."""
    i32 = torch.int32
    rects = tiles.tile_rects(sur.center2d, sur.ext, sur.valid, width, height,
                             32, 16, mtps)
    nt, cols = rects[4], []
    if use_cull:
        nt, cols = tiles.conic_cull(sur.cull, sur.center2d, rects, sur.valid,
                                    32, 16, mtps)
    x0, y0, nx = rects[:3]
    tbl_orig = torch.cat([x0[:, None], y0[:, None],
                          torch.clamp(nx, min=1)[:, None], nt[:, None]]
                         + cols, dim=1)
    order = tiles.depth_order(sur.depth, sur.valid)
    tbl_s = tbl_orig[order.long()]
    dup_start = torch.cat([torch.zeros(1, dtype=i32),
                           torch.cumsum(tbl_s[:, 3], 0).to(i32)])
    tbl = torch.cat([tbl_s[:, 0:3], dup_start[:-1, None], order[:, None]]
                    + ([tbl_s[:, 4:7]] if cols else []), dim=1)
    return tbl, dup_start


@pytest.mark.parametrize("mtps", [256, 2])
@pytest.mark.parametrize("use_cull", [True, False])
@pytest.mark.parametrize("size", [(64, 48), (96, 40)])
def test_cpu_ranked_table_is_unchanged_and_launches_nothing(size, use_cull,
                                                            mtps):
    width, height = size
    sur = screen(400, width, height, 50.0, seed=width + mtps)
    trace.reset_launch_counts()
    tbl, dup_start = tiles.ranked_table(
        sur.center2d, sur.ext, sur.depth, sur.valid, width, height, 32, 16,
        mtps, cull=sur.cull if use_cull else None)
    assert trace.launch_counts["cull"] == 0
    assert not any(trace.launch_counts.values())
    want_tbl, want_start = ranked_before(sur, width, height, mtps, use_cull)
    assert tbl.dtype == dup_start.dtype == torch.int32 and tbl.is_contiguous()
    assert torch.equal(tbl, want_tbl) and torch.equal(dup_start, want_start)
    assert int(dup_start[-1]) > 0 and bool(sur.valid.any())


# ---- on a card: the kernel against its plain version, bit for bit

W, H, FOCAL_A, H_U, FOCAL_U = 1920, 1280, 1000.0, 1080, 1970.0
SURFELS = 1_000_000


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda")


def assert_same_table(got, want, small_col):
    """Equal on every column; w0 and w1 (the last two) only where
    ``small_col`` is set, and 0 in ``got`` elsewhere."""
    small = want[:, small_col] > 0
    assert torch.equal(got[:, :small_col + 1], want[:, :small_col + 1])
    assert torch.equal(got[small, small_col + 1:], want[small, small_col + 1:])
    assert not got[~small, small_col + 1:].any()


def check_binning(sur, width, height, monkeypatch, mtps=256, cap=None):
    """The kernel's table, ranked table and stream against the plain
    version's on the same CUDA tensors."""
    args = (sur.center2d, sur.ext, sur.valid)
    trace.reset_launch_counts()
    got = tiles.cull_rects_cuda(sur.cull, *args, width, height, 32, 16, mtps)
    want = tiles.cull_rects_plain(sur.cull, *args, width, height, 32, 16, mtps)
    assert trace.launch_counts["cull"] == 1
    assert got.shape == want.shape and got.dtype == torch.int32
    assert_same_table(got, want, 4)
    bin_args = (sur.center2d, sur.ext, sur.depth, sur.valid, width, height,
                32, 16)
    tbl, dup_start = tiles.ranked_table(*bin_args, mtps, cull=sur.cull)
    assert trace.launch_counts["cull"] == 2
    if cap is None:
        cap = (-(-int(dup_start[-1]) // tiles.S_CHUNK) + 2) * tiles.S_CHUNK
    got_b = tiles.bin_surfels_stream(*bin_args, cap, mtps, cull=sur.cull)
    with monkeypatch.context() as m:
        m.setattr(tiles, "cull_rects_cuda", tiles.cull_rects_plain)
        want_tbl, want_start = tiles.ranked_table(*bin_args, mtps,
                                                  cull=sur.cull)
        want_b = tiles.bin_surfels_stream(*bin_args, cap, mtps,
                                          cull=sur.cull)
    assert trace.launch_counts["cull"] == 3
    assert torch.equal(dup_start, want_start)
    assert_same_table(tbl, want_tbl, 5)
    assert_same_stream(got_b, want_b)
    return got


def assert_same_stream(a, b):
    for f in ("sorted_surfel", "tile_offsets", "overflow", "demand",
              "tile_order"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.tiles_x, a.tiles_y) == (b.tiles_x, b.tiles_y)


@pytest.fixture(scope="module")
def street_state(card):
    from streetunveiler_torch.tools import street
    return street.street_state(n=SURFELS, device="cuda")


def street_screen(state, width, height, focal):
    from streetunveiler_torch.ops.rasterizer import RasterizeSettings
    from streetunveiler_torch.tools import street
    cam = street.street_camera(device="cuda", width=width, height=height,
                               focal=focal)
    with torch.no_grad():
        return preprocess_surfels(
            state.params.xyz, state.get_scaling(), state.get_rotation(),
            state.get_opacity()[:, 0], torch.zeros((SURFELS, 3),
                                                   device="cuda"),
            cam.w2c, cam.K, RasterizeSettings(width=width, height=height))


@pytest.mark.card
@pytest.mark.parametrize("mtps", [256, 2])
@pytest.mark.parametrize("view", ["1920x1280", "1920x1080"])
def test_street_kernel_is_plain(street_state, monkeypatch, view, mtps):
    height, focal = (H, FOCAL_A) if view == "1920x1280" else (H_U, FOCAL_U)
    sur = street_screen(street_state, W, height, focal)
    got = check_binning(sur, W, height, monkeypatch, mtps)
    rect = tiles.tile_rects(sur.center2d, sur.ext, sur.valid, W, height, 32,
                            16)[3]
    small = got[:, 4] > 0
    assert int(small.sum()) > 1000
    assert bool((got[small, 3] < torch.clamp(rect[small], max=mtps)).any())


@pytest.mark.card
def test_slab_kernel_is_plain(street_state, monkeypatch):
    from streetunveiler_torch.ops.rasterizer import RasterizeSettings
    from streetunveiler_torch.ops.rasterizer import api
    from streetunveiler_torch.tools import street
    state = street_state
    cam = street.street_camera(device="cuda")
    inputs = api.bin_inputs_for_camera(
        state.params.xyz, state.get_scaling(), state.get_rotation(),
        state.get_opacity()[:, 0], cam.w2c, cam.K,
        RasterizeSettings(width=W, height=H))
    slab_h, cap = H // 4, 4 * 1024 * 1024
    for row0 in (0, 2 * slab_h):
        trace.reset_launch_counts()
        got = api.bin_slab_from_inputs(inputs, row0, W, slab_h, cap)
        assert trace.launch_counts["cull"] == 1
        with monkeypatch.context() as m:
            m.setattr(tiles, "cull_rects_cuda", tiles.cull_rects_plain)
            want = api.bin_slab_from_inputs(inputs, row0, W, slab_h, cap)
        assert not bool(got.overflow)
        assert_same_stream(got, want)


def hand_rows(width, height, n, seed):
    """``n`` rows of a random scene at (width, height), the first ones
    replaced by the edge cases; as a ``SurfelScreen``-like namespace on
    the card."""
    from types import SimpleNamespace
    sur = screen(max(n, 64), width, height, 0.8 * width, seed, "cuda")
    c2d, ext = sur.center2d.clone(), sur.ext.clone()
    valid, cull = sur.valid.clone(), sur.cull.clone()
    depth = sur.depth.clone()
    ref = int(torch.nonzero(valid)[0])
    rows = []

    def put(cx, cy, ex, ey, ok=True, coef=None):
        i = len(rows)
        c2d[i] = torch.tensor([cx, cy])
        ext[i] = torch.tensor([ex, ey])
        valid[i] = ok
        cull[i] = cull[ref] if coef is None else coef
        depth[i] = 1.0 + i
        rows.append(i)

    nan, inf = float("nan"), float("inf")
    wide = cull[ref].clone()
    wide[9] = wide[10] = 1e6                  # every tile passes
    put(80.0, 40.0, 1.0, 1.0)                 # rect_nt 1
    put(384.0, 192.0, 63.0, 31.0, coef=wide)  # 4 x 4: rect_nt 16
    put(592.0, 168.0, 271.0, 2.0, coef=wide)  # 17 x 1: rect_nt 17
    put(300.0, 100.0, -40.0, 3.0)             # negative ext: rect_nt <= 0
    put(0.3, 0.2, 5.0, 5.0)                   # the image's corner
    put(width - 0.5, height - 0.5, 40.0, 20.0)
    put(width / 2, height - 4.0, 20.0, 6.0)   # the last tile row
    put(nan, nan, 0.0, 0.0, ok=False, coef=torch.full((11,), nan))
    put(10.0, 10.0, 0.0, 0.0, ok=False, coef=torch.full((11,), inf))
    put(50.0, 20.0, 30.0, 9.0, coef=torch.tensor(
        [nan, 1.0, inf, 0.0, -inf, 1.0, 2.0, nan, 1.0, 3.0, 4.0]))
    zero_a = cull[ref].clone()
    zero_a[3:6] = 0.0                         # B = 0: A = 0, det = 0
    put(200.0, 60.0, 50.0, 20.0, coef=zero_a)
    par = cull[ref].clone()
    par[6:9] = par[3:6]                       # C = B: det = 4AC - B^2 = 0
    put(260.0, 90.0, 50.0, 20.0, coef=par)
    put(260.0, 90.0, 50.0, 20.0, coef=-par)
    take = torch.arange(n, device="cuda")
    return SimpleNamespace(center2d=c2d[take].contiguous(),
                           ext=ext[take].contiguous(),
                           valid=valid[take].contiguous(),
                           cull=cull[take].contiguous(),
                           depth=depth[take].contiguous())


@pytest.mark.card
@pytest.mark.parametrize("n", [1, 17, 1001])
@pytest.mark.parametrize("view", ["1920x1280", "1920x1080"])
def test_hand_built_rows_kernel_is_plain(card, monkeypatch, view, n):
    height = H if view == "1920x1280" else H_U
    sur = hand_rows(W, height, n, seed=n)
    got = check_binning(sur, W, height, monkeypatch)
    if n > 13:
        rect = tiles.tile_rects(sur.center2d, sur.ext, sur.valid, W, height,
                                32, 16)[3]
        assert {1, 16, 17} <= set(rect[:13].tolist())
        assert int(rect[3]) <= 0
        assert int(got[1, 3]) == 16 and int(got[2, 4]) == 0
