"""Port vs JAX: the ZITS++ and LeftRefill adapter math
(``streetunveiler_torch/pipeline/zits.py``, ``pipeline/leftrefill.py``) and
the unveil CLI's inpainter specs, on the same seeded numpy inputs as the
JAX package's ``pipeline/zits.py``/``leftrefill.py``.

Tolerances: the positional encoding (integer maps), ``edge_nms`` (0/1
maps), the batch's images, masks and encodings, and every LeftRefill
function exactly; ``sobel_xy``, ``sharpen`` and the batch's gradients
within 1e-6 (float32 ``exp`` and sums in the two libraries).
"""

import numpy as np
import pytest
import torch

from streetunveiler_tpu.cli.unveil import make_inpainter as jmake_inpainter
from streetunveiler_tpu.pipeline import leftrefill as jleft
from streetunveiler_tpu.pipeline import zits as jzits
from streetunveiler_torch.cli.unveil import make_inpainter
from streetunveiler_torch.pipeline import leftrefill, zits
from streetunveiler_torch.pipeline.inpaint import (DiffuseFillInpainter,
                                                   DirectoryInpainter)

torch.set_num_threads(1)


def _mask(shape, seed):
    """A rectangular hole with scattered hole pixels around it."""
    rng = np.random.default_rng(seed)
    h, w = shape
    m = np.zeros(shape, np.uint8)
    m[h // 4:h // 2, w // 3:2 * w // 3] = 255
    m[rng.random(shape) < 0.01] = 255
    return m


@pytest.mark.parametrize("shape", [(256, 256), (64, 80), (300, 200)])
def test_masked_position_encoding_matches_jax(shape):
    m = _mask(shape, sum(shape))
    got = zits.masked_position_encoding(m, device="cpu")
    want = jzits.masked_position_encoding(m)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_masked_position_encoding_half_plane_matches_jax():
    """A hole over the right half: 128 dilation steps, one quadrant pair
    reaching each column first."""
    m = np.zeros((256, 256), np.uint8)
    m[:, 128:] = 255
    for g, w in zip(zits.masked_position_encoding(m, device="cpu"),
                    jzits.masked_position_encoding(m)):
        np.testing.assert_array_equal(g, w)


def test_sobel_sharpen_and_nms_match_jax():
    rng = np.random.default_rng(3)
    g = rng.random((64, 72)).astype(np.float32)
    for got, want in zip(zits.sobel_xy(g), jzits.sobel_xy(g)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    x = (rng.normal(size=(50, 50)) * 3).astype(np.float32)
    np.testing.assert_allclose(zits.sharpen(x).numpy(), jzits.sharpen(x),
                               rtol=0, atol=1e-6)
    edges = rng.random((3, 40, 48)).astype(np.float32)
    bar = np.zeros((32, 32), np.float32)
    for off, v in [(-2, 0.3), (-1, 0.6), (0, 1.0), (1, 0.6), (2, 0.3)]:
        bar[:, 16 + off] = v
    for thr in (50, 128):
        got = zits.edge_nms(torch.from_numpy(edges), thr).numpy()
        for e, ge in zip(edges, got):
            np.testing.assert_array_equal(ge, jzits.edge_nms(e, thr))
        np.testing.assert_array_equal(zits.edge_nms(bar, thr).numpy(),
                                      jzits.edge_nms(bar, thr))


@pytest.mark.parametrize("test_size,use_gradient",
                         [(512, True), (256, False)])
def test_prepare_batch_matches_zits_inpainter_batch(test_size,
                                                    use_gradient):
    """``prepare_batch`` against the JAX adapter's ``_batch`` (reached on an
    instance whose constructor, which needs the external models, is not
    run), at both test sizes."""
    rng = np.random.default_rng(test_size)
    image = rng.random((90, 140, 3)).astype(np.float32)
    mask = _mask((90, 140), 5)
    j = object.__new__(jzits.ZitsInpainter)
    j._torch, j.test_size, j.use_gradient, j.device = \
        torch, test_size, use_gradient, "cpu"
    want = j._batch(image, mask)
    got = zits.prepare_batch(image, mask, test_size, use_gradient,
                             device="cpu")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if not isinstance(w, torch.Tensor):
            assert g == w, k
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k.startswith("gradient"):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
        else:
            assert torch.equal(g, w), k


def test_leftrefill_geometry_matches_jax():
    rng = np.random.default_rng(0)
    src = rng.uniform(0, 1, (100, 150, 3)).astype(np.float32)
    ref = rng.uniform(0, 1, (100, 150, 3)).astype(np.float32)
    mask = np.zeros((100, 150), np.uint8)
    mask[30:60, 40:80] = 1
    for size in (512, 256):
        for g, w in zip(leftrefill.compose_side_by_side(src, mask, ref, size),
                        jleft.compose_side_by_side(src, mask, ref, size)):
            np.testing.assert_array_equal(g, w)
    res = rng.uniform(0, 1, (512, 1024, 3)).astype(np.float32)
    np.testing.assert_array_equal(leftrefill.split_right_half(res, (100, 150)),
                                  jleft.split_right_half(res, (100, 150)))
    for img, mult in [(src, 32), (src, 64), (res, 64), (mask, 64)]:
        np.testing.assert_array_equal(leftrefill.pad_to_multiple(img, mult),
                                      jleft.pad_to_multiple(img, mult))
    for n in (1, 50):
        assert leftrefill.build_prompt(n) == jleft.build_prompt(n)


def test_adapters_raise_without_external_repo(tmp_path):
    with pytest.raises(RuntimeError):
        zits.ZitsInpainter(str(tmp_path / "nope"), str(tmp_path),
                           device="cpu")
    with pytest.raises(RuntimeError):
        leftrefill.LeftRefillInpainter(str(tmp_path / "nope"), device="cpu")
    # a checkout that does not import raises too
    (tmp_path / "repo").mkdir()
    with pytest.raises(RuntimeError, match="imports failed"):
        zits.ZitsInpainter(str(tmp_path / "repo"), str(tmp_path),
                           device="cpu")
    with pytest.raises(RuntimeError, match="imports failed"):
        leftrefill.LeftRefillInpainter(str(tmp_path / "repo"), device="cpu")


def test_cli_inpainter_specs(tmp_path):
    """``make_inpainter`` takes the JAX CLI's specs: the same kinds, and
    the same errors where the external checkout is absent."""
    assert isinstance(make_inpainter("diffuse", device="cpu"),
                      DiffuseFillInpainter)
    assert isinstance(make_inpainter(f"dir:{tmp_path}", device="cpu"),
                      DirectoryInpainter)
    for spec, err in [("unknown-model", ValueError),
                      (f"zits:{tmp_path}/nope:{tmp_path}", RuntimeError),
                      (f"zits:{tmp_path}/nope", RuntimeError),
                      (f"leftrefill:{tmp_path}/nope", RuntimeError),
                      (f"leftrefill:{tmp_path}/nope:ck", RuntimeError)]:
        with pytest.raises(err):
            jmake_inpainter(spec)
        with pytest.raises(err):
            make_inpainter(spec, device="cpu")
