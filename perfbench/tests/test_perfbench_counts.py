"""The count functions against counts made by hand on a 2-tile scene."""

from __future__ import annotations

import torch

from perfbench import counts
from perfbench.reference import model as ref
from perfbench.reference import raster


def two_tile_scene(classes=(0, 1)):
    """Two wide camera-facing surfels, one behind the other, over a 64×16
    image (two 32×16 tiles): every pixel sees both, each at α ≈ 0.5, and
    nothing terminates."""
    st = ref.SurfelState(
        params=ref.SurfelParams(
            xyz=torch.tensor([[0.0, 0.0, 5.0], [0.0, 0.0, 8.0]]),
            features_dc=torch.full((2, 1, 3), 0.3),
            features_rest=torch.zeros((2, 0, 3)),
            scaling=torch.log(torch.full((2, 2), 100.0)),
            rotation=torch.tensor([[1.0, 0.0, 0.0, 0.0]] * 2),
            opacity=torch.zeros((2, 1))),
        semantics=torch.tensor(classes, dtype=torch.int32),
        alive=torch.ones(2, dtype=torch.bool), max_radii2d=torch.zeros(2),
        grad_accum=torch.zeros(2), denom=torch.zeros(2),
        spatial_scale=torch.tensor(1.0), sh_degree=0)
    cam = ref.Camera(w2c=torch.eye(4),
                     K=torch.tensor([[50.0, 0, 32], [0, 50.0, 8], [0, 0, 1]]),
                     width=64, height=16)
    return cam, st


def test_pair_counts_by_hand():
    cam, st = two_tile_scene()
    c = ref.pair_counts(cam, st, active_sh_degree=0, duplicate_capacity=128)
    pixels = 64 * 16
    # each pixel evaluates and keeps both surfels, in each pass
    assert c["k1"]["evaluated_skip_rule"] == 2 * pixels
    assert c["k1"]["kept"] == 2 * pixels
    assert c["k2"]["evaluated_skip_rule"] == 2 * pixels
    assert c["k2"]["kept"] == c["k2"]["any_kept"] == 2 * pixels
    assert (c["n_tiles"], c["pixels"], c["filled"], c["nq"]) == \
        (2, 2 * raster.PIX, 4, 6)
    assert counts.k1_ops(c["k1"]) == 30 * 2 * pixels
    assert counts.k2_ops(c["k2"], 6) == (33 + 20 + 4 * 6 + 62) * 2 * pixels
    # 16 record rows × 4 filled slots, 3 offsets, 12 accumulator channels
    # and lk for 1024 pixels
    assert counts.k1_bytes(16, 4, 2, 1024, 12) == 4 * (64 + 3 + 12288 + 1024)
    assert counts.k1_bytes(c["rec_rows"], c["filled"], c["n_tiles"],
                           c["pixels"], c["channels"]) \
        == 4 * (16 * 4 + 3 + 1024 * 12 + 1024)
    # K2: rows 0..15 of 4 slots, 3 offsets, α and lk, the 10 cotangent
    # channels, all 16 × 128 of the record gradient
    assert counts.k2_bytes(16, 128, 4, 2, 1024, 6, 0) \
        == 4 * (16 * 4 + 3 + 1024 + 1024 + 1024 * 10 + 16 * 128)


def test_gated_counts_by_hand():
    cam, st = two_tile_scene()
    gates = torch.stack([st.semantic_mask(1 << g) for g in range(2)], 1)
    c = ref.pair_counts(cam, st, active_sh_degree=0, class_gates=gates,
                        duplicate_capacity=128)
    pixels = 64 * 16
    # chain 0 keeps the front surfel, chain 1 the back one, at every pixel
    assert c["k1"]["gated_kept"] == 2 * pixels
    assert c["k2"]["gated_kept"] == 2 * pixels
    assert counts.k1_ops(c["k1"]) == (30 * 2 + 8 * 2) * pixels
    assert c["n_gates"] == 2


def test_bound_takes_the_larger():
    assert counts.bound_s(3.35e12, 0.0) == 1.0
    assert counts.bound_s(0.0, 67e12) == 1.0
    assert counts.bound_s(3.35e12, 134e12) == 2.0
    assert counts.sky_ops(1, backward=False) == 2 * (16 * 64 + 2 * 64 * 64
                                                      + 64 * 3)
    assert counts.ssim_ops(1) == 2 * 2 * 11 * 24
