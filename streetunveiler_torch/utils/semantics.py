"""Semantic taxonomy (counterpart of ``streetunveiler_tpu/utils/
semantics.py``): the 19 Cityscapes train classes collapse to six
"concerned" classes [road, sidewalk, building, vegetation, sky, vehicle]
through a lookup table; class colours for visualization; the class bits
the training loop gates and prunes by.
"""

from __future__ import annotations

import numpy as np

CITYSCAPES_CLASSES = [
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic light", "traffic sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle",
]

CONCERNED_CLASSES = ["road", "sidewalk", "building", "vegetation", "sky",
                     "vehicle"]
CONCERNED_IND = {name: i for i, name in enumerate(CONCERNED_CLASSES)}
NUM_CONCERNED = len(CONCERNED_CLASSES)

# Cityscapes train id → concerned id: walls, fences, poles and signs go to
# building, terrain to sidewalk, people and every vehicle to vehicle
_C2C = {
    "road": "road", "sidewalk": "sidewalk", "building": "building",
    "wall": "building", "fence": "building", "pole": "building",
    "traffic light": "building", "traffic sign": "building",
    "vegetation": "vegetation", "terrain": "sidewalk", "sky": "sky",
    "person": "vehicle", "rider": "vehicle", "car": "vehicle",
    "truck": "vehicle", "bus": "vehicle", "train": "vehicle",
    "motorcycle": "vehicle", "bicycle": "vehicle",
}
CITYSCAPES_TO_CONCERNED = np.array(
    [CONCERNED_IND[_C2C[name]] for name in CITYSCAPES_CLASSES], np.int32)

CONCERNED_COLORS = np.array([
    [128, 64, 128],    # road
    [244, 35, 232],    # sidewalk
    [70, 70, 70],      # building
    [107, 142, 35],    # vegetation
    [70, 130, 180],    # sky
    [0, 0, 142],       # vehicle
], np.uint8)

SKY_BIT = 1 << CONCERNED_IND["sky"]
VEGETATION_BIT = 1 << CONCERNED_IND["vegetation"]
VEHICLE_BIT = 1 << CONCERNED_IND["vehicle"]


def cityscapes_to_concerned(labels):
    """Cityscapes train-id maps (any shape) → concerned ids; ids outside
    [0, 19) are clamped into it first."""
    labels = np.asarray(labels)
    safe = np.clip(labels, 0, len(CITYSCAPES_CLASSES) - 1)
    return CITYSCAPES_TO_CONCERNED[safe]


def semantic_prob_to_rgb(prob):
    """[..., C] class probabilities (array or tensor) → the argmax class's
    colour, uint8 [..., 3]."""
    prob = prob.detach().cpu().numpy() if hasattr(prob, "detach") \
        else np.asarray(prob)
    return CONCERNED_COLORS[np.argmax(prob, axis=-1)]


def class_onehot_image(labels, num_classes: int = NUM_CONCERNED):
    """int labels [H, W] → one-hot [H, W, C] float32 (a camera's per-class
    semantic probability image)."""
    labels = np.asarray(labels)
    out = np.zeros(labels.shape + (num_classes,), np.float32)
    np.put_along_axis(out, labels[..., None], 1.0, axis=-1)
    return out
