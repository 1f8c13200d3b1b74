"""Semantic taxonomy (counterpart of ``streetunveiler_tpu/utils/
semantics.py``): the six "concerned" classes [road, sidewalk, building,
vegetation, sky, vehicle] and the class bits the training loop prunes by.
The Cityscapes tables and colour helpers come with the late-phase
semantic slice.
"""

from __future__ import annotations

CONCERNED_CLASSES = ["road", "sidewalk", "building", "vegetation", "sky",
                     "vehicle"]
CONCERNED_IND = {name: i for i, name in enumerate(CONCERNED_CLASSES)}
NUM_CONCERNED = len(CONCERNED_CLASSES)

SKY_BIT = 1 << CONCERNED_IND["sky"]
VEGETATION_BIT = 1 << CONCERNED_IND["vegetation"]
VEHICLE_BIT = 1 << CONCERNED_IND["vehicle"]
