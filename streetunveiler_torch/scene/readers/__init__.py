"""Dataset readers → ``SceneInfo`` (counterpart of
``streetunveiler_tpu/scene/readers/``). Only the synthetic street scene is
ported so far; the file-based readers come with the data-layer slice."""

from .basic import CameraInfo, PointCloud, SceneInfo, nerf_normalization
from .synthetic import make_synthetic_street

SCENE_READERS = {"synthetic": make_synthetic_street}
