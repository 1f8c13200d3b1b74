"""Dataset readers → ``SceneInfo`` (counterpart of
``streetunveiler_tpu/scene/readers/``). Every reader returns the
reference's ``SceneInfo`` contract: an initial point cloud with colours
and semantics, a reference cloud, the train and test camera infos, the
NeRF++-style normalization and the artifact paths, as numpy arrays.
Every reader takes ``device``: the driving readers colour and
voxel-downsample their LiDAR cloud there, the synthetic one builds its
street there, and the COLMAP and Blender readers, which only parse
files, ignore it.
"""

from .basic import CameraInfo, PointCloud, SceneInfo, nerf_normalization
from .blender import read_blender_info
from .colmap import read_colmap_scene
from .kitti import read_kitti_info
from .nuscenes import read_nuscenes_info
from .pandaset import read_pandaset_info
from .synthetic import make_synthetic_street
from .waymo import read_waymo_info

# the reference dispatches on sentinel files (scene/__init__.py:41-67);
# here the kind is explicit configuration
SCENE_READERS = {
    "colmap": read_colmap_scene,
    "synthetic": make_synthetic_street,
    "blender": read_blender_info,
    "waymo": read_waymo_info,
    "kitti": read_kitti_info,
    "pandaset": read_pandaset_info,
    "nuscenes": read_nuscenes_info,
}
