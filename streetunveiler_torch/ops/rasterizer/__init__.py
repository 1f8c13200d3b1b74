"""2D Gaussian surfel (2DGS) rasterization in PyTorch with hand-written
CUDA kernels for Hopper (counterpart of ``streetunveiler_tpu.ops.
rasterizer``).

  preprocess.py — world → ray-space surfel transform, culling, extents
  oracle.py     — untiled plain-torch renderer, the correctness oracle
  tiles.py      — tile binning; duplicate expansion = CUDA kernel K3
  kernel.py     — record pack; blend forward = CUDA kernel K1
  api.py        — ``rasterize``: the tiled forward path end to end
  cuda_lib.py   — builds ``csrc/*.cu`` with nvcc at first use, loads it
"""

from .types import RasterizeSettings, RenderOutput
from .oracle import rasterize_oracle
from .api import rasterize
