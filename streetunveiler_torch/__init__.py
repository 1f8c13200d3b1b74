"""streetunveiler_torch — the PyTorch/CUDA build of the 2D Gaussian surfel
renderer, for one NVIDIA Hopper card (H100, ``sm_90a``).

It mirrors ``streetunveiler_tpu`` module for module (``ops/rasterizer/
tiles.py`` here is the counterpart of the same path there) and is held
against it by the tests. It imports ``torch``, numpy and the standard
library only — never ``jax`` and nothing of the JAX package.

Layer map of the forward render path:

    renderer.py            render / render_semantic / measure_duplicate_capacity
    ops/rasterizer/api.py  rasterize: preprocess → binning → blend → assembly
    ops/rasterizer/tiles.py   tile binning; duplicate expansion = CUDA kernel K3
    ops/rasterizer/kernel.py  record pack; blend forward = CUDA kernel K1
    ops/rasterizer/csrc/   the hand-written CUDA C++ kernels (built at first use
                           into ``streetunveiler_torch/_build/``)
    models/, scene/, utils/, convert.py   state, cameras, PLY, weight carry-over

Entry points take ``device="cuda"`` by default and raise when no CUDA
device is present; they run on the CPU only when asked (``device="cpu"``),
where every kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"
