"""streetunveiler_torch — the PyTorch/CUDA build of the 2D Gaussian surfel
renderer, for one NVIDIA Hopper card (H100, ``sm_90a``).

It mirrors ``streetunveiler_tpu`` module for module (``ops/rasterizer/
tiles.py`` here is the counterpart of the same path there) and is held
against it by the tests. It imports ``torch``, numpy and the standard
library only — never ``jax`` and nothing of the JAX package.

Layer map, from the entry points down:

    cli/train.py           the stage-1 training CLI (synthetic street scene)
    cli/render.py          the render CLI: views, depth, normals, semantics,
                           PSNR, the TSDF mesh (mesh.py, ops/tsdf.py)
    cli/unveil.py          the unveil CLI: pipeline/select.py (instances),
                           masks.py (removal masks), inpaint.py,
                           reoptimize.py (the masked delta steps,
                           models/deltas.py)
    train/loop.py          train_scene: camera order, densify/prune schedule,
                           capacity auto-bump, held-out evaluation
    train/step.py          train_step: render → losses → backward → Adam →
                           densification statistics (losses.py, optim.py)
    renderer.py            render / render_semantic / measure_duplicate_capacity
    ops/rasterizer/api.py  rasterize: preprocess → binning → blend → assembly;
                           backward: K2 → record scatter → preprocess autograd
    ops/rasterizer/tiles.py   tile binning; duplicate expansion = CUDA kernel K3
    ops/rasterizer/kernel.py  record pack; blend forward = CUDA kernel K1,
                              blend backward = CUDA kernel K2
    ops/rasterizer/csrc/   the hand-written CUDA C++ kernels (built at first use
                           into ``streetunveiler_torch/_build/``)
    models/, scene/, utils/, evaluation/, config.py, convert.py
                           state and densification, cameras, synthetic scene,
                           PLY, cfg_args.json, metrics, weight carry-over
    trace.py               the profiler ranges and counters of these layers
                           (on while a torch.profiler collects) and the
                           kernels' launch counts

Entry points take ``device="cuda"`` by default and raise when no CUDA
device is present; they run on the CPU only when asked (``device="cpu"``),
where every kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"
