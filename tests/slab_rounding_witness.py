"""The slab split's rounding in both packages on the CPU, on the street of
``chip_smoke.py``'s phase group 21 (300k surfels, f = 1000, 1280 rows).

A slab renders through the shifted principal point (K[1,2] -= row0), an
exact crop in real arithmetic; in float32 its pixels differ from the full
render's rows by rounding. This script renders the 32 centre columns of
the 1920×1280 street camera, with the surfels those columns can see, in 4
slabs of 320 rows, through the JAX package (``streetunveiler_tpu``) and the
port (``streetunveiler_torch``, its plain versions on the CPU), and prints
per slab the share of pixels past 1e-5 and 1e-4 and the largest error:

* ``frame="strip"``: a 32-column camera (cx = 16), the geometry of
  ``tests/test_torch_shard.py::test_slab_rounding_is_the_designs``;
* ``frame="full"``: the full 1920-column camera (cx = 960), the same
  pixels at the full frame's x coordinates, as the card renders them
  (``chip_smoke.py``'s ``share_over_atol_centre32``).

    JAX_PLATFORMS=cpu python tests/slab_rounding_witness.py \
        [--frames strip,full] [--packages port,jax]

A few minutes on the CPU, most of it the port's full-frame renders.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PARAMS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
STRIP = 32
N_SLAB = 4


def states():
    """The street's surfels that the centre strip can see, as the port's
    state and the JAX package's."""
    import jax.numpy as jnp
    import torch
    from streetunveiler_tpu.models.gaussians import SurfelParams, SurfelState
    from streetunveiler_torch.tools import street

    st = street.street_state(street.N_SURFELS, device="cpu")
    xyz = st.params.xyz
    keep = torch.nonzero((xyz[:, 2] > 0.2) & ((xyz[:, 0] / xyz[:, 2]).abs()
                         < (STRIP / 2 + 16) / street.FOCAL))[:, 0]
    p = type(st.params)(**{k: getattr(st.params, k)[keep] for k in PARAMS})
    st = dataclasses.replace(st, params=p, **{
        k: getattr(st, k)[keep] for k in ("semantics", "alive",
                                          "max_radii2d", "grad_accum",
                                          "denom")})
    j = lambda t: jnp.asarray(t.detach().numpy())
    jst = SurfelState(
        params=SurfelParams(**{k: j(getattr(p, k)) for k in PARAMS}),
        semantics=j(st.semantics), alive=j(st.alive),
        max_radii2d=j(st.max_radii2d), grad_accum=j(st.grad_accum),
        denom=j(st.denom), spatial_scale=jnp.float32(30.0))
    return st, jst


def shares(package, frame, st, jst):
    import jax.numpy as jnp
    import torch
    from streetunveiler_tpu.renderer import render as jrender
    from streetunveiler_tpu.scene.cameras import Camera as JCamera
    from streetunveiler_torch.renderer import render
    from streetunveiler_torch.scene.cameras import Camera
    from streetunveiler_torch.tools import street

    w = STRIP if frame == "strip" else street.W
    h, f = street.H, street.FOCAL
    c0 = w // 2 - STRIP // 2
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    bg = np.array([0.2, 0.1, 0.0], np.float32)

    def rows(row0, height):
        k = K.copy()
        k[1, 2] -= row0
        if package == "port":
            img = render(Camera(w2c=torch.eye(4), K=torch.as_tensor(k),
                                width=w, height=height), st,
                         torch.as_tensor(bg), device="cpu").render.numpy()
        else:
            img = np.asarray(jrender(JCamera(
                w2c=jnp.eye(4), K=jnp.asarray(k), width=w, height=height),
                jst, jnp.asarray(bg)).render)
        return img[:, c0:c0 + STRIP]

    full = rows(0, h)
    slab = h // N_SLAB
    out = []
    for i in range(N_SLAB):
        e = np.abs(rows(i * slab, slab)
                   - full[i * slab:(i + 1) * slab]).max(-1)
        out.append(dict(row0=i * slab, over_1e5=float((e > 1e-5).mean()),
                        over_1e4=float((e > 1e-4).mean()),
                        max_abs_err=float(e.max())))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", default="strip,full")
    ap.add_argument("--packages", default="port,jax")
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    st, jst = states()
    for frame in args.frames.split(","):
        for package in args.packages.split(","):
            print(json.dumps(dict(frame=frame, package=package,
                                  surfels=st.capacity, slabs=shares(
                                      package, frame, st, jst))),
                  flush=True)


if __name__ == "__main__":
    main()
