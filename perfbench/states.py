"""The benchmark's inputs in the program's types and in the reference's.

Raw state arrays (``scenes.*_raw_state``) become the port's
``SurfelState`` (copies: the program updates its parameters in place) and
the reference's; the sky's arrays its ``SkyParams`` and the reference's;
(w2c, K) pairs cameras. Only this module and the entry drivers import the
program.
"""

from __future__ import annotations

import torch

from .reference import model as ref

PARAMS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
STATS = ("semantics", "alive", "max_radii2d", "grad_accum", "denom",
         "spatial_scale")


def to_device(raw: dict, device) -> dict:
    return {k: (v.to(device).clone() if torch.is_tensor(v) else v)
            for k, v in raw.items()}


def program_state(raw: dict, device):
    from streetunveiler_torch.models.gaussians import (SurfelParams,
                                                       SurfelState)
    r = to_device(raw, device)
    return SurfelState(params=SurfelParams(**{k: r[k] for k in PARAMS}),
                       sh_degree=r["sh_degree"],
                       **{k: r[k] for k in STATS})


def reference_state(raw: dict, device):
    r = to_device(raw, device)
    return ref.SurfelState(params=ref.SurfelParams(**{k: r[k]
                                                      for k in PARAMS}),
                           sh_degree=r["sh_degree"],
                           **{k: r[k] for k in STATS})


def raw_of(state) -> dict:
    """Raw arrays of a program's or the reference's state, on the host."""
    out = {k: getattr(state.params, k).detach().cpu().clone()
           for k in PARAMS}
    out.update({k: getattr(state, k).detach().cpu().clone() for k in STATS})
    out["sh_degree"] = state.sh_degree
    return out


def _sky_fields(sky: dict, device):
    return dict(hash_tables=sky["hash_tables"].to(device).clone(),
                mlp_w=tuple(w.to(device).clone() for w in sky["mlp_w"]),
                mlp_b=tuple(b.to(device).clone() for b in sky["mlp_b"]),
                num_levels=sky["num_levels"], base_res=sky["base_res"],
                growth=sky["growth"], sh_bands=sky["sh_bands"])


def program_sky(sky: dict, device):
    from streetunveiler_torch.models.sky import SkyParams
    return SkyParams(**_sky_fields(sky, device))


def reference_sky(sky: dict, device):
    return ref.SkyParams(**_sky_fields(sky, device))


def program_camera(w2c, K, width: int, height: int):
    from streetunveiler_torch.scene.cameras import Camera
    return Camera(w2c=w2c, K=K, width=width, height=height)


def reference_camera(w2c, K, width: int, height: int):
    return ref.Camera(w2c=w2c, K=K, width=width, height=height)


def leaves(params, sky=None) -> dict:
    """The trained tensors by name: the surfels' and the sky's."""
    out = {k: getattr(params, k) for k in PARAMS}
    if sky is not None:
        out["sky.hash_tables"] = sky.hash_tables
        out.update({f"sky.mlp_w{i}": w for i, w in enumerate(sky.mlp_w)})
        out.update({f"sky.mlp_b{i}": b for i, b in enumerate(sky.mlp_b)})
    return out
