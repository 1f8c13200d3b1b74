"""PLY import/export in the reference's per-surfel layout (counterpart of
``streetunveiler_tpu/utils/ply.py``; the JAX package writes its
checkpoints in the same layout, so either package reads the other's).

Positions, zero normals, SH features (dc then rest, channel-major),
opacity logit, 2 log-scales, 4 quaternion components and an int32
``semantics`` column, binary little-endian. Pure numpy.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device


def _attribute_names(num_rest: int):
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(num_rest)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(2)]
    names += [f"rot_{i}" for i in range(4)]
    return names


def save_surfel_ply(path: str, xyz, features_dc, features_rest, opacity,
                    scaling, rotation, semantics) -> None:
    """Binary little-endian PLY in the reference's layout.

    features_dc [N,1,3], features_rest [N,K-1,3] — flattened channel-major
    like the reference's ``transpose(1,2).flatten(start_dim=1)``.
    """
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    dc = np.asarray(features_dc, np.float32).transpose(0, 2, 1).reshape(n, -1)
    rest = np.asarray(features_rest, np.float32).transpose(0, 2, 1).reshape(
        n, -1)
    cols = [xyz, np.zeros((n, 3), np.float32), dc, rest,
            np.asarray(opacity, np.float32).reshape(n, 1),
            np.asarray(scaling, np.float32),
            np.asarray(rotation, np.float32)]
    flat = np.concatenate(cols, axis=1)
    names = _attribute_names(rest.shape[1])
    dtype = [(nm, "<f4") for nm in names] + [("semantics", "<i4")]
    rec = np.empty(n, dtype=dtype)
    for i, nm in enumerate(names):
        rec[nm] = flat[:, i]
    rec["semantics"] = np.asarray(semantics, np.int32)

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}"]
        header += [f"property float {nm}" for nm in names]
        header += ["property int semantics", "end_header"]
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


def load_surfel_ply(path: str):
    """Read a reference-layout surfel PLY → dict of numpy arrays."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode("ascii").splitlines()
    if header[0] != "ply":
        raise ValueError(f"{path} is not a PLY file")
    fmt = [l for l in header if l.startswith("format")][0].split()[1]
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt}")
    n = int([l for l in header if l.startswith("element vertex")][0].split()[-1])
    type_map = {"float": "<f4", "float32": "<f4", "int": "<i4",
                "int32": "<i4", "double": "<f8", "uchar": "u1",
                "uint8": "u1", "uint": "<u4", "short": "<i2",
                "ushort": "<u2", "char": "i1"}
    props = []
    for l in header:
        if l.startswith("property"):
            _, t, nm = l.split()
            props.append((nm, type_map[t]))
    rec = np.frombuffer(data[head_end:], dtype=np.dtype(props), count=n)

    xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float32)
    dc_names = sorted([p for p, _ in props if p.startswith("f_dc_")],
                      key=lambda s: int(s.split("_")[-1]))
    rest_names = sorted([p for p, _ in props if p.startswith("f_rest_")],
                        key=lambda s: int(s.split("_")[-1]))
    dc = np.stack([rec[nm] for nm in dc_names], axis=1).astype(np.float32)
    out = dict(
        xyz=xyz,
        features_dc=dc.reshape(n, 3, 1).transpose(0, 2, 1),
        opacity=rec["opacity"].astype(np.float32).reshape(n, 1),
        scaling=np.stack([rec["scale_0"], rec["scale_1"]], 1).astype(np.float32),
        rotation=np.stack([rec[f"rot_{i}"] for i in range(4)], 1).astype(np.float32),
        semantics=(rec["semantics"].astype(np.int32)
                   if "semantics" in rec.dtype.names
                   else np.zeros(n, np.int32)),
    )
    if rest_names:
        rest = np.stack([rec[nm] for nm in rest_names], axis=1).astype(np.float32)
        k1 = len(rest_names) // 3
        out["features_rest"] = rest.reshape(n, 3, k1).transpose(0, 2, 1)
    else:
        out["features_rest"] = np.zeros((n, 0, 3), np.float32)
    return out


def state_to_ply(path: str, state, only_alive: bool = True) -> None:
    """Save a SurfelState (alive slots) in reference PLY format."""
    host = lambda t: t.detach().cpu().numpy()
    alive = host(state.alive)
    sel = alive if only_alive else np.ones_like(alive)
    p = state.params
    save_surfel_ply(path, host(p.xyz)[sel], host(p.features_dc)[sel],
                    host(p.features_rest)[sel], host(p.opacity)[sel],
                    host(p.scaling)[sel], host(p.rotation)[sel],
                    host(state.semantics)[sel])


def state_from_ply(path: str, spatial_scale: float = 1.0,
                   capacity: int | None = None, sh_degree: int = 3,
                   device="cuda"):
    """Load a reference-format PLY into a SurfelState on ``device``."""
    from ..models.gaussians import SurfelState, empty_params

    dev = resolve_device(device)
    d = load_surfel_ply(path)
    n = d["xyz"].shape[0]
    if capacity is None:
        capacity = int(n * 1.5)
    p = empty_params(capacity, sh_degree, dev)
    for name in ["xyz", "features_dc", "features_rest", "opacity",
                 "scaling", "rotation"]:
        buf = getattr(p, name)
        val = d[name]
        if name == "features_rest" and val.shape[1] != buf.shape[1]:
            k = min(val.shape[1], buf.shape[1])
            val = np.concatenate(
                [val[:, :k], np.zeros((n, buf.shape[1] - k, 3), np.float32)],
                1)
        buf[:n] = torch.as_tensor(np.ascontiguousarray(val))
    sem = torch.zeros(capacity, dtype=torch.int32, device=dev)
    sem[:n] = torch.as_tensor(np.ascontiguousarray(d["semantics"]))
    alive = torch.zeros(capacity, dtype=torch.bool, device=dev)
    alive[:n] = True
    z = lambda: torch.zeros(capacity, dtype=torch.float32, device=dev)
    return SurfelState(
        params=p, semantics=sem, alive=alive,
        max_radii2d=z(), grad_accum=z(), denom=z(),
        spatial_scale=torch.tensor(spatial_scale, dtype=torch.float32,
                                   device=dev),
        sh_degree=sh_degree)
