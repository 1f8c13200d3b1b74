"""Sky / environment model (counterpart of ``streetunveiler_tpu/models/
sky.py``): a learned per-ray sky colour composited behind the surfels,
``image = render + sky·(1 − α)``.

Encoders, concatenated and fed to a width-64 ReLU MLP with a sigmoid:

* the ray direction → real SH basis, ``sh_bands`` = 3: 16 features
  (``ops/sh.sh_basis``, on the unnormalized direction);
* the camera origin → a multiresolution hash grid, 16 levels × 2 features,
  2^16 entries a level, base resolution 16, growth 2: 32 features;
* the camera origin → a frequency embedding, 10 octaves with the input:
  63 features.

Weights keep the JAX package's ``[in, out]`` layout (``h @ w + b``), so
parameters convert leaf for leaf (``convert.sky_from_arrays``). The hash
reproduces the JAX package's int32 arithmetic exactly: coordinates and
primes are int32, products wrap, ``abs`` keeps INT_MIN, the modulo floors.

Every ray of a camera starts at the same origin ``c2w[:3, 3]``, so
``render_sky`` encodes that origin once and adds its share of the first
layer (``o_enc @ w0[16:]``) to every ray: the same function as
``sky_forward`` on broadcast origins, whose gradient to the hash table is
the same sum taken as one reduction instead of H·W scattered adds onto
the same 8 rows a level.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from ..ops.sh import sh_basis

# spatial-hash primes (instant-ngp), as int32 values
HASH_PRIMES = (1, 2654435761 - 2 ** 32, 805459861)
_INT32_MIN = -2 ** 31


@dataclasses.dataclass(frozen=True)
class SkyParams:
    hash_tables: torch.Tensor   # [L, 2^log2_size, F]
    mlp_w: tuple                # weights [in, out]
    mlp_b: tuple                # biases [out]
    num_levels: int = 16
    base_res: int = 16
    growth: float = 2.0
    sh_bands: int = 3

    def named_tensors(self) -> dict:
        """The tensors under the JAX package's leaf paths (``.hash_tables``,
        ``.mlp_w[0]``, …, ``.mlp_b[0]``, …), in its leaf order."""
        out = {".hash_tables": self.hash_tables}
        out.update({f".mlp_w[{i}]": w for i, w in enumerate(self.mlp_w)})
        out.update({f".mlp_b[{i}]": b for i, b in enumerate(self.mlp_b)})
        return out

    def map(self, fn) -> "SkyParams":
        """The same structure with ``fn`` applied to every tensor."""
        return dataclasses.replace(
            self, hash_tables=fn(self.hash_tables),
            mlp_w=tuple(fn(w) for w in self.mlp_w),
            mlp_b=tuple(fn(b) for b in self.mlp_b))

    def to(self, device) -> "SkyParams":
        return self.map(lambda t: t.to(device))


def init_sky(generator: torch.Generator | None = None, num_levels=16,
             features_per_level=2, log2_size=16, base_res=16, growth=2.0,
             width=64, depth=3, sh_bands=3, device="cuda") -> SkyParams:
    """Hash tables ~ U(−1e-4, 1e-4), weights ~ N(0, 2/fan_in), zero
    biases, drawn on the CPU from ``generator`` (a CPU
    ``torch.Generator``) and moved to ``device``. sh_bands = 3 gives 16
    direction features."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    tables = (torch.rand((num_levels, 2 ** log2_size, features_per_level),
                         generator=generator) * 2.0 - 1.0) * 1e-4
    in_dim = (sh_bands + 1) ** 2 + num_levels * features_per_level + 63
    dims = [in_dim] + [width] * depth + [3]
    ws = tuple(torch.randn((dims[i], dims[i + 1]), generator=generator)
               * (2.0 / dims[i]) ** 0.5 for i in range(len(dims) - 1))
    bs = tuple(torch.zeros(dims[i + 1]) for i in range(len(dims) - 1))
    return SkyParams(hash_tables=tables, mlp_w=ws, mlp_b=bs,
                     num_levels=num_levels, base_res=base_res,
                     growth=growth, sh_bands=sh_bands).to(dev)


def freq_embed(x, num_freqs: int = 10):
    """Log-sampled positional encoding with the input: [..., 3] →
    [..., 3 + 6·num_freqs]."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    ang = x[..., None, :] * freqs[:, None]                 # [..., F, 3]
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], dim=-1)


def _wrap32(v):
    """int64 tensor → the int32 value with the same low 32 bits."""
    return ((v - _INT32_MIN) & 0xFFFFFFFF) + _INT32_MIN


def hash_encode(params: SkyParams, x):
    """Multiresolution hash-grid lookup with trilinear interpolation.

    x: [..., 3] raw world coordinates (the hash wraps any range). Returns
    [..., L·F]. The grid coordinate converts to int32 as XLA converts
    (saturating, NaN → 0); the int32 arithmetic then runs in int64 and is
    wrapped back to int32 after every step that can overflow."""
    n_levels, table_size, n_feat = params.hash_tables.shape
    dev = x.device
    # every level and corner at once (a loop over them launches thousands
    # of tiny kernels on a card): [..., L, 3] grid coordinates, then
    # [..., L, 8, 3] corners
    res = torch.tensor([params.base_res * params.growth ** level
                        for level in range(n_levels)], dtype=x.dtype,
                       device=dev)
    scaled = x[..., None, :] * res[:, None]
    base = torch.floor(scaled)
    frac = scaled - base
    base = torch.nan_to_num(base, nan=0.0).clamp(-2.0 ** 31, 2.0 ** 31)
    base = base.to(torch.int64).clamp(_INT32_MIN, 2 ** 31 - 1)
    off = torch.tensor([[(corner >> k) & 1 for k in range(3)]
                        for corner in range(8)], device=dev)   # [8, 3]
    c = _wrap32(base[..., None, :] + off)
    primes = torch.tensor(HASH_PRIMES, dtype=torch.int64, device=dev)
    hk = _wrap32(c * primes)
    h = hk[..., 0] ^ hk[..., 1] ^ hk[..., 2]                   # [..., L, 8]
    h = torch.where(h == _INT32_MIN, h, h.abs())               # int32 abs
    idx = torch.remainder(h, table_size) + table_size * torch.arange(
        n_levels, device=dev)[:, None]
    f = frac[..., None, :]
    w = torch.where(off.bool(), f, 1.0 - f).prod(dim=-1)      # [..., L, 8]
    feats = params.hash_tables.reshape(-1, n_feat)[idx]       # [..., L, 8, F]
    out = (w[..., None] * feats).sum(dim=-2)                  # [..., L, F]
    return out.reshape(*x.shape[:-1], n_levels * n_feat)


def _mlp_tail(params: SkyParams, h):
    """Layers 1.. of the MLP on the first layer's pre-activation, then the
    sigmoid."""
    for w, b in zip(params.mlp_w[1:], params.mlp_b[1:]):
        h = torch.relu(h) @ w + b
    return torch.sigmoid(h)


def sky_forward(params: SkyParams, dirs, origins):
    """dirs/origins [..., 3] → RGB [..., 3] in (0, 1)."""
    d_enc = sh_basis(dirs, params.sh_bands)
    h_enc = hash_encode(params, origins)
    p_enc = freq_embed(origins)
    h = torch.cat([d_enc, h_enc, p_enc], dim=-1)
    return _mlp_tail(params, h @ params.mlp_w[0] + params.mlp_b[0])


def camera_rays(height: int, width: int, K, c2w):
    """Per-pixel rays (origins, directions) [H, W, 3]: direction
    ((i − cx)/fx, −(j − cy)/fy, −1) rotated by c2w, unnormalized."""
    dev = c2w.device
    j, i = torch.meshgrid(torch.arange(height, dtype=torch.float32,
                                       device=dev),
                          torch.arange(width, dtype=torch.float32,
                                       device=dev), indexing="ij")
    dirs = torch.stack([(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1],
                        -torch.ones_like(i)], dim=-1)
    # a 3-wide contraction as products and sums: full f32 whatever the
    # TF32 flags say
    rays_d = (dirs[..., None, :] * c2w[:3, :3]).sum(dim=-1)
    rays_o = c2w[:3, 3].expand_as(rays_d)
    return rays_o, rays_d


def render_sky(params: SkyParams, height: int, width: int, K, c2w):
    """[H, W, 3] sky image for a camera: ``sky_forward`` over
    ``camera_rays``, with the shared origin encoded once."""
    _, rays_d = camera_rays(height, width, K, c2w)
    origin = c2w[None, :3, 3]
    o_enc = torch.cat([hash_encode(params, origin), freq_embed(origin)],
                      dim=-1)                                 # [1, L·F + 63]
    d_enc = sh_basis(rays_d, params.sh_bands)                 # [H, W, 16]
    w0 = params.mlp_w[0]
    n_d = d_enc.shape[-1]
    h = d_enc @ w0[:n_d] + (o_enc @ w0[n_d:] + params.mlp_b[0])[0]
    return _mlp_tail(params, h)
