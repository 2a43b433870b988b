"""The model, plain: the multi-resolution hash grid with a bias-free MLP
(tiny-cuda-nn's HashGrid + FullyFusedMLP, the upstream's
example-model.json).

A configuration's compute type is made explicit: `rounding(dtype)` gives
a function that rounds a float32 tensor to that type and back, with an
identity gradient, so that the forward rounds the MLP's operands as the
configuration states while every sum, every gradient and the optimizer
stay in float32. The control swaps bfloat16 for float8 (e4m3).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
CORNERS = tuple(((c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1) for c in range(8))

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32, "float8_e4m3": torch.float8_e4m3fn}


def rounding(dtype_name: str):
    """x ↦ x rounded to `dtype_name` and back to float32, gradient 1."""
    dtype = DTYPES[dtype_name]
    if dtype == torch.float32:
        return lambda x: x

    def rnd(x):
        r = x.detach().to(dtype).to(torch.float32)
        return x + (r - x).detach() if x.requires_grad else r

    return rnd


def activation(name: str, h: torch.Tensor) -> torch.Tensor:
    n = name.lower()
    if n == "relu":
        return torch.clamp(h, min=0.0)
    if n in ("none", "linear", "identity"):
        return h
    raise ValueError(f"no reference for the activation {name}")


def mlp_widths(n_input: int, net: dict) -> list:
    return [n_input] + [int(net["n_neurons"])] * int(
        net["n_hidden_layers"]) + [1]


def mlp(weights: list, x: torch.Tensor, net: dict, rnd) -> torch.Tensor:
    """Bias-free MLP, operands rounded by `rnd`, float32 sums → [B, 1]."""
    h = rnd(x)
    for w in weights[:-1]:
        h = rnd(activation(net["activation"], h @ rnd(w)))
    return activation(net.get("output_activation", "None"),
                      h @ rnd(weights[-1]))


# -- the hash grid ------------------------------------------------------------


@dataclass(frozen=True)
class GridSpec:
    n_levels: int
    n_features: int
    log2_hashmap_size: int
    base_resolution: int
    per_level_scale: float

    @classmethod
    def from_config(cls, cfg: dict) -> "GridSpec":
        e = cfg["encoding"]
        return cls(int(e["n_levels"]), int(e["n_features_per_level"]),
                   int(e["log2_hashmap_size"]), int(e["base_resolution"]),
                   float(e["per_level_scale"]))

    @property
    def scales(self):
        l2 = math.log2(self.per_level_scale)
        return [2.0 ** (l * l2) * self.base_resolution - 1.0
                for l in range(self.n_levels)]

    @property
    def resolutions(self):
        return [int(math.ceil(s)) + 1 for s in self.scales]

    @property
    def sizes(self):
        cap = 1 << self.log2_hashmap_size
        return [-(-min(r ** 3, cap) // 8) * 8 for r in self.resolutions]

    @property
    def offsets(self):
        out = [0]
        for s in self.sizes:
            out.append(out[-1] + s)
        return out

    @property
    def n_entries(self) -> int:
        return self.offsets[-1]

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features


def grid_corners(spec: GridSpec, coords: torch.Tensor):
    """Table rows [B, L·8] (int64) and trilinear weights [B, L·8] of coords
    [B, 3] in [0,1]³: x = p·scale + 0.5, cell = floor(x); dense levels by
    stride, the others by tcnn's prime-XOR hash mod the level's size."""
    dev = coords.device
    corners = torch.tensor(CORNERS, dtype=torch.int64, device=dev)
    idx_parts, w_parts = [], []
    for lvl in range(spec.n_levels):
        res, size = spec.resolutions[lvl], spec.sizes[lvl]
        x = coords * float(np.float32(spec.scales[lvl])) + 0.5
        cell = torch.floor(x)
        frac = x - cell
        pos = cell.to(torch.int64)[:, None, :] + corners[None]
        if res ** 3 <= size:
            idx = pos[..., 0] + pos[..., 1] * res + pos[..., 2] * (res * res)
        else:
            idx = (((pos[..., 0] * _PRIMES[0]) & _U32)
                   ^ ((pos[..., 1] * _PRIMES[1]) & _U32)
                   ^ ((pos[..., 2] * _PRIMES[2]) & _U32))
        idx_parts.append((idx & _U32) % size + spec.offsets[lvl])
        cw = torch.where(corners[None] == 0, 1.0 - frac[:, None, :],
                         frac[:, None, :])
        w_parts.append(cw[..., 0] * cw[..., 1] * cw[..., 2])
    return torch.cat(idx_parts, 1), torch.cat(w_parts, 1)


def grid_encode(table, coords, spec: GridSpec, rnd) -> torch.Tensor:
    """[B, L·F]: each corner's row times its weight, the operands rounded
    by `rnd`, summed in float32."""
    b = coords.shape[0]
    idx, w = grid_corners(spec, coords)
    rows = rnd(table[idx])  # [B, L·8, F]
    feats = (rows * rnd(w)[..., None]).reshape(
        b, spec.n_levels, 8, spec.n_features).sum(2)
    return feats.reshape(b, spec.n_output_dims)


class HashGridModel:
    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.spec = GridSpec.from_config(cfg)
        self.net = cfg["network"]

    def widths(self):
        return mlp_widths(self.spec.n_output_dims, self.net)

    def leaf_shapes(self):
        w = self.widths()
        return [(self.spec.n_entries, self.spec.n_features)] + [
            (a, c) for a, c in zip(w[:-1], w[1:])]

    def init(self, gen: torch.Generator, device) -> list:
        """tcnn's initialization: the table uniform in ±1e-4, the MLP
        He-normal; one draw for the table, one for the MLP."""
        t = torch.rand(self.leaf_shapes()[0], generator=gen, device=device)
        table = t * 2e-4 - 1e-4
        return [table] + self._mlp_init(gen, device)

    def init_serving(self, gen: torch.Generator, device) -> list:
        """A field that draws something: the table uniform in ±1 (an
        untrained ±1e-4 table decodes to a transparent frame), the MLP
        He-normal."""
        t = torch.rand(self.leaf_shapes()[0], generator=gen, device=device)
        return [t * 2.0 - 1.0] + self._mlp_init(gen, device)

    def _mlp_init(self, gen, device):
        shapes = self.leaf_shapes()[1:]
        flat = torch.randn(sum(a * c for a, c in shapes), generator=gen,
                           device=device)
        out, i = [], 0
        for a, c in shapes:
            out.append(flat[i:i + a * c].reshape(a, c) * math.sqrt(2.0 / a))
            i += a * c
        return out

    def l2_leaves(self) -> list:
        """Where l2_reg applies: the MLP's matrices, not the table."""
        return [False] + [True] * (len(self.leaf_shapes()) - 1)

    def apply(self, leaves, coords, rnd) -> torch.Tensor:
        feats = grid_encode(leaves[0], coords, self.spec, rnd)
        return mlp(leaves[1:], feats, self.net, rnd)

    def mlp_macs(self) -> int:
        w = self.widths()
        return sum(a * c for a, c in zip(w[:-1], w[1:]))


def model_for(cfg: dict):
    if cfg.get("encoding", {}).get("otype") != "HashGrid":
        raise ValueError("the reference holds the hash-grid family only")
    return HashGridModel(cfg)
