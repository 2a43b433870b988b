"""fV-SRN, the second model family (counterpart of
`instantvnr_tpu/models/fvsrn.py`; the reference's `FvsrnNetwork`,
`core/networks/fvsrn_network.cu:1-162`, `fvsrn_network.h:20-57`).

A volume field from a dense LATENT GRID (a feature volume read
trilinearly), FOURIER features of the position and an MLP with the SnakeAlt
activation: the architecture of Weiss et al.'s fV-SRN, behind the same
(field, params) interface as the hash-grid field, so the shared trainer,
metrics, decoder and renderers take it unchanged (`apply_params` is the
dispatch point of models/network.py::network_apply).

The forward is plain PyTorch on every device, and this is no fallback:
the JAX package's `FvsrnField.apply_params` never reaches its Pallas MLP
either, it runs `mlp_apply` or `_mlp_apply_bias` (bf16 operands, float32
sums) in XLA. So the port runs `torch.matmul` on bf16-rounded operands in
float32 (ops/mlp.py), and the latent lookup is a trilinear gather
(`table[idx]` under autograd). There is no kernel for it in either
package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field as dfield

import numpy as np
import torch

from instantvnr_torch.config import LossConfig, NetworkConfig, OptimizerConfig
from instantvnr_torch.ops.mlp import (activation_name, apply_activation,
                                      init_mlp_params, mlp_apply,
                                      mlp_n_params)
from instantvnr_torch.utils.device import device_constant

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
_CORNER_TUPLES = tuple(((c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1)
                       for c in range(8))


@dataclass(frozen=True)
class FvsrnConfig:
    """Architecture knobs (the fV-SRN defines fvsrn_network.cu:85-130
    reads: grid resolution and channels, Fourier bands, hidden width)."""

    latent_res: tuple[int, int, int] = (32, 32, 32)  # (x, y, z)
    latent_features: int = 16
    fourier_bands: int = 14  # sin/cos pairs per axis, log-linear
    network: NetworkConfig = dfield(default_factory=lambda: NetworkConfig(
        n_neurons=64, n_hidden_layers=4, activation="SnakeAlt"))
    optimizer: OptimizerConfig = dfield(default_factory=OptimizerConfig)
    loss: LossConfig = dfield(default_factory=LossConfig)
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        # a trilinear cell needs 2 nodes an axis: _latent_interp clamps the
        # cell to res − 2, which is −1 on a 1-node axis
        if min(self.latent_res) < 2:
            raise ValueError(
                f"latent_res must be >= 2 per axis, got {self.latent_res}")

    def to_json(self) -> dict:
        """The native checkpoint's model document, the JAX package's
        (serializer.py:215: the family tag, then dataclasses.asdict)."""
        import dataclasses

        return {"family": "fvsrn", **dataclasses.asdict(self)}

    @classmethod
    def from_json(cls, doc: dict) -> "FvsrnConfig":
        return cls(latent_res=tuple(int(r) for r in doc["latent_res"]),
                   latent_features=int(doc["latent_features"]),
                   fourier_bands=int(doc["fourier_bands"]),
                   network=NetworkConfig(**doc["network"]),
                   optimizer=OptimizerConfig(**doc["optimizer"]),
                   loss=LossConfig(**doc["loss"]),
                   compute_dtype=doc["compute_dtype"])


@dataclass(frozen=True)
class FvsrnField:
    """Static field description."""

    cfg: FvsrnConfig

    @classmethod
    def from_config(cls, cfg: FvsrnConfig | None = None) -> "FvsrnField":
        return cls(cfg=cfg or FvsrnConfig())

    @property
    def n_input_dims(self) -> int:
        return 3

    @property
    def n_output_dims(self) -> int:
        return 1

    @property
    def n_latent(self) -> int:
        rx, ry, rz = self.cfg.latent_res
        return rx * ry * rz

    @property
    def mlp_input_dims(self) -> int:
        return self.cfg.latent_features + 6 * self.cfg.fourier_bands

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.compute_dtype]

    @property
    def n_params(self) -> int:
        return (self.n_latent * self.cfg.latent_features
                + mlp_n_params(self.cfg.network, self.mlp_input_dims, 1))

    def init(self, generator: torch.Generator, device="cuda") -> dict:
        """A latent grid of small normals (1e-2) and a He-normal MLP, drawn
        on the generator's device."""
        table = 1e-2 * torch.randn(
            (self.n_latent, self.cfg.latent_features), generator=generator,
            dtype=torch.float32, device=generator.device)
        mlp = init_mlp_params(generator, n_input=self.mlp_input_dims,
                              cfg=self.cfg.network, n_output=1, device=device)
        return {"table": table.to(device), "mlp": mlp}

    def apply_params(self, params: dict, coords: torch.Tensor
                     ) -> torch.Tensor:
        """coords [B, 3] in [0,1]³ → values [B, 1] float32.

        Imported checkpoints (models/fvsrn_import.py) may carry two more
        entries: "fourier", an [M, 3] frequency matrix whose features
        [sin(2π·F·p), cos(2π·F·p)] replace the log-linear bands, and
        "bias", per-layer bias vectors (nn.Linear has them; the native MLP
        has none)."""
        lat = _latent_interp(params["table"], coords, self.cfg.latent_res)
        if "fourier" in params:
            four = _fourier_matrix_features(coords, params["fourier"])
        else:
            four = _fourier_features(coords, self.cfg.fourier_bands)
        x = torch.cat([lat, four], dim=-1)
        if "bias" in params:
            return _mlp_apply_bias(params["mlp"], params["bias"], x,
                                   self.cfg.network, self.compute_dtype)
        return mlp_apply(params["mlp"], x, self.cfg.network,
                         compute_dtype=self.compute_dtype)

    def apply(self, params: dict, coords: torch.Tensor) -> torch.Tensor:
        return self.apply_params(params, coords)


def _latent_interp(table: torch.Tensor, coords: torch.Tensor,
                   res: tuple[int, int, int]) -> torch.Tensor:
    """Trilinear interpolation of the latent grid [rx·ry·rz, F], nodes
    spanning [0,1] inclusive (fvsrn_network.cu:22-27), one 8-corner gather
    → [B, F] float32."""
    rx, ry, rz = res
    dev = coords.device
    x = torch.clamp(coords.to(torch.float32), 0.0, 1.0) * device_constant(
        (rx - 1.0, ry - 1.0, rz - 1.0), torch.float32, dev)
    cell = torch.minimum(
        torch.clamp(torch.floor(x).to(torch.int64), min=0),
        device_constant((rx - 2, ry - 2, rz - 2), torch.int64, dev))
    frac = x - cell.to(torch.float32)
    corners = device_constant(_CORNER_TUPLES, torch.int64, dev)
    pos = cell[:, None, :] + corners[None]  # [B, 8, 3]
    idx = (pos[..., 2] * ry + pos[..., 1]) * rx + pos[..., 0]
    cw = torch.where(corners[None] == 0, 1.0 - frac[:, None, :],
                     frac[:, None, :])
    w = cw[..., 0] * cw[..., 1] * cw[..., 2]  # [B, 8]
    return (table[idx] * w[..., None]).sum(dim=1)


def _fourier_matrix_features(coords: torch.Tensor,
                             fmat: torch.Tensor) -> torch.Tensor:
    """[sin(2π·F·p), cos(2π·F·p)] of an [M, 3] frequency matrix over the
    raw [0,1] coords → [B, 2M]."""
    ang = 2.0 * math.pi * (coords.to(torch.float32) @ fmat.to(
        torch.float32).T)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _mlp_apply_bias(weights: list, biases: list, x: torch.Tensor,
                    cfg: NetworkConfig, compute_dtype) -> torch.Tensor:
    """ops/mlp.py::mlp_apply with per-layer biases (nn.Linear's convention,
    imported checkpoints): operands rounded to the compute type, float32
    sums, the bias added in float32, the activation, the round back."""
    f32 = torch.float32
    act, out_act = (activation_name(cfg.activation),
                    activation_name(cfg.output_activation))
    h = x.to(compute_dtype)
    for w, b in zip(weights[:-1], biases[:-1]):
        h = torch.matmul(h.to(f32), w.to(compute_dtype).to(f32)) + b.to(f32)
        h = apply_activation(h, act).to(compute_dtype)
    y = torch.matmul(h.to(f32), weights[-1].to(compute_dtype).to(f32)) \
        + biases[-1].to(f32)
    return apply_activation(y, out_act)


def _fourier_features(coords: torch.Tensor, bands: int) -> torch.Tensor:
    """NeRF's log-linear features of the [-1,1]-mapped position,
    sin/cos(2^i·π·p) per axis (fV-SRN's default Fourier matrix) →
    [B, 6·bands]."""
    p = 2.0 * coords.to(torch.float32) - 1.0
    freqs = torch.as_tensor(np.asarray([2.0 ** i * math.pi
                                        for i in range(bands)], np.float32),
                            device=coords.device)
    ang = p[:, :, None] * freqs[None, None, :]  # [B, 3, bands]
    out = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return out.reshape(coords.shape[0], 6 * bands)
