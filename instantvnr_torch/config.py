"""Typed configuration: the tcnn model schema, transfer-function and camera
configs, and the reference's compile-time constants.

Counterpart of `instantvnr_tpu/config.py`, restricted to what the decode +
slab-render path needs. The JAX package's TPU dispatch knobs (`mlp_impl`,
`grid_grad_impl`, `grid_fwd_impl`) have no counterpart: in this package the
device of a tensor decides between a CUDA kernel and its plain version.
"""
from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Any

MACROCELL_SIZE_MIP = 4  # cell = 2^4 = 16 voxels/side (reference CMakeLists.txt:61)
NEARLY_ONE = 0.9999  # early-termination opacity (reference instantvnr_types.h:160)


def env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default

_COMMENT_RE = re.compile(r'("(?:[^"\\]|\\.)*")|(//[^\n]*)|(/\*.*?\*/)', re.S)


def loads_relaxed_json(text: str) -> Any:
    """json.loads with //-style and /* */ comments stripped (outside strings)."""

    def repl(m: re.Match) -> str:
        return m.group(1) if m.group(1) is not None else ""

    return json.loads(_COMMENT_RE.sub(repl, text))


@dataclass(frozen=True)
class EncodingConfig:
    """HashGrid encoding (reference example-model.json:19-25, tcnn semantics)."""

    otype: str = "HashGrid"
    n_levels: int = 8
    n_features_per_level: int = 8
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 2.0
    interpolation: str = "Linear"
    # only the tcnn spatial hash is ported; "paired" is a later item
    hash_variant: str = "tcnn"

    def __post_init__(self):
        if self.hash_variant not in ("tcnn", "paired"):
            raise ValueError(f"hash_variant={self.hash_variant!r}; "
                             "expected 'tcnn' or 'paired'")

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level


@dataclass(frozen=True)
class NetworkConfig:
    """Bias-free MLP (reference example-model.json:26-32): n_hidden_layers
    hidden layers of n_neurons, so n_hidden_layers+1 weight matrices."""

    otype: str = "FullyFusedMLP"
    activation: str = "ReLU"
    n_neurons: int = 64
    n_hidden_layers: int = 4
    output_activation: str = "None"


@dataclass(frozen=True)
class OptimizerConfig:
    """Adam in ExponentialDecay wrapper (reference example-model.json:2-15)."""

    otype: str = "ExponentialDecay"
    decay_start: int = 2000
    decay_interval: int = 1000
    decay_base: float = 0.99
    learning_rate: float = 5e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-15
    l2_reg: float = 1e-6


@dataclass(frozen=True)
class LossConfig:
    otype: str = "L1"


@dataclass(frozen=True)
class ModelConfig:
    encoding: EncodingConfig = field(default_factory=EncodingConfig)
    network: NetworkConfig = field(default_factory=NetworkConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    compute_dtype: str = "bfloat16"  # params stay float32; compute casts

    def to_json(self) -> dict:
        """Serialize back to the tcnn-compatible schema (for checkpoints)."""
        return {
            "optimizer": {
                "otype": self.optimizer.otype,
                "decay_start": self.optimizer.decay_start,
                "decay_interval": self.optimizer.decay_interval,
                "decay_base": self.optimizer.decay_base,
                "nested": {
                    "otype": "Adam",
                    "learning_rate": self.optimizer.learning_rate,
                    "beta1": self.optimizer.beta1,
                    "beta2": self.optimizer.beta2,
                    "epsilon": self.optimizer.epsilon,
                    "l2_reg": self.optimizer.l2_reg,
                },
            },
            "loss": {"otype": self.loss.otype},
            "encoding": {
                "otype": self.encoding.otype,
                "n_levels": self.encoding.n_levels,
                "n_features_per_level": self.encoding.n_features_per_level,
                "log2_hashmap_size": self.encoding.log2_hashmap_size,
                "base_resolution": self.encoding.base_resolution,
                "per_level_scale": self.encoding.per_level_scale,
                **({"hash_variant": self.encoding.hash_variant}
                   if self.encoding.hash_variant != "tcnn" else {}),
            },
            "network": {
                "otype": self.network.otype,
                "activation": self.network.activation,
                "n_neurons": self.network.n_neurons,
                "n_hidden_layers": self.network.n_hidden_layers,
                "output_activation": self.network.output_activation,
            },
        }


def model_config_from_dict(cfg: dict) -> ModelConfig:
    enc = cfg.get("encoding", {})
    net = cfg.get("network", {})
    opt = cfg.get("optimizer", {})
    loss = cfg.get("loss", {})
    nested = opt.get("nested", opt)
    return ModelConfig(
        encoding=EncodingConfig(
            otype=enc.get("otype", "HashGrid"),
            n_levels=int(enc.get("n_levels", 8)),
            n_features_per_level=int(enc.get("n_features_per_level", 8)),
            log2_hashmap_size=int(enc.get("log2_hashmap_size", 19)),
            base_resolution=int(enc.get("base_resolution", 16)),
            per_level_scale=float(enc.get("per_level_scale", 2.0)),
            interpolation=enc.get("interpolation", "Linear"),
            hash_variant=enc.get("hash_variant", "tcnn"),
        ),
        network=NetworkConfig(
            otype=net.get("otype", "FullyFusedMLP"),
            activation=net.get("activation", "ReLU"),
            n_neurons=int(net.get("n_neurons", 64)),
            n_hidden_layers=int(net.get("n_hidden_layers", 4)),
            output_activation=net.get("output_activation", "None"),
        ),
        optimizer=OptimizerConfig(
            otype=opt.get("otype", "ExponentialDecay"),
            decay_start=int(opt.get("decay_start", 2000)),
            decay_interval=int(opt.get("decay_interval", 1000)),
            decay_base=float(opt.get("decay_base", 0.99)),
            learning_rate=float(nested.get("learning_rate", 5e-3)),
            beta1=float(nested.get("beta1", 0.9)),
            beta2=float(nested.get("beta2", 0.999)),
            epsilon=float(nested.get("epsilon", 1e-15)),
            l2_reg=float(nested.get("l2_reg", 1e-6)),
        ),
        loss=LossConfig(otype=loss.get("otype", "L1")),
    )


def load_model_config(path_or_dict) -> ModelConfig:
    if isinstance(path_or_dict, dict):
        return model_config_from_dict(path_or_dict)
    with open(path_or_dict) as f:
        return model_config_from_dict(loads_relaxed_json(f.read()))


@dataclass(frozen=True)
class CameraConfig:
    """Look-at camera (reference serializer.cpp:178-187)."""

    eye: tuple[float, float, float] = (0.0, 0.0, -3.0)
    center: tuple[float, float, float] = (0.0, 0.0, 0.0)
    up: tuple[float, float, float] = (0.0, 1.0, 0.0)
    fovy: float = 60.0  # degrees


@dataclass(frozen=True)
class TransferFunctionConfig:
    """Piecewise-linear color + opacity control points over a value range
    (reference serializer.cpp:190-250 → tfn module)."""

    # (position in [0,1], r, g, b) control points
    colors: tuple = ((0.0, 0.0, 0.0, 1.0), (1.0, 1.0, 0.0, 0.0))
    # (position in [0,1], alpha) control points
    alphas: tuple = ((0.0, 0.0), (1.0, 1.0))
    range: tuple[float, float] = (0.0, 1.0)  # value range in DATA units
