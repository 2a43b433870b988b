"""The decoder MLP, plain PyTorch (counterpart of `instantvnr_tpu/ops/mlp.py`).

tcnn FullyFusedMLP semantics: no biases; n_hidden_layers hidden layers of
n_neurons, so n_hidden_layers+1 weight matrices [fan_in, fan_out].

Numerics follow the JAX package: operands rounded to the compute dtype,
the product accumulated in float32, the activation applied, then rounded
back to the compute dtype; the last layer stays float32. A bare
`bf16 @ bf16` in torch would round its output to bf16, so every product
here is a float32 matmul of rounded operands.
"""
from __future__ import annotations

import torch

from instantvnr_torch.config import NetworkConfig


def mlp_widths(cfg: NetworkConfig, n_input: int, n_output: int = 1) -> list[int]:
    """The single source of truth for the weight-matrix layout."""
    return [n_input] + [cfg.n_neurons] * cfg.n_hidden_layers + [n_output]


def mlp_n_params(cfg: NetworkConfig, n_input: int, n_output: int = 1) -> int:
    widths = mlp_widths(cfg, n_input, n_output)
    return sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def init_mlp_params(generator: torch.Generator, n_input: int,
                    cfg: NetworkConfig, n_output: int = 1, device="cuda",
                    dtype=torch.float32) -> list[torch.Tensor]:
    """He-normal init (std = sqrt(2/fan_in)), drawn on the generator's
    device."""
    widths = mlp_widths(cfg, n_input, n_output)
    params = []
    for fan_in, fan_out in zip(widths[:-1], widths[1:]):
        std = (2.0 / fan_in) ** 0.5
        w = torch.randn((fan_in, fan_out), generator=generator,
                        dtype=torch.float32, device=generator.device) * std
        params.append(w.to(device=device, dtype=dtype))
    return params


_ACTIVATIONS = ("relu", "sine", "squareplus", "snakealt", "none")


def activation_name(name: str) -> str:
    """Canonical lower-case activation name; raises on unsupported ones."""
    n = name.lower()
    if n in ("linear", "identity"):
        n = "none"
    if n not in _ACTIVATIONS:
        raise ValueError(f"unsupported activation: {name}")
    return n


def apply_activation(h: torch.Tensor, name: str) -> torch.Tensor:
    name = activation_name(name)
    if name == "relu":
        return torch.clamp(h, min=0.0)
    if name == "sine":
        return torch.sin(h)
    if name == "squareplus":
        return 0.5 * (h + torch.sqrt(h * h + 4.0))
    if name == "snakealt":
        # fV-SRN's periodic activation, (x + 1 − cos 2x)/2
        return 0.5 * (h + 1.0 - torch.cos(2.0 * h))
    return h


def mlp_apply(params: list[torch.Tensor], x: torch.Tensor, cfg: NetworkConfig,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x [B, n_input] → [B, n_output] float32."""
    h = x.to(compute_dtype)
    for w in params[:-1]:
        h = torch.matmul(h.to(torch.float32),
                         w.to(compute_dtype).to(torch.float32))
        h = apply_activation(h, cfg.activation).to(compute_dtype)
    y = torch.matmul(h.to(torch.float32),
                     params[-1].to(compute_dtype).to(torch.float32))
    return apply_activation(y, cfg.output_activation)
