"""Fused MLP forward: the whole bias-free decoder chain as one CUDA kernel
(`csrc/fused_mlp.cu`), counterpart of the TPU kernel
`instantvnr_tpu/ops/pallas/fused_mlp.py::fused_mlp_apply` (inference form).

`fused_mlp_apply` launches the kernel for CUDA tensors and takes the plain
version, `fused_mlp_reference`, only for CPU tensors. It is forward-only
and refuses inputs that require grad: the training form (with residuals
and its matmul-chain backward) is a later item of the port.
"""
from __future__ import annotations

import torch

from instantvnr_torch.config import NetworkConfig
from instantvnr_torch.ops.cuda_lib import LaunchCounter
from instantvnr_torch.ops.mlp import activation_name, mlp_apply

_ACT_CODES = {"none": 0, "relu": 1, "sine": 2, "squareplus": 3}
_WIDTHS = (16, 32, 64, 128)

counter = LaunchCounter()


def fused_mlp_reference(params: list[torch.Tensor], x: torch.Tensor,
                        cfg: NetworkConfig) -> torch.Tensor:
    """Plain version: the plain MLP in bf16 compute, which rounds at the
    kernel's points (float32 matmuls on bf16-rounded operands; a bare
    bf16 @ bf16 would round its output)."""
    return mlp_apply(params, x, cfg, compute_dtype=torch.bfloat16)


def pack_weights(params: list[torch.Tensor]) -> torch.Tensor:
    """All weight matrices, row-major [fan_in, fan_out], as one bf16 buffer
    (the kernel's shared-memory image)."""
    return torch.cat([w.to(torch.bfloat16).reshape(-1) for w in params])


def fused_mlp_apply(params: list[torch.Tensor], x: torch.Tensor,
                    cfg: NetworkConfig) -> torch.Tensor:
    """x [B, n_in] → [B, n_out] float32."""
    if x.requires_grad or any(w.requires_grad for w in params):
        raise RuntimeError("fused_mlp_apply is forward-only; the training "
                           "form of the fused MLP is not ported yet")
    if x.device.type == "cpu":
        return fused_mlp_reference(params, x, cfg)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n_hidden = len(params) - 1
    b, n_in = x.shape
    n_out = params[-1].shape[1]
    width = params[0].shape[1] if n_hidden > 0 else _WIDTHS[0]
    if width not in _WIDTHS or n_in > 128 or any(
            w.device != x.device for w in params):
        raise ValueError(
            f"fused_mlp kernel takes hidden widths {_WIDTHS} and n_in ≤ 128 "
            f"on the input's device (got width {width}, n_in {n_in})")
    for w in params[1:-1]:
        if tuple(w.shape) != (width, width):
            raise ValueError("hidden weight matrices must be [width, width]")
    from instantvnr_torch.ops.cuda_lib import load_library

    lib = load_library()
    xb = x.to(torch.bfloat16).contiguous()
    wb = pack_weights(params)
    y = torch.empty((b, n_out), dtype=torch.float32, device=x.device)
    lib.call("fused_mlp_forward", xb.data_ptr(), wb.data_ptr(), y.data_ptr(),
             b, n_in, width, n_hidden, n_out,
             _ACT_CODES[activation_name(cfg.activation)],
             _ACT_CODES[activation_name(cfg.output_activation)],
             torch.cuda.current_stream(x.device).cuda_stream)
    counter.launches += 1
    return y
