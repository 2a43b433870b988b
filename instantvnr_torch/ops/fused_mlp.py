"""Fused MLP: the whole bias-free decoder chain as CUDA kernels
(`csrc/fused_mlp.cu`), counterpart of the TPU kernel
`instantvnr_tpu/ops/pallas/fused_mlp.py`.

`fused_mlp_apply` launches a kernel for CUDA tensors and takes the plain
version only for CPU tensors:

- inference (no input requires grad): one kernel with the output
  activation applied in the kernel (`fused_mlp_forward`; plain version
  `fused_mlp_reference`);
- training (an input requires grad): the TPU kernel's `custom_vjp`
  (`_fwd`/`_bwd`, `fused_mlp.py:177-232`) as a `torch.autograd.Function`.
  Its forward kernel (`fused_mlp_train_forward`) also writes the f32
  pre-activation of every hidden layer and leaves the output activation to
  the caller; its backward kernel (`fused_mlp_backward`) runs the matmul
  chain from those residuals with no forward recompute, with the hidden
  activations rebuilt as bf16(act(z)) and the cotangent chain and the
  weight gradients in float32. The plain version of both is
  `fused_mlp_train_reference`, which mirrors `_fwd`/`_bwd` in eager
  PyTorch (it is not autograd of `mlp_apply`, whose casts would round the
  cotangents to bf16). A single weight matrix needs no residuals: the
  backward then reads only the output pre-activation.
"""
from __future__ import annotations

import torch

from instantvnr_torch.config import NetworkConfig
from instantvnr_torch.ops import cuda_lib
from instantvnr_torch.ops.mlp import activation_name, apply_activation, mlp_apply

_ACT_CODES = {"none": 0, "relu": 1, "sine": 2, "squareplus": 3}
_WIDTHS = (16, 32, 64, 128)
_BF16, _F32 = torch.bfloat16, torch.float32

counter = cuda_lib.LaunchCounter()  # fused_mlp_forward (inference)
train_forward_counter = cuda_lib.LaunchCounter()  # fused_mlp_train_forward
backward_counter = cuda_lib.LaunchCounter()  # fused_mlp_backward


def fused_mlp_reference(params: list[torch.Tensor], x: torch.Tensor,
                        cfg: NetworkConfig) -> torch.Tensor:
    """Plain version: the plain MLP in bf16 compute, which rounds at the
    kernel's points (float32 matmuls on bf16-rounded operands; a bare
    bf16 @ bf16 would round its output)."""
    return mlp_apply(params, x, cfg, compute_dtype=_BF16)


def pack_weights(params: list[torch.Tensor]) -> torch.Tensor:
    """All weight matrices, row-major [fan_in, fan_out], as one bf16 buffer
    (the kernel's shared-memory image)."""
    return torch.cat([w.to(_BF16).reshape(-1) for w in params])


def act_grad(z: torch.Tensor, name: str) -> torch.Tensor:
    """d act(z) / dz from the pre-activation z (`_act_grad`, `:53-63`);
    ReLU's derivative is 0 at z = 0."""
    name = activation_name(name)
    if name == "relu":
        return (z > 0).to(z.dtype)
    if name == "sine":
        return torch.cos(z)
    if name == "squareplus":
        return 0.5 * (1.0 + z * torch.rsqrt(z * z + 4.0))
    return torch.ones_like(z)


def _shape(params: list[torch.Tensor], x: torch.Tensor):
    """(n_hidden, width, n_in, n_out) the kernels take; raises otherwise."""
    n_hidden = len(params) - 1
    n_in = x.shape[1]
    n_out = params[-1].shape[1]
    width = params[0].shape[1] if n_hidden > 0 else _WIDTHS[0]
    if width not in _WIDTHS or n_in > 128 or any(
            w.device != x.device for w in params):
        raise ValueError(
            f"fused_mlp kernels take hidden widths {_WIDTHS} and n_in ≤ 128 "
            f"on the input's device (got width {width}, n_in {n_in})")
    for w in params[1:-1]:
        if tuple(w.shape) != (width, width):
            raise ValueError("hidden weight matrices must be [width, width]")
    return n_hidden, width, n_in, n_out


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# -- the training form: plain version -----------------------------------


def _plain_train_forward(params, x, cfg):
    """→ (z_out [B, n_out] f32 before the output activation, zs
    [n_hidden, B, W] f32 hidden pre-activations)."""
    h = x.to(_BF16)
    zs = []
    for w in params[:-1]:
        z = torch.matmul(h.to(_F32), w.to(_BF16).to(_F32))
        zs.append(z)
        h = apply_activation(z, cfg.activation).to(_BF16)
    z_out = torch.matmul(h.to(_F32), params[-1].to(_BF16).to(_F32))
    if not zs:
        return z_out, x.new_empty((0, x.shape[0], 0), dtype=_F32)
    return z_out, torch.stack(zs)


def _plain_backward(params, x, zs, z_out, g, cfg):
    """→ (dx in x's dtype, [dW_k] float32): `_bwd` in eager PyTorch."""
    g_z = g.to(_F32)
    if activation_name(cfg.output_activation) != "none":
        g_z = g_z * act_grad(z_out, cfg.output_activation)
    hs = [x.to(_BF16).to(_F32)]
    hs += [apply_activation(z, cfg.activation).to(_BF16).to(_F32) for z in zs]
    dws = [None] * len(params)
    for k in range(len(params) - 1, -1, -1):
        dws[k] = torch.matmul(hs[k].T, g_z).to(params[k].dtype)
        g_h = torch.matmul(g_z, params[k].to(_BF16).to(_F32).T)
        if k > 0:
            g_z = g_h * act_grad(zs[k - 1], cfg.activation)
    return g_h.to(x.dtype), dws


# -- the training form: kernels --------------------------------------------


def _kernel_train_forward(params, x, cfg):
    n_hidden, width, n_in, n_out = _shape(params, x)
    b = x.shape[0]
    lib = cuda_lib.load_library()
    xb = x.to(_BF16).contiguous()
    z_out = torch.empty((b, n_out), dtype=_F32, device=x.device)
    zs = torch.empty((n_hidden, b, width if n_hidden else 0), dtype=_F32,
                     device=x.device)
    lib.call("fused_mlp_train_forward", xb.data_ptr(),
             pack_weights(params).data_ptr(), z_out.data_ptr(), zs.data_ptr(),
             b, n_in, width, n_hidden, n_out,
             _ACT_CODES[activation_name(cfg.activation)], _stream(x))
    train_forward_counter.launches += 1
    return z_out, zs


def _kernel_backward(params, x, zs, z_out, g, cfg):
    n_hidden, width, n_in, n_out = _shape(params, x)
    b = x.shape[0]
    lib = cuda_lib.load_library()
    xb = x.to(_BF16).contiguous()
    wb = pack_weights(params)
    dx = torch.empty((b, n_in), dtype=_BF16 if x.dtype == _BF16 else _F32,
                     device=x.device)
    dw = torch.empty(wb.numel(), dtype=_F32, device=x.device)
    tiles = -(-b // (64 if width == 128 else 128))  # the kernel's row tile
    partials = torch.empty((tiles, wb.numel()), dtype=_F32, device=x.device)
    lib.call("fused_mlp_backward", xb.data_ptr(), wb.data_ptr(),
             zs.data_ptr(), z_out.data_ptr(),
             g.to(_F32).contiguous().data_ptr(), dx.data_ptr(),
             int(dx.dtype == _BF16), partials.data_ptr(), dw.data_ptr(), b,
             n_in, width, n_hidden, n_out,
             _ACT_CODES[activation_name(cfg.activation)],
             _ACT_CODES[activation_name(cfg.output_activation)], _stream(x))
    backward_counter.launches += 1
    dws, off = [], 0
    for w in params:
        dws.append(dw[off:off + w.numel()].view(w.shape).to(w.dtype))
        off += w.numel()
    return dx.to(x.dtype), dws


class _TrainForm(torch.autograd.Function):
    """y = out_act(MLP(x)) with the residual-saving forward and the
    matmul-chain backward, through the kernels or their plain versions."""

    @staticmethod
    def forward(ctx, x, cfg, kernel, *params):
        fwd = _kernel_train_forward if kernel else _plain_train_forward
        z_out, zs = fwd(list(params), x, cfg)
        ctx.save_for_backward(x, zs, z_out, *params)
        ctx.cfg, ctx.kernel = cfg, kernel
        return apply_activation(z_out, cfg.output_activation)

    @staticmethod
    def backward(ctx, g):
        x, zs, z_out, *params = ctx.saved_tensors
        bwd = _kernel_backward if ctx.kernel else _plain_backward
        dx, dws = bwd(params, x, zs, z_out, g, ctx.cfg)
        return (dx, None, None, *dws)


def fused_mlp_train_reference(params: list[torch.Tensor], x: torch.Tensor,
                              cfg: NetworkConfig) -> torch.Tensor:
    """Plain version of the training form, on any device."""
    return _TrainForm.apply(x, cfg, False, *params)


# -- the wrapper ----------------------------------------------------------


def fused_mlp_apply(params: list[torch.Tensor], x: torch.Tensor,
                    cfg: NetworkConfig) -> torch.Tensor:
    """x [B, n_in] → [B, n_out] float32; the training form when an input
    requires grad."""
    train = torch.is_grad_enabled() and (
        x.requires_grad or any(w.requires_grad for w in params))
    if x.device.type == "cpu":
        if train:
            return fused_mlp_train_reference(params, x, cfg)
        return fused_mlp_reference(params, x, cfg)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if train:
        return _TrainForm.apply(x, cfg, True, *params)
    n_hidden, width, n_in, n_out = _shape(params, x)
    b = x.shape[0]
    lib = cuda_lib.load_library()
    xb = x.to(_BF16).contiguous()
    wb = pack_weights(params)
    y = torch.empty((b, n_out), dtype=_F32, device=x.device)
    lib.call("fused_mlp_forward", xb.data_ptr(), wb.data_ptr(), y.data_ptr(),
             b, n_in, width, n_hidden, n_out,
             _ACT_CODES[activation_name(cfg.activation)],
             _ACT_CODES[activation_name(cfg.output_activation)], _stream(x))
    counter.launches += 1
    return y
