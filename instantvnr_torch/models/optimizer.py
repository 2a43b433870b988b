"""Adam + ExponentialDecay with tiny-cuda-nn's semantics (counterpart of
`instantvnr_tpu/models/optimizer.py`).

Reference config (`example-model.json:2-15`): Adam(lr 5e-3, β1 .9, β2 .999,
ε 1e-15, l2_reg 1e-6) inside ExponentialDecay(start 2000, interval 1000,
base 0.99). As in tcnn:

- ε is added to sqrt(v̂), outside the sqrt;
- bias correction by (1 − β1^t) and (1 − β2^t);
- l2_reg is additive weight decay on the MLP matrices only, not the table;
- the decay multiplies the lr by base^floor((t − start)/interval) once
  t > start (a staircase), and only when the config wraps Adam in
  ExponentialDecay.

The step count and the scalar factors live on the host (float32, as the
JAX package computes them). `adam_update` returns new tensors, so a step
leaves the old params untouched. On CUDA it is one streaming pass, the
`adam_step` kernel (`ops/adam.py`); on the CPU it is the plain form
`adam_update_plain`, one multi-tensor (`torch._foreach_*`) launch per step
of the formula, which the kernel equals bit for bit on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from instantvnr_torch.config import OptimizerConfig
from instantvnr_torch.ops.adam import AdamScalars, adam_step


class AdamState(NamedTuple):
    step: int
    mu: dict  # first moment, the params' layout
    nu: dict  # second moment


def _leaves(tree: dict) -> list[torch.Tensor]:
    return [tree["table"], *tree["mlp"]]


def _tree(leaves: list[torch.Tensor]) -> dict:
    return {"table": leaves[0], "mlp": list(leaves[1:])}


def adam_init(params: dict) -> AdamState:
    zeros = [torch.zeros_like(p, dtype=torch.float32) for p in _leaves(params)]
    return AdamState(step=0, mu=_tree(zeros),
                     nu=_tree([torch.zeros_like(z) for z in zeros]))


def lr_at_step(cfg: OptimizerConfig, step: int) -> float:
    """The learning rate of step `step` (1-based), float32."""
    lr = np.float32(cfg.learning_rate)
    if cfg.otype.lower() != "exponentialdecay":
        return float(lr)
    n_decays = max(step - cfg.decay_start, 0) // cfg.decay_interval
    return float(lr * np.power(np.float32(cfg.decay_base),
                               np.float32(n_decays)))


def mlp_l2_mask(params: dict) -> dict:
    """l2_reg applies to the MLP matrices, not the hash table."""
    return {"table": False, "mlp": [True for _ in params["mlp"]]}


def adam_scalars(cfg: OptimizerConfig, step: int) -> AdamScalars:
    """The factors of step `step` (1-based) as the plain form hands them to
    PyTorch: lr and the bias corrections float32 (as the JAX package
    computes them), the rest the config's Python floats."""
    t = np.float32(step)
    return AdamScalars(
        lr=lr_at_step(cfg, step), beta1=cfg.beta1,
        one_minus_beta1=1.0 - cfg.beta1, beta2=cfg.beta2,
        one_minus_beta2=1.0 - cfg.beta2,
        c1=float(np.float32(1.0) - np.power(np.float32(cfg.beta1), t)),
        c2=float(np.float32(1.0) - np.power(np.float32(cfg.beta2), t)),
        epsilon=cfg.epsilon, l2_reg=cfg.l2_reg)


def _l2_flags(cfg: OptimizerConfig, params: dict, l2_mask: dict | None):
    if l2_mask is None or cfg.l2_reg <= 0:
        return [False] * (1 + len(params["mlp"]))
    return [bool(use) for use in _leaves(l2_mask)]


def adam_update(cfg: OptimizerConfig, params: dict, grads: dict,
                state: AdamState, l2_mask: dict | None = None):
    """One Adam step → (new params, new state); `l2_mask` marks where l2_reg
    applies (default: nowhere). The `adam_step` kernel for a tree on CUDA
    (contiguous float32 leaves), the plain form for a tree on the CPU."""
    device = params["table"].device
    if device.type == "cpu":
        return adam_update_plain(cfg, params, grads, state, l2_mask)
    step = state.step + 1
    p, m, v = adam_step(_leaves(params), _leaves(grads), _leaves(state.mu),
                        _leaves(state.nu), _l2_flags(cfg, params, l2_mask),
                        adam_scalars(cfg, step))
    return _tree(p), AdamState(step=step, mu=_tree(m), nu=_tree(v))


def adam_update_plain(cfg: OptimizerConfig, params: dict, grads: dict,
                      state: AdamState, l2_mask: dict | None = None):
    """`adam_update` in plain PyTorch on any device."""
    step = state.step + 1
    s = adam_scalars(cfg, step)
    f32 = torch.float32
    ps = [p.to(f32) for p in _leaves(params)]
    gs = [g.to(f32) for g in _leaves(grads)]
    gs = [g + s.l2_reg * p if use else g
          for g, p, use in zip(gs, ps, _l2_flags(cfg, params, l2_mask))]
    # one multi-tensor launch per elementwise step, the same arithmetic as
    # m = β1·m + (1−β1)·g;  v = β2·v + ((1−β2)·g)·g;
    # p − (lr·m/c1) / (sqrt(v/c2) + ε)
    mul, add, div = torch._foreach_mul, torch._foreach_add, torch._foreach_div
    m = add(mul(_leaves(state.mu), s.beta1), mul(gs, s.one_minus_beta1))
    v = add(mul(_leaves(state.nu), s.beta2),
            mul(mul(gs, s.one_minus_beta2), gs))
    den = add(torch._foreach_sqrt(div(v, s.c2)), s.epsilon)
    upd = div(mul(div(m, s.c1), s.lr), den)
    new_p = [q.to(p.dtype) for q, p in zip(torch._foreach_sub(ps, upd),
                                           _leaves(params))]
    return _tree(new_p), AdamState(step=step, mu=_tree(m), nu=_tree(v))
