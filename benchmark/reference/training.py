"""Training steps, plain: a batch of uniform coordinates and their
trilinear ground truth, the field's forward, the L1 loss, autograd in
float32, and tiny-cuda-nn's Adam inside ExponentialDecay (ε added to
sqrt(v̂), bias correction, l2_reg as weight decay on the MLP's matrices
only, the learning rate times base^floor((t − start)/interval) once
t > start).

The coordinates are drawn as the system under test documents them: one
`torch.rand((B, 3))` a step from a generator on the card seeded with the
run's seed plus the upstream sampler's 1337. Philox is PyTorch's, so the
reference draws the same rows from the same seed.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.volume import sample_tex

SAMPLER_SEED = 1337  # the upstream's sampler seed (neural_sampler.cu:36)


def coord_stream(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(SAMPLER_SEED + seed)


def lr_at(opt: dict, step: int) -> float:
    lr = np.float32(opt["learning_rate"])
    if opt["otype"].lower() != "exponentialdecay":
        return float(lr)
    n = max(step - int(opt["decay_start"]), 0) // int(opt["decay_interval"])
    return float(lr * np.power(np.float32(opt["decay_base"]), np.float32(n)))


def adam(opt: dict, leaves, grads, state, l2_mask):
    """One step → (new leaves, new state, the gradients as Adam took them
    (l2 added))."""
    step = state["step"] + 1
    lr = lr_at(opt, step)
    t = np.float32(step)
    b1, b2 = float(opt["beta1"]), float(opt["beta2"])
    c1 = float(np.float32(1.0) - np.power(np.float32(b1), t))
    c2 = float(np.float32(1.0) - np.power(np.float32(b2), t))
    l2 = float(opt["l2_reg"])
    taken, new_p, new_m, new_v = [], [], [], []
    for p, g, m, v, use in zip(leaves, grads, state["m"], state["v"],
                               l2_mask):
        if use and l2 > 0:
            g = g + l2 * p
        m = m * b1 + g * (1.0 - b1)
        v = v * b2 + (g * (1.0 - b2)) * g
        upd = ((m / c1) * lr) / (torch.sqrt(v / c2) + float(opt["epsilon"]))
        taken.append(g)
        new_p.append(p - upd)
        new_m.append(m)
        new_v.append(v)
    return new_p, {"step": step, "m": new_m, "v": new_v}, taken


def train_steps(model, leaves, volume, seed: int, batch: int, n_steps: int,
                rnd, opt: dict, half_batch: bool = False,
                state: dict | None = None, skip: int = 0):
    """n_steps from `leaves` → (losses, first gradients as Adam took them,
    leaves after the steps). `state` is Adam's ({step, m, v}; fresh when
    None) and `skip` the steps whose coordinates the stream has already
    drawn. `half_batch` plants a fault: the loss is the mean over the
    batch's first half."""
    gen = coord_stream(seed, volume.device)
    for _ in range(skip):
        torch.rand((batch, 3), generator=gen, dtype=torch.float32,
                   device=volume.device)
    if state is None:
        state = {"step": 0, "m": [torch.zeros_like(p) for p in leaves],
                 "v": [torch.zeros_like(p) for p in leaves]}
    losses, first = [], None
    mask = model.l2_leaves()
    for _ in range(n_steps):
        coords = torch.rand((batch, 3), generator=gen, dtype=torch.float32,
                            device=volume.device)
        if half_batch:
            coords = coords[: batch // 2]
        targets = sample_tex(volume, coords)[:, None]
        live = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            pred = model.apply(live, coords, rnd)
            loss = torch.mean(torch.abs(pred - targets))
            grads = torch.autograd.grad(loss, live)
        leaves, state, taken = adam(opt, [p.detach() for p in leaves],
                                    list(grads), state, mask)
        losses.append(float(loss.detach()))
        if first is None:
            first = [g.detach() for g in taken]
    return losses, first, leaves
