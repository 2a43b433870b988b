"""Expert parallelism: one expert field a z-slab (counterpart of
`instantvnr_tpu/parallel/ep.py`; the reference sketches it in a comment,
core/network.cu:584-603).

The volume is partitioned into z-slabs and each rank, an "expert", owns a
COMPLETE small field (hash table + MLP) for its slab:

  - training: each expert samples ONLY its slab plus a ghost margin and
    updates only its own parameters — no collective at all;
  - decode: each expert decodes its own slab; the full volume is the
    concatenation of the slabs, which one optional all_gather assembles on
    every rank.
"""
from __future__ import annotations

import numpy as np
import torch

from instantvnr_torch.models.network import (NeuralField, network_apply_chunked,
                                             params_from_numpy)
from instantvnr_torch.models.optimizer import adam_update, mlp_l2_mask
from instantvnr_torch.models.trainer import (TrainState, create_train_state,
                                             value_and_grad)
from instantvnr_torch.ops.trilinear import sample_volume_tex
from instantvnr_torch.parallel.mesh import Mesh, all_gather, make_axis_mesh
from instantvnr_torch.utils.device import resolve_device


def make_expert_mesh(device="cuda") -> Mesh:
    """A 1-D ("expert",) mesh over the world: one expert a rank."""
    return make_axis_mesh("expert", device)


def create_ep_train_state(field: NeuralField, mesh: Mesh, seed: int = 0
                          ) -> TrainState:
    """Expert e's train state, initialized from seed + e (each expert
    starts from its own init and draws its own sample stream)."""
    dev = resolve_device(mesh.device)
    return create_train_state(field, seed=seed + mesh.axis_index("expert"),
                              device=dev)


def expert_params_from_numpy(stacked: dict, expert: int, device="cuda"
                             ) -> dict:
    """Expert e's params from the JAX package's stacked per-expert params
    ([n_experts, ...] leaves) converted with numpy."""
    return params_from_numpy({"table": np.asarray(stacked["table"])[expert],
                              "mlp": [np.asarray(w)[expert]
                                      for w in stacked["mlp"]]}, device)


def _slab_frame(e: int, n_exp: int, ghost: float):
    """Expert e's sampling range of the global z (the slab plus the ghost
    margin, clamped to the volume) as (z_lo, z_hi − z_lo), the local
    frame's origin e/n − g and its extent 1/n + 2g, as float32 values."""
    f32 = np.float32
    base = f32(f32(e) / f32(n_exp)) - f32(ghost)
    top = f32(f32(e + 1) / f32(n_exp)) + f32(ghost)
    z_lo, z_hi = max(base, f32(0.0)), min(top, f32(1.0))
    return (float(z_lo), float(z_hi - z_lo), float(base),
            float(f32(1.0 / n_exp + 2.0 * ghost)))


def make_ep_train_step(field: NeuralField, mesh: Mesh, batch: int,
                       n_steps: int = 1, ghost: float = 0.02):
    """Expert e's step, (state, volume) → state: sample z ∈ [e/n − g,
    (e+1)/n + g] of the GLOBAL volume, map to the local frame with the
    UNCLAMPED affine z' = (z − (e/n − g)) / (1/n + 2g), and train the
    expert's own field. No collectives.

    The local frame spans the slab plus the margin, so ghost samples keep
    distinct local coordinates (JAX :80-89): clipping them onto the slab's
    face would hand one coordinate conflicting targets from a 2g band."""
    n_exp = mesh.shape["expert"]
    z_lo, z_len, base, span = _slab_frame(mesh.axis_index("expert"), n_exp,
                                         ghost)

    def step(state: TrainState, volume: torch.Tensor) -> TrainState:
        for _ in range(n_steps):
            u = torch.rand((batch, 3), generator=state.generator,
                           dtype=torch.float32, device=volume.device)
            z_g = z_lo + u[:, 2:] * z_len
            targets = sample_volume_tex(volume, torch.cat([u[:, :2], z_g],
                                                          dim=1))[:, None]
            coords_l = torch.cat([u[:, :2], (z_g - base) / span], dim=1)
            loss, grads = value_and_grad(field, state.params, coords_l,
                                         targets)
            params, opt = adam_update(field.cfg.optimizer, state.params,
                                      grads, state.opt,
                                      l2_mask=mlp_l2_mask(state.params))
            state = state._replace(params=params, opt=opt, loss=loss)
        return state

    return step


def make_ep_decode(field: NeuralField, mesh: Mesh, dims, ghost: float = 0.02,
                   slab: int = 16, gather: bool = False):
    """Decode expert e's z-slab of the [dz, dy, dx] volume with its own
    params → [dz / n, dy, dx] (or, with `gather`, the full volume on every
    rank through one all_gather).

    ghost must match the train step's margin: the slab interior
    zi ∈ (0, 1) sits at z' = (zi + g·n) / (1 + 2g·n) of the local frame.
    Decoded `slab` planes at a time through `network_apply_chunked` (on the
    card each chunk one K3 gather and one inference fused-MLP launch)."""
    dx, dy, dz = (int(d) for d in dims)
    n_exp = mesh.shape["expert"]
    if dz % n_exp != 0:
        raise ValueError(
            f"EP decode needs dz divisible by the expert count: dz={dz}, "
            f"experts={n_exp}. Pad the volume in z or change the mesh.")
    dz_loc = dz // n_exp
    gn = ghost * n_exp
    slab = min(slab, dz_loc)

    @torch.no_grad()
    def decode(state: TrainState) -> torch.Tensor:
        params = state.params
        dev = params["table"].device
        f32 = torch.float32
        yy = (torch.arange(dy, dtype=f32, device=dev) + 0.5) / dy
        xx = (torch.arange(dx, dtype=f32, device=dev) + 0.5) / dx
        out = torch.empty((dz_loc, dy, dx), dtype=f32, device=dev)
        for z0 in range(0, dz_loc, slab):
            k = min(slab, dz_loc - z0)
            zi = (z0 + torch.arange(k, dtype=f32, device=dev) + 0.5) / dz_loc
            z, y, x = torch.meshgrid((zi + gn) / (1.0 + 2.0 * gn), yy, xx,
                                     indexing="ij")
            coords = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
            out[z0:z0 + k] = network_apply_chunked(
                params, coords, field).reshape(k, dy, dx)
        if gather:
            return all_gather(out, mesh, "expert").reshape(dz, dy, dx)
        return out

    return decode
