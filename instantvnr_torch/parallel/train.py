"""Sharded training steps (counterpart of `instantvnr_tpu/parallel/
train.py`).

Data parallelism: each rank draws its own slice of the 2^16-sample batch
from its own sample stream (the state's generator folded with the rank's
data index, `derived_generator`, JAX's fold_in), computes local gradients
and averages them with ONE fused all-reduce before a replicated Adam step.
Params and the ground-truth volume are replicated: every rank holds the
same params and applies the same update. Hash-table gradients are carried
dense so that the reduce stays one collective.

On the card a step runs, as `trainer._apply` does, the hash grid's K3 and
K4 and the fused MLP's training forward and backward, then the all-reduce.
"""
from __future__ import annotations

import torch
import torch.utils._pytree as pytree

from instantvnr_torch.models.network import NeuralField
from instantvnr_torch.models.optimizer import adam_update, mlp_l2_mask
from instantvnr_torch.models.trainer import (TrainState, derived_generator,
                                             value_and_grad)
from instantvnr_torch.ops.trilinear import sample_volume_tex
from instantvnr_torch.parallel.mesh import (Mesh, all_reduce_mean_flat,
                                            broadcast)


def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Rank 0's state on every rank of the mesh: one broadcast of the
    params, moments and loss (one float32 vector) and one of the step count
    and the generator's state."""
    world = mesh.axis_names[0]
    if len(mesh.shape) != 1:
        raise ValueError("replicate_state takes a 1-D mesh")
    leaves, spec = pytree.tree_flatten((state.params, state.opt.mu,
                                        state.opt.nu, state.loss))
    floats = torch.cat([t.reshape(-1).to(torch.float32) for t in leaves])
    floats = broadcast(floats.to(mesh.device), mesh, world)
    out, off = [], 0
    for t in leaves:
        out.append(floats[off:off + t.numel()].reshape(t.shape).to(
            device=t.device, dtype=t.dtype))
        off += t.numel()
    params, mu, nu, loss = pytree.tree_unflatten(out, spec)
    gen_state = state.generator.get_state()
    meta = torch.cat([gen_state.to(torch.int64),
                      torch.tensor([state.opt.step], dtype=torch.int64)])
    meta = broadcast(meta.to(mesh.device), mesh, world).cpu()
    gen = torch.Generator(device=state.generator.device)
    gen.set_state(meta[:-1].to(torch.uint8))
    opt = state.opt._replace(step=int(meta[-1]), mu=mu, nu=nu)
    return state._replace(params=params, opt=opt, generator=gen, loss=loss)


def fused_pmean(tree, mesh: Mesh, axis: str = "data"):
    """The mean over `axis` of a whole pytree as ONE collective
    (`all_reduce_mean_flat`): every leaf flattened into one float32 vector,
    one all-reduce, then unflattened into the leaves' shapes and dtypes.
    Leafwise all-reduces would issue one collective a leaf."""
    leaves, spec = pytree.tree_flatten(tree)
    return pytree.tree_unflatten(all_reduce_mean_flat(leaves, mesh, axis),
                                 spec)


def _apply_mean(field: NeuralField, mesh: Mesh, state: TrainState, coords,
                targets) -> TrainState:
    """Local value_and_grad, one fused mean all-reduce over "data" of the
    gradients and the loss, then the tcnn Adam on the MLP L2 mask."""
    loss, grads = value_and_grad(field, state.params, coords, targets)
    grads, loss = fused_pmean((grads, loss), mesh, "data")
    params, opt = adam_update(field.cfg.optimizer, state.params, grads,
                              state.opt, l2_mask=mlp_l2_mask(state.params))
    return state._replace(params=params, opt=opt, loss=loss)


def _advance(gen: torch.Generator):
    """Move the replicated sample stream on by one draw (JAX's key split),
    so each step derives new per-rank streams."""
    torch.rand((1,), generator=gen, device=gen.device)


def _rank_batch(state: TrainState, volume: torch.Tensor, data_index: int,
                local_batch: int):
    """This data rank's (coords [b, 3], targets [b, 1]) of the step: drawn
    from the state's stream folded with the data index, after which the
    shared stream moves on (JAX's fold_in, then split)."""
    gen = derived_generator(state.generator, data_index)
    _advance(state.generator)
    coords = torch.rand((local_batch, 3), generator=gen, dtype=torch.float32,
                        device=volume.device)
    return coords, sample_volume_tex(volume, coords)[:, None]


def make_dp_train_step(field: NeuralField, mesh: Mesh, batch: int,
                       n_steps: int = 1):
    """A data-parallel step, (state, volume) → state, n_steps at a time.

    Everything is replicated; the batch is sharded through the sample
    streams: each of the D data ranks draws batch / D samples from its own
    stream (the state's generator folded with its data index), then the
    gradients meet in one fused mean all-reduce."""
    n_data = mesh.shape["data"]
    if batch % n_data:
        raise ValueError(f"batch {batch} not divisible by the data axis "
                         f"({n_data})")
    local_batch = batch // n_data
    idx = mesh.axis_index("data")

    def step(state: TrainState, volume: torch.Tensor) -> TrainState:
        for _ in range(n_steps):
            coords, targets = _rank_batch(state, volume, idx, local_batch)
            state = _apply_mean(field, mesh, state, coords, targets)
        return state

    return step


def make_dp_hostbatch_step(field: NeuralField, mesh: Mesh):
    """A data-parallel step on host-provided batches, (state, coords,
    targets) → state, where coords [b, 3] and targets [b, 1] are this rank's
    rows of the global batch (`shard_host_batch`): the multi-host
    out-of-core path, each rank streaming its own blocks. The sample
    stream still advances, as `trainer.train_step_hostbatch`'s does, so at
    one rank the step is that function's step exactly."""

    def step(state: TrainState, coords, targets) -> TrainState:
        _advance(state.generator)
        return _apply_mean(field, mesh, state, coords, targets)

    return step


def shard_host_batch(mesh: Mesh, coords, targets):
    """This rank's rows of the global batch on its device: the process-local
    arrays (numpy or tensors) are its shard, as jax.make_array_from_
    process_local_data reads them."""
    def put(a):
        return torch.as_tensor(a, dtype=torch.float32).to(mesh.device)

    return put(coords), put(targets)
