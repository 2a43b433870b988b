"""Training loop (counterpart of `instantvnr_tpu/models/trainer.py`): the
reference's `NeuralVolume::Impl::train` (`core/network.cu:231-259`) and
tcnn's `Trainer::training_step`.

One step: sample a batch (uniform coords, trilinear ground truth) → hash
encode → MLP training form → loss → backward (MLP backward, then the
hash-grid scatter) → tcnn Adam. On CUDA tensors the encode and the MLP run
through their kernels (`ops/hash_encoding.py`, `ops/fused_mlp.py`), each
once forward and once backward per step.

Each step is a `train.step` span (utils/profiling.py::span) holding its
stages, `train.sample`, `train.forward` (encode, MLP and loss),
`train.backward` and `train.adam`: while a profiler records, they split
the host's time to enqueue a step.

Every step returns a new params dict (new tensors, the old ones
untouched), as JAX's functional update does: renderers key their decoded
grids on the params object, so an update in place would leave them
showing the old weights.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple

import torch

from instantvnr_torch.config import DEFAULT_TRAIN_BATCH
from instantvnr_torch.data.sampler import DEFAULT_SEED, sample_static
from instantvnr_torch.models.network import (NeuralField, init_params,
                                             network_apply)
from instantvnr_torch.models.optimizer import (AdamState, adam_init,
                                               adam_update, mlp_l2_mask)
from instantvnr_torch.ops.trilinear import sample_volume_tex
from instantvnr_torch.utils.profiling import span


class TrainState(NamedTuple):
    params: dict
    opt: AdamState
    generator: torch.Generator  # the sample stream; advanced by each step
    loss: torch.Tensor  # last step's loss, a float32 scalar on the device
    # the JAX package's uint32[2] key words, kept only for its native
    # checkpoints (serializer.save_native): a state made here carries the
    # raw words of jax.random.PRNGKey(seed), one loaded from a JAX file its
    # key. The port's sample stream is `generator`; threefry and Philox
    # never give the same numbers, so the stream does not cross packages.
    key: tuple = (0, 0)


def create_train_state(field: NeuralField, seed: int = 0,
                       device="cuda") -> TrainState:
    """Params drawn from a CPU generator seeded with `seed` (the same
    weights on every device), the sample stream from a generator on
    `device` seeded from `seed` and the reference's 1337."""
    from instantvnr_torch.utils.device import resolve_device

    dev = resolve_device(device)
    params = init_params(torch.Generator(device="cpu").manual_seed(seed),
                         field, device=dev)
    return state_for_params(params, seed=seed)


def state_for_params(params: dict, seed: int = 0) -> TrainState:
    """A fresh train state (Adam moments zero) around existing params."""
    dev = params["table"].device
    gen = torch.Generator(device=dev).manual_seed(DEFAULT_SEED + seed)
    return TrainState(params=params, opt=adam_init(params), generator=gen,
                      loss=torch.zeros((), dtype=torch.float32, device=dev),
                      key=(0, seed & 0xFFFFFFFF))


def derived_generator(gen: torch.Generator, tag: int) -> torch.Generator:
    """A generator on gen's device seeded from gen's current state and a
    tag, without advancing gen (JAX's fold_in)."""
    digest = hashlib.sha256(gen.get_state().numpy().tobytes()
                            + tag.to_bytes(4, "little")).digest()
    seed = int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)
    return torch.Generator(device=gen.device).manual_seed(seed)


def loss_terms(kind: str, pred: torch.Tensor,
               targets: torch.Tensor) -> torch.Tensor:
    """Per-sample loss residuals: tcnn's L1, L2 and RelativeL2."""
    if kind == "l1":
        return torch.abs(pred - targets)
    if kind == "l2":
        return (pred - targets) ** 2
    if kind == "relativel2":
        # tcnn holds the prediction-dependent denominator constant in the
        # backward: its gradient is 2(pred − target)/(pred² + ε)
        return (pred - targets) ** 2 / (pred.detach() ** 2 + 1e-2)
    raise ValueError(f"unsupported loss: {kind}")


def make_loss_fn(field: NeuralField):
    kind = field.cfg.loss.otype.lower()

    def loss_fn(params, coords, targets):
        pred = network_apply(params, coords, field)
        return torch.mean(loss_terms(kind, pred, targets))

    return loss_fn


def value_and_grad(field: NeuralField, params: dict, coords: torch.Tensor,
                   targets: torch.Tensor):
    """(loss, grads) of the field's loss at params, the grads in the
    params' layout (float32)."""
    leaves = [params["table"], *params["mlp"]]
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        with span("train.forward"):
            loss = make_loss_fn(field)({"table": live[0], "mlp": live[1:]},
                                       coords, targets)
        with span("train.backward"):
            grads = torch.autograd.grad(loss, live)
    return loss.detach(), {"table": grads[0], "mlp": list(grads[1:])}


def _apply(field: NeuralField, state: TrainState, coords, targets
           ) -> TrainState:
    loss, grads = value_and_grad(field, state.params, coords, targets)
    with span("train.adam"):
        params, opt = adam_update(field.cfg.optimizer, state.params, grads,
                                  state.opt,
                                  l2_mask=mlp_l2_mask(state.params))
    return state._replace(params=params, opt=opt, loss=loss)


def train_step(field: NeuralField, volume: torch.Tensor, state: TrainState,
               batch: int = DEFAULT_TRAIN_BATCH) -> TrainState:
    """One sample → forward → backward → Adam step on the volume's
    device."""
    with span("train.step"):
        with span("train.sample"):
            coords, targets = sample_static(volume, state.generator, batch)
        return _apply(field, state, coords, targets)


def train_steps(field: NeuralField, volume: torch.Tensor, state: TrainState,
                n_steps: int, batch: int = DEFAULT_TRAIN_BATCH) -> TrainState:
    """n_steps of train_step (the reference's chunk-of-10 loop,
    `batch_trainer.cpp:97-107`)."""
    for _ in range(n_steps):
        state = train_step(field, volume, state, batch)
    return state


def train_step_hostbatch(field: NeuralField, state: TrainState,
                         coords: torch.Tensor,
                         targets: torch.Tensor) -> TrainState:
    """One step on a caller-provided batch (the reference's out-of-core
    path, neural_sampler.cpp:1066-1120). The sample stream still advances,
    so the online macrocell refreshes stay deterministic."""
    with span("train.step"):
        torch.rand((1,), generator=state.generator,
                   device=state.generator.device)
        return _apply(field, state, coords, targets)


def test_loss(field: NeuralField, volume: torch.Tensor, state: TrainState,
              batch: int = DEFAULT_TRAIN_BATCH) -> torch.Tensor:
    """Mean L1 on a fresh batch from a generator derived from the state's
    (`NeuralVolume::Impl::test`, network.cu:261-288). Always L1 whatever
    the training loss: the reference hard-codes abs() in its test kernel
    (network.cu:283)."""
    gen = derived_generator(state.generator, 0x7357)
    coords = torch.rand((batch, 3), generator=gen, dtype=torch.float32,
                        device=volume.device)
    targets = sample_volume_tex(volume, coords)[:, None]
    with torch.no_grad():
        pred = network_apply(state.params, coords, field)
    return torch.mean(torch.abs(pred - targets))


def train_steps_source(field: NeuralField, sampler, state: TrainState,
                       n_steps: int, batch: int = DEFAULT_TRAIN_BATCH
                       ) -> TrainState:
    """n_steps from an analytic source (the reference's OpenVKL modes,
    neural_sampler.cpp:714-958): each batch's values come from the
    sampler's field (data/procedural.py::AnalyticSampler), evaluated on
    the batch's device, in place of a volume's texture; no volume exists
    anywhere."""
    for _ in range(n_steps):
        with span("train.step"):
            with span("train.sample"):
                coords, targets = sampler.sample(state.generator, batch)
            state = _apply(field, state, coords, targets)
    return state


def train_out_of_core(field: NeuralField, sampler, state: TrainState,
                      n_steps: int, batch: int) -> TrainState:
    """Training from a host-side sampler (data/outofcore.py::
    OutOfCoreSampler): the reference's OutOfCoreSampler::sample →
    cudaMemcpyAsync → training_step (neural_sampler.cpp:1066-1120).

    On the card, two pinned host batches alternate. A worker thread fills
    batch k + 1 through the sampler's `sample_into` (the native sampler
    runs without the interpreter lock) while this thread issues step k,
    and each batch's copy to the card is a non-blocking copy followed by
    an event: the sampler writes into a buffer only after the event of
    that buffer's last copy has passed, so no batch is overwritten while
    its copy is in flight. On the CPU the batches come from `sample` and
    are consumed in turn."""
    dev = state.params["table"].device
    if dev.type != "cuda":
        for _ in range(n_steps):
            coords, targets = sampler.sample(batch)
            state = train_step_hostbatch(field, state,
                                         torch.from_numpy(coords).to(dev),
                                         torch.from_numpy(targets).to(dev))
        return state
    if n_steps <= 0:
        return state
    from concurrent.futures import ThreadPoolExecutor

    bufs = [(torch.empty((batch, 3), dtype=torch.float32, pin_memory=True),
             torch.empty((batch, 1), dtype=torch.float32, pin_memory=True))
            for _ in range(2)]
    copied = [None, None]  # the event after each buffer's last copy

    def fill(slot: int):
        if copied[slot] is not None:
            copied[slot].synchronize()
        c, v = bufs[slot]
        sampler.sample_into(c.numpy(), v.numpy())

    with ThreadPoolExecutor(1) as pool:
        pending = pool.submit(fill, 0)
        for i in range(n_steps):
            slot = i % 2
            pending.result()
            c, v = bufs[slot]
            coords = c.to(dev, non_blocking=True)
            targets = v.to(dev, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            copied[slot] = ev
            # the prefetch after the last step would be read for nothing
            if i + 1 < n_steps:
                pending = pool.submit(fill, 1 - slot)
            state = train_step_hostbatch(field, state, coords, targets)
    return state
