"""Tensor parallelism over hash-grid levels (counterpart of
`instantvnr_tpu/parallel/tp.py`; no reference counterpart).

The hash table dominates the parameters; the MLP is tiny. The TP axis is
the LEVEL dimension:

  - each "model" rank owns a contiguous slice of levels, in a sub-table
    padded to a common entry count E_max (the JAX package's stacked
    [n_model, E_max, F] layout, so that its TP params converted with numpy
    are this package's too);
  - the encode is local: a rank gathers only from its own levels (the
    traced encode, ops/hash_encoding.py: K3 forward and K4 backward on the
    card, over the rank's level rows);
  - the first MLP layer is row-parallel: W1 is split by input-feature rows
    ([n_model, (L/n)·F, width]); each rank contracts its local features and
    ONE sum all-reduce over "model" gives the full first-layer activation;
  - the rest of the MLP is replicated.

The all-reduce is an autograd function whose backward is the identity:
every model rank holds the same cotangent of the summed activation, and
that is the cotangent of each rank's partial sum. (The JAX package reduces
with `jax.lax.psum` inside `shard_map(check_vma=False)`, whose transpose is
another psum: its table and W1 gradients come out n_model times the true
gradient — ROADMAP Queue 3. This step gives the single-device gradient.)

A step issues two all-reduces: the forward's over "model" and the fused
gradient mean over "data". Table and W1 gradients stay on their rank; the
tail's are the same on every model rank, as its forward is.
"""
from __future__ import annotations

import numpy as np
import torch

from instantvnr_torch.models.network import NeuralField, init_params
from instantvnr_torch.models.optimizer import adam_update
from instantvnr_torch.models.trainer import (TrainState, loss_terms,
                                             state_for_params)
from instantvnr_torch.ops.hash_encoding import (hash_encode_traced,
                                                hash_encode_traced_splitgrad,
                                                level_param_arrays)
from instantvnr_torch.ops.mlp import apply_activation
from instantvnr_torch.parallel.mesh import Mesh, all_reduce_sum
from instantvnr_torch.parallel.train import _rank_batch, fused_pmean
from instantvnr_torch.utils.device import resolve_device


def tp_layout(field: NeuralField, n_model: int):
    """Static layout: (levels a shard, padded entries a shard)."""
    spec = field.spec
    if spec.n_levels % n_model:
        raise ValueError(f"{spec.n_levels} levels not divisible by "
                         f"n_model={n_model}")
    lps = spec.n_levels // n_model
    shard_entries = [sum(spec.level_sizes[s * lps:(s + 1) * lps])
                     for s in range(n_model)]
    return lps, max(shard_entries)


def split_params_tp(field: NeuralField, params: dict, n_model: int) -> dict:
    """Single-device params → the TP layout {"table": [n_model, E_max, F],
    "w1": [n_model, lps·F, W], "mlp_rest": [...replicated...]}."""
    spec = field.spec
    lps, e_max = tp_layout(field, n_model)
    f = spec.n_features
    tables, w1s = [], []
    w1_full = params["mlp"][0]  # [L·F, W]
    for s in range(n_model):
        lo = spec.level_offsets[s * lps]
        hi = spec.level_offsets[(s + 1) * lps]
        t = params["table"][lo:hi]
        pad = e_max - (hi - lo)
        if pad:
            t = torch.cat([t, torch.zeros((pad, f), dtype=t.dtype,
                                          device=t.device)])
        tables.append(t)
        w1s.append(w1_full[s * lps * f:(s + 1) * lps * f])
    return {"table": torch.stack(tables), "w1": torch.stack(w1s),
            "mlp_rest": [w.clone() for w in params["mlp"][1:]]}


def merge_params_tp(field: NeuralField, tp_params: dict, n_model: int
                    ) -> dict:
    """Inverse of split_params_tp (drops the padding)."""
    spec = field.spec
    lps, _ = tp_layout(field, n_model)
    tables = []
    for s in range(n_model):
        lo = spec.level_offsets[s * lps]
        hi = spec.level_offsets[(s + 1) * lps]
        tables.append(tp_params["table"][s, :hi - lo])
    return {"table": torch.cat(tables),
            "mlp": [torch.cat(list(tp_params["w1"]))]
            + list(tp_params["mlp_rest"])}


def shard_level_params(field: NeuralField, n_model: int) -> dict:
    """Per-shard level parameters, [n_model, lps] host arrays, with the
    offsets rebased into each shard's padded local table."""
    spec = field.spec
    lps, _ = tp_layout(field, n_model)
    out = {k: v.reshape(n_model, lps).clone()
           for k, v in level_param_arrays(spec).items()}
    for s in range(n_model):
        out["offset"][s] -= spec.level_offsets[s * lps]
    return out


def level_caps(field: NeuralField, n_model: int) -> tuple:
    """Static per-local-level size bounds (the largest over the shards), for
    the split-grad backward."""
    spec = field.spec
    lps, _ = tp_layout(field, n_model)
    return tuple(max(spec.level_sizes[s * lps + l] for s in range(n_model))
                 for l in range(lps))


def local_params(tp_params: dict, shard: int) -> dict:
    """One model rank's params of the stacked TP layout."""
    return {"table": tp_params["table"][shard], "w1": tp_params["w1"][shard],
            "mlp_rest": list(tp_params["mlp_rest"])}


def local_level_params(lp: dict, shard: int) -> dict:
    return {k: v[shard] for k, v in lp.items()}


class _SumOverModel(torch.autograd.Function):
    """Sum all-reduce forward, identity backward: each rank's partial
    activation enters the sum with weight one, so its cotangent is the
    summed activation's, which every model rank already holds."""

    @staticmethod
    def forward(ctx, partial_h, mesh, axis):
        return all_reduce_sum(partial_h, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _matmul(x, w, compute_dtype):
    """JAX's jnp.dot(x, w.astype(cd), preferred_element_type=f32): a
    float32 product of operands rounded to the compute type."""
    return torch.matmul(x.to(compute_dtype).to(torch.float32),
                        w.to(compute_dtype).to(torch.float32))


def tp_apply(field: NeuralField, tp_local: dict, level_params_local: dict,
             coords: torch.Tensor, mesh: Mesh, axis: str = "model",
             level_caps: tuple | None = None) -> torch.Tensor:
    """The forward on one model rank: local encode → row-parallel W1 → sum
    all-reduce over `axis` → replicated MLP tail. coords [B, 3] → [B, 1].

    level_caps routes the table gradient through the split-grad backward
    (`hash_encode_traced_splitgrad`); None keeps the traced encode's own."""
    cfg = field.cfg
    cd = field.compute_dtype
    nf = field.spec.n_features
    lps = field.spec.n_levels // mesh.shape[axis]
    if level_caps is not None:
        feats = hash_encode_traced_splitgrad(
            tp_local["table"], coords, level_params_local, level_caps, nf,
            compute_dtype=cd)
    else:
        feats = hash_encode_traced(tp_local["table"], coords,
                                   level_params_local, lps, nf,
                                   compute_dtype=cd)  # [B, lps·F]
    partial_h = _matmul(feats, tp_local["w1"], cd)
    h = _SumOverModel.apply(partial_h, mesh, axis)  # the one TP collective
    act, out_act = cfg.network.activation, cfg.network.output_activation
    h = apply_activation(h, act).to(cd)
    for w in tp_local["mlp_rest"][:-1]:
        h = apply_activation(_matmul(h, w, cd), act).to(cd)
    return apply_activation(_matmul(h, tp_local["mlp_rest"][-1], cd),
                            out_act)


def _as_mlp_tree(p: dict) -> dict:
    """The TP params as {"table", "mlp"} (W1 first), the layout Adam and
    its L2 mask take."""
    return {"table": p["table"], "mlp": [p["w1"], *p["mlp_rest"]]}


def _as_tp_tree(p: dict) -> dict:
    return {"table": p["table"], "w1": p["mlp"][0],
            "mlp_rest": list(p["mlp"][1:])}


def _tp_grads(field: NeuralField, mesh: Mesh, params: dict, lp_local: dict,
              caps: tuple, coords, targets):
    """(loss, grads) of the local params on one (data, model) rank, the
    grads meaned over "data" with the loss in one fused all-reduce."""
    kind = field.cfg.loss.otype.lower()
    leaves = [params["table"], params["w1"], *params["mlp_rest"]]
    live = [p.detach().requires_grad_() for p in leaves]
    local = {"table": live[0], "w1": live[1], "mlp_rest": live[2:]}
    with torch.enable_grad():
        pred = tp_apply(field, local, lp_local, coords, mesh,
                        level_caps=caps)
        loss = torch.mean(loss_terms(kind, pred, targets))
        g = torch.autograd.grad(loss, live)
    grads = {"table": g[0], "w1": g[1], "mlp_rest": list(g[2:])}
    grads, loss = fused_pmean((grads, loss.detach()), mesh, "data")
    return loss, grads


def _tp_step(field: NeuralField, mesh: Mesh, state: TrainState,
             lp_local: dict, caps: tuple, coords, targets) -> TrainState:
    """One TP step on a given batch (this data rank's rows; the same on
    every model rank)."""
    loss, grads = _tp_grads(field, mesh, state.params, lp_local, caps,
                            coords, targets)
    params, opt = adam_update(
        field.cfg.optimizer, _as_mlp_tree(state.params), _as_mlp_tree(grads),
        state.opt._replace(mu=_as_mlp_tree(state.opt.mu),
                           nu=_as_mlp_tree(state.opt.nu)),
        l2_mask={"table": False, "mlp": [True] * (1 + len(grads["mlp_rest"]))})
    opt = opt._replace(mu=_as_tp_tree(opt.mu), nu=_as_tp_tree(opt.nu))
    return state._replace(params=_as_tp_tree(params), opt=opt, loss=loss)


def make_tp_train_step(field: NeuralField, mesh: Mesh, batch: int,
                       n_steps: int = 1):
    """A (data × model) step, (state, volume) → state, on this rank's
    local TP params (`create_tp_train_state`). The batch is the same on
    every model rank of a data row (the stream folded with the data index)
    and differs across the data axis."""
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    if batch % n_data:
        raise ValueError(f"batch {batch} not divisible by the data axis "
                         f"({n_data})")
    local_batch = batch // n_data
    lp_local = local_level_params(shard_level_params(field, n_model),
                                  mesh.axis_index("model"))
    caps = level_caps(field, n_model)
    d_idx = mesh.axis_index("data")

    def step(state: TrainState, volume: torch.Tensor) -> TrainState:
        for _ in range(n_steps):
            coords, targets = _rank_batch(state, volume, d_idx, local_batch)
            state = _tp_step(field, mesh, state, lp_local, caps, coords,
                             targets)
        return state

    return step


def create_tp_train_state(field: NeuralField, mesh: Mesh, seed: int = 0
                          ) -> TrainState:
    """This rank's TP train state: the single-device init of `seed` (drawn
    on the CPU, the same on every rank), split, and only this rank's shard
    moved to its device; Adam moments zero."""
    dev = resolve_device(mesh.device)
    n_model = mesh.shape["model"]
    base = init_params(torch.Generator(device="cpu").manual_seed(seed), field,
                       device="cpu")
    local = local_params(split_params_tp(field, base, n_model),
                         mesh.axis_index("model"))
    local = {"table": local["table"].to(dev), "w1": local["w1"].to(dev),
             "mlp_rest": [w.to(dev) for w in local["mlp_rest"]]}
    state = state_for_params(_as_mlp_tree(local), seed=seed)
    return state._replace(params=local, opt=state.opt._replace(
        mu=_as_tp_tree(state.opt.mu), nu=_as_tp_tree(state.opt.nu)))


def tp_params_from_numpy(tp_params_np: dict, shard: int, device="cuda"
                         ) -> dict:
    """One rank's local params from the stacked TP layout as numpy (the JAX
    package's split_params_tp converted with np.asarray)."""
    dev = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return {"table": t(tp_params_np["table"][shard]),
            "w1": t(tp_params_np["w1"][shard]),
            "mlp_rest": [t(w) for w in tp_params_np["mlp_rest"]]}
