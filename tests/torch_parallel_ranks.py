"""The rank side of the port's multi-rank tests (tests/test_torch_parallel.py,
tests/test_torch_multihost.py).

Each function here runs in one rank of a process group that
`instantvnr_torch.parallel.mesh.spawn` forms on the CPU over gloo: it takes
its inputs as numpy (made by the test from a seed, or the JAX package's
arrays converted with numpy) and returns numpy, so this module imports only
torch, numpy and the port. The tests hold what the ranks return to the JAX
package's results.
"""
from __future__ import annotations

import numpy as np
import torch

from instantvnr_torch.config import (EncodingConfig, ModelConfig,
                                     NetworkConfig, OptimizerConfig,
                                     TransferFunctionConfig)
from instantvnr_torch.models.network import NeuralField, params_from_numpy
from instantvnr_torch.models.trainer import state_for_params
from instantvnr_torch.parallel import ep, tp
from instantvnr_torch.parallel import mesh as pm
from instantvnr_torch.parallel import train as pt
from instantvnr_torch.parallel.inspect import count_collectives

# tests/test_parallel.py's small_field (lr 5e-3) and tests/test_multihost.py's
# (lr 1e-2), as keyword arguments both packages' configs take
SMALL = dict(encoding=dict(n_levels=4, n_features_per_level=4,
                           log2_hashmap_size=12, base_resolution=4),
             network=dict(n_neurons=32, n_hidden_layers=2),
             optimizer=dict(learning_rate=5e-3, decay_start=10_000))


def small_kwargs(n_levels=4, lr=5e-3, compute_dtype="bfloat16") -> dict:
    kw = {k: dict(v) for k, v in SMALL.items()}
    kw["encoding"]["n_levels"] = n_levels
    kw["optimizer"]["learning_rate"] = lr
    return dict(kw, compute_dtype=compute_dtype)


def small_field(**kw) -> NeuralField:
    k = small_kwargs(**kw)
    return NeuralField.from_config(ModelConfig(
        encoding=EncodingConfig(**k["encoding"]),
        network=NetworkConfig(**k["network"]),
        optimizer=OptimizerConfig(**k["optimizer"]),
        compute_dtype=k["compute_dtype"]))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _tree_np(tree):
    return torch.utils._pytree.tree_map(_np, tree)


def _volume(kind, dims):
    from instantvnr_torch.data.volume import synthetic_volume

    return synthetic_volume(dims, kind=kind, device="cpu").data


def _rows(a, i, n):
    k = a.shape[0] // n
    return a[i * k:(i + 1) * k]


# -- tests/test_torch_parallel.py: two ranks ---------------------------------


def _dp_cases(rank, mesh, plan):
    out = {}
    n = mesh.shape["data"]
    # the host-batch step on this rank's rows, float32 compute (the JAX
    # twin's XLA MLP and this package's plain MLP are the same function)
    f32 = small_field(compute_dtype="float32")
    c, t = (_rows(a, rank, n) for a in plan["dp_batch"])
    state = state_for_params(params_from_numpy(plan["dp_params"], "cpu"))
    c, t = pt.shard_host_batch(mesh, c, t)
    step = pt.make_dp_hostbatch_step(f32, mesh)
    out["dp_hostbatch"] = count_collectives(lambda: out.setdefault(
        "dp_state", step(state, c, t)))
    s = out.pop("dp_state")
    out["dp_loss"], out["dp_params"] = _np(s.loss), _tree_np(s.params)
    # bf16: the fused mean of the halves' gradients
    from instantvnr_torch.models.trainer import value_and_grad

    bf = small_field()
    params = params_from_numpy(plan["dp_params_bf16"], "cpu")
    c, t = (torch.from_numpy(_rows(a, rank, n)) for a in plan["dp_batch"])
    loss, grads = value_and_grad(bf, params, c, t)
    grads, loss = pt.fused_pmean((grads, loss), mesh)
    out["dp_mean_grads"], out["dp_mean_loss"] = _tree_np(grads), _np(loss)
    # replicate_state: every rank ends with rank 0's state
    from instantvnr_torch.models.trainer import create_train_state

    vol = _volume("sphere", (16, 16, 16))
    st = pt.replicate_state(create_train_state(bf, seed=rank, device="cpu"),
                            mesh)
    out["replicated_table"] = _np(st.params["table"])
    out["replicated_gen"] = st.generator.get_state().numpy()
    st = pt.make_dp_train_step(bf, mesh, batch=2048, n_steps=50)(st, vol)
    out["dp_converge_loss"] = _np(st.loss)
    f8 = small_field(n_levels=8)
    st8 = pt.replicate_state(create_train_state(f8, device="cpu"), mesh)
    out["pin_dp"] = count_collectives(
        pt.make_dp_train_step(f8, mesh, batch=64 * n), st8, vol)
    # fused_pmean against leafwise means
    tree = {"a": torch.arange(24.0).reshape(8, 3),
            "b": (torch.ones((8, 2)) * torch.arange(8.0)[:, None],
                  torch.arange(8.0))}
    local = torch.utils._pytree.tree_map(lambda x: _rows(x, rank, n), tree)
    out["fused_pmean"] = _tree_np(pt.fused_pmean(local, mesh))
    out["leafwise_pmean"] = _tree_np(torch.utils._pytree.tree_map(
        lambda x: pm.all_reduce_sum(x, mesh, "data") / n, local))
    return out


def _tp_cases(rank, mesh, plan):
    out = {}
    field = small_field()
    n_model = mesh.shape["model"]
    shard = mesh.axis_index("model")
    local = tp.tp_params_from_numpy(plan["tp_split"], shard, "cpu")
    lp = tp.local_level_params(tp.shard_level_params(field, n_model), shard)
    coords = torch.from_numpy(plan["tp_grad_batch"][0])
    out["tp_forward"] = _np(tp.tp_apply(field, local, lp, coords, mesh))
    out.update(_tp_grad_case(field, mesh, plan))
    vol = _volume("sphere", (16, 16, 16))
    f8 = small_field(n_levels=8)
    st8 = tp.create_tp_train_state(f8, mesh)
    out["pin_tp"] = count_collectives(
        tp.make_tp_train_step(f8, mesh, batch=64 * mesh.shape["data"]), st8,
        vol)
    st = tp.create_tp_train_state(field, mesh, seed=0)
    st = tp.make_tp_train_step(field, mesh, batch=2048, n_steps=40)(st, vol)
    out["tp_converge_loss"] = _np(st.loss)
    st = tp.create_tp_train_state(field, mesh, seed=5)
    st = tp.make_tp_train_step(field, mesh, batch=1024, n_steps=20)(st, vol)
    out["tp_trained_local"] = _tree_np(st.params)
    out["tp_trained_loss"] = _np(st.loss)
    return out


def _tp_grad_case(field, mesh, plan):
    """The TP gradient of the L1 loss on plan["tp_grad_batch"] (this data
    rank's rows), after the data mean: this rank's local grads."""
    n_model, n_data = mesh.shape["model"], mesh.shape["data"]
    shard, d = mesh.axis_index("model"), mesh.axis_index("data")
    local = tp.tp_params_from_numpy(plan["tp_split"], shard, "cpu")
    lp = tp.local_level_params(tp.shard_level_params(field, n_model), shard)
    c, t = (torch.from_numpy(_rows(a, d, n_data))
            for a in plan["tp_grad_batch"])
    loss, grads = tp._tp_grads(field, mesh, local, lp,
                               tp.level_caps(field, n_model), c, t)
    return {"tp_grads": _tree_np(grads), "tp_grad_loss": _np(loss),
            "tp_index": (d, shard)}


def _render_cases(rank, mesh, plan):
    from instantvnr_torch.accel import macrocell as mcmod
    from instantvnr_torch.parallel.render import make_sharded_render_fn
    from instantvnr_torch.render.raymarch import RaymarchSettings, raymarch
    from instantvnr_torch.render.renderer import reference_sample_fn
    from instantvnr_torch.utils.tfn import bake_transfer_function

    r = plan["rays"]
    vol = torch.from_numpy(r["volume"])
    tf = bake_transfer_function(TransferFunctionConfig(), device="cpu")
    mc = mcmod.build(vol, tuple(r["dims"]), tf)
    settings = RaymarchSettings(n_iters=4, max_supersteps=48)
    args = [torch.from_numpy(r[k]) for k in ("org", "dirn", "t0", "t1")]
    jitter = torch.from_numpy(r["jitter"])
    fn = make_sharded_render_fn(reference_sample_fn, mesh, settings)
    out = {}
    out["pin_ray"] = count_collectives(lambda: out.setdefault(
        "ray_sharded", _np(fn(vol, *args, mc, tf, jitter))))
    from functools import partial

    out["ray_local"] = _np(raymarch(partial(reference_sample_fn, vol), *args,
                                    mc, tf, jitter, settings))
    return out


def _ep_cases(rank, mesh, plan):
    out = {}
    field = small_field()
    e = plan["ep"]
    params = ep.expert_params_from_numpy(e["params"], rank, "cpu")
    state = state_for_params(params)
    dims = tuple(e["dims"])
    decode = ep.make_ep_decode(field, mesh, dims, gather=True)
    out["ep_decode_jax_params"] = _np(decode(state))
    local = ep.make_ep_decode(field, mesh, dims)
    out["pin_ep_decode"] = count_collectives(local, state)
    vol = _volume("sphere", (32, 32, 32))
    out["pin_ep_step"] = count_collectives(
        ep.make_ep_train_step(field, mesh, batch=256),
        ep.create_ep_train_state(field, mesh), vol)
    return out


def _ep_train_cases(mesh):
    """Train one expert a rank for 80 steps on the sphere 32³ and decode
    the stitched volume."""
    field = small_field()
    vol = _volume("sphere", (32, 32, 32))
    st = ep.create_ep_train_state(field, mesh, seed=0)
    st = ep.make_ep_train_step(field, mesh, batch=2048, n_steps=80)(st, vol)
    full = ep.make_ep_decode(field, mesh, (32, 32, 32), gather=True)(st)
    return {"ep_loss": _np(st.loss), "ep_table": _np(st.params["table"]),
            "ep_full": _np(full)}


def slab_frames(mesh, cases):
    """The slab-sharded frame of each case, (eye, size, xform kwargs,
    host volume?, shadow?), on the vorts 32³ of plan["slab"] → {case:
    (sharded rgba, single-device rgba, collectives of the sharded
    frame)}."""
    from instantvnr_torch.parallel.slab import (make_sharded_slab_render,
                                                shard_volume_slabs)
    from instantvnr_torch.render.camera import Camera
    from instantvnr_torch.render.slabmarch import (SlabSettings,
                                                   camera_arrays,
                                                   permuted_dims,
                                                   principal_axis,
                                                   slab_render)
    from instantvnr_torch.render.transform import default_transform
    from instantvnr_torch.utils.tfn import bake_transfer_function

    tf = bake_transfer_function(TransferFunctionConfig(), device="cpu")
    out = {}
    for name, c in cases.items():
        vol_np = c["volume"]
        vol = torch.from_numpy(vol_np)
        cam = Camera(eye=c["eye"], center=(0, 0, 0), up=(0, 1, 0), fovy=40)
        ca = camera_arrays(cam, "cpu")
        xform = default_transform(vol_np.shape[::-1], "cpu")
        if c.get("clip") is not None:
            lo, hi, sc = (torch.tensor(v, dtype=torch.float32)
                          for v in c["clip"])
            xform = xform._replace(clip_lower=lo, clip_upper=hi, scale=sc)
        axis, flipped = principal_axis(cam, xform.scale.numpy())
        s = SlabSettings()
        src = vol_np if c.get("host") else vol
        chunk, _ = shard_volume_slabs(src, mesh, axis, flipped)
        sh = None
        if c.get("shadow") is not None:
            sh, _ = shard_volume_slabs(c["shadow"], mesh, axis, flipped)
        w = h = c["size"]
        fn = make_sharded_slab_render(mesh, w, h, s, axis, flipped,
                                      vol_np.shape)
        d_slab = permuted_dims(vol_np.shape, axis)[0]
        occ = torch.ones((d_slab,), dtype=torch.bool)
        got = {}
        pins = count_collectives(lambda: got.setdefault(
            "f", fn(chunk, tf, ca, occ, xform, sh)))
        sv = None if c.get("shadow") is None else torch.from_numpy(
            c["shadow"])
        ref = slab_render(vol, tf, ca, w, h, s, axis, flipped, None, xform,
                          shadow_volume=sv)
        out[name] = (_np(got["f"]), _np(ref), pins, tuple(chunk.shape))
    return out


def group_two(rank, dev, plan):
    """Every two-rank case of tests/test_torch_parallel.py."""
    m1 = pm.make_mesh(device=dev)
    m2 = pm.make_mesh(tp=2, device=dev)
    me = ep.make_expert_mesh(dev)
    out = {"mesh": (m1.shape, m1.index, m2.shape, m2.index,
                    pm.data_axis_size(m1))}
    out.update(_dp_cases(rank, m1, plan))
    out.update(_tp_cases(rank, m2, plan))
    out.update(_render_cases(rank, m1, plan))
    out.update(_ep_cases(rank, me, plan))
    out["slab"] = slab_frames(m1, plan["slab"])
    return out


def group_four(rank, dev, plan):
    """The 2 × 2 (data × model) mesh, its layout and the TP gradient; four
    experts trained and decoded."""
    m = pm.make_mesh(tp=2, device=dev)
    out = {"mesh": (m.shape, m.index, pm.make_mesh(device=dev).shape)}
    out.update(_tp_grad_case(small_field(), m, plan))
    out.update(_ep_train_cases(ep.make_expert_mesh(dev)))
    return out


# -- tests/test_torch_multihost.py: two processes ----------------------------


def multihost(rank, dev, plan):
    """The two-process cases of tests/test_multihost.py, one rank a
    process: DP, out-of-core DP (each rank streams its own blocks), TP, EP
    and the slab-sharded frame."""
    from instantvnr_torch.models.trainer import create_train_state

    out = {}
    field = small_field(lr=1e-2)
    mesh = pm.make_mesh(device=dev)
    vol = _volume("sphere", (16, 16, 16))
    # DP, 30 steps
    st = pt.replicate_state(create_train_state(field, device=dev), mesh)
    st = pt.make_dp_train_step(field, mesh, batch=2048, n_steps=30)(st, vol)
    out["dp_loss"] = _np(st.loss)
    # out of core: this rank's own sampler over the shared raw file
    from instantvnr_torch.config import VolumeDesc
    from instantvnr_torch.data.outofcore import OutOfCoreSampler

    desc = VolumeDesc(filename=plan["ooc_path"], dims=(32, 32, 32),
                      dtype="FLOAT")
    sampler = OutOfCoreSampler(desc, (0.0, 1.0), block_y=16, block_z=16,
                               use_native=False, seed=1337 + rank)
    st = pt.replicate_state(create_train_state(field, device=dev), mesh)
    step = pt.make_dp_hostbatch_step(field, mesh)
    first = None
    for _ in range(120):
        c, t = sampler.sample(2048)  # this rank's half of 4096
        if first is None:
            first = c
        st = step(st, *pt.shard_host_batch(mesh, c, t))
    out["ooc_loss"] = _np(st.loss)
    out["ooc_first_coords"] = first
    # TP over the two processes
    m2 = pm.make_mesh(tp=2, device=dev)
    st = tp.create_tp_train_state(field, m2)
    st = tp.make_tp_train_step(field, m2, batch=2048, n_steps=30)(st, vol)
    out["tp_loss"] = _np(st.loss)
    # EP: one expert a process, the stitched decode all-gathered
    me = ep.make_expert_mesh(dev)
    st = ep.create_ep_train_state(field, me)
    st = ep.make_ep_train_step(field, me, batch=1024, n_steps=30)(st, vol)
    out["ep_loss"] = _np(st.loss)
    out["ep_full"] = _np(ep.make_ep_decode(field, me, (16, 16, 16),
                                           gather=True)(st))
    # the slab-sharded frame across the process boundary
    out["slab"] = slab_frames(mesh, plan["slab"])
    return out


# -- tests/test_torch_cuda.py: on the card -----------------------------------


def tp_card_vs_cpu(rank, dev, plan):
    """The TP forward and gradient (tp = 2, one rank a model shard) on the
    card and on the CPU, through the same gloo group, with the card's K3
    and K4 launches."""
    from instantvnr_torch.ops import hash_encoding as he

    field = small_field()
    mesh = pm.make_mesh(tp=2, device=dev)
    lp = tp.local_level_params(tp.shard_level_params(field, 2), rank)
    caps = tp.level_caps(field, 2)
    out = {}
    for where in (dev, torch.device("cpu")):
        local = tp.tp_params_from_numpy(plan["tp_split"], rank, where)
        c, t = (torch.from_numpy(a).to(where) for a in plan["batch"])
        fwd = tp.tp_apply(field, local, lp, c, mesh)
        k3, k4 = he.counter.launches, he.backward_counter.launches
        loss, grads = tp._tp_grads(field, mesh, local, lp, caps, c, t)
        out[where.type] = {"forward": _np(fwd), "loss": _np(loss),
                           "grads": _tree_np(grads),
                           "k3": he.counter.launches - k3,
                           "k4": he.backward_counter.launches - k4}
    return out


def dp_world1_on_card(rank, dev, plan):
    """A world-1 DP host-batch step against trainer.train_step_hostbatch on
    one gradient (both take the first call's: K4's float atomics would
    sum two calls in two orders), the reduce alone on a gradient, and the
    kernels and collectives of the DP steps."""
    from instantvnr_torch.models import trainer
    from instantvnr_torch.ops import fused_mlp as fm
    from instantvnr_torch.ops import hash_encoding as he

    field = small_field()
    mesh = pm.make_mesh(device=dev)
    params = params_from_numpy(plan["params"], dev)
    c, t = (torch.from_numpy(a).to(dev) for a in plan["batch"])
    counters = (he.counter, fm.train_forward_counter, fm.backward_counter,
                he.backward_counter)
    real, memo = trainer.value_and_grad, []

    def once(*args):
        if not memo:
            memo.append(real(*args))
        return memo[0]

    trainer.value_and_grad = pt.value_and_grad = once
    try:
        before = [k.launches for k in counters]
        single = trainer.train_step_hostbatch(field, state_for_params(params),
                                              c, t)
        k = [x.launches for x in counters]
        dp = pt.make_dp_hostbatch_step(field, mesh)(state_for_params(params),
                                                    c, t)
    finally:
        trainer.value_and_grad = pt.value_and_grad = real

    def leaves(s):
        return torch.utils._pytree.tree_leaves(
            (s.params, s.opt.mu, s.opt.nu, s.loss, s.generator.get_state()))

    same = [bool(torch.equal(a, b))
            for a, b in zip(leaves(dp), leaves(single))]
    loss, grads = real(field, params, c, t)
    reduced = pt.fused_pmean((grads, loss), mesh)
    vol = _volume("sphere", (16, 16, 16)).to(dev)

    def launched(fn, *args):
        before = [x.launches for x in counters]
        pins = count_collectives(fn, *args)
        return [x.launches - y for x, y in zip(counters, before)], pins

    train_launches, train_pins = launched(
        pt.make_dp_train_step(field, mesh, batch=4096), dp, vol)
    host_launches, host_pins = launched(
        pt.make_dp_hostbatch_step(field, mesh), dp, c, t)
    return {"same": same,
            "reduce_same": [bool(torch.equal(a, b)) for a, b in zip(
                torch.utils._pytree.tree_leaves(reduced),
                torch.utils._pytree.tree_leaves((grads, loss)))],
            "single_launches": [b - a for a, b in zip(before, k)],
            "hostbatch_launches": host_launches,
            "train_launches": train_launches,
            "pins": (host_pins, train_pins)}
