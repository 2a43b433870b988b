"""The benchmark's plain reference against the port's own plain versions,
at tiny sizes on the CPU: the same inputs give the same answers."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from benchmark.reference import fields, training
from benchmark.reference import frame as rf
from benchmark.reference.volume import sample_tex, vorts

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY_GRID = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
             "log2_hashmap_size": 10, "base_resolution": 8,
             "per_level_scale": 2.0}


def config(name, **changes):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        return {**json.load(f), **changes}


def port_field(cfg, compute="float32"):
    from benchmark.traffic.train import port_config
    from instantvnr_torch.api import _field_from_config

    pc = dataclasses.replace(port_config(cfg), compute_dtype=compute)
    return _field_from_config(pc)[1]


def as_params(leaves):
    return {"table": leaves[0], "mlp": list(leaves[1:])}


def test_volume_sample_is_the_ports():
    from instantvnr_torch.ops.trilinear import sample_volume_tex

    vol = vorts((12, 10, 9), 5, "cpu")
    assert vol.shape == (9, 10, 12) and float(vol.max()) == 1.0
    p = torch.rand((500, 3), generator=torch.Generator().manual_seed(1))
    assert torch.equal(sample_tex(vol, p), sample_volume_tex(vol, p))


def test_volumes_differ_by_seed_not_by_size():
    a, b = vorts((16,) * 3, 1, "cpu"), vorts((16,) * 3, 2, "cpu")
    assert a.shape == b.shape and not torch.equal(a, b)
    assert torch.equal(a, vorts((16,) * 3, 1, "cpu"))


def test_grid_corners_are_the_ports():
    from instantvnr_torch.ops.hash_encoding import (HashGridSpec,
                                                    corner_indices_and_weights)
    from instantvnr_torch.config import EncodingConfig

    cfg = config("vnr_ref_2e19", encoding=TINY_GRID)
    spec = fields.GridSpec.from_config(cfg)
    pspec = HashGridSpec.from_config(EncodingConfig(**{
        k: v for k, v in TINY_GRID.items()}))
    assert spec.n_entries == pspec.n_entries
    p = torch.rand((300, 3), generator=torch.Generator().manual_seed(2))
    i, w = fields.grid_corners(spec, p)
    pi, pw = corner_indices_and_weights(pspec, p)
    assert torch.equal(i, pi) and torch.equal(w, pw)


def test_field_forward_is_the_ports_in_float32():
    from instantvnr_torch.models.network import network_apply

    cfg = config("vnr_ref_2e19", encoding=TINY_GRID)
    model = fields.model_for(cfg)
    leaves = model.init_serving(torch.Generator().manual_seed(3), "cpu")
    p = torch.rand((400, 3), generator=torch.Generator().manual_seed(4))
    ours = model.apply(leaves, p, fields.rounding("float32"))
    theirs = network_apply(as_params(leaves), p, port_field(cfg))
    torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-5)


def test_field_forward_in_bf16_stays_near_the_ports():
    from instantvnr_torch.models.network import network_apply

    cfg = config("vnr_ref_2e19", encoding=TINY_GRID)
    model = fields.model_for(cfg)
    leaves = model.init_serving(torch.Generator().manual_seed(5), "cpu")
    p = torch.rand((400, 3), generator=torch.Generator().manual_seed(6))
    ours = model.apply(leaves, p, fields.rounding("bfloat16"))
    theirs = network_apply(as_params(leaves), p, port_field(cfg, "bfloat16"))
    scale = float(theirs.abs().max())
    assert float((ours - theirs).abs().max()) <= 2e-2 * scale
    # the control's precision is far coarser
    ctl = model.apply(leaves, p, fields.rounding("float8_e4m3"))
    assert float((ctl - theirs).abs().max()) > 4e-2 * scale


def test_training_steps_are_the_ports_in_float32():
    from benchmark.traffic.train import optimizer_of
    from instantvnr_torch.models.trainer import state_for_params, train_steps

    cfg = config("vnr_ref_2e19", encoding=TINY_GRID)
    model = fields.model_for(cfg)
    seed, batch = 11, 2048
    leaves = model.init(torch.Generator().manual_seed(7), "cpu")
    vol = vorts((16, 16, 16), seed, "cpu")
    losses, first, after = training.train_steps(
        model, leaves, vol, seed, batch, 2, fields.rounding("float32"),
        optimizer_of(cfg))
    field = port_field(cfg)
    state = state_for_params(as_params([x.clone() for x in leaves]),
                             seed=seed)
    state = train_steps(field, vol, state, 1, batch)
    assert float(state.loss) == pytest.approx(losses[0], rel=1e-5)
    g = [m / 0.1 for m in [state.opt.mu["table"], *state.opt.mu["mlp"]]]
    for a, b in zip(g, first):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-9)
    state = train_steps(field, vol, state, 1, batch)
    assert float(state.loss) == pytest.approx(losses[1], rel=1e-5)
    for a, b in zip([state.params["table"], *state.params["mlp"]], after):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_a_late_step_from_the_ports_state_is_the_ports():
    # the reference follows the program's state after n steps, drawing
    # past the n steps' coordinates: its step n + 1 is the program's
    from benchmark.traffic.train import optimizer_of
    from instantvnr_torch.models.trainer import state_for_params, train_steps

    cfg = config("vnr_ref_2e19", encoding=TINY_GRID)
    model = fields.model_for(cfg)
    seed, batch, n = 12, 2048, 5
    leaves = model.init(torch.Generator().manual_seed(8), "cpu")
    vol = vorts((16, 16, 16), seed, "cpu")
    field = port_field(cfg)
    state = train_steps(field, vol, state_for_params(
        as_params([x.clone() for x in leaves]), seed=seed), n, batch)
    snap = {"step": state.opt.step,
            "m": [x.clone() for x in [state.opt.mu["table"],
                                      *state.opt.mu["mlp"]]],
            "v": [x.clone() for x in [state.opt.nu["table"],
                                      *state.opt.nu["mlp"]]]}
    before = [x.clone() for x in [state.params["table"],
                                  *state.params["mlp"]]]
    assert snap["step"] == n
    losses, _, after = training.train_steps(
        model, before, vol, seed, batch, 1, fields.rounding("float32"),
        optimizer_of(cfg), state=snap, skip=n)
    state = train_steps(field, vol, state, 1, batch)
    assert float(state.loss) == pytest.approx(losses[0], rel=1e-5)
    for a, b in zip([state.params["table"], *state.params["mlp"]], after):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    # one draw fewer skipped is another step's batch
    other, _, _ = training.train_steps(
        model, before, vol, seed, batch, 1, fields.rounding("float32"),
        optimizer_of(cfg), state=snap, skip=n - 1)
    assert other[0] != pytest.approx(losses[0], rel=1e-5)


def small_scene(seed=3):
    dims = (24, 20, 16)
    vol = vorts(dims, seed, "cpu")
    tf = rf.bake_tf([[0.0, 0.0, 0.0, 1.0], [1.0, 1.0, 0.0, 0.0]],
                    [[0.0, 0.0], [1.0, 1.0]], [0.0, 1.0], "cpu")
    cam = {"eye": [3.6, 2.4, -48.0], "center": [0, 0, 0], "up": [0, 1, 0],
           "fovy": 45.0}
    return vol, dims, tf, cam


def port_scene(vol, dims, cam, w, h):
    from instantvnr_torch.accel import macrocell as mcmod
    from instantvnr_torch.config import TransferFunctionConfig
    from instantvnr_torch.render.camera import Camera
    from instantvnr_torch.render.renderer import _frame_rays
    from instantvnr_torch.render.slabmarch import camera_arrays
    from instantvnr_torch.render.transform import default_transform
    from instantvnr_torch.utils.tfn import bake_transfer_function

    tf = bake_transfer_function(TransferFunctionConfig(), device="cpu")
    mc = mcmod.build(vol, dims, tf)
    c = Camera(eye=tuple(cam["eye"]), center=tuple(cam["center"]),
               up=tuple(cam["up"]), fovy=cam["fovy"])
    d = torch.tensor([float(x) for x in dims])
    rays = _frame_rays(w, h, camera_arrays(c, "cpu"), d,
                       torch.tensor([0.7, 0.9, 0.4]),
                       default_transform(dims, "cpu"))
    return tf, mc, rays


def test_macrocells_rays_and_emission_are_the_ports():
    from instantvnr_torch.render.raymarch import _emit_samples, init_ray_state

    vol, dims, tf, cam = small_scene()
    w, h = 20, 14
    scene = rf.make_scene(vol, dims, tf, cam, w, h, 8, 8)
    ptf, mc, (org, dirn, t0, t1, *_ ) = port_scene(vol, dims, cam, w, h)
    assert torch.equal(scene.occ, mc.max_opacity)
    assert torch.equal(scene.org, org) and torch.equal(scene.dirn, dirn)
    assert torch.equal(scene.t0, t0) and torch.equal(scene.t1, t1)
    state = init_ray_state(t0, t1)
    for _ in range(3):
        theirs = _emit_samples(org, dirn, t1, state, mc, 1.0, 8, 8)
        ours = rf.emit(org, dirn, t1, state.t, state.t_cell_end, state.ss,
                       scene.occ, 1.0, 8, 8)
        for a, b in zip(ours[0] + ours[1:], theirs[0] + theirs[1:]):
            assert torch.equal(a, b)
        state = state._replace(t=theirs[0][0], t_cell_end=theirs[0][1],
                               ss=theirs[0][2])


@pytest.mark.parametrize("max_skips", [8, 1])
def test_a_pass_is_the_ports_masked_march(max_skips):
    from instantvnr_torch.render.raymarch import RaymarchSettings, raymarch
    from instantvnr_torch.render.renderer import make_neural_sample_fn
    from instantvnr_torch.models.network import render_params

    vol, dims, tf, cam = small_scene(4)
    w, h = 24, 16
    cfg = config("vnr_ref_2e19", encoding=TINY_GRID)
    model = fields.model_for(cfg)
    leaves = model.init_serving(torch.Generator().manual_seed(8), "cpu")
    scene = rf.make_scene(vol, dims, tf, cam, w, h, 8, max_skips)
    jitter = torch.rand(w * h, generator=torch.Generator().manual_seed(9))
    ours, samples, steps = rf.render_pass(
        scene, lambda p: model.apply(leaves, p, fields.rounding("float32"))[
            :, 0], jitter)
    ptf, mc, (org, dirn, t0, t1, light, lo, hi) = port_scene(vol, dims, cam,
                                                             w, h)
    field = port_field(cfg)
    stats = {}
    theirs = raymarch(
        lambda p: make_neural_sample_fn(field)(
            render_params(as_params(leaves), field), p),
        org, dirn, t0, t1, mc, ptf, jitter,
        RaymarchSettings(n_iters=8, max_skips=max_skips), light_dir=light,
        stats=stats)
    assert steps == stats["supersteps"] and samples > 0
    torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-5)
