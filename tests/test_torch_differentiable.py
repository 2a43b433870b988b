"""The differentiable march, RaymarchSettings(fixed_steps=True), against the
JAX package's on the CPU (ROADMAP Queue 1 item 9).

The JAX package runs a lax.scan of exactly max_supersteps supersteps; its
frame is differentiable with respect to a network's params
(tests/test_api.py::test_rendered_image_grads_flow_to_network:
8 × 8 rays, n_iters 4, max_supersteps 16) and to a sampled volume
(tests/test_render.py::test_differentiable_render: _render_frame, 8 × 8,
max_supersteps 24). The same losses, on the same rays, jitter, params and
volume, go through both packages.

Tolerances:
- the volume's gradient: rtol 1e-4 of its largest entry (float32 sums in
  another order; the emission and the blend are the same operations);
- the network's gradients, float32 compute: rtol 1e-4 of the largest
  entry;
- the network's gradients, bf16 compute: 2e-2 of the largest entry. Both
  packages round the operands to bf16 and sum in float32, but JAX's
  autodiff of its XLA MLP rounds each layer's cotangent to bf16 where the
  port's training form keeps it in float32 (ops/fused_mlp.py), 2^-8 a
  layer.
"""
import dataclasses
import importlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantvnr_tpu.accel import macrocell as jmc
from instantvnr_tpu.config import EncodingConfig as JEnc
from instantvnr_tpu.config import ModelConfig as JModelConfig
from instantvnr_tpu.config import NetworkConfig as JNet
from instantvnr_tpu.config import TransferFunctionConfig as JTFConfig
from instantvnr_tpu.data import synthetic_volume as j_synthetic_volume
from instantvnr_tpu.models.network import NeuralField as JNeuralField
from instantvnr_tpu.render.camera import Camera as JCamera
from instantvnr_tpu.render.camera import camera_rays as j_camera_rays
from instantvnr_tpu.render.renderer import _render_frame as j_render_frame
from instantvnr_tpu.render.renderer import \
    make_neural_sample_fn as j_make_neural
from instantvnr_tpu.render.renderer import reference_sample_fn as j_ref_fn
from instantvnr_tpu.utils.math import ray_box_intersect as j_box
from instantvnr_tpu.utils.tfn import bake_transfer_function as j_bake
from instantvnr_torch.accel import macrocell as mcmod
from instantvnr_torch.config import EncodingConfig, ModelConfig, NetworkConfig
from instantvnr_torch.config import TransferFunctionConfig
from instantvnr_torch.data.volume import synthetic_volume
from instantvnr_torch.models.network import (NeuralField, params_from_numpy,
                                             render_params)
from instantvnr_torch.ops.hash_encoding import packed_dense_tables
from instantvnr_torch.render.camera import Camera, camera_rays
from instantvnr_torch.render.raymarch import RaymarchSettings, raymarch
from instantvnr_torch.render.renderer import (_render_frame,
                                              make_neural_sample_fn,
                                              reference_sample_fn)
from instantvnr_torch.render.slabmarch import camera_arrays
from instantvnr_torch.utils.math import ray_box_intersect
from instantvnr_torch.utils.tfn import bake_transfer_function

jrm = importlib.import_module("instantvnr_tpu.render.raymarch")
DIMS = (32, 32, 32)
ENC = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=12,
           base_resolution=4)
NET = dict(n_neurons=16, n_hidden_layers=2)


@pytest.fixture(scope="module")
def scene():
    """sphere 32³ (the JAX tests' volume), the default TF, each package's
    own macrocell."""
    jvol = j_synthetic_volume(DIMS, kind="sphere")
    tvol = synthetic_volume(DIMS, kind="sphere", device="cpu")
    jtf = j_bake(JTFConfig())
    ttf = bake_transfer_function(TransferFunctionConfig(), device="cpu")
    return (jvol, tvol, jtf, ttf, jmc.build(jvol.data, jvol.dims, jtf),
            mcmod.build(tvol.data, tvol.dims, ttf))


def _params_np(spec, widths, seed=5):
    """A trained-looking model: table ±0.5, He-normal MLP."""
    rng = np.random.default_rng(seed)
    return {"table": rng.uniform(-0.5, 0.5, (spec.n_entries, spec.n_features)
                                 ).astype(np.float32),
            "mlp": [(rng.standard_normal((a, b)) * np.sqrt(2.0 / a)).astype(
                np.float32) for a, b in zip(widths[:-1], widths[1:])]}


def _default_rays(n):
    """tests/test_api.py's rays: the default camera, voxel-space origins,
    the box [0, dims]."""
    cam = JCamera.default_for_dims(DIMS)
    org_w, dirn = j_camera_rays(cam, n, n)
    dims = jnp.array(DIMS, jnp.float32)
    org = org_w + 0.5 * dims
    t0, t1, hit = j_box(org, dirn, jnp.zeros(3), dims)
    t0 = jnp.where(hit, jnp.maximum(t0, 0.0), 1.0)
    t1 = jnp.where(hit, t1, 0.0)
    return [np.asarray(a) for a in (org, dirn, t0, t1)]


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("compute_dtype,rtol", [("float32", 1e-4),
                                                ("bfloat16", 2e-2)])
def test_network_gradients_match_jax(scene, compute_dtype, rtol):
    """tests/test_api.py:131's loss, sum(rgba²) over 8 × 8 rays, with the
    table's and the MLP's gradients held to JAX's."""
    _, _, jtf, ttf, jm, tm = scene
    jcfg = JModelConfig(encoding=JEnc(**ENC), network=JNet(**NET),
                        compute_dtype=compute_dtype)
    tcfg = ModelConfig(encoding=EncodingConfig(**ENC),
                       network=NetworkConfig(**NET),
                       compute_dtype=compute_dtype)
    jfield, tfield = JNeuralField.from_config(jcfg), NeuralField.from_config(
        tcfg)
    widths = [tfield.spec.n_output_dims, 16, 16, 1]
    p = _params_np(tfield.spec, widths)
    org, dirn, t0, t1 = _default_rays(8)
    jit = np.full((64,), 0.5, np.float32)
    jset = jrm.RaymarchSettings(n_iters=4, max_supersteps=16,
                                fixed_steps=True)
    tset = RaymarchSettings(n_iters=4, max_supersteps=16, fixed_steps=True)
    jfn = j_make_neural(jfield)

    def jloss(params):
        rgba = jrm.raymarch(partial(jfn, params), org, dirn, t0, t1, jm, jtf,
                            jnp.asarray(jit), jset)
        return jnp.sum(rgba ** 2)

    jg = jax.grad(jloss)({"table": jnp.asarray(p["table"]),
                          "mlp": [jnp.asarray(w) for w in p["mlp"]]})
    tp = params_from_numpy(p, "cpu")
    for t in [tp["table"], *tp["mlp"]]:
        t.requires_grad_(True)
    tfn = make_neural_sample_fn(tfield)
    t = torch.from_numpy
    rgba = raymarch(partial(tfn, tp), t(org), t(dirn), t(t0), t(t1), tm, ttf,
                    t(jit), tset)
    assert rgba.requires_grad and float(rgba[:, 3].detach().max()) > 0.1
    (rgba ** 2).sum().backward()
    gt = tp["table"].grad.numpy()
    assert np.abs(gt).sum() > 0 and np.isfinite(gt).all()
    assert _rel_err(gt, np.asarray(jg["table"])) < rtol
    for w, jw in zip(tp["mlp"], jg["mlp"]):
        assert np.abs(w.grad.numpy()).sum() > 0
        assert _rel_err(w.grad.numpy(), np.asarray(jw)) < rtol


@pytest.mark.parametrize("compute_dtype,rtol", [("float32", 1e-4),
                                                ("bfloat16", 2e-2)])
@pytest.mark.parametrize("trainable", [False, True])
def test_ray_gradients_match_jax(scene, compute_dtype, rtol, trainable):
    """The same loss differentiated in the rays' origins and directions
    (camera or pose refinement), the params frozen or trainable too: the
    gradient reaches the samples' positions through the emission's cell
    exits and steps and the sample's lerp, then the network through the
    hash encoding's coordinate backward; each held to jax.grad. bf16: JAX
    also rounds the encoding's coordinate cotangent to bf16
    (tests/test_torch_hash_coords_grad.py)."""
    _, _, jtf, ttf, jm, tm = scene
    jcfg = JModelConfig(encoding=JEnc(**ENC), network=JNet(**NET),
                        compute_dtype=compute_dtype)
    tcfg = ModelConfig(encoding=EncodingConfig(**ENC),
                       network=NetworkConfig(**NET),
                       compute_dtype=compute_dtype)
    jfield, tfield = JNeuralField.from_config(jcfg), NeuralField.from_config(
        tcfg)
    p = _params_np(tfield.spec, [tfield.spec.n_output_dims, 16, 16, 1])
    org, dirn, t0, t1 = _default_rays(8)
    jit = np.full((64,), 0.5, np.float32)
    jset = jrm.RaymarchSettings(n_iters=4, max_supersteps=16,
                                fixed_steps=True)
    tset = RaymarchSettings(n_iters=4, max_supersteps=16, fixed_steps=True)
    jfn = j_make_neural(jfield)

    def jloss(params, o, d):
        rgba = jrm.raymarch(partial(jfn, params), o, d, t0, t1, jm, jtf,
                            jnp.asarray(jit), jset)
        return jnp.sum(rgba ** 2)

    jp = {"table": jnp.asarray(p["table"]),
          "mlp": [jnp.asarray(w) for w in p["mlp"]]}
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(org),
                                            jnp.asarray(dirn))
    tp = params_from_numpy(p, "cpu")
    leaves = [tp["table"], *tp["mlp"]]
    for t in leaves:
        t.requires_grad_(trainable)
    to, td = (torch.from_numpy(a).requires_grad_(True) for a in (org, dirn))
    t = torch.from_numpy
    rgba = raymarch(partial(make_neural_sample_fn(tfield), tp), to, td,
                    t(t0), t(t1), tm, ttf, t(jit), tset)
    (rgba ** 2).sum().backward()
    for got, want in ((to.grad, jg[1]), (td.grad, jg[2])):
        got = got.numpy()
        assert np.isfinite(got).all() and np.abs(got).max() > 0
        assert _rel_err(got, np.asarray(want)) < rtol
    if trainable:
        for w, jw in zip(leaves, [jg[0]["table"], *jg[0]["mlp"]]):
            assert _rel_err(w.grad.numpy(), np.asarray(jw)) < rtol
    else:
        assert all(w.grad is None for w in leaves)


def test_emission_backward_is_the_plain_emissions():
    """The card's emission (`_Emit`: the `raymarch_emit` kernel forward,
    the `raymarch_emit_backward` kernel backward) gives the gradient of the
    plain emission under autograd, for every output and input: here with
    each kernel's launch replaced by its plain version (the forward's twin
    bit for bit, the backward's `_plain_emit_backward`;
    tests/test_torch_cuda.py holds the kernels to them)."""
    from instantvnr_torch.render import raymarch as rm

    vol = synthetic_volume(DIMS, kind="sphere", device="cpu")
    ttf = bake_transfer_function(TransferFunctionConfig(), device="cpu")
    tm = mcmod.build(vol.data, vol.dims, ttf)
    org, dirn, t0, t1 = (torch.from_numpy(a) for a in _default_rays(8))
    rng = np.random.default_rng(2)
    weights = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((64,), (64,), (64,), (64, 4), (64, 4))]
    args = (tm, 0.5, 4, 8, 1)

    def grads(emit):
        leaves = [x.clone().requires_grad_(True) for x in (org, dirn, t1)]
        state = rm.init_ray_state(t0, leaves[2])
        state = state._replace(t=state.t + 0.25 * leaves[0][:, 0])
        (t, tce, ss), t_x, t_y, valid = emit(leaves[0], leaves[1], leaves[2],
                                             state)
        assert valid.any()
        loss = sum((w * o).sum() for w, o in zip(
            weights, (t, tce, torch.where(torch.isfinite(ss), ss, 0.0),
                      t_x, t_y)))
        loss.backward()
        return [x.grad for x in leaves]

    want = grads(lambda o, d, tf, st: rm._emit_samples(o, d, tf, st, *args))

    def plain_launch(o, d, tf, t, tce, ss, *a):
        st = rm._RayState(t=t, t_cell_end=tce, ss=ss, alpha=None, color=None,
                          active=None, best_w=None, best_pos=None,
                          best_rgb=None)
        return rm._emit_samples(o, d, tf, st, *a)

    orig = rm._kernel_emit, rm._kernel_emit_backward
    rm._kernel_emit = plain_launch
    rm._kernel_emit_backward = rm._plain_emit_backward
    try:
        got = grads(lambda o, d, tf, st: (
            lambda r: ((r[0], r[1], r[2]), r[3], r[4], r[5]))(rm._Emit.apply(
                o, d, tf, st.t, st.t_cell_end, st.ss, *args)))
    finally:
        rm._kernel_emit, rm._kernel_emit_backward = orig
    for g, w in zip(got, want):
        assert w is not None and w.abs().sum() > 0
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("shading", ["none", "gradient", "ssh"])
def test_volume_gradient_matches_jax(scene, shading):
    """tests/test_render.py:148's loss, sum(frame²) of an 8 × 8 frame of
    the sampled volume, with the volume's gradient held to JAX's on JAX's
    jitter; with gradient shading the probes, with SSH the deferred shadow
    march carry gradient too."""
    jvol, tvol, jtf, ttf, jm, tm = scene
    jset = jrm.RaymarchSettings(n_iters=4, max_supersteps=24,
                                fixed_steps=True, shading=shading)
    tset = RaymarchSettings(n_iters=4, max_supersteps=24, fixed_steps=True,
                            shading=shading)
    jcam = JCamera.default_for_dims(DIMS)
    jca = (jnp.asarray(jcam.eye, jnp.float32),
           jnp.asarray(jcam.center, jnp.float32),
           jnp.asarray(jcam.up, jnp.float32), jnp.float32(jcam.fovy))
    key = jax.random.PRNGKey(0)

    def jloss(volume):
        _, frame = j_render_frame(j_ref_fn, 8, 8, jset, volume, jca, jm, jtf,
                                  key, jnp.zeros((64, 4), jnp.float32),
                                  jnp.int32(1))
        return jnp.sum(frame ** 2)

    jg = np.asarray(jax.grad(jloss)(jvol.data))
    jitter = torch.from_numpy(np.asarray(
        jax.random.uniform(key, (64,), jnp.float32)))
    vol = tvol.data.clone().requires_grad_(True)
    tca = camera_arrays(Camera.default_for_dims(DIMS), "cpu")
    _, frame = _render_frame(reference_sample_fn, 8, 8, tset, vol, tca, tm,
                             ttf, jitter, None, 1)
    (frame ** 2).sum().backward()
    g = vol.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0
    assert _rel_err(g, jg) < 1e-4


@pytest.mark.parametrize("shading", ["none", "gradient", "ssh"])
def test_fixed_steps_frame_equals_early_stopping(scene, shading):
    """Past the last active ray a superstep samples nothing and blends
    opacity 0, so the fixed-length march gives the early-stopping frame
    bit for bit, with autograd on or off."""
    _, tvol, _, ttf, _, tm = scene
    org, dirn, t0, t1 = (torch.from_numpy(a) for a in _default_rays(12))
    jitter = torch.from_numpy(
        np.random.default_rng(3).random(144).astype(np.float32))
    fn = partial(reference_sample_fn, tvol.data)
    stats = {}
    early = RaymarchSettings(n_iters=4, max_supersteps=48, shading=shading)
    want = raymarch(fn, org, dirn, t0, t1, tm, ttf, jitter, early,
                    stats=stats)
    # SSH's shadow march runs to max_supersteps on rays stuck within 1e-6
    # of t_far, as in JAX; the primary march stops early
    assert 2 < stats["supersteps"] - (48 if shading == "ssh" else 0) < 48
    assert not want.requires_grad
    fixed = dataclasses.replace(early, fixed_steps=True)
    stats = {}
    vol = tvol.data.clone().requires_grad_(True)
    got = raymarch(partial(reference_sample_fn, vol), org, dirn, t0, t1, tm,
                   ttf, jitter, fixed, stats=stats)
    assert got.requires_grad
    assert stats["supersteps"] == (96 if shading == "ssh" else 48)
    np.testing.assert_array_equal(got.detach().numpy(), want.numpy())
    with torch.no_grad():
        off = raymarch(partial(reference_sample_fn, vol), org, dirn, t0, t1,
                       tm, ttf, jitter, fixed)
    assert not off.requires_grad
    np.testing.assert_array_equal(off.numpy(), want.numpy())


def test_inference_params_raise_under_fixed_steps(scene):
    """render_params (a bf16 table, packed levels, nothing that requires
    grad) would reach the inference forms, which have no backward: a
    fixed_steps march refuses them, naming the item."""
    _, _, _, ttf, _, tm = scene
    cfg = ModelConfig(encoding=EncodingConfig(**ENC),
                      network=NetworkConfig(**NET))
    field = NeuralField.from_config(cfg)
    p = params_from_numpy(_params_np(field.spec,
                                     [field.spec.n_output_dims, 16, 16, 1]),
                          "cpu")
    org, dirn, t0, t1 = (torch.from_numpy(a) for a in _default_rays(4))
    jitter = torch.full((16,), 0.5)
    fn = make_neural_sample_fn(field)
    fixed = RaymarchSettings(n_iters=4, max_supersteps=4, fixed_steps=True)
    for ctx in (render_params(p, field),
                {"table": p["table"].to(torch.bfloat16), "mlp": p["mlp"]}):
        with pytest.raises(NotImplementedError, match="item 9"):
            raymarch(partial(fn, ctx), org, dirn, t0, t1, tm, ttf, jitter,
                     fixed)
    # the same params march without fixed_steps (no autograd)
    out = raymarch(partial(fn, render_params(p, field)), org, dirn, t0, t1,
                   tm, ttf, jitter, RaymarchSettings(n_iters=4))
    assert not out.requires_grad


def test_frozen_params_march_with_rays_that_require_grad(scene):
    """The f32 training params with no tensor that requires grad are
    accepted once the rays require grad (the sample positions do), and the
    frame is differentiable in them; with rays that do not, or with a bf16
    or corner-packed table, the march still refuses, naming the item."""
    _, _, _, ttf, _, tm = scene
    cfg = ModelConfig(encoding=EncodingConfig(**ENC),
                      network=NetworkConfig(**NET))
    field = NeuralField.from_config(cfg)
    p = params_from_numpy(_params_np(field.spec,
                                     [field.spec.n_output_dims, 16, 16, 1]),
                          "cpu")
    org, dirn, t0, t1 = (torch.from_numpy(a) for a in _default_rays(4))
    jitter = torch.full((16,), 0.5)
    fn = make_neural_sample_fn(field)
    fixed = RaymarchSettings(n_iters=4, max_supersteps=4, fixed_steps=True)
    with pytest.raises(NotImplementedError, match="item 9"):
        raymarch(partial(fn, p), org, dirn, t0, t1, tm, ttf, jitter, fixed)
    o = org.clone().requires_grad_(True)
    # what render_params builds on the CPU for a big schema (a small one
    # keeps the f32 table, the training params' copy, and is accepted)
    table16 = p["table"].to(torch.bfloat16)
    for ctx in ({"table": table16, "mlp": p["mlp"],
                 "packed": packed_dense_tables(table16, field.spec)},
                {"table": table16, "mlp": p["mlp"]}):
        with pytest.raises(NotImplementedError, match="item 9"):
            raymarch(partial(fn, ctx), o, dirn, t0, t1, tm, ttf, jitter,
                     fixed)
    out = raymarch(partial(fn, p), o, dirn, t0, t1, tm, ttf, jitter, fixed)
    assert out.requires_grad
    out.sum().backward()
    assert o.grad.abs().sum() > 0
    assert all(t.grad is None for t in [p["table"], *p["mlp"]])


def test_default_rays_hit(scene):
    """The rays of the network test cross the volume (t0 < t1 somewhere),
    so its gradients are not vacuous."""
    org, dirn, t0, t1 = _default_rays(8)
    assert (t0 < t1).sum() > 16
    tray = camera_rays(Camera.default_for_dims(DIMS), 8, 8)
    np.testing.assert_allclose(tray[1].numpy(), dirn, atol=1e-6)
    lo, hi, hit = ray_box_intersect(torch.from_numpy(org),
                                    torch.from_numpy(dirn), torch.zeros(3),
                                    torch.tensor(DIMS, dtype=torch.float32))
    assert int(hit.sum()) == int((t0 < t1).sum())
