"""Port's slab-compositor plain versions == the JAX package's Pallas
compositors (interpret mode) on the same per-slab inputs, and the port's
LUT form == the JAX XLA scan for a transfer function of more than 64
segments (which the TPU kernels do not take).

Tolerance atol 2e-5: both sides compute the resample as float32 matmuls
(tests/test_slab_pallas.py holds the Pallas kernel to the scan at the same
tolerance); only the summation order differs. Gradient shading amplifies
that noise (the specular term is cos_nh^40 of a normal divided by its own
length), and the JAX package holds its shaded kernel to its scan at 2e-4
(test_slab_pallas.py:99); at these inputs the shaded frames still agree
within 2e-5 (largest difference 2.4e-7 against the kernel, 4.3e-6 against
the XLA scan), so they are held at the tightest tolerance, 2e-5, too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantvnr_tpu.accel import macrocell as jmc
from instantvnr_tpu.config import TransferFunctionConfig as JTFConfig
from instantvnr_tpu.data import synthetic_volume as j_synthetic_volume
from instantvnr_tpu.ops.pallas.slab_composite import composite_slabs as j_comp
from instantvnr_tpu.ops.pallas.slab_composite import \
    composite_slabs_ext as j_comp_ext
from instantvnr_tpu.ops.pallas.slab_composite import pack_controls as j_pack
from instantvnr_tpu.ops.pallas.slab_composite import pack_misc as j_pack_misc
from instantvnr_tpu.render import slabmarch as jsm
from instantvnr_tpu.render.camera import Camera as JCamera
from instantvnr_tpu.render.decoded import DecodedRenderer as JDecodedRenderer
from instantvnr_tpu.render.shadow import shadow_volume_for as j_shadow_for
from instantvnr_tpu.render.transform import default_transform as j_default_xf
from instantvnr_tpu.utils.tfn import bake_transfer_function as j_bake
from instantvnr_torch.accel import macrocell as mcmod
from instantvnr_torch.config import TransferFunctionConfig
from instantvnr_torch.data.volume import synthetic_volume
from instantvnr_torch.ops import slab_composite as sc
from instantvnr_torch.render.camera import Camera
from instantvnr_torch.render.decoded import DecodedRenderer
from instantvnr_torch.render.slabmarch import SlabSettings
from instantvnr_torch.utils.tfn import bake_transfer_function

ATOL = 2e-5


def _knotty_tf_kw(n=70):
    """A transfer function with n alpha knots → > 64 segments."""
    rng = np.random.default_rng(11)
    xs = np.linspace(0.0, 1.0, n)
    alphas = tuple((float(x), float(a)) for x, a in
                   zip(xs, rng.uniform(0.0, 0.9, n)))
    colors = ((0.0, 0.2, 0.3, 0.9), (0.5, 0.9, 0.6, 0.1), (1.0, 1.0, 0.2, 0.2))
    return dict(colors=colors, alphas=alphas, range=(0.0, 1.0))


def _slab_inputs(tfc_kw, eye):
    """The JAX package's per-slab compositor inputs for one camera."""
    vol = j_synthetic_volume((32, 32, 32), kind="vorts")
    tf = j_bake(JTFConfig(**tfc_kw))
    dims_w = jnp.array([32.0, 32.0, 32.0], jnp.float32)
    cam = JCamera(eye=eye, center=(0, 0, 0), up=(0, 1, 0), fovy=40)
    axis, flipped = jsm.principal_axis(cam)
    v, perm = jsm._permute_volume(vol.data, axis, flipped)
    cam_arrays = (jnp.asarray(cam.eye, jnp.float32),
                  jnp.asarray(cam.center, jnp.float32),
                  jnp.asarray(cam.up, jnp.float32), jnp.float32(cam.fovy))
    geo = jsm.frame_geometry(dims_w, 32, 32, 32, cam_arrays,
                             j_default_xf(dims_w), perm, flipped,
                             jsm.SlabSettings(), 40, 36)
    e, _, clo, chi, z_ref, in_front = geo[:6]
    xs, ys, corr = geo[7], geo[8], geo[9]
    z_ks, my_all, mx_all, x_src, y_src = jsm._per_slab_state(
        e, z_ref, xs, ys, 32, 32, 32)
    keep = in_front & (z_ks >= clo[2]) & (z_ks <= chi[2])
    covy, covx = jsm._coverage_masks(my_all, mx_all, x_src, y_src, clo, chi,
                                     keep)
    return tf, [np.array(a) for a in (v, my_all, mx_all, covy, covx, corr)]


@pytest.mark.parametrize("eye", [(0, 0, -70), (60, 9, 7), (-4, 66, 3)])
def test_reference_matches_pallas_kernel(eye):
    tf, arrs = _slab_inputs({}, eye)
    ctrl = np.array(j_pack(tf))
    ref_c, ref_a = j_comp(*[jnp.asarray(a) for a in arrs], jnp.asarray(ctrl),
                          12, interpret=True)  # tile_h 12: 3 row tiles of 36
    got_c, got_a = sc.composite_slabs_reference(
        *[torch.from_numpy(a) for a in arrs], torch.from_numpy(ctrl))
    assert np.asarray(ref_a).max() > 0.05
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), atol=ATOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(ref_a), atol=ATOL)
    # the port packs the same control rows from its own baked TF
    port_tf = bake_transfer_function(TransferFunctionConfig(), device="cpu")
    np.testing.assert_array_equal(sc.pack_controls(port_tf).numpy(), ctrl)
    assert sc.pack_lut(port_tf) is None


def test_wrapper_takes_plain_version_on_cpu():
    tf, arrs = _slab_inputs({}, (0, 0, -70))
    ctrl = torch.from_numpy(np.array(j_pack(tf)))
    ts = [torch.from_numpy(a) for a in arrs]
    before = sc.counter.launches
    c1, a1 = sc.composite_slabs(*ts, ctrl)
    c2, a2 = sc.composite_slabs_reference(*ts, ctrl)
    assert sc.counter.launches == before
    np.testing.assert_array_equal(c1.numpy(), c2.numpy())
    np.testing.assert_array_equal(a1.numpy(), a2.numpy())


def test_lut_form_matches_jax_scan():
    """> 64 segments: the port classifies from the dense LUT (the kernel's
    flag form) and matches the JAX scan, which does the same; the TPU
    kernel would have fallen back to that scan."""
    kw = _knotty_tf_kw()
    port_tf = bake_transfer_function(TransferFunctionConfig(**kw),
                                     device="cpu")
    assert port_tf.ctrl_x.shape[0] - 1 > 64
    lut = sc.pack_lut(port_tf)
    assert lut is not None and lut.shape == (1024, 4)

    jvol = j_synthetic_volume((32, 32, 32), kind="vorts")
    jtf = j_bake(JTFConfig(**kw))
    jmcell = jmc.build(jvol.data, jvol.dims, jtf)
    tvol = synthetic_volume((32, 32, 32), kind="vorts", device="cpu")
    tmc = mcmod.build(tvol.data, tvol.dims, port_tf)
    for eye in [(0, 0, -70), (25, -18, -62)]:
        jr = JDecodedRenderer(40, 40, jmcell, jtf, jvol.dims,
                              initial_volume=jvol.data,
                              settings=jsm.SlabSettings(
                                  pallas_compositor=False))
        jr.set_camera(JCamera(eye=eye, center=(0, 0, 0), up=(0, 1, 0),
                              fovy=40))
        jr.render()
        tr = DecodedRenderer(40, 40, tmc, port_tf, tvol.dims,
                             initial_volume=tvol.data, device="cpu")
        tr.set_camera(Camera(eye=eye, center=(0, 0, 0), up=(0, 1, 0),
                             fovy=40))
        tr.render()
        ref = jr.mapframe()
        assert ref[..., 3].max() > 0.05
        np.testing.assert_allclose(tr.mapframe(), ref, atol=ATOL)


def _ext_inputs(eye, shade, shadow, tfc_kw=None):
    """The JAX package's inputs of composite_slabs_ext for one camera, built
    as its slab_render builds them (slabmarch.py:449-469)."""
    vol = j_synthetic_volume((32, 32, 32), kind="vorts").data
    tf = j_bake(JTFConfig(**(tfc_kw or {})))
    dims_w = jnp.array([32.0, 32.0, 32.0], jnp.float32)
    xf = j_default_xf(dims_w)
    cam = JCamera(eye=eye, center=(0, 0, 0), up=(0, 1, 0), fovy=40)
    axis, flipped = jsm.principal_axis(cam)
    v, perm = jsm._permute_volume(vol, axis, flipped)
    cam_arrays = (jnp.asarray(cam.eye, jnp.float32),
                  jnp.asarray(cam.center, jnp.float32),
                  jnp.asarray(cam.up, jnp.float32), jnp.float32(cam.fovy))
    settings = jsm.SlabSettings(shading="gradient" if shade else "none")
    geo = jsm.frame_geometry(dims_w, 32, 32, 32, cam_arrays, xf, perm,
                             flipped, settings, 40, 36)
    e, _, clo, chi, z_ref, in_front = geo[:6]
    xs, ys, corr = geo[7], geo[8], geo[9]
    z_ks, my_all, mx_all, x_src, y_src = jsm._per_slab_state(
        e, z_ref, xs, ys, 32, 32, 32)
    keep = in_front & (z_ks >= clo[2]) & (z_ks <= chi[2])
    covy, covx = jsm._coverage_masks(my_all, mx_all, x_src, y_src, clo, chi,
                                     keep)
    if shade:
        grads = jsm.compute_gradient_volumes(vol)
        fields = jnp.stack([v] + [jsm._permute_volume(grads[i], axis,
                                                      flipped)[0]
                                  for i in range(3)], axis=1)
    else:
        fields = v[:, None]
    svol = None
    if shadow:
        svol = jsm._permute_volume(j_shadow_for(vol, tf, (0.2, 0.9, 0.3)),
                                   axis, flipped)[0]
    light = jnp.asarray(settings.light_dir, jnp.float32)
    light = jnp.where(jnp.dot(cam_arrays[1] - cam_arrays[0], light) > 0,
                      -light, light)
    light = light / jnp.linalg.norm(light)
    eye_w = cam_arrays[0] / xf.scale + 0.5 * dims_w
    zw = dims_w[perm[2]] - z_ks if flipped else z_ks
    misc = j_pack_misc(settings.shadow_ambient, settings.shading_scale,
                       light, eye_w, xf.scale)
    arrs = [fields, svol, my_all, mx_all, covy, covx, corr, x_src, y_src, zw,
            j_pack(tf), misc]
    return perm, [None if a is None else np.array(a) for a in arrs]


@pytest.mark.parametrize("shade,shadow,eye", [
    (True, False, (25, -18, -62)),
    (False, True, (25, -18, -62)),
    (True, True, (25, -18, -62)),
    (True, False, (-60, 9, 7)),     # flipped x slabs
    (True, True, (4, -8, 70)),      # flipped z slabs
], ids=["shaded", "shadow", "shaded+shadow", "shaded-flipped-x",
        "shaded+shadow-flipped-z"])
def test_ext_reference_matches_pallas_kernel(shade, shadow, eye):
    """The gradients keep their world sign under a flipped permutation; the
    kernel divides them by the world scale in world order (the flipped
    cameras hold that)."""
    perm, arrs = _ext_inputs(eye, shade, shadow)
    ref_c, ref_a = j_comp_ext(
        *[None if a is None else jnp.asarray(a) for a in arrs], 12, perm,
        shade, shadow, interpret=True)
    got_c, got_a = sc.composite_slabs_ext_reference(
        *[None if a is None else torch.from_numpy(a) for a in arrs], perm)
    assert np.asarray(ref_a).max() > 0.05
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), atol=ATOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(ref_a), atol=ATOL)
    # the wrapper takes the plain version on the CPU, counting no launch
    before = sc.ext_counter.launches
    w_c, _ = sc.composite_slabs_ext(
        *[None if a is None else torch.from_numpy(a) for a in arrs], perm)
    assert sc.ext_counter.launches == before
    np.testing.assert_array_equal(w_c.numpy(), got_c.numpy())


def test_pack_misc_matches():
    light = np.array([0.1, -0.5, 0.86], np.float32)
    eye = np.array([3.0, -40.0, 16.5], np.float32)
    scale = np.array([1.0, 1.4, 0.8], np.float32)
    ref = np.asarray(j_pack_misc(0.05, 0.95, light, eye, scale))
    got = sc.pack_misc(0.05, 0.95, torch.from_numpy(light),
                       torch.from_numpy(eye), torch.from_numpy(scale))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_ext_lut_form_matches_jax_scan():
    """> 64 segments, shaded: the port classifies from the dense LUT inside
    the extended compositor and matches the JAX XLA scan's shaded frame
    (the TPU kernel would have fallen back to that scan)."""
    kw = _knotty_tf_kw()
    port_tf = bake_transfer_function(TransferFunctionConfig(**kw),
                                     device="cpu")
    jvol = j_synthetic_volume((32, 32, 32), kind="vorts")
    jtf = j_bake(JTFConfig(**kw))
    jmcell = jmc.build(jvol.data, jvol.dims, jtf)
    tvol = synthetic_volume((32, 32, 32), kind="vorts", device="cpu")
    tmc = mcmod.build(tvol.data, tvol.dims, port_tf)
    eye = (25, -18, -62)
    jr = JDecodedRenderer(40, 40, jmcell, jtf, jvol.dims,
                          initial_volume=jvol.data,
                          settings=jsm.SlabSettings(
                              pallas_compositor=False, shading="gradient"))
    jr.set_camera(JCamera(eye=eye, center=(0, 0, 0), up=(0, 1, 0), fovy=40))
    jr.render()
    tr = DecodedRenderer(40, 40, tmc, port_tf, tvol.dims,
                         initial_volume=tvol.data, device="cpu",
                         settings=SlabSettings(shading="gradient"))
    tr.set_camera(Camera(eye=eye, center=(0, 0, 0), up=(0, 1, 0), fovy=40))
    before = sc.ext_counter.launches
    tr.render()
    assert sc.ext_counter.launches == before
    ref = jr.mapframe()
    assert ref[..., 3].max() > 0.05
    np.testing.assert_allclose(tr.mapframe(), ref, atol=ATOL)
