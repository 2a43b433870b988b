"""Port's slab-compositor plain version == the JAX package's Pallas
compositor (interpret mode) on the same per-slab inputs, and the port's
LUT form == the JAX XLA scan for a transfer function of more than 64
segments (which the TPU kernel does not take).

Tolerance atol 2e-5: both sides compute the resample as float32 matmuls
(tests/test_slab_pallas.py holds the Pallas kernel to the scan at the same
tolerance); only the summation order differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantvnr_tpu.accel import macrocell as jmc
from instantvnr_tpu.config import TransferFunctionConfig as JTFConfig
from instantvnr_tpu.data import synthetic_volume as j_synthetic_volume
from instantvnr_tpu.ops.pallas.slab_composite import composite_slabs as j_comp
from instantvnr_tpu.ops.pallas.slab_composite import pack_controls as j_pack
from instantvnr_tpu.render import slabmarch as jsm
from instantvnr_tpu.render.camera import Camera as JCamera
from instantvnr_tpu.render.decoded import DecodedRenderer as JDecodedRenderer
from instantvnr_tpu.render.transform import default_transform as j_default_xf
from instantvnr_tpu.utils.tfn import bake_transfer_function as j_bake
from instantvnr_torch.accel import macrocell as mcmod
from instantvnr_torch.config import TransferFunctionConfig
from instantvnr_torch.data.volume import synthetic_volume
from instantvnr_torch.ops import slab_composite as sc
from instantvnr_torch.render.camera import Camera
from instantvnr_torch.render.decoded import DecodedRenderer
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
