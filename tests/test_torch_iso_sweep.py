"""Port's first-hit isosurface sweep == the JAX package's.

- `iso_sweep_reference` against the Pallas kernel `iso_sweep` (interpret
  mode) on the same per-slab inputs, the port's per-row pairs built from
  the same geometry (they densify to the kernel's matrices bit for bit):
  `found` exactly equal, hit_z and hit_g at atol 1e-5 (float32 matmuls
  against the banded sums; a crossing within an ulp of the isovalue could
  flip `found`, none does at these inputs).
- `slab_iso_args` builds no dense interpolation matrix.
- Whole isosurface frames (render/isosurf.py) against JAX's IsoRenderer
  through its Pallas sweep, at atol 2e-5, for the plain, clipped-scaled and
  two-isovalue cases of tests/test_slab_pallas.py:146-177.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantvnr_tpu.config import TransferFunctionConfig as JTFConfig
from instantvnr_tpu.data import synthetic_volume as j_synthetic_volume
from instantvnr_tpu.ops.pallas.iso_sweep import iso_sweep as j_iso_sweep
from instantvnr_tpu.render import slabmarch as jsm
from instantvnr_tpu.render.camera import Camera as JCamera
from instantvnr_tpu.render.isosurf import IsoRenderer as JIsoRenderer
from instantvnr_tpu.render.isosurf import IsoSettings as JIsoSettings
from instantvnr_tpu.render.transform import default_transform as j_default_xf
from instantvnr_tpu.utils.tfn import bake_transfer_function as j_bake
from instantvnr_torch.config import TransferFunctionConfig
from instantvnr_torch.data.volume import synthetic_volume
from instantvnr_torch.ops import iso_sweep as isw
from instantvnr_torch.render.camera import Camera
from instantvnr_torch.render.isosurf import IsoRenderer, IsoSettings
from instantvnr_torch.render.slabmarch import _densify_pairs, _per_slab_state
from instantvnr_torch.render.transform import default_transform
from instantvnr_torch.utils.tfn import bake_transfer_function

SWEEP_ATOL = 1e-5
FRAME_ATOL = 2e-5


def _sweep_inputs(eye):
    """The JAX package's iso_sweep inputs for one camera, built as its
    slab_iso_render builds them (isosurf.py:94-148)."""
    vol = j_synthetic_volume((32, 32, 32), kind="vorts").data
    dims_w = jnp.array([32.0, 32.0, 32.0], jnp.float32)
    cam = JCamera(eye=eye, center=(0, 0, 0), up=(0, 1, 0), fovy=40)
    axis, flipped = jsm.principal_axis(cam)
    v, perm = jsm._permute_volume(vol, axis, flipped)
    grads = jsm.compute_gradient_volumes(vol)
    fields = jnp.stack([v] + [jsm._permute_volume(grads[i], axis, flipped)[0]
                              for i in range(3)], axis=1)
    cam_arrays = (jnp.asarray(cam.eye, jnp.float32),
                  jnp.asarray(cam.center, jnp.float32),
                  jnp.asarray(cam.up, jnp.float32), jnp.float32(cam.fovy))
    geo = jsm.frame_geometry(dims_w, 32, 32, 32, cam_arrays,
                             j_default_xf(dims_w), perm, flipped,
                             JIsoSettings(), 40, 36)
    e, _, clo, chi, z_ref, in_front = geo[:6]
    xs, ys = geo[7], geo[8]
    z_ks, my_all, mx_all, x_src, y_src = jsm._per_slab_state(
        e, z_ref, xs, ys, 32, 32, 32)
    keep = in_front & (z_ks >= clo[2]) & (z_ks <= chi[2])
    covy, covx = jsm._coverage_masks(my_all, mx_all, x_src, y_src, clo, chi,
                                     keep)
    return ([np.array(a) for a in (fields, my_all, mx_all, covy, covx)],
            [torch.from_numpy(np.array(a)) for a in (e, z_ref, xs, ys)])


@pytest.mark.parametrize("eye,iso", [((0, 0, -70), 0.5), ((60, 9, 7), 0.5),
                                     ((-4, -66, 3), 0.3)])
def test_reference_matches_pallas_kernel(eye, iso):
    arrs, geo = _sweep_inputs(eye)
    rf, rz, rg = j_iso_sweep(*[jnp.asarray(a) for a in arrs],
                             jnp.float32(iso), 12, interpret=True)
    # the port's pairs from the same geometry densify to JAX's matrices
    _, y_pairs, x_pairs, _, _ = _per_slab_state(*geo, 32, 32, 32,
                                                banded=True)
    assert torch.equal(_densify_pairs(y_pairs, 32), torch.from_numpy(arrs[1]))
    assert torch.equal(_densify_pairs(x_pairs, 32), torch.from_numpy(arrs[2]))
    fields, _, _, covy, covx = [torch.from_numpy(a) for a in arrs]
    before = isw.counter.launches
    gf, gz, gg = isw.iso_sweep(fields, y_pairs, x_pairs, covy, covx, iso)
    assert isw.counter.launches == before  # CPU: the plain version
    rf, rz, rg = np.asarray(rf), np.asarray(rz), np.asarray(rg)
    assert gg.shape == rg.shape == (36, 40, 3)
    assert rf.sum() >= 40  # the surface is hit
    np.testing.assert_array_equal(gf.numpy(), rf)
    np.testing.assert_allclose(gz.numpy(), rz, atol=SWEEP_ATOL)
    np.testing.assert_allclose(gg.numpy(), rg, atol=SWEEP_ATOL)


def _frames(eye, iso=0.5, xform=None, fovy=40):
    jvol = j_synthetic_volume((32, 32, 32), kind="vorts")
    tvol = synthetic_volume((32, 32, 32), kind="vorts", device="cpu")
    jxf = txf = None
    if xform is not None:
        jxf = j_default_xf(jvol.dims)._replace(
            **{k: jnp.asarray(v, jnp.float32) for k, v in xform.items()})
        txf = default_transform(tvol.dims, "cpu")._replace(
            **{k: torch.tensor(v, dtype=torch.float32)
               for k, v in xform.items()})
    jr = JIsoRenderer(40, 40, jvol.data, j_bake(JTFConfig()), isovalue=iso,
                      settings=JIsoSettings(pallas_sweep=True),
                      transform=jxf)
    tr = IsoRenderer(40, 40, tvol.data, bake_transfer_function(
        TransferFunctionConfig(), device="cpu"), isovalue=iso, transform=txf,
        device="cpu")
    jr.set_camera(JCamera(eye=eye, center=(0, 0, 0), up=(0, 1, 0), fovy=fovy))
    tr.set_camera(Camera(eye=eye, center=(0, 0, 0), up=(0, 1, 0), fovy=fovy))
    jr.render()
    tr.render()
    return jr, tr


@pytest.mark.parametrize("eye", [(0, 0, -70), (60, 9, 7)])
def test_frame_matches(eye):
    jr, tr = _frames(eye)
    ref, got = jr.mapframe(), tr.mapframe()
    assert got.shape == (40, 40, 4) and np.isfinite(got).all()
    assert ref[..., 3].max() > 0.5  # surface visible
    np.testing.assert_allclose(got, ref, atol=FRAME_ATOL)


def test_frame_matches_clipped_scaled():
    xf = dict(clip_lower=[4.0, 0.0, 6.0], clip_upper=[28.0, 25.0, 30.0],
              scale=[1.0, 1.4, 0.8])
    jr, tr = _frames((8, -6, -75), xform=xf, fovy=38)
    ref = jr.mapframe()
    assert ref[..., 3].max() > 0.5
    np.testing.assert_allclose(tr.mapframe(), ref, atol=FRAME_ATOL)


def test_isovalue_edits():
    """Two isovalues through one renderer each: an edit re-renders with the
    new value and rebuilds nothing else (the gradients stay cached)."""
    jr, tr = _frames((0, 0, -70), iso=0.3)
    grads = tr._grads
    np.testing.assert_allclose(tr.mapframe(), jr.mapframe(), atol=FRAME_ATOL)
    jr.set_isovalue(0.62)
    tr.set_isovalue(0.62)
    jr.render()
    tr.render()
    assert tr._grads is grads
    ref = jr.mapframe()
    assert ref[..., 3].max() > 0.5
    np.testing.assert_allclose(tr.mapframe(), ref, atol=FRAME_ATOL)


def test_iso_args_build_no_dense_matrices(monkeypatch):
    """The isosurface sweep's inputs hold the per-row pairs and never call
    _interp_matrix; the pairs densify to the matrices that
    _per_slab_state builds without `banded` from the same geometry."""
    from instantvnr_torch.render import isosurf
    from instantvnr_torch.render import slabmarch as sm

    vol = synthetic_volume((24, 20, 28), kind="vorts", device="cpu").data
    grads = sm.compute_gradient_volumes(vol)
    cam = Camera(eye=(25, -18, -62), center=(0, 0, 0), up=(0, 1, 0), fovy=40)
    axis, flipped = sm.principal_axis(cam)
    per_slab_state = sm._per_slab_state
    calls = []

    def refuse(*a, **kw):
        raise AssertionError("the sweep's inputs built a dense matrix")

    def spy(*a, **kw):
        calls.append((a, kw))
        return per_slab_state(*a, **kw)

    monkeypatch.setattr(sm, "_interp_matrix", refuse)
    monkeypatch.setattr(isosurf, "_per_slab_state", spy)
    args, _ = isosurf.slab_iso_args(vol, grads, 33, 29, IsoSettings(), axis,
                                    flipped, sm.camera_arrays(cam, "cpu"))
    found, _, _ = isw.iso_sweep(*args, 0.5)
    monkeypatch.undo()
    assert len(calls) == 1 and calls[0][1] == {"banded": True}
    assert float(found.sum()) > 0  # the surface is hit
    _, my_all, mx_all, _, _ = per_slab_state(*calls[0][0])
    fields, y_pairs, x_pairs = args[:3]
    ay, ax = fields.shape[2:]
    assert y_pairs[0].dtype == torch.int32 and x_pairs[0].dtype == torch.int32
    assert torch.equal(_densify_pairs(y_pairs, ay), my_all)
    assert torch.equal(_densify_pairs(x_pairs, ax), mx_all)
