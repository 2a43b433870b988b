"""Port's shadow volume (render/shadow.py) == the JAX package's on the same
grid and transfer function, at atol 1e-5: both shear with the same banded
interpolation matrices as float32 matmuls and take the same cumulative
product; only the matmul summation order differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantvnr_tpu.config import TransferFunctionConfig as JTFConfig
from instantvnr_tpu.data import synthetic_volume as j_synthetic_volume
from instantvnr_tpu.render import shadow as jshadow
from instantvnr_tpu.utils.tfn import bake_transfer_function as j_bake
from instantvnr_torch.config import TransferFunctionConfig
from instantvnr_torch.data.volume import synthetic_volume
from instantvnr_torch.render import shadow
from instantvnr_torch.utils.tfn import bake_transfer_function

ATOL = 1e-5


def _pair(kind, dims=(32, 32, 32)):
    jvol = j_synthetic_volume(dims, kind=kind).data
    tvol = synthetic_volume(dims, kind=kind, device="cpu").data
    np.testing.assert_array_equal(tvol.numpy(), np.asarray(jvol))
    return (jvol, j_bake(JTFConfig())), (tvol, bake_transfer_function(
        TransferFunctionConfig(), device="cpu"))


@pytest.mark.parametrize("light", [
    (0.0, 0.0, 1.0),     # axis-aligned: no shear, no pads
    (0.5, 0.0, 1.0),     # oblique in x: pads on the low x side
    (-0.4, 0.3, -0.9),   # flipped layer axis, pads on both lateral axes
    (0.3, 0.9, 0.2),     # y-dominant: layers along world y
    (0.9, -0.35, 0.45),  # x-dominant: layers along world x
])
def test_shadow_volume_matches(light):
    (jvol, jtf), (tvol, ttf) = _pair("vorts")
    ref = np.asarray(jshadow.shadow_volume_for(jvol, jtf, light))
    got = shadow.shadow_volume_for(tvol, ttf, light)
    assert got.shape == ref.shape == (32, 32, 32)
    assert ref.min() < 0.5  # the grid really casts shadows
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    assert shadow.light_principal_axis(light) == \
        jshadow.light_principal_axis(light)


def test_pads_match():
    for need, d in [(0, 32), (1, 32), (9, 32), (33, 32), (100, 128)]:
        assert shadow._quantized_pad(need, d) == jshadow._quantized_pad(
            need, d)


def test_side_entry_rays_are_shadowed():
    """The pads make rays entering through a side face accumulate
    occlusion (tests/test_shadow.py:43): a fully opaque cube under a
    (0.9, 0, 1) light is dark in its deepest layer, and equal to JAX."""
    jtf, ttf = j_bake(JTFConfig()), bake_transfer_function(
        TransferFunctionConfig(), device="cpu")
    got = shadow.shadow_volume_for(torch.ones((32, 32, 32)), ttf,
                                   (0.9, 0.0, 1.0)).numpy()
    ref = np.asarray(jshadow.shadow_volume_for(jnp.ones((32, 32, 32)), jtf,
                                               (0.9, 0.0, 1.0)))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert (got[0] > 0.95).mean() == 0.0
    assert got[0][:, :-2].max() < 1e-3


def test_empty_volume_fully_lit():
    """tests/test_shadow.py:26 on the port: nothing occludes."""
    ttf = bake_transfer_function(TransferFunctionConfig(), device="cpu")
    s = shadow.shadow_volume_for(torch.zeros((16, 16, 16)), ttf,
                                 (0.3, 0.9, 0.2))
    assert s.shape == (16, 16, 16)
    assert float(s.min()) > 0.999
