"""What the compacted wavefront's CPU tests share
(tests/test_torch_compaction*.py): JAX's test scene
(tests/test_compaction.py:27) in both packages, its rays, buckets small
enough that a 48² frame compacts, and a compacted renderer of the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantvnr_tpu.accel import macrocell as jmc
from instantvnr_tpu.config import TransferFunctionConfig as JTFConfig
from instantvnr_tpu.data import synthetic_volume as j_synthetic_volume
from instantvnr_tpu.render import camera_rays as j_camera_rays
from instantvnr_tpu.render.camera import Camera as JCamera
from instantvnr_tpu.render.shadow import shadow_volume_for as j_shadow_for
from instantvnr_tpu.utils.math import ray_box_intersect as j_box
from instantvnr_tpu.utils.tfn import bake_transfer_function as j_bake
from instantvnr_torch.accel import macrocell as mcmod
from instantvnr_torch.config import TransferFunctionConfig
from instantvnr_torch.data.volume import synthetic_volume
from instantvnr_torch.render import compaction as comp
from instantvnr_torch.render import raymarch as rm
from instantvnr_torch.render.camera import Camera
from instantvnr_torch.render.renderer import Renderer, reference_sample_fn
from instantvnr_torch.utils.tfn import bake_transfer_function

jcomp = __import__("instantvnr_tpu.render.compaction",
                   fromlist=["_bucket"])
jrm = __import__("instantvnr_tpu.render.raymarch", fromlist=["raymarch"])

DIMS = (32, 32, 32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """JAX's test scene (tests/test_compaction.py:27) in both packages."""
    jvol = j_synthetic_volume(DIMS, kind="sphere")
    tvol = synthetic_volume(DIMS, kind="sphere", device="cpu")
    jtf = j_bake(JTFConfig())
    ttf = bake_transfer_function(TransferFunctionConfig(), device="cpu")
    jm = jmc.build(jvol.data, jvol.dims, jtf)
    tm = mcmod.build(tvol.data, tvol.dims, ttf)
    shadow = np.asarray(j_shadow_for(jvol.data, jtf, (0.7, 0.9, 0.4)))
    return jvol, tvol, jtf, ttf, jm, tm, shadow


def _jax_rays(n=64):
    """tests/test_compaction.py::_rays."""
    cam = JCamera.default_for_dims(DIMS)
    org_w, dirn = j_camera_rays(cam, n, n)
    d = jnp.array(DIMS, jnp.float32)
    org = org_w + 0.5 * d
    t0, t1, hit = j_box(org, dirn, jnp.zeros(3), d)
    t0 = jnp.where(hit, jnp.maximum(t0, 0.0), 1.0)
    t1 = jnp.where(hit, t1, 0.0)
    jitter = jax.random.uniform(jax.random.PRNGKey(7), (org.shape[0],))
    return org, dirn, t0, t1, jitter


@pytest.fixture
def small_buckets(monkeypatch):
    """Buckets small enough that a 48² frame compacts (JAX's tests use the
    same), in both packages."""
    for mod in (comp, jcomp):
        monkeypatch.setattr(mod, "_MIN_BUCKET", 256)
        monkeypatch.setattr(mod, "_FINISH_BUCKET", 512)


def _renderer(scene, size=48, seed=5, **kw):
    _, tvol, _, ttf, _, tm, _ = scene
    r = Renderer(size, size, tm, ttf, reference_sample_fn,
                 sample_ctx=tvol.data,
                 settings=rm.RaymarchSettings(compact=True, **kw), seed=seed)
    r.set_camera(Camera.default_for_dims(DIMS))
    return r


CAM2 = Camera(eye=(1.5 * DIMS[0], 8, 4), center=(0, 0, 0), up=(0, 1, 0),
              fovy=60)
