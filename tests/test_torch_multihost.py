"""The port's multi-process training and rendering, the twins of
tests/test_multihost.py: two processes, one rank each, in one gloo group
on the CPU (tests/torch_parallel_ranks.py::multihost), spawned once for
this file. Per-rank RNG streams, reduces across the process boundary and
per-rank data loading: each rank streams its own blocks of a shared raw
file through its own out-of-core sampler.

The JAX side: each rank's first out-of-core batch equals the JAX
package's sampler's of the same seed, bit for bit (the samplers are twins,
tests/test_torch_data.py), and the slab-sharded frame is held to the JAX
package's single-device frame at atol 1e-3, as tests/test_multihost.py
holds JAX's. The training cases hold JAX's bars (the two packages' RNGs
differ, so losses are compared with bars, not with each other).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch_parallel_ranks as ranks

from instantvnr_tpu.config import TransferFunctionConfig as JTFConfig
from instantvnr_tpu.config import VolumeDesc as JVolumeDesc
from instantvnr_tpu.data import synthetic_volume as j_synthetic_volume
from instantvnr_tpu.data.outofcore import OutOfCoreSampler as JSampler
from instantvnr_torch.parallel import mesh as pm

EYE = (8, 6, -70)


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    path = tmp_path_factory.mktemp("multihost") / "sphere.raw"
    np.asarray(j_synthetic_volume((32, 32, 32), kind="sphere").data
               ).tofile(path)
    vorts = np.asarray(j_synthetic_volume((32, 32, 32), kind="vorts").data)
    plan = {"ooc_path": str(path),
            "slab": {"main": dict(volume=vorts, eye=EYE, size=32)}}
    return plan, pm.spawn(ranks.multihost, 2, plan, device="cpu",
                          timeout=600)


def _same_on_both(outs, key):
    a, b = (np.asarray(o[key]) for o in outs)
    np.testing.assert_array_equal(a, b)
    return a


def test_two_process_dp_training(hosts):
    loss = float(_same_on_both(hosts[1], "dp_loss"))
    assert np.isfinite(loss) and loss < 0.06, loss


def test_two_process_out_of_core_training(hosts):
    """Each rank streams its own blocks (seed 1337 + rank): the ranks'
    batches differ, each equals the JAX sampler's of its seed, and the
    gradients meet in the fused all-reduce."""
    plan, outs = hosts
    loss = float(_same_on_both(outs, "ooc_loss"))
    assert np.isfinite(loss) and loss < 0.05, loss
    firsts = [o["ooc_first_coords"] for o in outs]
    assert not np.array_equal(firsts[0], firsts[1])
    desc = JVolumeDesc(filename=plan["ooc_path"], dims=(32, 32, 32),
                       dtype="FLOAT")
    for rank, first in enumerate(firsts):
        want, _ = JSampler(desc, (0.0, 1.0), block_y=16, block_z=16,
                           use_native=False, seed=1337 + rank).sample(2048)
        np.testing.assert_array_equal(first, np.asarray(want))


def test_two_process_tp_training(hosts):
    loss = float(_same_on_both(hosts[1], "tp_loss"))
    assert np.isfinite(loss) and loss < 0.06, loss


def test_two_process_ep_training(hosts):
    """One expert a process: zero-collective training, then the stitched
    decode all-gathered across the process boundary."""
    losses = np.array([float(o["ep_loss"]) for o in hosts[1]])
    assert np.isfinite(losses).all() and losses.max() < 0.1, losses
    full = _same_on_both(hosts[1], "ep_full")
    assert full.shape == (16, 16, 16) and np.isfinite(full).all()


def test_two_process_slab_sharded_render(hosts):
    """Each process holds half the slabs; the frame assembles through one
    cross-process all_gather and matches the single-device frame."""
    from instantvnr_tpu.render.camera import Camera
    from instantvnr_tpu.render.slabmarch import (SlabSettings,
                                                 principal_axis, slab_render)
    from instantvnr_tpu.render.transform import default_transform
    from instantvnr_tpu.utils.tfn import bake_transfer_function

    plan, outs = hosts
    frames = [o["slab"]["main"] for o in outs]
    np.testing.assert_array_equal(frames[0][0], frames[1][0])
    vol = jnp.asarray(plan["slab"]["main"]["volume"])
    cam = Camera(eye=EYE, center=(0, 0, 0), up=(0, 1, 0), fovy=40)
    cam_arrays = (jnp.asarray(cam.eye, jnp.float32),
                  jnp.asarray(cam.center, jnp.float32),
                  jnp.asarray(cam.up, jnp.float32), jnp.float32(cam.fovy))
    axis, flipped = principal_axis(cam)
    ref = np.asarray(slab_render(vol, bake_transfer_function(JTFConfig()),
                                 cam_arrays, 32, 32, SlabSettings(), axis,
                                 flipped, None, None, None,
                                 default_transform((32, 32, 32))))
    got, _, pins, chunk = frames[0]
    assert np.isfinite(got).all() and ref[:, 3].max() > 0.05
    assert pins == {"all_gather": 1} and chunk == (16, 32, 32)
    np.testing.assert_allclose(got, ref, atol=1e-3)
