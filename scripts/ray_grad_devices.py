#!/usr/bin/env python3
"""The gradient of a fixed_steps frame in its rays, on the card against the
CPU: with the camera's rays made on each device, and with the CPU's rays
copied to the card; each with the kernels and with every kernel swapped for
its plain version on the card.

    python3 scripts/ray_grad_devices.py      (from the repository root; a card)

The scene is tests/test_torch_cuda.py::test_ray_gradient_on_card_matches_cpu's:
vorts 32³, a 4-level field (4 features, 2^12) with a 16-wide MLP of seeded
weights, 16² rays of a fixed camera, n_iters 4, 24 supersteps, the params
frozen. Prints one JSON line a case: the relative L2 and largest-entry
errors of the origins' and directions' gradients, and the rays whose
gradient parts from the CPU's by more than 5% of the largest entry.
"""
import json
import os
import subprocess
import sys
from functools import partial

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from instantvnr_torch.accel import macrocell as mcmod  # noqa: E402
from instantvnr_torch.config import (EncodingConfig, ModelConfig,  # noqa: E402
                                     NetworkConfig, TransferFunctionConfig)
from instantvnr_torch.data.volume import synthetic_volume  # noqa: E402
from instantvnr_torch.models.network import (NeuralField,  # noqa: E402
                                             params_from_numpy)
from instantvnr_torch.ops import fused_mlp as fm  # noqa: E402
from instantvnr_torch.ops import hash_encoding as he  # noqa: E402
from instantvnr_torch.render import raymarch as rm  # noqa: E402
from instantvnr_torch.render.camera import Camera  # noqa: E402
from instantvnr_torch.render.renderer import (_frame_rays,  # noqa: E402
                                              make_neural_sample_fn)
from instantvnr_torch.render.slabmarch import camera_arrays  # noqa: E402
from instantvnr_torch.render.transform import default_transform  # noqa: E402
from instantvnr_torch.utils.tfn import bake_transfer_function  # noqa: E402

SIZE, DIMS = 16, (32, 32, 32)
CAMERA = Camera(eye=(10.0, 20.0, -60.0), center=(0, 0, 0), up=(0, 1, 0),
                fovy=40.0)


def ray_grads(dev, rays_on):
    """The origins' and directions' gradients of sum(rgba²) on `dev`, the
    rays made on `rays_on`."""
    vol = synthetic_volume(DIMS, kind="vorts", device=dev).data
    tf = bake_transfer_function(TransferFunctionConfig(), device=dev)
    mc = mcmod.build(vol, DIMS, tf)
    settings = rm.RaymarchSettings(n_iters=4, max_supersteps=24,
                                   fixed_steps=True)
    org, dirn, t0, t1, light, _, _ = (x.to(dev) for x in _frame_rays(
        SIZE, SIZE, camera_arrays(CAMERA, rays_on),
        torch.tensor([float(d) for d in DIMS], device=rays_on),
        torch.tensor(settings.light_dir, device=rays_on),
        default_transform(DIMS, rays_on)))
    jitter = torch.rand(SIZE * SIZE,
                        generator=torch.Generator().manual_seed(5)).to(dev)
    field = NeuralField.from_config(ModelConfig(
        encoding=EncodingConfig(n_levels=4, n_features_per_level=4,
                                log2_hashmap_size=12, base_resolution=4),
        network=NetworkConfig(n_neurons=16, n_hidden_layers=2)))
    rng = np.random.default_rng(6)
    p = params_from_numpy({
        "table": rng.uniform(-0.5, 0.5, (field.spec.n_entries, 4)
                             ).astype(np.float32),
        "mlp": [(rng.standard_normal(s) * np.sqrt(2.0 / s[0])).astype(
            np.float32) for s in ((16, 16), (16, 16), (16, 1))]}, dev)
    rays = [org.detach().clone().requires_grad_(),
            dirn.detach().clone().requires_grad_()]
    rgba = rm.raymarch(partial(make_neural_sample_fn(field), p), *rays, t0,
                       t1, mc, tf, jitter, settings, light_dir=light)
    (rgba ** 2).sum().backward()
    return [r.grad.detach().double().cpu() for r in rays]


def plain_on_card():
    """Every kernel of the frame swapped for its plain version (on the
    card's tensors) → a function that undoes it."""
    saved = (fm._kernel_train_forward, fm._kernel_backward,
             he._kernel_coords_backward, he._kernel_forward, rm._kernel_emit,
             rm._kernel_emit_backward)

    def emit(o, d, tf, t, tce, ss, *a):
        state = rm._RayState(t=t, t_cell_end=tce, ss=ss, alpha=None,
                             color=None, active=None, best_w=None,
                             best_pos=None, best_rgb=None)
        return rm._emit_samples(o, d, tf, state, *a)

    fm._kernel_train_forward = fm._plain_train_forward
    fm._kernel_backward = fm._plain_backward
    he._kernel_coords_backward = he._plain_coords_backward
    he._kernel_forward = (lambda t, c, s, cd, count=None, offset=0:
                          he._gather_encode(t, c, s, cd))
    rm._kernel_emit = emit
    rm._kernel_emit_backward = rm._plain_emit_backward

    def undo():
        (fm._kernel_train_forward, fm._kernel_backward,
         he._kernel_coords_backward, he._kernel_forward,
         rm._kernel_emit, rm._kernel_emit_backward) = saved
    return undo


def main():
    if not torch.cuda.is_available():
        print("ray_grad_devices: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cpu = torch.device("cpu")
    ref = ray_grads(cpu, cpu)
    for rays_on in ("cuda", "cpu"):
        for forms in ("kernels", "plain"):
            undo = plain_on_card() if forms == "plain" else (lambda: None)
            try:
                got = ray_grads(torch.device("cuda"), torch.device(rays_on))
            finally:
                undo()
            rec = {"rays_made_on": rays_on, "card_forms": forms}
            for name, a, b in zip(("org", "dirn"), got, ref):
                rec[name] = {
                    "l2_rel": float((a - b).norm() / b.norm()),
                    "max_rel": float((a - b).abs().max() / b.abs().max()),
                    "rays_off_by_5pct": int(((a - b).abs().amax(1)
                                             > 0.05 * b.abs().max()).sum())}
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
