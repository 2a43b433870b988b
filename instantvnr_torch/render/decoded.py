"""Decoded-volume renderer with progressive neural decoding (counterpart of
`instantvnr_tpu/render/decoded.py`).

The network is decoded into a persistent grid one 16-z-slice blob at a time
(the reference's `vnrNeuralVolumeDecodeProgressive` loop, api.cpp:228 →
infer_progressively_decode_volume, network.cu:290-326), and every frame
slab-composites the current grid (render/slabmarch.py).
"""
from __future__ import annotations

import numpy as np
import torch

from instantvnr_torch.accel.macrocell import MacroCell
from instantvnr_torch.models.metrics import decode_slab
from instantvnr_torch.render.camera import Camera
from instantvnr_torch.render.slabmarch import (
    SlabSettings,
    camera_arrays,
    compute_gradient_volumes,
    principal_axis,
    slab_occupancy_from_macrocell,
    slab_path_valid,
    slab_render,
)
from instantvnr_torch.utils.tfn import TransferFunction


class DecodedRenderer:
    """Renders a (possibly progressively decoded) grid via slab compositing."""

    def __init__(self, width: int, height: int, mc: MacroCell,
                 tf: TransferFunction, volume_dims,
                 settings: SlabSettings | None = None, field=None,
                 params=None, initial_volume=None, slab_blob: int = 16,
                 transform=None, device="cuda"):
        from instantvnr_torch.render.transform import default_transform
        from instantvnr_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        dx, dy, dz = (int(d) for d in volume_dims)
        self.width, self.height = width, height
        self.mc = mc
        self.tf = tf
        self.volume_dims = (dx, dy, dz)
        self.settings = settings or SlabSettings()
        self.camera = Camera.default_for_dims(self.volume_dims)
        self.field = field
        self.params = None
        self._raw_params = None
        self.set_transform(transform or default_transform(volume_dims,
                                                          self.device))
        if params is not None:
            self.set_params(params)
        self.slab_blob = slab_blob
        self._next_blob = 0
        if initial_volume is not None:
            # a copy: blobs are written into this grid in place
            self.decoded = torch.as_tensor(
                initial_volume, dtype=torch.float32,
                device=self.device).clone()
        else:
            self.decoded = torch.zeros((dz, dy, dx), dtype=torch.float32,
                                       device=self.device)
        self._frame = None
        self._gradients = None  # [3, dz, dy, dx], built lazily for shading
        self.shadow_volume = None  # optional [dz, dy, dx] transmittance
        self._shadow_light = None  # sticky (light, rate): refreshed on decode
        # shadows owned by the FULL_SHADOW_DECODED mode (api.VNRenderer)
        self._mode_shadows = False

    # -- progressive decoding (reference decode-progressive loop) ---------

    @property
    def n_blobs(self) -> int:
        """vnrNeuralVolumeGetNumberOfBlobs (network.cu:969-975)."""
        return (self.volume_dims[2] + self.slab_blob - 1) // self.slab_blob

    def decode_progressive(self, n_blobs: int = 1):
        """Decode the next n blobs (round-robin) into the grid. Each blob
        is written into the grid in place (the JAX package donates the
        buffer to the same effect)."""
        if self.field is None or self.params is None:
            raise RuntimeError("decode_progressive needs a field and params")
        dz = self.volume_dims[2]
        for _ in range(n_blobs):
            z0 = (self._next_blob % self.n_blobs) * self.slab_blob
            blob = decode_slab(self.field, self.params, z0, self.volume_dims,
                               slab=self.slab_blob)
            n = max(0, min(self.slab_blob, dz - z0))
            self.decoded[z0:z0 + n] = blob[:n]
            self._next_blob += 1
        self._gradients = None  # the decoded content changed
        self._refresh_shadows()

    def decode_all(self):
        self.decode_progressive(self.n_blobs)

    def set_params(self, params):
        """Bind inference params (models.network.render_params). Identity-
        cached: rebinding the SAME params object — every frame does — must
        not redo the bf16 cast and corner packing of the table."""
        if params is not None and params is self._raw_params:
            return
        self._raw_params = params
        if (self.field is not None and isinstance(params, dict)
                and "table" in params):
            from instantvnr_torch.models.network import render_params

            params = render_params(params, self.field)
        self.params = params

    def set_camera(self, cam: Camera):
        self.camera = cam

    def set_transform(self, transform):
        """Clipping box / scaling update (api.cpp:322-351); keeps a host
        copy of the scale for the per-frame principal-axis pick."""
        self.transform = transform
        self._scale_h = transform.scale.detach().cpu().numpy()

    def set_transfer_function(self, tf: TransferFunction):
        """TF edit: re-derive the macrocell max opacity; the decoded grid is
        TF-independent."""
        from instantvnr_torch.accel import macrocell as mcmod

        self.tf = tf
        self.mc = mcmod.update_max_opacity(self.mc, tf)
        self._refresh_shadows()

    def _refresh_shadows(self):
        """Recompute the sticky shadow volume after a grid or TF change."""
        if self._shadow_light is not None:
            light, rate = self._shadow_light
            self.enable_shadows(light, sampling_rate=rate)

    def enable_shadows(self, light_dir=None, sampling_rate: float = 1.0):
        """Compute the shadow volume from the current decoded grid
        (reference generate_shadow_map / MethodShadowMap). Sticky: once
        enabled it is recomputed whenever the grid or the transfer function
        changes; call again with another light_dir to move the light."""
        from instantvnr_torch.render.shadow import shadow_volume_for

        light = (light_dir if light_dir is not None
                 else self.settings.light_dir)
        self._shadow_light = (tuple(float(v) for v in light),
                              float(sampling_rate))
        self.shadow_volume = shadow_volume_for(self.decoded, self.tf,
                                               self._shadow_light[0],
                                               sampling_rate)

    def disable_shadows(self):
        self._shadow_light = None
        self.shadow_volume = None

    # -- frame loop -------------------------------------------------------

    def render(self):
        cam = self.camera
        axis, flipped = principal_axis(cam, self._scale_h)
        if not slab_path_valid(cam, self.volume_dims, axis, flipped,
                               self._scale_h,
                               aspect=self.width / float(self.height)):
            # degenerate camera (the frustum looks backward along the
            # principal axis): the masked wavefront marches the grid instead
            return self._render_fallback(cam)
        d_slab = self.decoded.shape[0 if axis == 2 else (1 if axis == 1 else 2)]
        occ = (slab_occupancy_from_macrocell(self.mc, axis, flipped, d_slab)
               if self.settings.skip_empty_slabs else None)
        grad = None
        if self.settings.shading == "gradient":
            if self._gradients is None:
                self._gradients = compute_gradient_volumes(self.decoded)
            grad = self._gradients
        self._frame = slab_render(
            self.decoded, self.tf, camera_arrays(cam, self.device),
            self.width, self.height, self.settings, axis, flipped, occ,
            self.transform, grad, self.shadow_volume)
        return self._frame

    def _fallback_jitter(self) -> torch.Tensor:
        """The fallback frame's per-ray jitter, from a generator seeded 0
        on the grid's device (the JAX package draws it from PRNGKey(0))."""
        gen = torch.Generator(device=self.device).manual_seed(0)
        return torch.rand((self.width * self.height,), generator=gen,
                          dtype=torch.float32, device=self.device)

    def _render_fallback(self, cam):
        """One wavefront frame of the decoded grid, with the slab path's
        rate, density and shading, so that a degenerate camera does not pop
        to another look (JAX render/decoded.py:203)."""
        from instantvnr_torch.render.raymarch import RaymarchSettings
        from instantvnr_torch.render.renderer import (_render_frame,
                                                      reference_sample_fn)

        settings = RaymarchSettings(
            sampling_rate=self.settings.sampling_rate,
            density_scale=self.settings.density_scale,
            shading=self.settings.shading,
            shading_scale=self.settings.shading_scale,
            light_dir=self.settings.light_dir)
        _, self._frame = _render_frame(
            reference_sample_fn, self.width, self.height, settings,
            self.decoded, camera_arrays(cam, self.device), self.mc, self.tf,
            self._fallback_jitter(), None, 1, self.transform)
        return self._frame

    def mapframe(self) -> np.ndarray:
        return self._frame.detach().cpu().numpy().reshape(
            self.height, self.width, 4)
