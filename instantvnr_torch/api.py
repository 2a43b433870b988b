"""High-level facade — the decoded-grid part of `instantvnr_tpu/api.py`
(the reference C API, `api.h:91-188`):

  vnrCreateSimpleVolume          → SimpleVolume(Volume) / SimpleVolume.synthetic
  vnrCreateNeuralVolume(cfg,vol) → NeuralVolume(model_cfg, simple=...)
  vnrCreateNeuralVolume(params)  → NeuralVolume.from_checkpoint(path)
  vnrNeuralVolumeDecodeProgressive → NeuralVolume.decode_progressive()
  vnrNeuralVolumeSerializeParams → NeuralVolume.save_params(path)  (BSON)
  vnrCreateRenderer/vnrRender/vnrRendererMapFrame → VNRenderer.render()/mapframe()

Render modes ported: DECODED_SLAB (with `set_slab_shading("gradient")` and
`enable_shadows()`), FULL_SHADOW_DECODED, ISOSURFACE_DECODED and
ISOSURFACE_REFERENCE. Every entry point takes a `device` and defaults to
"cuda": on a machine without CUDA it raises rather than running on the
CPU. Training and the other render modes are later items of the port and
raise NotImplementedError naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from instantvnr_torch.accel import macrocell as mcmod
from instantvnr_torch.config import (
    ModelConfig,
    TransferFunctionConfig,
    load_model_config,
)
from instantvnr_torch.data.volume import Volume, synthetic_volume
from instantvnr_torch.models.network import NeuralField
from instantvnr_torch.models.optimizer import adam_init
from instantvnr_torch.models.trainer import (
    DEFAULT_TRAIN_BATCH,
    TrainState,
    create_train_state,
    derived_generator,
    test_loss,
    train_steps,
)
from instantvnr_torch.render.camera import Camera
from instantvnr_torch.render.raymarch import DEFAULT_LIGHT
from instantvnr_torch.render.transform import default_transform
from instantvnr_torch.utils.device import resolve_device
from instantvnr_torch.utils.tfn import TransferFunction, bake_transfer_function


class RenderMode(enum.IntEnum):
    """The JAX package's mode matrix (instantvnr_tpu/api.py:71); the
    decoded-grid modes are ported (_PORTED_MODES)."""

    DECODED_SLAB = 0
    NEURAL_WAVEFRONT = 1
    REFERENCE_RAYMARCH = 2
    NEURAL_WAVEFRONT_GRADIENT = 3
    REFERENCE_GRADIENT = 4
    PATHTRACE_DECODED = 5
    PATHTRACE_REFERENCE = 6
    NEURAL_WAVEFRONT_SSH = 7
    REFERENCE_SSH = 8
    PATHTRACE_NEURAL = 9
    ISOSURFACE_DECODED = 10
    ISOSURFACE_REFERENCE = 11
    FULL_SHADOW_DECODED = 12
    FULL_SHADOW_REFERENCE = 13


_PORTED_MODES = (RenderMode.DECODED_SLAB, RenderMode.FULL_SHADOW_DECODED,
                 RenderMode.ISOSURFACE_DECODED,
                 RenderMode.ISOSURFACE_REFERENCE)
# the ROADMAP item that ports every other mode (FULL_SHADOW_REFERENCE is a
# shadow-modulated wavefront)
_MARCHERS_ITEM = ("ROADMAP 'Next slices' item 3 (exact marchers: wavefront, "
                  "brick cache and path tracing)")
_NPZ_ITEM = ("ROADMAP 'Next slices' item 2 (main-path CLI and bench, "
             "with native .npz checkpoints for --resume)")


class SimpleVolume:
    """Ground-truth volume + macrocell (reference SimpleVolumeContext,
    api_internal.h:17-24)."""

    def __init__(self, source: Volume, tfn_cfg=None, device="cuda"):
        dev = resolve_device(device)
        if not isinstance(source, Volume):
            raise NotImplementedError(
                "scene files and raw volumes are not ported yet (ROADMAP "
                "'Next slices' item 5, data and model breadth)")
        self.volume = dataclasses.replace(source, data=source.data.to(dev))
        self.device = dev
        self.tfn_cfg = tfn_cfg or TransferFunctionConfig()
        self.tf: TransferFunction = bake_transfer_function(self.tfn_cfg,
                                                           device=dev)
        self.macrocell = mcmod.build(self.volume.data, self.volume.dims,
                                     self.tf)
        self.transform = default_transform(self.dims, dev)

    @classmethod
    def synthetic(cls, dims=(64, 64, 64), kind="vorts", device="cuda", **kw):
        return cls(synthetic_volume(dims, kind=kind, device=device),
                   device=device, **kw)

    @property
    def dims(self):
        return self.volume.dims


@dataclasses.dataclass
class TrainingStatistics:
    """NeuralVolume::statistics (network.cu:762-767)."""

    step: int
    loss: float


class NeuralVolume:
    """The neural representation and its trainer (reference
    NeuralVolumeContext / NeuralVolume, core/network.h:29-107).

    `params` holds {"table", "mlp"} on `device`; each training step, and
    each assignment, makes a new dict, and renderers re-derive their
    inference params by identity."""

    def __init__(self, model_config, simple: SimpleVolume | None = None,
                 dims=None, seed: int = 0, device="cuda",
                 train_batch: int = DEFAULT_TRAIN_BATCH):
        self.device = resolve_device(device)
        if not isinstance(model_config, ModelConfig):
            model_config = load_model_config(model_config)
        self.cfg = model_config
        self.field = NeuralField.from_config(model_config)
        self.simple = simple
        self.dims = tuple(simple.dims) if simple is not None else tuple(dims)
        self.train_batch = train_batch
        self.state: TrainState = create_train_state(self.field, seed,
                                                    self.device)
        self.step = 0
        # the inference macrocell, updated online from training batches
        # (reference m_macrocell)
        self._mc_needs_rebuild = False
        self.macrocell = mcmod.allocate(self.dims, self.device)
        self._decoder = None
        self._full_decode_params = None  # params identity at last decode_all
        self._decode_cache = None  # (params, grid) of the last decode_volume
        self.transform = default_transform(self.dims, self.device)

    @property
    def params(self) -> dict:
        return self.state.params

    @params.setter
    def params(self, params: dict):
        """New weights; the optimizer restarts (fresh Adam moments), the
        sample stream goes on."""
        self.state = self.state._replace(params=params,
                                         opt=adam_init(params))

    # -- training -----------------------------------------------------------

    def train(self, steps: int, fast_mode: bool = False,
              chunk: int = 10) -> TrainingStatistics:
        """Run `steps` training steps in chunks of `chunk`
        (vnrNeuralVolumeTrain, api.cpp:222 → Impl::train,
        network.cu:231-259). fast_mode skips the online macrocell update."""
        if self.simple is None:
            raise ValueError("training needs a reference volume (simple=...)")
        vol = self.simple.volume.data
        done = 0
        while done < steps:
            n = min(chunk, steps - done)
            self.state = train_steps(self.field, vol, self.state, n,
                                     self.train_batch)
            done += n
        self.step += steps
        if not fast_mode:
            self._update_macrocell_online()
        return self.statistics()

    def _update_macrocell_online(self):
        """Online macrocell refresh from a fresh sample batch and the TF's
        opacity (the reference updates from the training batch,
        network.cu:770-779), on a generator derived from the sample
        stream."""
        from instantvnr_torch.ops.trilinear import sample_volume_tex

        gen = derived_generator(self.state.generator, 0x6d63)
        coords = torch.rand((self.train_batch, 3), generator=gen,
                            dtype=torch.float32, device=self.device)
        values = sample_volume_tex(self.simple.volume.data, coords)
        mc = mcmod.update_explicit(self.macrocell, coords, values)
        self.macrocell = mcmod.update_max_opacity(mc, self.simple.tf)

    def statistics(self) -> TrainingStatistics:
        return TrainingStatistics(step=self.step, loss=float(self.state.loss))

    def get_training_loss(self) -> float:
        """vnrNeuralVolumeGetTrainingLoss (api.cpp:300-305)."""
        return float(self.state.loss)

    def get_training_step(self) -> int:
        """vnrNeuralVolumeGetTrainingStep (api.cpp:307-312)."""
        return self.step

    def set_model(self, model_config):
        """vnrNeuralVolumeSetModel (api.cpp:258-267): a new architecture and
        a fresh training state."""
        if not isinstance(model_config, ModelConfig):
            model_config = load_model_config(model_config)
        self.cfg = model_config
        self.field = NeuralField.from_config(model_config)
        self.state = create_train_state(self.field, 0, self.device)
        self.step = 0
        self._decoder = None

    def set_params(self, params):
        """vnrNeuralVolumeSetParams (api.cpp:269-278): weights from a BSON
        checkpoint path or an already-decoded document. The optimizer
        restarts, as the reference's deserialize_params does (Adam moments
        are not in the interchange format)."""
        from instantvnr_torch.serializer import (load_checkpoint,
                                                 load_checkpoint_doc)

        if isinstance(params, str):
            if params.endswith(".npz"):
                raise NotImplementedError(
                    "native .npz checkpoints are not ported yet: " + _NPZ_ITEM)
            field, p, mc, dims, meta = load_checkpoint(params, self.device)
        else:
            field, p, mc, dims, meta = load_checkpoint_doc(params, self.device)
        if dims is not None and tuple(dims) != tuple(self.dims):
            if self.simple is not None:
                # the reference refuses a checkpoint of other dims
                # (network.cu:886-893)
                raise ValueError(
                    f"checkpoint volume dims {tuple(dims)} != this volume's "
                    f"{tuple(self.dims)}")
            # no ground truth: adopt the checkpoint's dims, as
            # from_checkpoint does
            self.dims = tuple(dims)
            self.macrocell = mcmod.allocate(self.dims, self.device)
            self.transform = default_transform(self.dims, self.device)
            self._decoder = None
        if (field.cfg.encoding != self.cfg.encoding
                or field.cfg.network != self.cfg.network):
            self.cfg = field.cfg  # the checkpoint's own model section
            self.field = field
            self._decoder = None
        self.params = p
        self.step = int(meta.get("step", 0))
        if mc is not None:
            tf = self.simple.tf if self.simple is not None else \
                bake_transfer_function(TransferFunctionConfig(),
                                       device=self.device)
            self.macrocell = mcmod.update_max_opacity(mc, tf)
        elif self.simple is None:
            self._mc_needs_rebuild = True

    # -- inference / decoding ---------------------------------------------

    def get_decoder(self, width=None, height=None, tf=None, settings=None):
        """The progressive decode + slab render pipeline bound to this
        network, created lazily and reused across frames; a size change
        rebuilds it and carries the decode progress over."""
        from instantvnr_torch.render.decoded import DecodedRenderer

        old = self._decoder
        if width is None:
            width = old.width if old is not None else 512
        if height is None:
            height = old.height if old is not None else 512
        if old is not None and (old.width, old.height) != (width, height):
            # a resize rebuilds the pipeline and carries over all of its
            # state: decode progress, settings, sticky shadows and who owns
            # them
            self._decoder = None
            settings = settings or old.settings
        if self._decoder is None:
            mc = (self.simple.macrocell if self.simple is not None
                  else self.macrocell)
            tf = tf or (old.tf if old is not None else None) or (
                self.simple.tf if self.simple is not None else
                bake_transfer_function(TransferFunctionConfig(),
                                       device=self.device))
            self._decoder = DecodedRenderer(
                width, height, mc, tf, self.dims, settings=settings,
                field=self.field, params=self.params,
                initial_volume=old.decoded if old is not None else None,
                transform=self.transform, device=self.device)
            if old is not None:
                self._decoder._next_blob = old._next_blob
                if old._shadow_light is not None:
                    light, rate = old._shadow_light
                    self._decoder.enable_shadows(light, sampling_rate=rate)
                    self._decoder._mode_shadows = old._mode_shadows
        else:
            self._decoder.set_params(self.params)
            if self._decoder.transform is not self.transform:
                self._decoder.set_transform(self.transform)
            if tf is not None and tf is not self._decoder.tf:
                self._decoder.set_transfer_function(tf)
        return self._decoder

    def ensure_decoded(self, width=None, height=None, tf=None):
        """get_decoder + a full decode only when the params changed since
        the last full decode."""
        dec = self.get_decoder(width, height, tf=tf)
        if self._full_decode_params is not self.params:
            dec.decode_all()
            self._full_decode_params = self.params
        return dec

    def decode_progressive(self, n_blobs: int = 1):
        """vnrNeuralVolumeDecodeProgressive (api.cpp:228)."""
        self.get_decoder().decode_progressive(n_blobs)

    @property
    def n_blobs(self) -> int:
        return self.get_decoder().n_blobs

    @property
    def macrocell(self):
        """A checkpoint without a macrocell section lazily rebuilds it from
        a full decode on first use (an all-zero max opacity would cull
        every slab)."""
        if self._mc_needs_rebuild:
            self._mc_needs_rebuild = False
            tf = bake_transfer_function(TransferFunctionConfig(),
                                        device=self.device)
            self._macrocell = mcmod.build(self.decode_volume(), self.dims, tf)
        return self._macrocell

    @macrocell.setter
    def macrocell(self, mc):
        self._macrocell = mc
        self._mc_needs_rebuild = False

    def decode_volume(self) -> torch.Tensor:
        """The full grid [dz, dy, dx], identity-cached on params."""
        from instantvnr_torch.models.metrics import decode_volume
        from instantvnr_torch.models.network import render_params

        if (self._decode_cache is not None
                and self._decode_cache[0] is self.params):
            return self._decode_cache[1]
        grid = decode_volume(self.field,
                             render_params(self.params, self.field), self.dims)
        self._decode_cache = (self.params, grid)
        return grid

    # -- metrics ------------------------------------------------------------

    def get_psnr(self) -> float:
        """PSNR of the decoded grid (decode_volume, identity-cached, so a
        PSNR then SSIM report pays one decode)."""
        from instantvnr_torch.models.metrics import psnr_arrays

        return float(psnr_arrays(self.decode_volume(),
                                 self.simple.volume.data))

    def get_mssim(self) -> float:
        from instantvnr_torch.models.metrics import ssim_arrays

        return float(ssim_arrays(self.decode_volume(),
                                 self.simple.volume.data))

    def get_testing_loss(self) -> float:
        return float(test_loss(self.field, self.simple.volume.data,
                               self.state, self.train_batch))

    def get_macrocell_psnr(self) -> float:
        """PSNR of the online macrocell's value ranges against the ground
        truth's (reference macrocell min/max PSNR, network.cu:628-698), over
        the cells the online update touched."""
        gt = self.simple.macrocell
        got = self.macrocell
        touched = got.value_hi >= got.value_lo
        if not bool(touched.any()):
            return 0.0
        err = torch.cat([(got.value_lo - gt.value_lo)[touched],
                         (got.value_hi - gt.value_hi)[touched]])
        mse = float((err.double() ** 2).mean())
        return float(10.0 * np.log10(1.0 / max(mse, 1e-20)))

    # -- serialization ----------------------------------------------------

    def save_params(self, path: str):
        """vnrNeuralVolumeSerializeParams: the reference BSON format, with
        the training step and loss."""
        if path.endswith(".npz"):
            raise NotImplementedError(
                "native .npz checkpoints are not ported yet: " + _NPZ_ITEM)
        from instantvnr_torch.serializer import save_checkpoint

        mc = self.simple.macrocell if self.simple is not None else self.macrocell
        save_checkpoint(path, self.field, self.params, mc, self.dims,
                        groundtruth_mc=self.simple is not None, step=self.step,
                        loss=float(self.state.loss))

    @classmethod
    def from_checkpoint(cls, path: str, simple: SimpleVolume | None = None,
                        device="cuda"):
        """vnrCreateNeuralVolume(params) (api.cpp:206-220): a loaded model
        renders without any ground truth."""
        if path.endswith(".npz"):
            raise NotImplementedError(
                "native .npz checkpoints are not ported yet: " + _NPZ_ITEM)
        from instantvnr_torch.serializer import load_checkpoint

        dev = resolve_device(device)
        field, params, mc, dims, meta = load_checkpoint(path, device=dev)
        nv = cls(field.cfg, simple=simple, dims=dims, device=dev)
        nv.params = params
        nv.step = int(meta.get("step", 0))
        if mc is not None:
            tf = simple.tf if simple is not None else bake_transfer_function(
                TransferFunctionConfig(), device=dev)
            nv.macrocell = mcmod.update_max_opacity(mc, tf)
        elif simple is None:
            nv._mc_needs_rebuild = True
        return nv


class VNRenderer:
    """Renderer handle (reference RendererContext, api_internal.h:37-45) for
    the decoded-grid modes (_PORTED_MODES)."""

    def __init__(self, volume, width=512, height=512,
                 mode: RenderMode = RenderMode.DECODED_SLAB):
        self.width, self.height = width, height
        self.mode = mode
        self._impl = None
        self._camera = None
        self.sampling_rate = 1.0
        self.density_scale = 1.0
        self.isovalue = 0.5  # for the ISOSURFACE_* modes
        self._shadow_light_used = None  # FULL_SHADOW_DECODED's light
        if isinstance(volume, NeuralVolume):
            self.neural = volume
            self.simple = volume.simple
        else:
            self.neural = None
            self.simple = volume
        self.set_mode(mode)

    def _subject(self, mode: RenderMode):
        """The volume object a mode renders; raises if it is missing."""
        needs_simple = mode == RenderMode.ISOSURFACE_REFERENCE
        subject = self.simple if needs_simple else self.neural
        if subject is None:
            raise ValueError(f"{mode.name} renders a "
                             + ("SimpleVolume" if needs_simple
                                else "NeuralVolume"))
        return subject

    def _tf(self, device):
        """The scene's transfer function: the SimpleVolume's, else the
        default one (JAX VNRenderer._scene_parts)."""
        if self.simple is not None:
            return self.simple.tf
        return bake_transfer_function(TransferFunctionConfig(), device=device)

    def set_mode(self, mode: RenderMode):
        from instantvnr_torch.render.isosurf import IsoRenderer, IsoSettings

        mode = RenderMode(mode)
        if mode not in _PORTED_MODES:
            raise NotImplementedError(
                f"render mode {mode.name} is not ported yet: "
                + _MARCHERS_ITEM)
        subject = self._subject(mode)
        self.mode = mode
        if mode in (RenderMode.DECODED_SLAB, RenderMode.FULL_SHADOW_DECODED):
            tf = self.simple.tf if self.simple is not None else None
            impl = self.neural.ensure_decoded(self.width, self.height, tf=tf)
            impl.settings = dataclasses.replace(
                impl.settings, sampling_rate=self.sampling_rate,
                density_scale=self.density_scale)
            if mode == RenderMode.FULL_SHADOW_DECODED:
                # reference mode 2 on the decoded grid: the shadow volume's
                # modulation is the per-sample transmittance; the ambient
                # floor 1 − shadingScale matches lerp(shadingScale, c,
                # c·shadow) (method_optix.cu:215)
                impl.settings = dataclasses.replace(impl.settings,
                                                    shadow_ambient=0.05)
                self._shadow_light_used = self._flipped_light()
                impl.enable_shadows(self._shadow_light_used,
                                    sampling_rate=self.sampling_rate)
                impl._mode_shadows = True
            elif impl._mode_shadows:
                # shadows that FULL_SHADOW_DECODED turned on do not leak into
                # the plain mode (an explicit enable_shadows() does); the
                # ownership lives on the decoder, which renderers share
                impl.disable_shadows()
                impl.settings = dataclasses.replace(impl.settings,
                                                    shadow_ambient=0.35)
                impl._mode_shadows = False
        else:
            grid = (self.neural.decode_volume()
                    if mode == RenderMode.ISOSURFACE_DECODED
                    else self.simple.volume.data)
            impl = IsoRenderer(
                self.width, self.height, grid, self._tf(subject.device),
                isovalue=self.isovalue, settings=IsoSettings(),
                transform=(self.neural or self.simple).transform,
                device=subject.device)
        if self._camera is not None:
            impl.set_camera(self._camera)
        self._impl = impl

    def set_camera(self, cam: Camera):
        self._camera = cam
        self._impl.set_camera(cam)
        # FULL_SHADOW: the light flips against the view (renderer.cpp:98-100)
        # and the shadow volume follows the flip; most camera moves do not
        # flip it, so the volume is recomputed only when the light changes
        if self.mode == RenderMode.FULL_SHADOW_DECODED:
            light = self._flipped_light()
            if light != self._shadow_light_used:
                self._shadow_light_used = light
                self._impl.enable_shadows(light,
                                          sampling_rate=self.sampling_rate)

    def _flipped_light(self) -> tuple:
        """The frame light: the default directional light flipped against
        the current view direction (renderer.cpp:98-100)."""
        light = np.asarray(DEFAULT_LIGHT, np.float32)
        cam = self.camera
        if cam is not None:
            view = np.asarray(cam.center, np.float32) - np.asarray(
                cam.eye, np.float32)
            if float(np.dot(view, light)) > 0:
                light = -light
        return tuple(float(v) for v in light)

    @property
    def camera(self) -> Camera | None:
        if self._camera is not None:
            return self._camera
        # inside the first set_mode there is no impl yet, so no camera
        return self._impl.camera if self._impl is not None else None

    def set_volume_sampling_rate(self, rate: float):
        """vnrRendererSetVolumeSamplingRate (batch_renderer.cpp:203)."""
        self.sampling_rate = float(rate)
        self.set_mode(self.mode)

    def set_volume_density_scale(self, scale: float):
        """vnrRendererSetVolumeDensityScale (batch_renderer.cpp:202)."""
        self.density_scale = float(scale)
        self.set_mode(self.mode)

    def set_isovalue(self, isovalue: float):
        """Isovalue of the ISOSURFACE_* modes (the reference app's iso
        slider, int_isosurface.cu); an edit rebuilds nothing."""
        self.isovalue = float(isovalue)
        if self.mode in (RenderMode.ISOSURFACE_DECODED,
                         RenderMode.ISOSURFACE_REFERENCE):
            self._impl.set_isovalue(self.isovalue)

    def _require_decoded_slab(self, what: str):
        if self.mode != RenderMode.DECODED_SLAB:
            raise ValueError(f"{what} applies to DECODED_SLAB, not "
                             f"{self.mode.name}")

    def enable_shadows(self, light_dir=None):
        """Shadow-volume rendering on the decoded path (the reference's
        MethodShadowMap / generate_shadow_map): a transmittance volume from
        the current decoded grid, kept fresh across decodes and TF edits
        (render/shadow.py)."""
        self._require_decoded_slab("enable_shadows")
        self._impl.enable_shadows(light_dir)
        self._impl._mode_shadows = False  # owned by the user from here on

    def disable_shadows(self):
        self._require_decoded_slab("disable_shadows")
        self._impl.disable_shadows()

    def set_slab_shading(self, shading: str):
        """Gradient shading on the decoded slab path: "none" | "gradient"
        (the reference's mode x shading matrix, api.h:36-60)."""
        self._require_decoded_slab("set_slab_shading")
        if shading not in ("none", "gradient"):
            raise ValueError(f"slab shading {shading!r}: expected 'none' or "
                             "'gradient'")
        self._impl.settings = dataclasses.replace(self._impl.settings,
                                                  shading=shading)

    def refresh_params(self):
        """Rebind the render path to the neural volume's current parameters
        (the online-training hook): the decoded slab modes re-read them at
        render(), ISOSURFACE_DECODED decodes its grid again."""
        if self.neural is not None and \
                self.mode == RenderMode.ISOSURFACE_DECODED:
            self._impl.set_grid(self.neural.decode_volume())

    def render(self):
        """vnrRender (api.cpp:522). Rebinding the same params object every
        frame costs nothing: the decoder caches its inference params by
        identity."""
        if self.mode in (RenderMode.DECODED_SLAB,
                         RenderMode.FULL_SHADOW_DECODED):
            self._impl.set_params(self.neural.params)
        return self._impl.render()

    def mapframe(self) -> np.ndarray:
        """vnrRendererMapFrame: [H, W, 4] float32 on the host."""
        return self._impl.mapframe()
