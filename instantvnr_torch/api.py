"""High-level facade, counterpart of `instantvnr_tpu/api.py` (the
reference C API, `api.h:91-188`):

  vnrCreateSimpleVolume          → SimpleVolume(scene path | SceneConfig |
                                   Volume | [Volume, ...]) /
                                   SimpleVolume.synthetic
  vnrSimpleVolumeSetCurrentTimeStep → SimpleVolume.set_current_timestep /
                                   VNRenderer.set_current_timestep
  vnrCreateNeuralVolume(cfg,vol) → NeuralVolume(model_cfg, simple=...)
  vnrCreateNeuralVolume(params)  → NeuralVolume.from_checkpoint(path)
  vnrNeuralVolumeTrain           → NeuralVolume.train(steps)
  vnrNeuralVolumeDecodeProgressive → NeuralVolume.decode_progressive()
  vnrNeuralVolumeSerializeParams → NeuralVolume.save_params(path)  (BSON;
                                   .npz: the native exact-resume format)
  vnrNeuralVolumeSerializeVolume → NeuralVolume.save_inference_volume(path)
  vnrCreateRenderer/vnrRender/vnrRendererMapFrame → VNRenderer.render()/mapframe()
  vnrRendererSetTransferFunction / SetFramebufferSize
                                 → VNRenderer.set_transfer_function /
                                   set_framebuffer_size
  vnrCreateTransferFunction      → TransferFunctionObject
  vnrCreateJson* / vnrLoadJson* / vnrSaveJson* → load_json / save_json
  vnrFreeTemporaryGPUMemory / vnrMemoryQuery → free_temporary_memory /
                                   memory_query

Every RenderMode renders: DECODED_SLAB (with `set_slab_shading("gradient")`
and `enable_shadows()`), FULL_SHADOW_DECODED, ISOSURFACE_DECODED and
ISOSURFACE_REFERENCE (slab paths, with the wavefront and brute-force
fallbacks of degenerate cameras), the wavefront modes NEURAL_WAVEFRONT
(_GRADIENT, _SSH) under every `streaming_cache` policy ("auto", the
default, and "brick", "hq", "lazy": brick pools, render/brickcache.py;
"none": exact per-sample network evaluation), REFERENCE_RAYMARCH,
REFERENCE_GRADIENT, REFERENCE_SSH and FULL_SHADOW_REFERENCE, and the path
tracer (render/pathtrace.py) in PATHTRACE_REFERENCE, PATHTRACE_DECODED and
PATHTRACE_NEURAL. Every entry point takes a `device` and defaults to
"cuda": on a machine without CUDA it raises rather than running on the
CPU.
"""
from __future__ import annotations

import dataclasses
import enum
import os

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
from instantvnr_torch.render.raymarch import DEFAULT_LIGHT, RaymarchSettings
from instantvnr_torch.render.transform import default_transform
from instantvnr_torch.utils.device import resolve_device
from instantvnr_torch.utils.profiling import span
from instantvnr_torch.utils.tfn import TransferFunction, bake_transfer_function


class RenderMode(enum.IntEnum):
    """The JAX package's mode matrix (instantvnr_tpu/api.py:71)."""

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

    @property
    def requires_decoding(self) -> bool:
        """vnrRequireDecoding (api.h:62-88): does the mode render from the
        decoded grid (and so need a decode before frames)?"""
        return self in (RenderMode.DECODED_SLAB, RenderMode.PATHTRACE_DECODED,
                        RenderMode.ISOSURFACE_DECODED,
                        RenderMode.FULL_SHADOW_DECODED)


_NEURAL_WAVEFRONT = {RenderMode.NEURAL_WAVEFRONT: "none",
                     RenderMode.NEURAL_WAVEFRONT_GRADIENT: "gradient",
                     RenderMode.NEURAL_WAVEFRONT_SSH: "ssh"}
_REFERENCE_WAVEFRONT = {RenderMode.REFERENCE_RAYMARCH: "none",
                        RenderMode.REFERENCE_GRADIENT: "gradient",
                        RenderMode.REFERENCE_SSH: "ssh",
                        RenderMode.FULL_SHADOW_REFERENCE: "shadow"}
_PATHTRACE = (RenderMode.PATHTRACE_REFERENCE, RenderMode.PATHTRACE_DECODED,
              RenderMode.PATHTRACE_NEURAL)
_STREAMING_CACHES = ("auto", "brick", "hq", "lazy", "none")


def _field_from_config(model_config):
    """The model family of a config (the reference's set_network builds
    a TcnnNetwork or an FvsrnNetwork, network.cu:551-603; JAX
    api.py:297-309): an FvsrnConfig builds the fV-SRN field, anything else
    (a path, a dict, a ModelConfig) the hash-grid NeuralField."""
    from instantvnr_torch.models.fvsrn import FvsrnConfig, FvsrnField

    if isinstance(model_config, FvsrnConfig):
        return model_config, FvsrnField.from_config(model_config)
    if not isinstance(model_config, ModelConfig):
        model_config = load_model_config(model_config)
    return model_config, NeuralField.from_config(model_config)


def _same_architecture(a, b) -> bool:
    if type(a) is not type(b):
        return False
    if isinstance(a, NeuralField):
        return (a.cfg.encoding == b.cfg.encoding
                and a.cfg.network == b.cfg.network)
    return a.cfg == b.cfg


class TransferFunctionObject:
    """Mutable transfer-function handle (vnrCreateTransferFunction and
    vnrTransferFunctionSet/Get{Color,Alpha,ValueRange}, api.h:127-137).
    Wraps the immutable TransferFunctionConfig; pass the handle straight
    to SimpleVolume/VNRenderer.set_transfer_function."""

    def __init__(self, cfg: TransferFunctionConfig | None = None):
        self.cfg = cfg or TransferFunctionConfig()

    def set_color(self, points):
        """points: iterable of (position, r, g, b), positions in [0, 1]."""
        self.cfg = dataclasses.replace(
            self.cfg, colors=tuple(tuple(float(v) for v in p) for p in points))

    def set_alpha(self, points):
        """points: iterable of (position, alpha)."""
        self.cfg = dataclasses.replace(
            self.cfg, alphas=tuple(tuple(float(v) for v in p) for p in points))

    def set_value_range(self, lo: float, hi: float):
        self.cfg = dataclasses.replace(self.cfg, range=(float(lo), float(hi)))

    def get_color(self):
        return self.cfg.colors

    def get_alpha(self):
        return self.cfg.alphas

    def get_value_range(self):
        return self.cfg.range


def _tf_config(tfn_cfg):
    """Accept a TransferFunctionConfig or a TransferFunctionObject handle."""
    if isinstance(tfn_cfg, TransferFunctionObject):
        return tfn_cfg.cfg
    return tfn_cfg


def load_json(path: str):
    """vnrCreateJsonText/Binary + vnrLoadJsonText/Binary (api.cpp:17-61):
    one loader for both encodings, sniffing BSON (a leading int32 length
    equal to the file's, a trailing NUL) against relaxed JSON text (//
    comments allowed)."""
    with open(path, "rb") as f:
        raw = f.read()
    if (len(raw) >= 5 and int.from_bytes(raw[:4], "little") == len(raw)
            and raw[-1] == 0):
        from instantvnr_torch.utils import bson

        return bson.decode(raw)
    from instantvnr_torch.config import loads_relaxed_json

    return loads_relaxed_json(raw.decode("utf-8"))


def save_json(doc: dict, path: str, binary: bool | None = None):
    """vnrSaveJsonText (api.cpp:34-39, an indent-4 dump) / vnrSaveJsonBinary
    (api.cpp:41-48, BSON); binary=None infers it from the extension."""
    if binary is None:
        binary = path.endswith((".bson", ".bin", ".params"))
    if binary:
        from instantvnr_torch.utils import bson

        with open(path, "wb") as f:
            f.write(bson.encode(doc))
    else:
        import json

        with open(path, "w") as f:
            json.dump(doc, f, indent=4)


class SimpleVolume:
    """Ground-truth volume + macrocell (reference SimpleVolumeContext,
    api_internal.h:17-24; SimpleVolume, core/sampler.h:66-94).

    `source`: a Volume; a SceneConfig or the path of a scene JSON (its raw
    file is read and placed on `device`, its camera and transfer function
    kept); or a list of Volumes sharing dims, an in-memory time series."""

    def __init__(self, source, tfn_cfg=None, device="cuda"):
        from instantvnr_torch.config import SceneConfig, load_scene_config
        from instantvnr_torch.data.volume import load_volume

        dev = resolve_device(device)
        self.device = dev
        if isinstance(source, str):
            source = load_scene_config(source)
        self.scene = None
        self.camera_cfg = None
        self._timestep_volumes = None  # an in-memory time series
        self._timestep = 0
        if isinstance(source, SceneConfig):
            self.scene = source
            volume = load_volume(source.volume, device=dev)
            tfn_cfg = tfn_cfg or source.tfn
            self.camera_cfg = source.camera
        elif isinstance(source, (list, tuple)):
            if len({v.dims for v in source}) != 1:
                raise ValueError("the timesteps' dims differ")
            self._timestep_volumes = list(source)
            volume = source[0]
        elif isinstance(source, Volume):
            volume = source
        else:
            raise TypeError(f"SimpleVolume of {type(source).__name__}: "
                            "expected a Volume, a SceneConfig, a scene path "
                            "or a list of Volumes")
        self.volume = dataclasses.replace(volume, data=volume.data.to(dev))
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

    @property
    def value_range(self):
        """vnrVolumeGetValueRange (api.h): (min, max) in data units."""
        return self.volume.original_range

    def set_transfer_function(self, tfn_cfg):
        """A new transfer function (a config or a TransferFunctionObject):
        rebaked, and the macrocell's max opacity re-derived from it."""
        self.tfn_cfg = _tf_config(tfn_cfg)
        self.tf = bake_transfer_function(self.tfn_cfg, device=self.device)
        self.macrocell = mcmod.update_max_opacity(self.macrocell, self.tf)

    # -- time series (vnrSimpleVolumeSetCurrentTimeStep /
    #    vnrSimpleVolumeGetNumberOfTimeSteps, api.h:118-119) ---------------

    @property
    def num_timesteps(self) -> int:
        if self._timestep_volumes is not None:
            return len(self._timestep_volumes)
        if self.scene is not None:
            return self.scene.volume.n_timesteps
        return 1

    @property
    def current_timestep(self) -> int:
        return self._timestep

    def set_current_timestep(self, index: int):
        """Switch the active timestep and rebuild the macrocell from its
        data (SimpleVolume::set_current_timestep, sampler.cu:20-26)."""
        from instantvnr_torch.data.volume import load_volume

        n = self.num_timesteps
        if not 0 <= index < n:
            raise IndexError(f"timestep {index} out of range [0,{n})")
        if index == self._timestep:
            return
        if self._timestep_volumes is not None:
            volume = self._timestep_volumes[index]
        else:
            volume = load_volume(self.scene.volume.at_timestep(index),
                                 device=self.device)
        self.volume = dataclasses.replace(volume,
                                          data=volume.data.to(self.device))
        self._timestep = index
        self.macrocell = mcmod.build(self.volume.data, self.volume.dims,
                                     self.tf)

    def set_clipping_box(self, lower, upper):
        """vnrVolumeSetClippingBox (api.cpp:322-338): bounds in voxel
        coordinates [0, dims], the reference's user-facing convention."""
        self.transform = _clipped(self.transform, lower, upper)

    def set_scaling(self, scale):
        """vnrVolumeSetScaling (api.cpp:340-351): composes scale with the
        existing data transform."""
        self.transform = _scaled(self.transform, scale)


def _clipped(xform, lower, upper):
    dev = xform.scale.device
    return xform._replace(
        clip_lower=torch.as_tensor(lower, dtype=torch.float32, device=dev),
        clip_upper=torch.as_tensor(upper, dtype=torch.float32, device=dev))


def _scaled(xform, scale):
    return xform._replace(scale=torch.as_tensor(
        scale, dtype=torch.float32, device=xform.scale.device) * xform.scale)


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
        self.cfg, self.field = _field_from_config(model_config)
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

    def set_clipping_box(self, lower, upper):
        """vnrVolumeSetClippingBox on the neural volume (api.cpp:322-338)."""
        self.transform = _clipped(self.transform, lower, upper)
        if self._decoder is not None:
            self._decoder.set_transform(self.transform)

    def set_scaling(self, scale):
        """vnrVolumeSetScaling on the neural volume (api.cpp:340-351)."""
        self.transform = _scaled(self.transform, scale)
        if self._decoder is not None:
            self._decoder.set_transform(self.transform)

    # -- training -----------------------------------------------------------

    def train(self, steps: int, fast_mode: bool = False,
              chunk: int = 10) -> TrainingStatistics:
        """Run `steps` training steps in chunks of `chunk`
        (vnrNeuralVolumeTrain, api.cpp:222 → Impl::train,
        network.cu:231-259). fast_mode skips the online macrocell update.
        The call is a `train.call` span, its closing read of the loss (the
        wait for the card) a `train.wait` (utils/profiling.py)."""
        if self.simple is None:
            raise ValueError("training needs a reference volume (simple=...)")
        with span("train.call"):
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
            with span("train.wait"):
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
        self.cfg, self.field = _field_from_config(model_config)
        self.state = create_train_state(self.field, 0, self.device)
        self.step = 0
        self._decoder = None

    def set_params(self, params):
        """vnrNeuralVolumeSetParams (api.cpp:269-278): weights from a BSON
        checkpoint path or an already-decoded document. The optimizer
        restarts, as the reference's deserialize_params does (Adam moments
        are not in the interchange format). A native `.npz` path restores
        the whole training state instead (exact resume)."""
        from instantvnr_torch.serializer import (load_checkpoint,
                                                 load_checkpoint_doc,
                                                 load_native)

        if isinstance(params, str) and params.endswith(".npz"):
            field, state, dims = load_native(params, self.device)
            self._adopt(field, dims)
            self.state = state
            self.step = int(state.opt.step)
            if self.simple is None:
                self._mc_needs_rebuild = True  # no macrocell in the file
            return
        if isinstance(params, str):
            field, p, mc, dims, meta = load_checkpoint(params, self.device)
        else:
            field, p, mc, dims, meta = load_checkpoint_doc(params, self.device)
        self._adopt(field, dims)
        self.params = p
        self.step = int(meta.get("step", 0))
        if mc is not None:
            tf = self.simple.tf if self.simple is not None else \
                bake_transfer_function(TransferFunctionConfig(),
                                       device=self.device)
            self.macrocell = mcmod.update_max_opacity(mc, tf)
        elif self.simple is None:
            self._mc_needs_rebuild = True

    def _adopt(self, field, dims):
        """A checkpoint's dims and model section: a dims mismatch is refused
        with a ground truth and adopted without one; another model section
        replaces this volume's."""
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
        if not _same_architecture(field, self.field):
            self.cfg = field.cfg  # the checkpoint's own model section
            self.field = field
            self._decoder = None

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

    def save_inference_volume(self, path: str):
        """Decode the network over the full grid and write it as raw
        float32 (vnrNeuralVolumeSerializeVolume → save_inference_volume,
        network.cu:328-408); a `.vdb` path writes an OpenVDB FloatGrid
        (data/vdb.py), which `--volume` reads back."""
        if path.endswith(".vdb"):
            from instantvnr_torch.data.vdb import write_vdb

            write_vdb(path, self.decode_volume().detach().cpu().numpy(),
                      compression="zip")
            return
        from instantvnr_torch.data.volume import save_raw

        save_raw(self.decode_volume(), path)

    def save_reference_volume(self, path: str):
        """Write the normalized ground-truth volume as raw float32
        (save_reference_volume)."""
        from instantvnr_torch.data.volume import save_raw

        if self.simple is None:
            raise ValueError("save_reference_volume needs a reference "
                             "volume (simple=...)")
        save_raw(self.simple.volume.data, path)

    def save_params(self, path: str):
        """vnrNeuralVolumeSerializeParams: the reference BSON format, with
        the training step and loss; a `.npz` path writes the native
        exact-resume checkpoint (the whole training state, in the JAX
        package's layout)."""
        if path.endswith(".npz"):
            from instantvnr_torch.serializer import save_native

            save_native(path, self.field, self.state, volume_dims=self.dims)
            return
        spec = getattr(self.field, "spec", None)
        if spec is None or spec.paired:
            raise ValueError(
                "fV-SRN and paired-hash models have no BSON interchange "
                "layout (the reference's FvsrnNetwork cannot serialize "
                "either, fvsrn_network.h:10-56; tcnn has no paired grid): "
                "save to a native .npz instead")
        from instantvnr_torch.serializer import save_checkpoint

        mc = self.simple.macrocell if self.simple is not None else self.macrocell
        save_checkpoint(path, self.field, self.params, mc, self.dims,
                        groundtruth_mc=self.simple is not None, step=self.step,
                        loss=float(self.state.loss))

    @classmethod
    def from_checkpoint(cls, path: str, simple: SimpleVolume | None = None,
                        device="cuda"):
        """vnrCreateNeuralVolume(params) (api.cpp:206-220): a loaded model
        renders without any ground truth. A `.npz` native checkpoint
        restores the whole training state (exact resume)."""
        from instantvnr_torch.serializer import load_checkpoint, load_native

        dev = resolve_device(device)
        if path.endswith(".npz"):
            field, state, dims = load_native(path, dev)
            nv = cls(field.cfg, simple=simple, dims=dims, device=dev)
            nv.state = state
            nv.step = int(state.opt.step)
            if simple is None:
                nv._mc_needs_rebuild = True  # no macrocell in the file
            return nv
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
    """Renderer handle (reference RendererContext, api_internal.h:37-45):
    dispatches between the slab paths (decoded grid), the wavefront
    (network, brick pool or ground truth) and the path tracer by
    RenderMode, and owns the camera and the frame size.

    streaming_cache: the sample-streaming policy of the NEURAL_WAVEFRONT*
    modes (JAX api.py:706-717): "auto" / "brick" a macrocell-guided brick
    pool (render/brickcache.py); "hq" the pool at a 2× nested lattice;
    "lazy" the pool with each brick decoded at its first visibility;
    "none" exact per-sample network evaluation (the reference's mode 5).
    A constructor argument, so "lazy" never pays the eager build.
    `streaming_cache_info` reports what a policy resolved to."""

    def __init__(self, volume, width=512, height=512,
                 mode: RenderMode = RenderMode.DECODED_SLAB,
                 streaming_cache: str = "auto"):
        if streaming_cache not in _STREAMING_CACHES:
            raise ValueError(f"streaming_cache={streaming_cache!r}: expected "
                             f"one of {_STREAMING_CACHES}")
        self.width, self.height = width, height
        self.mode = mode
        self.streaming_cache = streaming_cache
        self._lazy = None  # LazyBrickCache under streaming_cache="lazy"
        self._brick_cursor = 0  # refresh_params(budget_bricks=...)'s
        self._impl = None
        self._camera = None
        # vnrRendererSetVolumeSamplingRate / SetVolumeDensityScale /
        # SetDenoiser (batch_renderer.cpp:201-203)
        self.sampling_rate = 1.0
        self.density_scale = 1.0
        self.denoise = False
        self.isovalue = 0.5  # for the ISOSURFACE_* modes
        self._shadow_light_used = None  # the FULL_SHADOW_* modes' light
        # a renderer-level TF of a renderer without a ground truth
        # (vnrRendererSetTransferFunction); with one, the SimpleVolume's
        self._tf_override = None
        if isinstance(volume, NeuralVolume):
            self.neural = volume
            self.simple = volume.simple
        else:
            self.neural = None
            self.simple = volume
        self.set_mode(mode)

    def _subject(self, mode: RenderMode):
        """The volume object a mode renders; raises if it is missing."""
        needs_simple = mode in (RenderMode.ISOSURFACE_REFERENCE,
                                RenderMode.PATHTRACE_REFERENCE) or (
            mode in _REFERENCE_WAVEFRONT)
        subject = self.simple if needs_simple else self.neural
        if subject is None:
            raise ValueError(f"{mode.name} renders a "
                             + ("SimpleVolume" if needs_simple
                                else "NeuralVolume"))
        return subject

    def _tf(self, device):
        """The scene's transfer function: the SimpleVolume's, else the
        renderer-level one, else the default one (JAX
        VNRenderer._scene_parts)."""
        if self.simple is not None:
            return self.simple.tf
        if self._tf_override is not None:
            return self._tf_override
        return bake_transfer_function(TransferFunctionConfig(), device=device)

    def _scene_mc(self):
        """The ground truth's macrocell when there is one, else the neural
        volume's, its max opacity re-derived under a renderer-level TF (the
        JAX package keeps the default TF's there, so its wavefront and path
        tracer would skip cells the new TF makes visible)."""
        if self.simple is not None:
            return self.simple.macrocell
        if self._tf_override is not None:
            return mcmod.update_max_opacity(self.neural.macrocell,
                                            self._tf_override)
        return self.neural.macrocell

    def _transform(self):
        return (self.neural or self.simple).transform

    def set_mode(self, mode: RenderMode):
        from instantvnr_torch.render.isosurf import IsoRenderer, IsoSettings

        mode = RenderMode(mode)
        subject = self._subject(mode)
        self.mode = mode
        self._lazy = None  # re-established by _build_streaming_ctx("lazy")
        if mode in (RenderMode.DECODED_SLAB, RenderMode.FULL_SHADOW_DECODED):
            # None keeps the decoder's TF (the default, or an earlier
            # renderer's)
            tf = (self.simple.tf if self.simple is not None
                  else self._tf_override)
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
        elif mode in _NEURAL_WAVEFRONT:
            impl = self._neural_wavefront(mode, subject)
        elif mode in _REFERENCE_WAVEFRONT:
            from instantvnr_torch.render.renderer import (Renderer,
                                                          reference_sample_fn)

            tf = self.simple.tf
            impl = Renderer(
                self.width, self.height, self.simple.macrocell, tf,
                reference_sample_fn, sample_ctx=self.simple.volume.data,
                settings=RaymarchSettings(
                    shading=_REFERENCE_WAVEFRONT[mode], compact=True,
                    sampling_rate=self.sampling_rate,
                    density_scale=self.density_scale),
                transform=self._transform())
            if mode == RenderMode.FULL_SHADOW_REFERENCE:
                # reference mode 2 on the ground truth: the wavefront
                # modulated by the shadow volume (JAX api.py:878-895)
                self._shadow_light_used = self._flipped_light()
                impl.set_shadow_volume(self._reference_shadow_volume(
                    self._shadow_light_used))
        elif mode in _PATHTRACE:
            impl = self._pathtracer(mode, subject)
        else:
            grid = (self.neural.decode_volume()
                    if mode == RenderMode.ISOSURFACE_DECODED
                    else self.simple.volume.data)
            impl = IsoRenderer(
                self.width, self.height, grid, self._tf(subject.device),
                isovalue=self.isovalue,
                settings=IsoSettings(
                    sampling_rate=max(self.sampling_rate, 2.0)),
                transform=self._transform(), device=subject.device)
        if self._camera is not None:
            impl.set_camera(self._camera)
        self._impl = impl

    def _neural_wavefront(self, mode: RenderMode, nv):
        """The NEURAL_WAVEFRONT* renderer: on a brick pool under "auto" /
        "brick" / "hq" / "lazy" (n_iters = 8, max_skips = 1: JAX
        api.py:793-801), else exact per-sample network evaluation
        (n_iters = 8, the JAX package's exact setting)."""
        from instantvnr_torch.models.network import render_params
        from instantvnr_torch.render.renderer import (Renderer,
                                                      make_neural_sample_fn)

        mc = self._scene_mc()
        tf = self._tf(nv.device)
        shading = _NEURAL_WAVEFRONT[mode]
        ctx = (self._build_streaming_ctx(mc)
               if self.streaming_cache != "none" else None)
        if ctx is not None:
            from instantvnr_torch.render.brickcache import brick_sample_fn

            # frames of at least 480,000 pixels: 3 bands of rays, each
            # through its own schedule, with a 16384 finisher (JAX
            # api.py:785-799)
            big = self.width * self.height >= 480_000
            return Renderer(
                self.width, self.height, mc, tf, brick_sample_fn,
                sample_ctx=ctx, settings=RaymarchSettings(
                    shading=shading, compact=True, n_iters=8, max_skips=1,
                    tiles=3 if big else 1,
                    finish_bucket=16384 if big else None,
                    sampling_rate=self.sampling_rate,
                    density_scale=self.density_scale),
                transform=nv.transform)
        return Renderer(
            self.width, self.height, mc, tf, make_neural_sample_fn(nv.field),
            sample_ctx=render_params(nv.params, nv.field),
            settings=RaymarchSettings(
                shading=shading, compact=True, n_iters=8,
                sampling_rate=self.sampling_rate,
                density_scale=self.density_scale),
            transform=nv.transform)

    def _pathtracer(self, mode: RenderMode, subject):
        """PATHTRACE_REFERENCE (the ground truth), _DECODED (the decoded
        grid; both wrapped in a brick pool when it fits) and _NEURAL (the
        network sampled inside the tracking loop, the reference's neural
        path tracing, method_pathtracing.cu:679-813)."""
        from instantvnr_torch.render.pathtrace import (PathTraceRenderer,
                                                       PathTraceSettings)

        mc = self._scene_mc()
        tf = self._tf(subject.device)
        # the compacted tracker, as the JAX package's facade runs it
        # (api.py:980-987)
        settings = PathTraceSettings(density_scale=self.density_scale,
                                     compact=True)
        if mode == RenderMode.PATHTRACE_NEURAL:
            from instantvnr_torch.models.network import render_params
            from instantvnr_torch.render.renderer import make_neural_sample_fn

            nv = self.neural
            return PathTraceRenderer(
                self.width, self.height, mc, tf,
                render_params(nv.params, nv.field),
                sample_fn=make_neural_sample_fn(nv.field),
                settings=settings, transform=self._transform())
        grid = (self.simple.volume.data
                if mode == RenderMode.PATHTRACE_REFERENCE
                else self.neural.decode_volume())
        return PathTraceRenderer(self.width, self.height, mc, tf, grid,
                                 settings=settings,
                                 transform=self._transform())

    def _build_streaming_ctx(self, mc):
        """The memory-gated brick pool of the sample-streaming modes (JAX
        api.py:1068-1136): "brick" the f32 pool on the decoded lattice; a
        budget of VNR_BRICK_MAX_MB (default 4096) gates the rest: "hq" the
        f16 pool on the exact lattice at ss = 2 when it fits, else at
        ss = 1; "auto" and "lazy" the f16 pool on the exact lattice while
        half the f32 pool's bytes fit, else None (exact per-sample network
        evaluation: the JAX package's documented policy, which
        `streaming_cache_info` reports as resolved "none")."""
        from instantvnr_torch.models.network import render_params
        from instantvnr_torch.render.brickcache import (LazyBrickCache,
                                                        brick_cache_bytes,
                                                        build_brick_cache)

        nv = self.neural
        args = (nv.field, render_params(nv.params, nv.field), mc)
        if self.streaming_cache == "brick":
            return build_brick_cache(*args)
        budget = float(os.environ.get("VNR_BRICK_MAX_MB", "4096")) * 2**20
        f16 = torch.float16
        if self.streaming_cache == "hq":
            ss = 2 if brick_cache_bytes(mc, dtype=f16,
                                        supersample=2) <= budget else 1
            if brick_cache_bytes(mc, dtype=f16, supersample=ss) <= budget:
                return build_brick_cache(*args, dtype=f16, supersample=ss,
                                         convention="exact")
        if brick_cache_bytes(mc) / 2 > budget:
            return None
        if self.streaming_cache == "lazy":
            self._lazy = LazyBrickCache(*args, dtype=f16, convention="exact")
            return self._lazy.ctx
        return build_brick_cache(*args, dtype=f16, convention="exact")

    @property
    def streaming_cache_info(self) -> dict:
        """The sample-streaming policy, what it resolved to and its quality
        class (JAX api.py:1138-1183)."""
        info = {"policy": self.streaming_cache, "resolved": "n/a",
                "quality": "n/a"}
        if self.mode not in _NEURAL_WAVEFRONT:
            return info
        ctx = self._brick_ctx()
        if self._lazy is not None:
            info["resolved"] = "lazy"
        elif ctx is not None:
            info["resolved"] = "brick"
        else:
            # "none" requested, or "auto" past the memory gate
            info["resolved"] = "none"
        info["quality"] = ("exact-network" if ctx is None
                           else "decoded-trilinear")
        if ctx is not None:
            from instantvnr_torch.render.brickcache import (ctx_convention,
                                                            ctx_supersample)

            info["pool_dtype"] = str(ctx["packed"].dtype).replace("torch.",
                                                                  "")
            info["supersample"] = ctx_supersample(ctx)
            info["lattice"] = ctx_convention(ctx)
            if info["lattice"] == "exact":
                info["quality"] = "exact-trilinear"
        return info

    def _brick_ctx(self):
        """The brick pool the neural wavefront samples, if it samples one."""
        ctx = getattr(self._impl, "sample_ctx", None)
        return ctx if isinstance(ctx, dict) and "packed" in ctx else None

    def _reference_shadow_volume(self, light):
        from instantvnr_torch.render.shadow import shadow_volume_for

        return shadow_volume_for(self.simple.volume.data, self.simple.tf,
                                 light, sampling_rate=self.sampling_rate)

    def set_camera(self, cam: Camera):
        self._camera = cam
        self._impl.set_camera(cam)
        # FULL_SHADOW: the light flips against the view (renderer.cpp:98-100)
        # and the shadow volume follows the flip; most camera moves do not
        # flip it, so the volume is recomputed only when the light changes
        if self.mode in (RenderMode.FULL_SHADOW_DECODED,
                         RenderMode.FULL_SHADOW_REFERENCE):
            light = self._flipped_light()
            if light != self._shadow_light_used:
                self._shadow_light_used = light
                if self.mode == RenderMode.FULL_SHADOW_DECODED:
                    self._impl.enable_shadows(
                        light, sampling_rate=self.sampling_rate)
                else:
                    self._impl.set_shadow_volume(
                        self._reference_shadow_volume(light))

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

    def set_clipping_box(self, lower, upper):
        """vnrVolumeSetClippingBox and a renderer refresh (api.cpp:322-338,
        :455); voxel coordinates in [0, dims]."""
        (self.neural or self.simple).set_clipping_box(lower, upper)
        self._impl.set_transform(self._transform())

    def set_scaling(self, scale):
        """vnrVolumeSetScaling and a renderer refresh (api.cpp:340-351)."""
        (self.neural or self.simple).set_scaling(scale)
        self._impl.set_transform(self._transform())

    def set_current_timestep(self, index: int):
        """vnrSimpleVolumeSetCurrentTimeStep and a renderer rebind
        (api.h:118): the timestep's data and macrocell go into the render
        path through set_mode, which rebuilds what JAX's set_mode rebuilds
        (the ground-truth renderers, the brick pool)."""
        if self.simple is None:
            raise ValueError("a time series needs a SimpleVolume")
        self.simple.set_current_timestep(index)
        self.set_mode(self.mode)

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

    def set_streaming_cache(self, policy: str):
        """The NEURAL_WAVEFRONT* modes' sample-streaming policy (the class
        docstring)."""
        if policy not in _STREAMING_CACHES:
            raise ValueError(f"streaming_cache={policy!r}: expected one of "
                             f"{_STREAMING_CACHES}")
        self.streaming_cache = policy
        if self.mode in _NEURAL_WAVEFRONT:
            self.set_mode(self.mode)

    def set_denoiser(self, enabled: bool):
        """vnrRendererSetDenoiser (batch_renderer.cpp:201): the à-trous
        filter at mapframe time (the renderer.cpp:117-121 hook)."""
        self.denoise = bool(enabled)

    def set_framebuffer_size(self, width: int, height: int):
        """vnrRendererSetFramebufferSize (batch_renderer.cpp:199): set_mode
        rebuilds the render path at the new size (the slab decoder carries
        its decode over; the wavefront's ray buffers and the path tracer's
        accumulation start anew)."""
        self.width, self.height = int(width), int(height)
        self.set_mode(self.mode)

    def set_transfer_function(self, tfn_cfg):
        """vnrRendererSetTransferFunction (batch_renderer.cpp:197): a
        config or a TransferFunctionObject. With a ground truth it goes to
        the SimpleVolume (rebaked, the macrocell's max opacity re-derived),
        else it is the renderer's own; set_mode then rebinds the render
        path (the cached slab decoder's TF and macrocell, the wavefront's
        and the path tracer's macrocell, which restarts its
        accumulation)."""
        cfg = _tf_config(tfn_cfg)
        if self.simple is not None:
            self.simple.set_transfer_function(cfg)
            self._tf_override = None
        else:
            self._tf_override = bake_transfer_function(
                cfg, device=self.neural.device)
        self.set_mode(self.mode)

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
        (the wavefront modes carry shading in the RenderMode, the
        reference's mode x shading matrix, api.h:36-60)."""
        self._require_decoded_slab("set_slab_shading")
        if shading not in ("none", "gradient"):
            raise ValueError(f"slab shading {shading!r}: expected 'none' or "
                             "'gradient'")
        self._impl.settings = dataclasses.replace(self._impl.settings,
                                                  shading=shading)

    def refresh_params(self, budget_bricks: int | None = None):
        """Rebind the render path to the neural volume's current parameters
        (the online-training hook): the decoded slab modes re-read them at
        render(); the exact neural wavefront and PATHTRACE_NEURAL take new
        inference params; a brick pool re-decodes (at most `budget_bricks`
        bricks a call, round-robin across calls, when given: the pool's
        refresh_brick_pool, or the lazy pool's refresh; None rebuilds it);
        PATHTRACE_DECODED and ISOSURFACE_DECODED decode their grid again."""
        if self.neural is None:
            return
        from instantvnr_torch.models.network import render_params
        from instantvnr_torch.render.renderer import make_neural_sample_fn

        nv = self.neural
        if self.mode in _NEURAL_WAVEFRONT:
            if self._lazy is not None:
                # full restale without a budget: the next render()'s ensure
                # re-decodes what the frame can see against the new params
                self._lazy.refresh(render_params(nv.params, nv.field),
                                   budget_bricks=budget_bricks)
                self._impl.set_sample_ctx(self._lazy.ctx)
                return
            ctx = self._brick_ctx()
            if ctx is None:
                self._impl.set_sample_ctx(render_params(nv.params, nv.field))
                return
            if budget_bricks is not None:
                from instantvnr_torch.render.brickcache import (
                    refresh_brick_pool)

                ctx, self._brick_cursor = refresh_brick_pool(
                    nv.field, render_params(nv.params, nv.field), ctx,
                    start=self._brick_cursor, n_bricks=budget_bricks)
                self._impl.set_sample_ctx(ctx)
                return
            self._brick_cursor = 0
            ctx = self._build_streaming_ctx(self._scene_mc())
            if ctx is not None:
                self._impl.set_sample_ctx(ctx)
            else:
                # the pool's budget gated it off (occupancy grew): exact
                # per-sample network evaluation
                self._impl.set_sample_fn(make_neural_sample_fn(nv.field),
                                         render_params(nv.params, nv.field))
        elif self.mode == RenderMode.PATHTRACE_NEURAL:
            self._impl.sample_ctx = render_params(nv.params, nv.field)
            self._impl.reset_accumulation()
        elif self.mode in (RenderMode.PATHTRACE_DECODED,
                           RenderMode.ISOSURFACE_DECODED):
            # PATHTRACE_DECODED's set_grid re-applies the grid → brick-pool
            # policy its sample fn was wired with
            self._impl.set_grid(nv.decode_volume())

    def reset_accumulation(self):
        """vnrRendererResetAccumulation: restart the progressive
        accumulation of the wavefront and the path tracer (the one-shot
        slab paths accumulate nothing)."""
        if hasattr(self._impl, "reset_accumulation"):
            self._impl.reset_accumulation()

    @property
    def last_stats(self) -> dict:
        """The last frame's counts ({"supersteps": n} of a wavefront frame,
        {"events": n} of a path-traced one); empty for the slab paths."""
        return getattr(self._impl, "last_stats", {})

    def _ensure_lazy(self):
        """Decode the lazy pool's bricks this frame can touch: the view's,
        and under SSH their light-swept superset (the shadow rays leave
        the frustum only along the light, render/brickcache.py)."""
        lazy = self._lazy
        if lazy.n_decoded == lazy.n_bricks:
            return
        scale = self._transform().scale.detach().cpu().numpy()
        cam = self.camera
        if self.mode == RenderMode.NEURAL_WAVEFRONT_SSH:
            # the frame light, flipped as render/renderer.py::_frame_rays
            light = np.asarray(self._impl.settings.light_dir, np.float64)
            view = (np.asarray(cam.center, np.float64)
                    - np.asarray(cam.eye, np.float64))
            if float(np.dot(view, light)) > 0:
                light = -light
            n = lazy.ensure_view_ssh(cam, self.width, self.height,
                                     light / scale, scale=scale)
        else:
            n = lazy.ensure_view(cam, self.width, self.height, scale=scale)
        if n:
            self._impl.set_sample_ctx(lazy.ctx)

    def render(self):
        """vnrRender (api.cpp:522). Rebinding the same params object every
        frame costs nothing: the decoder caches its inference params by
        identity. The neural wavefront and the path tracer keep their
        params until refresh_params(), as in the JAX package; a lazy brick
        pool first decodes what the frame can touch."""
        if self.mode in (RenderMode.DECODED_SLAB,
                         RenderMode.FULL_SHADOW_DECODED):
            self._impl.set_params(self.neural.params)
        if self._lazy is not None and self.mode in _NEURAL_WAVEFRONT:
            self._ensure_lazy()
        return self._impl.render()

    def mapframe(self) -> np.ndarray:
        """vnrRendererMapFrame: [H, W, 4] float32 on the host, denoised
        when the denoiser is on (JAX api.py:1320-1328)."""
        frame = self._impl.mapframe()
        if self.denoise:
            from instantvnr_torch.render.denoise import atrous_denoise

            dev = self._impl.device
            frame = atrous_denoise(torch.from_numpy(frame).to(dev)
                                   ).cpu().numpy()
        return frame


def free_temporary_memory():
    """vnrFreeTemporaryGPUMemory (api.h): return the caching allocator's
    unused blocks to the card (torch.cuda.empty_cache); nothing to free
    without CUDA."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def memory_query() -> dict:
    """vnrMemoryQuery (api.cpp:532-552): each device's memory statistics
    under the JAX package's keys (bytes_in_use, peak_bytes_in_use,
    bytes_limit); the CPU, which has no statistics, maps to {} as in the
    JAX package."""
    if not torch.cuda.is_available():
        return {"cpu": {}}
    stats = {}
    for i in range(torch.cuda.device_count()):
        m = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": m.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": m.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return stats
