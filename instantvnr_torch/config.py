"""Typed configuration: the tcnn model schema, transfer-function and camera
configs, and the reference's compile-time constants.

Counterpart of `instantvnr_tpu/config.py`, with the scene half (raw-volume
descriptors, the vidi and diva scene dialects, time series). The JAX
package's TPU dispatch knobs (`mlp_impl`,
`grid_grad_impl`, `grid_fwd_impl`) have no counterpart: in this package the
device of a tensor decides between a CUDA kernel and its plain version.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from dataclasses import dataclass, field
from typing import Any

import numpy as np

MACROCELL_SIZE_MIP = 4  # cell = 2^4 = 16 voxels/side (reference CMakeLists.txt:61)
DEFAULT_TRAIN_BATCH = 1 << 16  # reference core/network.cu:183
NEARLY_ONE = 0.9999  # early-termination opacity (reference instantvnr_types.h:160)
DEFAULT_WAVEFRONT_ITERS = 16  # samples/ray/superstep (method_raymarching.cu:30-49)


def env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


def env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v else default


_COMMENT_RE = re.compile(r'("(?:[^"\\]|\\.)*")|(//[^\n]*)|(/\*.*?\*/)', re.S)


def loads_relaxed_json(text: str) -> Any:
    """json.loads with //-style and /* */ comments stripped (outside strings)."""

    def repl(m: re.Match) -> str:
        return m.group(1) if m.group(1) is not None else ""

    return json.loads(_COMMENT_RE.sub(repl, text))


@dataclass(frozen=True)
class EncodingConfig:
    """HashGrid encoding (reference example-model.json:19-25, tcnn semantics)."""

    otype: str = "HashGrid"
    n_levels: int = 8
    n_features_per_level: int = 8
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 2.0
    interpolation: str = "Linear"
    # "tcnn" (the reference's spatial hash) or "paired" (hashed levels
    # keyed by cell pairs, ops/hash_encoding.py; native .npz checkpoints)
    hash_variant: str = "tcnn"

    def __post_init__(self):
        if self.hash_variant not in ("tcnn", "paired"):
            raise ValueError(f"hash_variant={self.hash_variant!r}; "
                             "expected 'tcnn' or 'paired'")

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level


@dataclass(frozen=True)
class NetworkConfig:
    """Bias-free MLP (reference example-model.json:26-32): n_hidden_layers
    hidden layers of n_neurons, so n_hidden_layers+1 weight matrices."""

    otype: str = "FullyFusedMLP"
    activation: str = "ReLU"
    n_neurons: int = 64
    n_hidden_layers: int = 4
    output_activation: str = "None"


@dataclass(frozen=True)
class OptimizerConfig:
    """Adam in ExponentialDecay wrapper (reference example-model.json:2-15)."""

    otype: str = "ExponentialDecay"
    decay_start: int = 2000
    decay_interval: int = 1000
    decay_base: float = 0.99
    learning_rate: float = 5e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-15
    l2_reg: float = 1e-6


@dataclass(frozen=True)
class LossConfig:
    otype: str = "L1"


@dataclass(frozen=True)
class ModelConfig:
    encoding: EncodingConfig = field(default_factory=EncodingConfig)
    network: NetworkConfig = field(default_factory=NetworkConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    compute_dtype: str = "bfloat16"  # params stay float32; compute casts

    def to_json(self) -> dict:
        """Serialize back to the tcnn-compatible schema (for checkpoints)."""
        return {
            "optimizer": {
                "otype": self.optimizer.otype,
                "decay_start": self.optimizer.decay_start,
                "decay_interval": self.optimizer.decay_interval,
                "decay_base": self.optimizer.decay_base,
                "nested": {
                    "otype": "Adam",
                    "learning_rate": self.optimizer.learning_rate,
                    "beta1": self.optimizer.beta1,
                    "beta2": self.optimizer.beta2,
                    "epsilon": self.optimizer.epsilon,
                    "l2_reg": self.optimizer.l2_reg,
                },
            },
            "loss": {"otype": self.loss.otype},
            "encoding": {
                "otype": self.encoding.otype,
                "n_levels": self.encoding.n_levels,
                "n_features_per_level": self.encoding.n_features_per_level,
                "log2_hashmap_size": self.encoding.log2_hashmap_size,
                "base_resolution": self.encoding.base_resolution,
                "per_level_scale": self.encoding.per_level_scale,
                **({"hash_variant": self.encoding.hash_variant}
                   if self.encoding.hash_variant != "tcnn" else {}),
            },
            "network": {
                "otype": self.network.otype,
                "activation": self.network.activation,
                "n_neurons": self.network.n_neurons,
                "n_hidden_layers": self.network.n_hidden_layers,
                "output_activation": self.network.output_activation,
            },
        }


def model_config_from_dict(cfg: dict) -> ModelConfig:
    enc = cfg.get("encoding", {})
    net = cfg.get("network", {})
    opt = cfg.get("optimizer", {})
    loss = cfg.get("loss", {})
    nested = opt.get("nested", opt)
    return ModelConfig(
        encoding=EncodingConfig(
            otype=enc.get("otype", "HashGrid"),
            n_levels=int(enc.get("n_levels", 8)),
            n_features_per_level=int(enc.get("n_features_per_level", 8)),
            log2_hashmap_size=int(enc.get("log2_hashmap_size", 19)),
            base_resolution=int(enc.get("base_resolution", 16)),
            per_level_scale=float(enc.get("per_level_scale", 2.0)),
            interpolation=enc.get("interpolation", "Linear"),
            hash_variant=enc.get("hash_variant", "tcnn"),
        ),
        network=NetworkConfig(
            otype=net.get("otype", "FullyFusedMLP"),
            activation=net.get("activation", "ReLU"),
            n_neurons=int(net.get("n_neurons", 64)),
            n_hidden_layers=int(net.get("n_hidden_layers", 4)),
            output_activation=net.get("output_activation", "None"),
        ),
        optimizer=OptimizerConfig(
            otype=opt.get("otype", "ExponentialDecay"),
            decay_start=int(opt.get("decay_start", 2000)),
            decay_interval=int(opt.get("decay_interval", 1000)),
            decay_base=float(opt.get("decay_base", 0.99)),
            learning_rate=float(nested.get("learning_rate", 5e-3)),
            beta1=float(nested.get("beta1", 0.9)),
            beta2=float(nested.get("beta2", 0.999)),
            epsilon=float(nested.get("epsilon", 1e-15)),
            l2_reg=float(nested.get("l2_reg", 1e-6)),
        ),
        loss=LossConfig(otype=loss.get("otype", "L1")),
    )


def load_model_config(path_or_dict) -> ModelConfig:
    if isinstance(path_or_dict, dict):
        return model_config_from_dict(path_or_dict)
    with open(path_or_dict) as f:
        return model_config_from_dict(loads_relaxed_json(f.read()))


# dtype names of the reference scene schema (serializer.cpp:25-34)
VALUE_TYPES: dict[str, np.dtype] = {
    "BYTE": np.dtype(np.int8),
    "UNSIGNED_BYTE": np.dtype(np.uint8),
    "SHORT": np.dtype(np.int16),
    "UNSIGNED_SHORT": np.dtype(np.uint16),
    "INT": np.dtype(np.int32),
    "UNSIGNED_INT": np.dtype(np.uint32),
    "FLOAT": np.dtype(np.float32),
    "DOUBLE": np.dtype(np.float64),
}
VALUE_TYPE_NAMES = {v: k for k, v in VALUE_TYPES.items()}


@dataclass(frozen=True)
class VolumeDesc:
    """A raw-file volume descriptor (reference serializer.cpp:19-24,138-170)."""

    filename: str
    dims: tuple[int, int, int]  # (x, y, z)
    dtype: str = "FLOAT"  # key into VALUE_TYPES
    offset: int = 0
    bigendian: bool = False
    # normalization range in data units (the diva dialect's "range" key,
    # reference serializer.cpp:141-146). None: computed from the data
    # (in-core normalize_array; out-of-core a streaming scan, the
    # reference's StaticSampler fallback, neural_sampler.cpp:251-264)
    value_range: tuple[float, float] | None = None
    # time series: one file per timestep (reference MultiVolume::data,
    # instantvnr_types.h:40-56; diva 'filename' and vidi 'dataSource'
    # arrays, serializer.cpp:148-163, 330-344). Empty: one timestep at
    # `filename`.
    timestep_files: tuple = ()

    @property
    def n_timesteps(self) -> int:
        return max(1, len(self.timestep_files))

    def at_timestep(self, index: int) -> "VolumeDesc":
        """Descriptor of one timestep (vnrSimpleVolumeSetCurrentTimeStep)."""
        if not self.timestep_files:
            if index != 0:
                raise IndexError("single-timestep volume")
            return self
        return dataclasses.replace(
            self, filename=self.timestep_files[index], timestep_files=())

    @property
    def np_dtype(self) -> np.dtype:
        dt = VALUE_TYPES[self.dtype]
        return dt.newbyteorder(">") if self.bigendian else dt

    @property
    def n_voxels(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]

    @property
    def n_bytes(self) -> int:
        return self.n_voxels * self.np_dtype.itemsize


@dataclass(frozen=True)
class CameraConfig:
    """Look-at camera (reference serializer.cpp:178-187)."""

    eye: tuple[float, float, float] = (0.0, 0.0, -3.0)
    center: tuple[float, float, float] = (0.0, 0.0, 0.0)
    up: tuple[float, float, float] = (0.0, 1.0, 0.0)
    fovy: float = 60.0  # degrees


@dataclass(frozen=True)
class TransferFunctionConfig:
    """Piecewise-linear color + opacity control points over a value range
    (reference serializer.cpp:190-250 → tfn module)."""

    # (position in [0,1], r, g, b) control points
    colors: tuple = ((0.0, 0.0, 0.0, 1.0), (1.0, 1.0, 0.0, 0.0))
    # (position in [0,1], alpha) control points
    alphas: tuple = ((0.0, 0.0), (1.0, 1.0))
    range: tuple[float, float] = (0.0, 1.0)  # value range in DATA units


@dataclass(frozen=True)
class SceneConfig:
    volume: VolumeDesc
    camera: CameraConfig = field(default_factory=CameraConfig)
    tfn: TransferFunctionConfig = field(default_factory=TransferFunctionConfig)


def _pick_existing(filenames, base_dir: str) -> str:
    """'fileName' may be a list: the first that exists, else the first,
    each relative to the scene file (serializer.cpp:118-133)."""
    if isinstance(filenames, str):
        filenames = [filenames]
    for fn in filenames:
        cand = fn if os.path.isabs(fn) else os.path.join(base_dir, fn)
        if os.path.exists(cand):
            return cand
    fn = filenames[0]
    return fn if os.path.isabs(fn) else os.path.join(base_dir, fn)


def _vec3(d: Any) -> tuple[float, float, float]:
    if isinstance(d, dict):
        return (float(d["x"]), float(d["y"]), float(d["z"]))
    return (float(d[0]), float(d[1]), float(d[2]))


def _scene_from_vidi(root: dict, base_dir: str) -> SceneConfig:
    """The 'vidi' dialect: dataSource/view keys (serializer.cpp:253-300).
    A 'dataSource' array is a time series, each entry a timestep sharing
    the first entry's dims and type (serializer.cpp:330-344)."""
    ds = root["dataSource"]
    steps: tuple = ()
    if isinstance(ds, list):
        if len(ds) > 1:
            steps = tuple(_pick_existing(d["fileName"], base_dir) for d in ds)
        ds = ds[0]
    dims = _vec3(ds["dimensions"])
    vol = VolumeDesc(
        filename=_pick_existing(ds["fileName"], base_dir),
        dims=(int(dims[0]), int(dims[1]), int(dims[2])),
        dtype=ds["type"],
        offset=int(ds.get("offset", 0)),
        bigendian=(ds.get("endian", "LITTLE_ENDIAN") == "BIG_ENDIAN"),
        timestep_files=steps,
    )
    cam = CameraConfig()
    tfn = TransferFunctionConfig()
    view = root.get("view", {})
    if "camera" in view:
        jc = view["camera"]
        cam = CameraConfig(eye=_vec3(jc["eye"]), center=_vec3(jc["center"]),
                           up=_vec3(jc["up"]), fovy=float(jc.get("fovy", 60.0)))
    if "volume" in view and "transferFunction" in view["volume"]:
        tfn = _tfn_from_json(view["volume"]["transferFunction"],
                             view["volume"], vol)
    return SceneConfig(volume=vol, camera=cam, tfn=tfn)


def _tfn_from_json(jt: dict, jsvolume: dict,
                   vol: VolumeDesc) -> TransferFunctionConfig:
    """A tfn-module transfer function: opacity and color control points
    and the dtype-dependent range scaling (serializer.cpp:190-250)."""
    colors = []
    for c in jt.get("colorControls", jt.get("color", [])):
        if isinstance(c, dict):
            colors.append((float(c.get("position", c.get("p", 0.0))),
                           float(c.get("r", c.get("red", 0.0))),
                           float(c.get("g", c.get("green", 0.0))),
                           float(c.get("b", c.get("blue", 0.0)))))
    alphas = []
    for a in jt.get("opacityControls", jt.get("opacity", [])):
        if isinstance(a, dict):
            alphas.append((float(a.get("position", a.get("x", 0.0))),
                           float(a.get("value", a.get("y", 0.0)))))
        else:
            alphas.append((float(a[0]), float(a[1])))
    # endpoint alphas under 0.01 become exactly 0 (serializer.cpp:209-210)
    if alphas:
        if alphas[0][1] < 0.01:
            alphas[0] = (alphas[0][0], 0.0)
        if alphas[-1][1] < 0.01:
            alphas[-1] = (alphas[-1][0], 0.0)
    lo, hi = 0.0, 1.0
    if "scalarMappingRangeUnnormalized" in jsvolume:
        r = jsvolume["scalarMappingRangeUnnormalized"]
        lo, hi = float(r["minimum"]), float(r["maximum"])
    elif "scalarMappingRange" in jsvolume:
        r = jsvolume["scalarMappingRange"]
        rx, ry = float(r["minimum"]), float(r["maximum"])
        # dtype-dependent scaling (serializer.cpp:222-247)
        scale = {
            "UNSIGNED_BYTE": 255.0,
            "BYTE": 127.0,
            "UNSIGNED_SHORT": 65535.0,
            "SHORT": 32767.0,
            "UNSIGNED_INT": 4294967295.0,
            "INT": 2147483647.0,
        }.get(vol.dtype, 1.0)
        lo, hi = rx * scale, ry * scale
    return TransferFunctionConfig(
        colors=tuple(colors) or TransferFunctionConfig.colors,
        alphas=tuple(alphas) or TransferFunctionConfig.alphas,
        range=(lo, hi),
    )


def _scene_from_diva(root: dict, base_dir: str) -> SceneConfig:
    """The 'diva' dialect: a top-level 'volume' key
    (serializer.cpp:138-170). A 'filename' array is a time series."""
    config = root["volume"]
    dims = _vec3(config["dims"])
    fns = config["filename"]
    steps: tuple = ()
    if isinstance(fns, list) and len(fns) > 1:
        steps = tuple(fn if os.path.isabs(fn) else os.path.join(base_dir, fn)
                      for fn in fns)
    # the reference requires "range" here (serializer.cpp:141); without
    # it the range comes from the data
    vr = None
    if "range" in config:
        r = config["range"]
        rx, ry = ((r["x"], r["y"]) if isinstance(r, dict) else (r[0], r[1]))
        vr = (float(rx), float(ry))
    vol = VolumeDesc(
        filename=steps[0] if steps else _pick_existing(fns, base_dir),
        dims=(int(dims[0]), int(dims[1]), int(dims[2])),
        dtype=config["type"],
        offset=int(config.get("offset", 0)),
        bigendian=bool(config.get("bigendian", False)),
        timestep_files=steps,
        value_range=vr,
    )
    return SceneConfig(volume=vol)


def load_scene_config(path: str) -> SceneConfig:
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        root = loads_relaxed_json(f.read())
    if "dataSource" in root:
        return _scene_from_vidi(root, base_dir)
    if "volume" in root:
        return _scene_from_diva(root, base_dir)
    raise ValueError(f"unrecognized scene JSON dialect in {path}")


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)
