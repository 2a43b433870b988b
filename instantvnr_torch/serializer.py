"""Checkpoint (de)serialization in the reference's BSON container format
(counterpart of the tcnn-schema half of `instantvnr_tpu/serializer.py`).

Layout (`NeuralVolume::save_params_to_json`, core/network.cu:827-955):

  root["volume"]["dims"]{x,y,z}
  root["macrocell"]{groundtruth, dims, spacings, data: vec2f per cell}
                    — ranges stored with the reference's −1/+1 offset
  root["model"]     — the tcnn-schema model JSON
  root["parameters"]— flat n_params / params_binary / params_type keys plus
                    step/loss extras; params as one fp16 blob in tcnn order:
                    MLP matrices first ([out×in] row-major, the output layer
                    zero-padded to 16 rows), then the hash grid.

Keys are sorted at every level (nlohmann backs objects with std::map), so
files are byte-identical to those the JAX package and the reference write.

Native `.npz` checkpoints (`save_native`/`load_native`) hold the whole
training state in the JAX package's layout, so a file crosses between the
packages with its Adam moments, for either model family (an fV-SRN
document carries `"family": "fvsrn"`, as the JAX package writes it).
"""
from __future__ import annotations

import numpy as np
import torch

from instantvnr_torch.accel.macrocell import MACROCELL_SIZE, MacroCell
from instantvnr_torch.config import ModelConfig, load_model_config
from instantvnr_torch.models.network import NeuralField, params_from_numpy
from instantvnr_torch.utils import bson

_PAD_OUT = 16  # tcnn pads the MLP output layer to 16 rows


def _vec3(x, y, z, cast=float):
    return {"x": cast(x), "y": cast(y), "z": cast(z)}


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, np.float32)


def pack_params(field: NeuralField, params: dict) -> bytes:
    """Pack {table, mlp} into one fp16 blob, tcnn layout (network → grid)."""
    chunks = []
    for i, w in enumerate(params["mlp"]):
        m = _np(w).T  # [out, in] row-major like tcnn
        if i == len(params["mlp"]) - 1 and m.shape[0] < _PAD_OUT:
            m = np.concatenate(
                [m, np.zeros((_PAD_OUT - m.shape[0], m.shape[1]), np.float32)])
        chunks.append(m.astype(np.float16).ravel())
    chunks.append(_np(params["table"]).astype(np.float16).ravel())
    return np.concatenate(chunks).tobytes()


def unpack_params(field: NeuralField, blob: bytes) -> dict:
    """fp16 blob → {"table": ndarray, "mlp": [ndarray, ...]} (float32)."""
    data = np.frombuffer(blob, np.float16).astype(np.float32)
    cfg = field.cfg.network
    widths = ([field.spec.n_output_dims] + [cfg.n_neurons] * cfg.n_hidden_layers
              + [field.n_output_dims])
    mlp = []
    pos = 0
    for i, (fan_in, fan_out) in enumerate(zip(widths[:-1], widths[1:])):
        rows = fan_out
        if i == len(widths) - 2 and rows < _PAD_OUT:
            rows = _PAD_OUT
        m = data[pos:pos + rows * fan_in].reshape(rows, fan_in)
        pos += rows * fan_in
        mlp.append(np.ascontiguousarray(m[:fan_out].T))
    n_table = field.spec.n_params
    table = data[pos:pos + n_table].reshape(field.spec.n_entries,
                                            field.spec.n_features)
    pos += n_table
    if pos != data.size:
        raise ValueError(f"parameter blob size mismatch: {pos} != {data.size}")
    return {"table": table, "mlp": mlp}


def save_checkpoint(path: str, field: NeuralField, params: dict,
                    mc: MacroCell, volume_dims, groundtruth_mc: bool = False,
                    step: int = 0, loss: float = 0.0) -> None:
    mx, my, mz = mc.dims
    sx, sy, sz = mc.spacings
    # the reference's storage offset: (lo−1, hi+1), interleaved vec2f
    lo = _np(mc.value_lo) - 1.0
    hi = _np(mc.value_hi) + 1.0
    ranges = np.stack([lo.ravel(), hi.ravel()], axis=-1).astype("<f4")
    dx, dy, dz = (int(d) for d in volume_dims)
    blob = pack_params(field, params)
    root = {
        "volume": {"dims": _vec3(dx, dy, dz, int)},
        "macrocell": {
            "groundtruth": bool(groundtruth_mc),
            "dims": _vec3(mx, my, mz, int),
            "spacings": _vec3(sx, sy, sz, float),
            "data": bson.Binary(ranges.tobytes()),
        },
        "parameters": {
            "loss": float(loss),
            "n_params": len(blob) // 2,
            "params_binary": bson.Binary(blob),
            "params_type": "__half",
            "step": int(step),
        },
        "model": field.cfg.to_json(),
    }
    with open(path, "wb") as f:
        f.write(bson.encode(_sort_keys(root)))


def _sort_keys(v):
    """Recursively sort dict keys (nlohmann std::map ordering → to_bson)."""
    if isinstance(v, dict):
        return {k: _sort_keys(v[k]) for k in sorted(v)}
    if isinstance(v, (list, tuple)) and not isinstance(v, (bytes, bytearray)):
        return [_sort_keys(x) for x in v]
    return v


def load_checkpoint(path: str, device="cuda"):
    """Returns (field, params, mc, volume_dims, meta) with params and the
    macrocell on `device`."""
    with open(path, "rb") as f:
        root = bson.decode(f.read())
    return load_checkpoint_doc(root, device=device)


def load_checkpoint_doc(root: dict, device="cuda"):
    """load_checkpoint on an already-decoded document. Follows the
    reference loader's tolerance (network.cu:879-955): missing sections are
    skipped; the old format (parameters at root) is accepted."""
    from instantvnr_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model_cfg: ModelConfig = (load_model_config(root["model"])
                              if "model" in root else ModelConfig())
    field = NeuralField.from_config(model_cfg)

    volume_dims = None
    if "volume" in root:
        d = root["volume"]["dims"]
        volume_dims = (int(d["x"]), int(d["y"]), int(d["z"]))

    mc = None
    if "macrocell" in root and volume_dims is not None:
        m = root["macrocell"]
        mdims = (int(m["dims"]["x"]), int(m["dims"]["y"]), int(m["dims"]["z"]))
        expect = tuple(-(-d // MACROCELL_SIZE) for d in volume_dims)
        if mdims != expect:
            raise ValueError(
                f"checkpoint macrocell grid {mdims} does not match "
                f"{expect} (= ceil(dims/{MACROCELL_SIZE})); it was written "
                "with a different macrocell cell size")
        raw = np.frombuffer(bytes(m["data"]), "<f4").reshape(-1, 2)
        lo = raw[:, 0].reshape(mdims[2], mdims[1], mdims[0]) + 1.0
        hi = raw[:, 1].reshape(mdims[2], mdims[1], mdims[0]) - 1.0
        lo_t = torch.as_tensor(lo, device=dev)
        mc = MacroCell(value_lo=lo_t, value_hi=torch.as_tensor(hi, device=dev),
                       max_opacity=torch.zeros_like(lo_t),
                       volume_dims=volume_dims)

    psec = root.get("parameters", root)
    net = psec if "params_binary" in psec else psec["network"]
    blob = bytes(net["params_binary"])
    if net.get("params_type", "__half") != "__half":
        raise ValueError(f"unsupported params_type {net['params_type']!r}")
    if "n_params" in net and int(net["n_params"]) != len(blob) // 2:
        raise ValueError("n_params does not match params_binary size")
    params = params_from_numpy(unpack_params(field, blob), dev)
    meta = {"step": psec.get("step", 0), "loss": psec.get("loss", 0.0)}
    return field, params, mc, volume_dims, meta


# ---------------------------------------------------------------------------
# Native exact-resume checkpoints (.npz), the JAX package's layout
# ---------------------------------------------------------------------------

def native_leaves(state) -> list:
    """The leaves of a train state in the order jax.tree_util.tree_flatten
    gives for the JAX package's TrainState(params, opt=AdamState(step, mu,
    nu), key, loss): NamedTuple fields in order, dict keys sorted ("mlp"
    before "table"), list items in order. So:

        params.mlp[0..n-1], params.table,
        opt.step,
        opt.mu.mlp[0..n-1], opt.mu.table,
        opt.nu.mlp[0..n-1], opt.nu.table,
        key (uint32[2]), loss (float32 scalar)

    numpy arrays, each with the JAX leaf's dtype. mu and nu share their
    shapes, so a wrong order would load without an error:
    tests/test_torch_native_ckpt.py holds this one to jax.tree_util."""
    def tree(d):  # {"mlp": [...], "table": t} in sorted-key order
        return [_np(w) for w in d["mlp"]] + [_np(d["table"])]

    return (tree(state.params) + [np.asarray(state.opt.step, np.int32)]
            + tree(state.opt.mu) + tree(state.opt.nu)
            + [np.asarray(state.key, np.uint32).reshape(2),
               np.asarray(_np(state.loss), np.float32).reshape(())])


def save_native(path: str, field: NeuralField, state,
                volume_dims=None) -> None:
    """Write the whole TrainState (params, Adam moments, step, key, loss)
    and the model config, as the JAX package does (`leaf_i`, `model_json`,
    `volume_dims`), plus `torch_generator_state`, the port's sample stream,
    which the JAX package's loader does not read."""
    import json

    arrs = {f"leaf_{i}": v for i, v in enumerate(native_leaves(state))}
    arrs["model_json"] = np.frombuffer(
        json.dumps(field.cfg.to_json()).encode(), np.uint8)
    if volume_dims is not None:
        arrs["volume_dims"] = np.asarray(volume_dims, np.int32)
    arrs["torch_generator_state"] = state.generator.get_state().numpy()
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrs)


def load_native(path: str, device="cuda"):
    """→ (field, state, volume_dims) with the training state restored on
    `device` (volume_dims None for files without it). The sample stream
    resumes exactly from a file this package wrote on the same kind of
    device; from a JAX file (or another device's) the generator is seeded
    from the two key words instead, and the stream does not carry over."""
    import json

    from instantvnr_torch.config import model_config_from_dict
    from instantvnr_torch.models.optimizer import AdamState
    from instantvnr_torch.models.trainer import TrainState
    from instantvnr_torch.utils.device import resolve_device

    dev = resolve_device(device)
    data = np.load(path)
    doc = json.loads(bytes(data["model_json"]))
    if isinstance(doc, dict) and doc.get("family") == "fvsrn":
        from instantvnr_torch.models.fvsrn import FvsrnConfig, FvsrnField

        field = FvsrnField.from_config(FvsrnConfig.from_json(doc))
        n_in, table_shape = field.mlp_input_dims, (
            field.n_latent, field.cfg.latent_features)
    else:
        field = NeuralField.from_config(model_config_from_dict(doc))
        n_in, table_shape = field.spec.n_output_dims, (
            field.spec.n_entries, field.spec.n_features)
    net = field.cfg.network
    widths = ([n_in] + [net.n_neurons] * net.n_hidden_layers
              + [field.n_output_dims])
    tree_shapes = ([(a, b) for a, b in zip(widths[:-1], widths[1:])]
                   + [table_shape])
    shapes = tree_shapes + [()] + tree_shapes * 2 + [(2,), ()]
    leaves = []
    for i, shape in enumerate(shapes):
        arr = data[f"leaf_{i}"]
        if arr.shape != shape:
            raise ValueError(f"checkpoint leaf {i} shape {arr.shape} != "
                             f"model {shape}")
        leaves.append(arr)
    n = len(tree_shapes)

    def tree(ls):
        ts = [torch.tensor(np.asarray(a, np.float32), device=dev) for a in ls]
        return {"table": ts[-1], "mlp": ts[:-1]}

    params = tree(leaves[:n])
    opt = AdamState(step=int(leaves[n]), mu=tree(leaves[n + 1:2 * n + 1]),
                    nu=tree(leaves[2 * n + 1:3 * n + 1]))
    key = tuple(int(k) for k in np.asarray(leaves[-2], np.uint32))
    gen = torch.Generator(device=dev)
    stored = (data["torch_generator_state"]
              if "torch_generator_state" in data else None)
    if stored is not None and stored.size == gen.get_state().numel():
        gen.set_state(torch.from_numpy(np.array(stored, np.uint8)))
    else:
        gen.manual_seed((key[0] << 32) | key[1])
    state = TrainState(params=params, opt=opt, generator=gen,
                       loss=torch.tensor(float(leaves[-1]),
                                         dtype=torch.float32, device=dev),
                       key=key)
    dims = (tuple(int(d) for d in data["volume_dims"])
            if "volume_dims" in data else None)
    return field, state, dims
