"""The neural field: hash encoding + MLP, f: [0,1]³ → R (counterpart of
`instantvnr_tpu/models/network.py`).

Parameters keep the JAX package's layout, a plain dict

    {"table": [T, F] float32, "mlp": [W0, W1, ...]}   (Wi [fan_in, fan_out])

so both packages compare like for like and share BSON checkpoints.
`render_params` derives the inference params of one update (for big
schemas a bf16 table plus "packed", corner-packed dense-level tables).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from instantvnr_torch.config import ModelConfig
from instantvnr_torch.ops.hash_encoding import (
    HashGridSpec,
    hash_encode,
    hash_encode_packed,
    init_hash_table,
    packed_dense_tables,
)
from instantvnr_torch.ops.mlp import init_mlp_params, mlp_apply, mlp_n_params

Params = dict

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}

# render_params switches to the bf16 + packed layout at this many table
# parameters (instantvnr_tpu/models/network.py:171)
_BIG_SCHEMA_PARAMS = 1 << 22


@dataclass(frozen=True)
class NeuralField:
    """Static description of the model."""

    cfg: ModelConfig
    spec: HashGridSpec

    @classmethod
    def from_config(cls, cfg: ModelConfig) -> "NeuralField":
        return cls(cfg=cfg, spec=HashGridSpec.from_config(cfg.encoding))

    @property
    def n_output_dims(self) -> int:
        return 1

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.compute_dtype]

    @property
    def n_params(self) -> int:
        return self.spec.n_params + mlp_n_params(
            self.cfg.network, n_input=self.spec.n_output_dims, n_output=1)


def init_params(generator: torch.Generator, field: NeuralField,
                device="cuda") -> Params:
    """tcnn-style init: table uniform ±1e-4, He-normal MLP."""
    table = init_hash_table(generator, field.spec, device=device)
    mlp = init_mlp_params(generator, n_input=field.spec.n_output_dims,
                          cfg=field.cfg.network, n_output=field.n_output_dims,
                          device=device)
    return {"table": table, "mlp": mlp}


def params_from_numpy(params_np: dict, device="cuda") -> Params:
    """{"table": ndarray, "mlp": [ndarray, ...]} (e.g. the JAX package's
    params turned into numpy) → this package's params on `device`."""
    from instantvnr_torch.utils.device import resolve_device

    dev = resolve_device(device)

    def t(a):  # a copy: the caller's arrays may be read-only views
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return {"table": t(params_np["table"]),
            "mlp": [t(w) for w in params_np["mlp"]]}


def network_apply(params: Params, coords: torch.Tensor,
                  field: NeuralField) -> torch.Tensor:
    """coords [B,3] in [0,1]³ → values [B,1] float32; differentiable with
    respect to params that require grad.

    In bf16 compute the MLP runs through the fused MLP: its training form
    when a weight or the features require grad, its inference form
    otherwise (the kernels on CUDA tensors, their plain versions on CPU
    tensors). Other compute types run the plain MLP under autograd."""
    compute_dtype = field.compute_dtype
    if "packed" in params:
        feats = hash_encode_packed(params["table"], params["packed"], coords,
                                   field.spec, compute_dtype=compute_dtype)
    else:
        feats = hash_encode(params["table"], coords, field.spec,
                            compute_dtype=compute_dtype)
    if compute_dtype == torch.bfloat16:
        from instantvnr_torch.ops.fused_mlp import fused_mlp_apply

        return fused_mlp_apply(params["mlp"], feats, field.cfg.network)
    return mlp_apply(params["mlp"], feats, field.cfg.network,
                     compute_dtype=compute_dtype)


@torch.no_grad()
def render_params(params: Params, field: NeuralField) -> Params:
    """Inference params: fresh copies (never aliases of `params`). Big
    schemas (≥ 2^22 table parameters, the 2^19 reference schema) get a bf16
    table plus corner-packed dense levels; small ones keep the f32 table.
    Call once per parameter update, not per frame."""
    mlp = [w.detach().clone() for w in params["mlp"]]
    if field.spec.n_params < _BIG_SCHEMA_PARAMS:
        return {"table": params["table"].detach().clone(), "mlp": mlp}
    table = params["table"].detach().to(torch.bfloat16)
    if table.data_ptr() == params["table"].data_ptr():
        table = table.clone()  # already bf16: .to() aliased it
    out = {"table": table, "mlp": mlp}
    packed = packed_dense_tables(table, field.spec)
    if packed:
        out["packed"] = packed
    return out
