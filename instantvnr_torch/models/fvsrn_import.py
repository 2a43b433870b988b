"""fV-SRN checkpoint importer, inference only (counterpart of
`instantvnr_tpu/models/fvsrn_import.py`; the role of the reference's
`FvsrnNetwork` loader, `core/networks/fvsrn_network.cu:88-127`).

The reference loads a "volnet" binary from the fV-SRN toolchain; this reads
the artifact one step up that toolchain, the PyTorch checkpoint
(`torch.save` of a state dict) that fV-SRN training writes. Key names are
matched loosely (any prefix, common synonyms):

  grid / latent_grid / volume : [1, C, Z, Y, X] or [C, Z, Y, X], the latent
      feature volume (grid_sample layout), mapped to
      table[(z·ry + y)·rx + x, c], nodes spanning [0,1]³ inclusive;
  fourier_matrix / fourier / B / b_matrix : [M, 3] (or [3, M]), the
      frequency matrix; features [sin(2π·F·p), cos(2π·F·p)] of the raw
      [0,1] coords. Without it the field's log-linear bands are used;
  <prefix><i>.weight / .bias  : the nn.Linear stack ([out, in] weights),
      the prefix with the most layers. The first layer takes C + 2M inputs
      (latent, then Fourier).

Returns (FvsrnField, params) on the device asked for; params carry the
"fourier" and "bias" entries `FvsrnField.apply_params` reads.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from instantvnr_torch.config import NetworkConfig
from instantvnr_torch.models.fvsrn import FvsrnConfig, FvsrnField

_GRID_KEYS = ("latent_grid", "grid", "volume")
_FOURIER_KEYS = ("fourier_matrix", "fourier", "B", "b_matrix")


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _find_by_suffix(sd: dict, names: tuple[str, ...]):
    for name in names:
        for k, v in sd.items():
            if k.rsplit(".", 1)[-1] == name:
                return k, _to_numpy(v)
    return None, None


def _find_linears(sd: dict):
    """The nn.Linear (weight, bias) pairs of the longest Sequential-style
    stack, in index order."""
    pat = re.compile(r"^(.*?)(\d+)\.weight$")
    layers: dict = {}
    for k in sd:
        m = pat.match(k)
        if not m:
            continue
        prefix, idx = m.group(1), int(m.group(2))
        bias_key = f"{prefix}{idx}.bias"
        layers.setdefault(prefix, []).append(
            (idx, _to_numpy(sd[k]),
             _to_numpy(sd[bias_key]) if bias_key in sd else None))
    if not layers:
        raise ValueError("no nn.Linear 'N.weight' entries in the state dict "
                         f"(keys: {sorted(sd)[:8]}...)")
    seq = sorted(layers[max(layers, key=lambda p: len(layers[p]))],
                 key=lambda t: t[0])
    return [w for _, w, _ in seq], [b for _, _, b in seq]


def load_fvsrn_torch(path_or_state, activation: str = "SnakeAlt",
                     output_activation: str = "None", device="cuda"):
    """An fV-SRN torch checkpoint → (FvsrnField, params on `device`).

    path_or_state: the path of a torch.save file, or a loaded mapping (a
    state dict, or a checkpoint holding one under 'state_dict' or 'model'),
    or an nn.Module."""
    from instantvnr_torch.utils.device import resolve_device

    dev = resolve_device(device)
    sd = path_or_state
    if isinstance(sd, (str, bytes)):
        sd = torch.load(sd, map_location="cpu", weights_only=False)
    for container in ("state_dict", "model"):
        if isinstance(sd, dict) and isinstance(sd.get(container), dict):
            sd = sd[container]
    if hasattr(sd, "state_dict"):  # a whole nn.Module
        sd = sd.state_dict()

    _, grid = _find_by_suffix(sd, _GRID_KEYS)
    if grid is None:
        raise ValueError(f"no latent grid found (looked for {_GRID_KEYS})")
    if grid.ndim == 5:
        if grid.shape[0] != 1:
            raise ValueError(f"a batched latent grid {grid.shape}")
        grid = grid[0]
    if grid.ndim != 4:
        raise ValueError(f"the latent grid must be [C,Z,Y,X], got "
                         f"{grid.shape}")
    c, rz, ry, rx = grid.shape
    table = np.moveaxis(grid, 0, -1).reshape(rz * ry * rx, c)

    _, fmat = _find_by_suffix(sd, _FOURIER_KEYS)
    if fmat is not None:
        if fmat.shape[0] == 3 and fmat.shape[1] != 3:
            fmat = fmat.T
        if fmat.ndim != 2 or fmat.shape[1] != 3:
            raise ValueError(f"the Fourier matrix must be [M,3], got "
                             f"{fmat.shape}")

    ws, bs = _find_linears(sd)
    n_in = ws[0].shape[1]
    if fmat is not None:
        n_four = 2 * fmat.shape[0]
        if n_in != c + n_four:
            raise ValueError(
                f"the first linear takes {n_in} inputs but latent ({c}) + "
                f"Fourier ({n_four}) = {c + n_four}: a layout mismatch")
        bands = max(n_four // 6, 1)  # informational: the matrix overrides
    else:
        rem = n_in - c
        if rem < 0 or rem % 6:
            raise ValueError(
                f"no Fourier matrix, and the first linear's {n_in} inputs "
                f"less the latent's {c} = {rem} is not 6·bands")
        bands = rem // 6

    field = FvsrnField(cfg=FvsrnConfig(
        latent_res=(rx, ry, rz), latent_features=c, fourier_bands=bands,
        network=NetworkConfig(n_neurons=ws[0].shape[0],
                              n_hidden_layers=max(len(ws) - 1, 0),
                              activation=activation,
                              output_activation=output_activation)))

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    params = {"table": t(table), "mlp": [t(w.T) for w in ws]}  # [in, out]
    if fmat is not None:
        params["fourier"] = t(fmat)
    if any(b is not None for b in bs):
        params["bias"] = [t(b if b is not None else np.zeros(w.shape[0]))
                          for w, b in zip(ws, bs)]
    return field, params
