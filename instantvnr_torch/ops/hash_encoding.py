"""Multi-resolution hash-grid encoding (counterpart of
`instantvnr_tpu/ops/hash_encoding.py`).

Semantics mirror tiny-cuda-nn's GridEncoding (reference
`core/networks/tcnn_impl_decoder.cu:7-133`):

- per-level scale:  scale_l = 2^(l·log2_s) · base_resolution − 1
- resolution:       res_l  = ceil(scale_l) + 1
- position:         x = p·scale + 0.5;  cell = floor(x);  w = x − cell
- level size:       next_multiple(min(res_l³, 2^log2_hashmap_size), 8)
- dense levels use stride indexing; once res³ overflows the table the index
  is the prime-XOR hash (x·1) ⊻ (y·2654435761) ⊻ (z·805459861) mod size
- 8-corner trilinear blend of F features per level, concatenated.

The hash multiplies must wrap as uint32. Torch has few uint32 ops, so the
products are taken in int64 (exact: a coordinate < 2^31 times a prime
< 2^32 stays below 2^63) and masked to 32 bits before the xor and the mod.

`hash_encode` is differentiable with respect to the table. For CUDA
tensors its forward is the kernel `hash_encode_forward` and its backward
`hash_encode_backward` (`csrc/hash_encode.cu`); CPU tensors take the plain
version, `hash_encode_reference`: a gather forward and an `index_add_`
backward. Both accumulate the table gradient in float32 whatever the
compute type. (The JAX package differentiates its gather with XLA, which
scatters into the gathered rows' type, bf16 once a table of ≥ 32 MB is
pre-cast: ROADMAP Queue 3.) The gradient with respect to the coordinates
is not ported. `hash_encode_packed`, the gather of corner-packed dense
levels, is plain PyTorch: only CPU decodes take it (`network_apply`); the
card's decode gathers through `hash_encode_forward`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from instantvnr_torch.config import EncodingConfig
from instantvnr_torch.ops import cuda_lib
from instantvnr_torch.utils.device import device_constant

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def _next_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class HashGridSpec:
    """Static description of the hash-grid layout."""

    n_levels: int
    n_features: int
    log2_hashmap_size: int
    base_resolution: int
    per_level_scale: float
    paired: bool = False

    @classmethod
    def from_config(cls, cfg: EncodingConfig) -> "HashGridSpec":
        return cls(
            n_levels=cfg.n_levels,
            n_features=cfg.n_features_per_level,
            log2_hashmap_size=cfg.log2_hashmap_size,
            base_resolution=cfg.base_resolution,
            per_level_scale=cfg.per_level_scale,
            paired=cfg.hash_variant == "paired",
        )

    @property
    def scales(self) -> tuple[float, ...]:
        log2s = math.log2(self.per_level_scale)
        return tuple(2.0 ** (l * log2s) * self.base_resolution - 1.0
                     for l in range(self.n_levels))

    @property
    def resolutions(self) -> tuple[int, ...]:
        return tuple(int(math.ceil(s)) + 1 for s in self.scales)

    @property
    def level_sizes(self) -> tuple[int, ...]:
        cap = 1 << self.log2_hashmap_size
        return tuple(_next_multiple(min(r * r * r, cap), 8)
                     for r in self.resolutions)

    @property
    def level_offsets(self) -> tuple[int, ...]:
        offs = [0]
        for s in self.level_sizes:
            offs.append(offs[-1] + s)
        return tuple(offs)

    @property
    def level_is_dense(self) -> tuple[bool, ...]:
        return tuple(r * r * r <= s
                     for r, s in zip(self.resolutions, self.level_sizes))

    @property
    def n_entries(self) -> int:
        return self.level_offsets[-1]

    @property
    def n_params(self) -> int:
        return self.n_entries * self.n_features

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features


# the 8 corner offsets of a cell, [8, 3], x fastest (tcnn_impl_decoder.cu:101-118)
_CORNER_TUPLES = tuple(((c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1)
                       for c in range(8))
_CORNERS = np.array(_CORNER_TUPLES, np.int64)

# pre-cast tables of at least this many f32 bytes to the 16-bit compute
# dtype before the gather (identical numerics, half the gathered bytes)
_PRECAST_MIN_BYTES = 1 << 25


def _check_tcnn(spec: HashGridSpec):
    if spec.paired:
        raise NotImplementedError(
            "hash_variant='paired' is not ported yet (ROADMAP 'Next "
            "slices' item 5, data and model breadth)")


def init_hash_table(generator: torch.Generator, spec: HashGridSpec,
                    device="cuda", dtype=torch.float32) -> torch.Tensor:
    """tcnn initializes hash grids uniform in [-1e-4, 1e-4]. Drawn on the
    generator's device, then moved."""
    t = torch.rand((spec.n_entries, spec.n_features), generator=generator,
                   dtype=torch.float32, device=generator.device)
    return (t * 2e-4 - 1e-4).to(device=device, dtype=dtype)


def _precast_for_gather(table: torch.Tensor, compute_dtype) -> torch.Tensor:
    if (compute_dtype.itemsize == 2 and table.dtype == torch.float32
            and table.numel() * 4 >= _PRECAST_MIN_BYTES):
        return table.to(compute_dtype)
    return table


def corner_indices_and_weights(spec: HashGridSpec, coords: torch.Tensor):
    """Flat table indices [B, L·8] (int64) and trilinear weights [B, L·8]
    (float32) of all levels for coords [B, 3] in [0,1]³."""
    _check_tcnn(spec)
    corners = device_constant(_CORNER_TUPLES, torch.int64, coords.device)
    coords = coords.to(torch.float32)
    idx_parts, w_parts = [], []
    for lvl in range(spec.n_levels):
        res = spec.resolutions[lvl]
        size = spec.level_sizes[lvl]
        # scale rounded to float32 first, like the reference's f32 math
        x = coords * float(np.float32(spec.scales[lvl])) + 0.5
        cell = torch.floor(x)
        frac = x - cell
        pos = cell.to(torch.int64)[:, None, :] + corners[None]  # [B,8,3]
        if spec.level_is_dense[lvl]:
            idx = pos[..., 0] + pos[..., 1] * res + pos[..., 2] * (res * res)
        else:
            idx = (((pos[..., 0] * _PRIMES[0]) & _U32)
                   ^ ((pos[..., 1] * _PRIMES[1]) & _U32)
                   ^ ((pos[..., 2] * _PRIMES[2]) & _U32))
        idx = (idx & _U32) % size + spec.level_offsets[lvl]
        cw = torch.where(corners[None] == 0, 1.0 - frac[:, None, :],
                         frac[:, None, :])
        w = cw[..., 0] * cw[..., 1] * cw[..., 2]  # [B,8]
        idx_parts.append(idx)
        w_parts.append(w)
    return torch.cat(idx_parts, dim=1), torch.cat(w_parts, dim=1)


def _gather_encode(table, coords, spec, compute_dtype, corners=None):
    """The plain forward: the gathered row times the weight is rounded to
    the compute type, then the 8 corners are summed (PyTorch accumulates a
    16-bit sum in float32 and rounds it once). `corners`: the coords'
    (indices, weights), if already computed."""
    b = coords.shape[0]
    indices, weights = corners or corner_indices_and_weights(spec, coords)
    feats = _precast_for_gather(table, compute_dtype)[indices]
    feats = feats.to(compute_dtype) * weights.to(compute_dtype)[..., None]
    feats = feats.reshape(b, spec.n_levels, 8, spec.n_features).sum(dim=2)
    return feats.reshape(b, spec.n_levels * spec.n_features)


def _plain_backward(n_entries, coords, spec, g, compute_dtype, corners=None):
    """The plain backward: each corner's weight times the cotangent row,
    rounded to the compute type (the transpose of the forward's product),
    index_add_-ed into a float32 table → [T, F] float32."""
    b, nf = coords.shape[0], spec.n_features
    indices, weights = corners or corner_indices_and_weights(spec, coords)
    gc = g.to(compute_dtype).reshape(b, spec.n_levels, 1, nf)
    wc = weights.to(compute_dtype).reshape(b, spec.n_levels, 8, 1)
    contrib = (gc * wc).to(torch.float32).reshape(-1, nf)
    grad = torch.zeros((n_entries, nf), dtype=torch.float32, device=g.device)
    return grad.index_add_(0, indices.reshape(-1), contrib)


counter = cuda_lib.LaunchCounter()  # hash_encode_forward
backward_counter = cuda_lib.LaunchCounter()  # hash_encode_backward

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_FEATURES = (1, 2, 4, 8)
_MAX_LEVELS = 32


def _level_arrays(spec: HashGridSpec):
    """Host arrays the kernels read: scales [L] float32 and (res, size,
    offset, dense) [L, 4] int32."""
    scales = np.asarray(spec.scales, np.float32)
    levels = np.array([[r, s, o, int(d)] for r, s, o, d in zip(
        spec.resolutions, spec.level_sizes, spec.level_offsets,
        spec.level_is_dense)], np.int32)
    return scales, levels


def _kernel_args(table_or_none, coords, spec, compute_dtype):
    """Validate what the kernels take; → (coords, scales, levels)."""
    _check_tcnn(spec)
    if (compute_dtype not in _KERNEL_DTYPES
            or spec.n_features not in _KERNEL_FEATURES
            or spec.n_levels > _MAX_LEVELS or coords.dtype != torch.float32
            or (table_or_none is not None
                and (table_or_none.dtype not in _KERNEL_DTYPES
                     or table_or_none.device != coords.device))):
        raise ValueError(
            f"hash-grid kernels take f32/bf16 tables and compute types, "
            f"F in {_KERNEL_FEATURES}, at most {_MAX_LEVELS} levels and f32 "
            f"coords on one device (got table "
            f"{getattr(table_or_none, 'dtype', None)}, compute "
            f"{compute_dtype}, F {spec.n_features}, coords {coords.dtype})")
    return (coords.contiguous(), *_level_arrays(spec))


def _kernel_forward(table, coords, spec, compute_dtype):
    coords, scales, levels = _kernel_args(table, coords, spec, compute_dtype)
    table = table.contiguous()
    if table.data_ptr() % 16:  # the kernel's vector loads need alignment
        table = table.clone()
    b = coords.shape[0]
    out = torch.empty((b, spec.n_output_dims), dtype=compute_dtype,
                      device=coords.device)
    cuda_lib.load_library().call(
        "hash_encode_forward", table.data_ptr(), coords.data_ptr(),
        out.data_ptr(), b, spec.n_levels, spec.n_features, scales.ctypes.data,
        levels.ctypes.data, int(table.dtype == torch.bfloat16),
        int(compute_dtype == torch.bfloat16),
        torch.cuda.current_stream(coords.device).cuda_stream)
    counter.launches += 1
    return out


def _kernel_backward(n_entries, coords, spec, g, compute_dtype):
    coords, scales, levels = _kernel_args(None, coords, spec, compute_dtype)
    g = g.to(compute_dtype).contiguous()
    if g.data_ptr() % 16:  # the kernel's vector loads need alignment
        g = g.clone()
    grad = torch.zeros((n_entries, spec.n_features), dtype=torch.float32,
                       device=coords.device)
    cuda_lib.load_library().call(
        "hash_encode_backward", coords.data_ptr(), g.data_ptr(),
        grad.data_ptr(), coords.shape[0], spec.n_levels, spec.n_features,
        scales.ctypes.data, levels.ctypes.data,
        int(compute_dtype == torch.bfloat16),
        torch.cuda.current_stream(coords.device).cuda_stream)
    backward_counter.launches += 1
    return grad


class _Encode(torch.autograd.Function):
    """hash_encode, differentiable with respect to the table."""

    @staticmethod
    def forward(ctx, table, coords, spec, compute_dtype, kernel):
        ctx.meta = (table.shape[0], table.dtype, spec, compute_dtype, kernel)
        if kernel:
            ctx.save_for_backward(coords)
            return _kernel_forward(table, coords, spec, compute_dtype)
        # the plain backward reuses the forward's corners
        corners = corner_indices_and_weights(spec, coords)
        ctx.save_for_backward(coords, *corners)
        return _gather_encode(table, coords, spec, compute_dtype, corners)

    @staticmethod
    def backward(ctx, g):
        coords, *corners = ctx.saved_tensors
        n_entries, dtype, spec, compute_dtype, kernel = ctx.meta
        if kernel:
            grad = _kernel_backward(n_entries, coords, spec, g, compute_dtype)
        else:
            grad = _plain_backward(n_entries, coords, spec, g, compute_dtype,
                                   tuple(corners))
        return grad.to(dtype), None, None, None, None


def _needs_table_grad(table, coords) -> bool:
    if not torch.is_grad_enabled():
        return False
    if coords.requires_grad:
        raise NotImplementedError(
            "hash_encode: the gradient with respect to the coordinates is "
            "not ported")
    return table.requires_grad


def hash_encode_reference(table: torch.Tensor, coords: torch.Tensor,
                          spec: HashGridSpec,
                          compute_dtype=torch.float32) -> torch.Tensor:
    """Plain version of `hash_encode`, on any device."""
    if _needs_table_grad(table, coords):
        return _Encode.apply(table, coords, spec, compute_dtype, False)
    return _gather_encode(table, coords, spec, compute_dtype)


def hash_encode(table: torch.Tensor, coords: torch.Tensor, spec: HashGridSpec,
                compute_dtype=torch.float32) -> torch.Tensor:
    """Encode [B,3] coords → [B, L·F] features in `compute_dtype`: each
    gathered row times its weight is rounded to the compute type, then the
    8 corners are summed. Differentiable with respect to `table`."""
    if coords.device.type == "cpu":
        return hash_encode_reference(table, coords, spec, compute_dtype)
    if coords.device.type != "cuda":
        raise ValueError(f"unsupported device {coords.device}")
    if _needs_table_grad(table, coords):
        return _Encode.apply(table, coords, spec, compute_dtype, True)
    return _kernel_forward(table, coords, spec, compute_dtype)


def packed_dense_tables(table: torch.Tensor, spec: HashGridSpec) -> dict:
    """[size, 8F] corner-packed companion tables of the dense levels, keyed
    by str(level): row i holds the 8 corner rows of the cell whose min
    corner is entry i. torch.roll reproduces tcnn's `% size` wrap of the +1
    corners exactly."""
    _check_tcnn(spec)
    packed = {}
    for l in range(spec.n_levels):
        if not spec.level_is_dense[l]:
            continue
        res, size = spec.resolutions[l], spec.level_sizes[l]
        off = spec.level_offsets[l]
        sub = table[off:off + size]
        offs = [int(c[0] + c[1] * res + c[2] * res * res) for c in _CORNERS]
        packed[str(l)] = torch.cat([torch.roll(sub, -o, dims=0) for o in offs],
                                   dim=1)
    return packed


def hash_encode_packed(table: torch.Tensor, packed: dict,
                       coords: torch.Tensor, spec: HashGridSpec,
                       compute_dtype=torch.float32) -> torch.Tensor:
    """`hash_encode` with corner-packed dense levels: one [size, 8F]-row
    gather per packed level, one gather of all hashed levels' corners.
    Equal to `hash_encode` up to summation order."""
    b = coords.shape[0]
    nf = spec.n_features
    indices, weights = corner_indices_and_weights(spec, coords)
    iw = indices.reshape(b, spec.n_levels, 8)
    ww = weights.reshape(b, spec.n_levels, 8).to(compute_dtype)
    feats = [None] * spec.n_levels
    hashed = [l for l in range(spec.n_levels) if str(l) not in packed]
    for l in range(spec.n_levels):
        if str(l) in packed:
            # corner 0 is the min corner: x,y,z ≤ R−1 ⇒ index < R³ ≤ size,
            # so the base needs no wrap; the rolls carry the corner wraps
            base = iw[:, l, 0] - spec.level_offsets[l]
            f = packed[str(l)][base].reshape(b, 8, nf).to(compute_dtype)
            feats[l] = (f * ww[:, l, :, None]).sum(dim=1)
    if hashed:
        hsel = torch.as_tensor(hashed, device=coords.device)
        hi = iw[:, hsel, :].reshape(b, -1)
        hw = ww[:, hsel, :].reshape(b, -1)
        f = table[hi].to(compute_dtype) * hw[..., None]
        f = f.reshape(b, len(hashed), 8, nf).sum(dim=2)
        for j, l in enumerate(hashed):
            feats[l] = f[:, j]
    return torch.cat(feats, dim=1)
