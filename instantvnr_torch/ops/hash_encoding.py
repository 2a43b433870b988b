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

`hash_encode` is differentiable with respect to the table and to the
coordinates, each gradient computed only when it is asked for. For CUDA
tensors its forward is the kernel `hash_encode_forward`, the table's
gradient `hash_encode_backward` and the coordinates'
`hash_encode_coords_backward` (`csrc/hash_encode.cu`); CPU tensors take
the plain versions, `hash_encode_reference`: a gather forward, an
`index_add_` backward and `_plain_coords_backward`. The table gradient
accumulates in float32 whatever the compute type. (The JAX package
differentiates its gather with XLA, which scatters into the gathered rows'
type, bf16 once a table of ≥ 32 MB is pre-cast: ROADMAP Queue 3.) The
coordinates' gradient is what a frame differentiated in its rays needs
(RaymarchSettings.fixed_steps with origins or directions that require
grad, as in camera or pose refinement): JAX's `hash_encode` is
differentiable in its coords (tests/test_ops.py:347). Per sample it is
grad_p[a] = Σ_l scale_l · Σ_c ∂w_c/∂f_a · ⟨g_l, T[idx_c]⟩, from tcnn's
x = p·scale + 0.5, cell = floor(x) (no gradient), f = x − cell and
w_c = Π_a (1 − f_a or f_a). `hash_encode_packed`, the gather of
corner-packed dense levels, is plain PyTorch: only CPU decodes take it
(`network_apply`); the card's decode gathers through
`hash_encode_forward`.

`HashGridSpec.paired` (EncodingConfig.hash_variant="paired") selects the
JAX package's paired layout of the hashed levels (the section below);
every form here, the kernels' too, takes it.
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
        raise ValueError("tcnn corner addressing is invalid for a paired "
                         "spec: use paired_corner_indices_and_weights")


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


# -- the paired layout ------------------------------------------------------
#
# EncodingConfig.hash_variant="paired" (the JAX package's
# ops/hash_encoding.py:350-530): a hashed level's [S, F] entries are viewed
# as [S/2, 2F] pair-rows. The row of a cell's two corners along the level's
# pairing axis a = level mod 3 (x, y, z, x, ...) at the other two axes'
# corner (p1, p2) is
#
#     row = (cell_a·1 ⊻ p1·2654435761 ⊻ p2·805459861) mod (S/2)
#
# (the hash of the CELL's coordinate along a), its two corners in the row's
# two F-wide halves: entry offset + 2·row + half, weight w12·(1 − f_a) or
# w12·f_a. Dense levels keep tcnn's stride addressing. The same parameter
# count; not tcnn-BSON-interoperable, so native .npz checkpoints carry it.

# the (p1, p2) corner offsets of a pair-row, [4, 2]
_PAIR_CORNERS = ((0, 0), (1, 0), (0, 1), (1, 1))


def _cell_frac(coords: torch.Tensor, scale: float):
    """(cell [B, 3] int64, frac [B, 3] float32) at a level of the float32
    scale: tcnn's x = p·scale + 0.5, cell = floor(x), frac = x − cell."""
    x = coords.to(torch.float32) * scale + 0.5
    cell = torch.floor(x)
    return cell.to(torch.int64), x - cell


def _level_cell_frac(spec: HashGridSpec, lvl: int, coords: torch.Tensor):
    return _cell_frac(coords, float(np.float32(spec.scales[lvl])))


def _dense_level_corners(spec: HashGridSpec, lvl: int, coords: torch.Tensor):
    """One dense level's LOCAL entry indices [B, 8] (tcnn stride
    addressing, the same in both variants) and trilinear weights [B, 8]."""
    res, size = spec.resolutions[lvl], spec.level_sizes[lvl]
    corners = device_constant(_CORNER_TUPLES, torch.int64, coords.device)
    cell, frac = _level_cell_frac(spec, lvl, coords)
    pos = cell[:, None, :] + corners[None]
    idx = pos[..., 0] + pos[..., 1] * res + pos[..., 2] * (res * res)
    idx = (idx & _U32) % size
    cw = torch.where(corners[None] == 0, 1.0 - frac[:, None, :],
                     frac[:, None, :])
    return idx, cw[..., 0] * cw[..., 1] * cw[..., 2]


def _paired_level_rows(spec: HashGridSpec, lvl: int, coords: torch.Tensor):
    """One hashed level's LOCAL pair-rows [B, 4] (into its [S/2, 2F] view)
    and the weights of each row's two halves [B, 4, 2]. The pairing axis
    alternates x, y, z by level, so a difference between a point's two
    copies shows only across that axis's cell faces."""
    size = spec.level_sizes[lvl]
    if size % 2:
        raise ValueError(f"paired level {lvl} has an odd size {size}")
    a = lvl % 3
    o1, o2 = (a + 1) % 3, (a + 2) % 3
    yz = device_constant(_PAIR_CORNERS, torch.int64, coords.device)
    cell, frac = _level_cell_frac(spec, lvl, coords)
    p1 = cell[:, o1:o1 + 1] + yz[None, :, 0]
    p2 = cell[:, o2:o2 + 1] + yz[None, :, 1]
    h = (((cell[:, a:a + 1] * _PRIMES[0]) & _U32)
         ^ ((p1 * _PRIMES[1]) & _U32) ^ ((p2 * _PRIMES[2]) & _U32))
    rows = (h & _U32) % (size // 2)
    fa, f1, f2 = frac[:, a:a + 1], frac[:, o1:o1 + 1], frac[:, o2:o2 + 1]
    w12 = (torch.where(yz[None, :, 0] == 0, 1.0 - f1, f1)
           * torch.where(yz[None, :, 1] == 0, 1.0 - f2, f2))  # [B, 4]
    return rows, torch.stack([w12 * (1.0 - fa), w12 * fa], dim=-1)


def paired_rows_and_weights(spec: HashGridSpec, coords: torch.Tensor,
                            levels=None):
    """Pair-row addressing over the [T/2, 2F] view of the table: dense
    levels give their 8 corner entries as rows entry >> 1 with the weight on
    half entry & 1, hashed levels 4 pair-rows with both halves weighted.
    → (rows [B, R] int64 global pair-rows, w2 [B, R, 2] float32, counts:
    the rows of each level)."""
    rows_parts, w_parts, counts = [], [], []
    for lvl in (range(spec.n_levels) if levels is None else levels):
        offset = spec.level_offsets[lvl]
        if spec.level_is_dense[lvl]:
            idx, w = _dense_level_corners(spec, lvl, coords)
            e = idx + offset
            rows_parts.append(e >> 1)
            half = (e & 1).to(torch.float32)
            w_parts.append(torch.stack([w * (1.0 - half), w * half], dim=-1))
            counts.append(8)
        else:
            rows, w2 = _paired_level_rows(spec, lvl, coords)
            rows_parts.append(rows + (offset >> 1))
            w_parts.append(w2)
            counts.append(4)
    return (torch.cat(rows_parts, dim=1), torch.cat(w_parts, dim=1),
            tuple(counts))


def paired_corner_indices_and_weights(spec: HashGridSpec,
                                      coords: torch.Tensor):
    """The paired layout per corner: flat entry indices [B, L·8] (int64)
    and weights [B, L·8]. A hashed level's corner (pair-row j, half) is
    entry offset + 2·row_j + half at position 2j + half; dense levels are
    tcnn's stride entries."""
    b = coords.shape[0]
    idx_parts, w_parts = [], []
    for lvl in range(spec.n_levels):
        offset = spec.level_offsets[lvl]
        if spec.level_is_dense[lvl]:
            idx, w = _dense_level_corners(spec, lvl, coords)
            idx_parts.append(idx + offset)
            w_parts.append(w)
        else:
            rows, w2 = _paired_level_rows(spec, lvl, coords)
            e = offset + 2 * rows
            idx_parts.append(torch.stack([e, e + 1], dim=-1).reshape(b, 8))
            w_parts.append(w2.reshape(b, 8))
    return torch.cat(idx_parts, dim=1), torch.cat(w_parts, dim=1)


def _corners(spec: HashGridSpec, coords: torch.Tensor):
    """The spec's per-corner (indices, weights), in either layout."""
    if spec.paired:
        return paired_corner_indices_and_weights(spec, coords)
    return corner_indices_and_weights(spec, coords)


def hash_encode_paired(table: torch.Tensor, coords: torch.Tensor,
                       spec: HashGridSpec,
                       compute_dtype=torch.float32) -> torch.Tensor:
    """Plain paired-layout forward: one [B, L·8] gather of F-wide rows,
    the products rounded to the compute type and summed as `hash_encode`
    sums (`_gather_encode`)."""
    return _gather_encode(table, coords, spec, compute_dtype,
                          paired_corner_indices_and_weights(spec, coords))


def hash_encode_paired_wide(table: torch.Tensor, coords: torch.Tensor,
                            spec: HashGridSpec,
                            compute_dtype=torch.float32) -> torch.Tensor:
    """The same function from one gather of 2F-wide pair-rows
    (`paired_rows_and_weights`): the semantic cross-check of the narrow
    form, equal to it up to the order of the sums."""
    b, nf = coords.shape[0], spec.n_features
    rows, w2, counts = paired_rows_and_weights(spec, coords)
    g = table.reshape(-1, 2 * nf)[rows].to(compute_dtype)  # [B, R, 2F]
    g = g.reshape(b, -1, 2, nf) * w2.to(compute_dtype)[..., None]
    per_row = g.sum(dim=2)  # [B, R, F]
    feats, start = [], 0
    for c in counts:
        feats.append(per_row[:, start:start + c].sum(dim=1))
        start += c
    return torch.cat(feats, dim=1)


def _gather_encode(table, coords, spec, compute_dtype, corners=None):
    """The plain forward: the gathered row times the weight is rounded to
    the compute type, then the 8 corners are summed (PyTorch accumulates a
    16-bit sum in float32 and rounds it once). `corners`: the coords'
    (indices, weights), if already computed."""
    b = coords.shape[0]
    indices, weights = corners or _corners(spec, coords)
    feats = _precast_for_gather(table, compute_dtype)[indices]
    feats = feats.to(compute_dtype) * weights.to(compute_dtype)[..., None]
    feats = feats.reshape(b, spec.n_levels, 8, spec.n_features).sum(dim=2)
    return feats.reshape(b, spec.n_levels * spec.n_features)


def _plain_backward(n_entries, coords, spec, g, compute_dtype, corners=None):
    """The plain backward: each corner's weight times the cotangent row,
    rounded to the compute type (the transpose of the forward's product),
    index_add_-ed into a float32 table → [T, F] float32."""
    b, nf = coords.shape[0], spec.n_features
    indices, weights = corners or _corners(spec, coords)
    gc = g.to(compute_dtype).reshape(b, spec.n_levels, 1, nf)
    wc = weights.to(compute_dtype).reshape(b, spec.n_levels, 8, 1)
    contrib = (gc * wc).to(torch.float32).reshape(-1, nf)
    grad = torch.zeros((n_entries, nf), dtype=torch.float32, device=g.device)
    return grad.index_add_(0, indices.reshape(-1), contrib)


def _corner_sides(spec: HashGridSpec, lvl: int) -> tuple:
    """The side (0 lower, 1 upper) of each of a level's 8 corners along x,
    y and z, in the layout's corner order: tcnn's (x fastest), or on a
    paired spec's hashed level corner 2·j + half, its half along the
    pairing axis a = lvl mod 3 and pair-row j's two bits along the axes
    after it (`_PAIR_CORNERS`)."""
    if not spec.paired or spec.level_is_dense[lvl]:
        return _CORNER_TUPLES
    a = lvl % 3
    sides = []
    for c in range(8):
        side = [0, 0, 0]
        side[a], side[(a + 1) % 3], side[(a + 2) % 3] = (c & 1,
                                                         (c >> 1) & 1, c >> 2)
        sides.append(tuple(side))
    return tuple(sides)


def _level_coords_grad(rows, g_l, frac, sides, scale: float):
    """One level's term of the coordinates' gradient [B, 3] float32: rows
    [B, 8, F] and the cotangent g_l [B, F] as float32 values of the compute
    type, frac [B, 3], sides [8, 3] bool. Each corner's ⟨g_l, row⟩ times
    ∂w_c/∂f_a = ±Π_{b≠a} w_c,b (+ on the upper side), summed over the
    corners, times ∂f/∂p = scale."""
    dw = (rows * g_l[:, None, :]).sum(dim=2)  # [B, 8]
    cw = torch.where(sides[None], frac[:, None, :], 1.0 - frac[:, None, :])
    dwdf = torch.stack([cw[..., 1] * cw[..., 2], cw[..., 0] * cw[..., 2],
                        cw[..., 0] * cw[..., 1]], dim=-1)  # [B, 8, 3]
    dwdf = torch.where(sides[None], dwdf, -dwdf)
    return (dw[..., None] * dwdf).sum(dim=1) * scale


def _plain_coords_backward(table, coords, spec, g, compute_dtype,
                           corners=None):
    """The plain backward of the coordinates → [B, 3] float32: per level
    `_level_coords_grad` over the corners' table rows, the levels summed
    in order. The rows and the cotangent are rounded to the compute type
    (the forward's operands), and everything after that is float32: the
    dot of each row with its cotangent row, the weights' derivatives and
    the sums. (JAX's autodiff under bf16 compute rounds each product of
    the dot, and its sum, to bf16 as well.) `corners`: the coords'
    (indices, weights), if already computed."""
    b, nl, nf = coords.shape[0], spec.n_levels, spec.n_features
    indices = (corners or _corners(spec, coords))[0].reshape(b, nl, 8)
    gc = g.to(compute_dtype).to(torch.float32).reshape(b, nl, nf)
    grad = torch.zeros((b, 3), dtype=torch.float32, device=coords.device)
    for lvl in range(nl):
        rows = table[indices[:, lvl]].to(compute_dtype).to(torch.float32)
        _, frac = _level_cell_frac(spec, lvl, coords)
        sides = device_constant(_corner_sides(spec, lvl), torch.bool,
                                coords.device)
        grad += _level_coords_grad(rows, gc[:, lvl], frac, sides,
                                   float(np.float32(spec.scales[lvl])))
    return grad


counter = cuda_lib.LaunchCounter()  # hash_encode_forward, tcnn layout
backward_counter = cuda_lib.LaunchCounter()  # hash_encode_backward, tcnn
paired_counter = cuda_lib.LaunchCounter()  # hash_encode_forward, paired
paired_backward_counter = cuda_lib.LaunchCounter()  # backward, paired
# hash_encode_coords_backward, either layout (the traced forms too)
coords_counter = cuda_lib.LaunchCounter()

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
    return (_checked_coords(table_or_none, coords, spec.n_levels,
                            spec.n_features, compute_dtype),
            *_level_arrays(spec))


def _checked_coords(table_or_none, coords, n_levels, n_features,
                    compute_dtype):
    """Validate what the kernels take; → contiguous coords."""
    if (compute_dtype not in _KERNEL_DTYPES
            or n_features not in _KERNEL_FEATURES
            or n_levels > _MAX_LEVELS or coords.dtype != torch.float32
            or (table_or_none is not None
                and (table_or_none.dtype not in _KERNEL_DTYPES
                     or table_or_none.device != coords.device))):
        raise ValueError(
            f"hash-grid kernels take f32/bf16 tables and compute types, "
            f"F in {_KERNEL_FEATURES}, at most {_MAX_LEVELS} levels and f32 "
            f"coords on one device (got table "
            f"{getattr(table_or_none, 'dtype', None)}, compute "
            f"{compute_dtype}, F {n_features}, coords {coords.dtype})")
    return coords.contiguous()


def _kernel_forward(table, coords, spec, compute_dtype, count=None,
                    offset=0):
    return _launch_forward(table, coords, _level_arrays(spec),
                           spec.n_features, compute_dtype, spec.paired,
                           count, offset)


def _launch_forward(table, coords, level_arrays, n_features, compute_dtype,
                    paired=False, count=None, offset=0):
    """K3 over the levels of `level_arrays` (scales [L] float32, (res,
    size, offset, dense) [L, 4] int32) → [B, L·F] in the compute type.
    count: an optional int32 [1] on the device; then only the rows below
    count − offset are encoded (the others hold no value)."""
    scales, levels = level_arrays
    n_levels = len(scales)
    coords = _checked_coords(table, coords, n_levels, n_features,
                             compute_dtype)
    table = table.contiguous()
    if table.data_ptr() % 16:  # the kernel's vector loads need alignment
        table = table.clone()
    b = coords.shape[0]
    out = torch.empty((b, n_levels * n_features), dtype=compute_dtype,
                      device=coords.device)
    cuda_lib.load_library().call(
        "hash_encode_forward", table.data_ptr(), coords.data_ptr(),
        out.data_ptr(), b, n_levels, n_features, scales.ctypes.data,
        levels.ctypes.data, int(table.dtype == torch.bfloat16),
        int(compute_dtype == torch.bfloat16), int(paired),
        0 if count is None else cuda_lib.count_ptr(count, coords.device), int(offset),
        torch.cuda.current_stream(coords.device).cuda_stream)
    (paired_counter if paired else counter).launches += 1
    return out


def _kernel_backward(n_entries, coords, spec, g, compute_dtype):
    return _launch_backward(n_entries, coords, _level_arrays(spec),
                            spec.n_features, g, compute_dtype, spec.paired)


def _launch_backward(n_entries, coords, level_arrays, n_features, g,
                     compute_dtype, paired=False):
    """K4 over the levels of `level_arrays` into a zeroed [n_entries, F]
    float32 gradient: each product of weight and cotangent in the compute
    type, summed in float32."""
    scales, levels = level_arrays
    n_levels = len(scales)
    coords = _checked_coords(None, coords, n_levels, n_features,
                             compute_dtype)
    g = g.to(compute_dtype).contiguous()
    if g.data_ptr() % 16:  # the kernel's vector loads need alignment
        g = g.clone()
    grad = torch.zeros((n_entries, n_features), dtype=torch.float32,
                       device=coords.device)
    cuda_lib.load_library().call(
        "hash_encode_backward", coords.data_ptr(), g.data_ptr(),
        grad.data_ptr(), coords.shape[0], n_levels, n_features,
        scales.ctypes.data, levels.ctypes.data,
        int(compute_dtype == torch.bfloat16), int(paired),
        torch.cuda.current_stream(coords.device).cuda_stream)
    (paired_backward_counter if paired else backward_counter).launches += 1
    return grad


def _kernel_coords_backward(table, coords, spec, g, compute_dtype):
    return _launch_coords_backward(table, coords, _level_arrays(spec),
                                   spec.n_features, g, compute_dtype,
                                   spec.paired)


def _launch_coords_backward(table, coords, level_arrays, n_features, g,
                            compute_dtype, paired=False):
    """The coordinates' gradient [B, 3] float32 over the levels of
    `level_arrays`, with `_plain_coords_backward`'s rounding: the table's
    rows and g in the compute type, the rest in float32."""
    scales, levels = level_arrays
    n_levels = len(scales)
    coords = _checked_coords(table, coords, n_levels, n_features,
                             compute_dtype)
    table = table.contiguous()
    if table.data_ptr() % 16:  # the kernel's vector loads need alignment
        table = table.clone()
    g = g.to(compute_dtype).contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    grad = torch.empty((coords.shape[0], 3), dtype=torch.float32,
                       device=coords.device)
    cuda_lib.load_library().call(
        "hash_encode_coords_backward", table.data_ptr(), coords.data_ptr(),
        g.data_ptr(), grad.data_ptr(), coords.shape[0], n_levels, n_features,
        scales.ctypes.data, levels.ctypes.data,
        int(table.dtype == torch.bfloat16),
        int(compute_dtype == torch.bfloat16), int(paired),
        torch.cuda.current_stream(coords.device).cuda_stream)
    coords_counter.launches += 1
    return grad


class _Encode(torch.autograd.Function):
    """hash_encode, differentiable with respect to the table and to the
    coordinates: the backward computes each gradient only when it is asked
    for (on the card K4 for the table, `hash_encode_coords_backward` for
    the coordinates)."""

    @staticmethod
    def forward(ctx, table, coords, spec, compute_dtype, kernel):
        ctx.meta = (table.shape[0], table.dtype, spec, compute_dtype, kernel)
        # the coordinates' gradient reads the table's rows
        saved = (coords, table if ctx.needs_input_grad[1] else None)
        if kernel:
            ctx.save_for_backward(*saved)
            return _kernel_forward(table, coords, spec, compute_dtype)
        # the plain backwards reuse the forward's corners
        corners = _corners(spec, coords)
        ctx.save_for_backward(*saved, *corners)
        return _gather_encode(table, coords, spec, compute_dtype, corners)

    @staticmethod
    def backward(ctx, g):
        coords, table, *corners = ctx.saved_tensors
        n_entries, dtype, spec, compute_dtype, kernel = ctx.meta
        corners = tuple(corners) or None
        grad_table = grad_coords = None
        if ctx.needs_input_grad[0]:
            grad_table = (
                _kernel_backward(n_entries, coords, spec, g, compute_dtype)
                if kernel else _plain_backward(n_entries, coords, spec, g,
                                               compute_dtype, corners))
            grad_table = grad_table.to(dtype)
        if ctx.needs_input_grad[1]:
            grad_coords = (
                _kernel_coords_backward(table, coords, spec, g, compute_dtype)
                if kernel else _plain_coords_backward(table, coords, spec, g,
                                                      compute_dtype, corners))
            grad_coords = grad_coords.to(coords.dtype)
        return grad_table, grad_coords, None, None, None


def _needs_grad(table, coords) -> bool:
    return torch.is_grad_enabled() and (table.requires_grad
                                        or coords.requires_grad)


def hash_encode_reference(table: torch.Tensor, coords: torch.Tensor,
                          spec: HashGridSpec,
                          compute_dtype=torch.float32) -> torch.Tensor:
    """Plain version of `hash_encode`, on any device."""
    if _needs_grad(table, coords):
        return _Encode.apply(table, coords, spec, compute_dtype, False)
    return _gather_encode(table, coords, spec, compute_dtype)


def hash_encode(table: torch.Tensor, coords: torch.Tensor, spec: HashGridSpec,
                compute_dtype=torch.float32, count: torch.Tensor | None = None,
                offset: int = 0) -> torch.Tensor:
    """Encode [B,3] coords → [B, L·F] features in `compute_dtype`: each
    gathered row times its weight is rounded to the compute type, then the
    8 corners are summed. Differentiable with respect to `table` and to
    `coords`.

    count: an optional int32 [1] on the coords' device (inference only),
    the compacted wavefront's count of valid rows, whose first row is row
    `offset` of the whole batch: only the rows below count − offset are
    encoded, and the others hold no value. On the card K3 reads the count
    itself (no host read); the plain version reads it on the host."""
    if count is not None and _needs_grad(table, coords):
        raise ValueError("hash_encode: a row count is for inference only")
    if coords.device.type == "cpu":
        if count is not None:
            n = min(max(int(count) - offset, 0), coords.shape[0])
            out = torch.zeros((coords.shape[0], spec.n_output_dims),
                              dtype=compute_dtype)
            out[:n] = hash_encode_reference(table, coords[:n], spec,
                                            compute_dtype)
            return out
        return hash_encode_reference(table, coords, spec, compute_dtype)
    if coords.device.type != "cuda":
        raise ValueError(f"unsupported device {coords.device}")
    if _needs_grad(table, coords):
        return _Encode.apply(table, coords, spec, compute_dtype, True)
    return _kernel_forward(table, coords, spec, compute_dtype, count, offset)


def packed_dense_tables(table: torch.Tensor, spec: HashGridSpec) -> dict:
    """[size, 8F] corner-packed companion tables of the dense levels, keyed
    by str(level): row i holds the 8 corner rows of the cell whose min
    corner is entry i. torch.roll reproduces tcnn's `% size` wrap of the +1
    corners exactly. Dense levels address alike in both hash variants."""
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
    if spec.paired:
        return _hash_encode_packed_paired(table, packed, coords, spec,
                                          compute_dtype)
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


def _hash_encode_packed_paired(table, packed: dict, coords, spec,
                               compute_dtype):
    """`hash_encode_packed` of a paired spec: a packed dense level gathers
    one [size, 8F] row; the other levels share one gather of their paired
    per-corner entries (`paired_corner_indices_and_weights`)."""
    b, nf = coords.shape[0], spec.n_features
    feats = [None] * spec.n_levels
    rest = []
    for l in range(spec.n_levels):
        if str(l) in packed:
            idx, w = _dense_level_corners(spec, l, coords)
            # the min corner needs no wrap (see hash_encode_packed)
            f = packed[str(l)][idx[:, 0]].reshape(b, 8, nf).to(compute_dtype)
            feats[l] = (f * w.to(compute_dtype)[..., None]).sum(dim=1)
        else:
            rest.append(l)
    if rest:
        idx_parts, w_parts = [], []
        for l in rest:
            offset = spec.level_offsets[l]
            if spec.level_is_dense[l]:
                idx, w = _dense_level_corners(spec, l, coords)
                idx_parts.append(idx + offset)
                w_parts.append(w)
            else:
                rows, w2 = _paired_level_rows(spec, l, coords)
                e = offset + 2 * rows
                idx_parts.append(torch.stack([e, e + 1], dim=-1).reshape(b,
                                                                         8))
                w_parts.append(w2.reshape(b, 8))
        hi = torch.cat(idx_parts, dim=1)
        hw = torch.cat(w_parts, dim=1).to(compute_dtype)
        f = table[hi].to(compute_dtype) * hw[..., None]
        f = f.reshape(b, len(rest), 8, nf).sum(dim=2)
        for j, l in enumerate(rest):
            feats[l] = f[:, j]
    return torch.cat(feats, dim=1)


# -- the traced encode: per-level parameters as data ------------------------
#
# Tensor parallelism over levels (parallel/tp.py) gives each model shard a
# contiguous slice of the levels in a padded table of its own. The same code
# runs on every shard, so the per-level constants travel as arrays (the JAX
# package's ops/hash_encoding.py:198-329). On CUDA tensors the encode is K3
# and its backward K4 over the shard's level rows, their offsets rebased
# into the shard's table (`hash_encode_forward`, `hash_encode_backward` and
# `hash_encode_coords_backward` take any rows of (res, size, offset,
# dense)); on CPU tensors the plain per-level gather and scatter. Both forms
# are differentiable in the coordinates too, the split-grad one included,
# where the JAX package's custom_vjp returns None, a zero (ROADMAP Queue 3).

_LEVEL_KEYS = ("scale", "size", "offset", "res", "dense")


def level_param_arrays(spec: HashGridSpec) -> dict:
    """Per-level parameters as [L] host arrays: scale float32, size, offset
    (into the flat table) and res int64, dense bool. The tcnn layout only:
    a paired spec raises, as the JAX package's does."""
    if spec.paired:
        raise ValueError("tensor-parallel level sharding uses tcnn "
                         "addressing; the paired hash variant is "
                         "single-shard (DP/EP) only")
    return {"scale": torch.tensor(spec.scales, dtype=torch.float32),
            "size": torch.tensor(spec.level_sizes, dtype=torch.int64),
            "offset": torch.tensor(spec.level_offsets[:-1],
                                   dtype=torch.int64),
            "res": torch.tensor(spec.resolutions, dtype=torch.int64),
            "dense": torch.tensor(spec.level_is_dense, dtype=torch.bool)}


def _level_rows(level_params: dict, n_levels: int) -> list[tuple]:
    """[(scale, size, offset, res, dense)] of the first n_levels levels, as
    host numbers (the scale a float32 value)."""
    cols = [np.asarray(level_params[k]).reshape(-1)[:n_levels]
            for k in _LEVEL_KEYS]
    if any(len(c) != n_levels for c in cols):
        raise ValueError(f"level params hold fewer than {n_levels} levels")
    return [(float(np.float32(s)), int(z), int(o), int(r), bool(d))
            for s, z, o, r, d in zip(*cols)]


def _rows_kernel_arrays(rows: list[tuple]):
    """The kernels' (scales [L] float32, (res, size, offset, dense) [L, 4]
    int32) of the rows."""
    scales = np.array([r[0] for r in rows], np.float32)
    levels = np.array([[res, size, off, int(dense)]
                       for _, size, off, res, dense in rows], np.int32)
    return scales, levels


def _traced_level_corners(coords: torch.Tensor, row: tuple):
    """One level's LOCAL corner indices [B, 8] (int64 in [0, size)) and
    trilinear weights [B, 8] float32: tcnn's stride index on a dense level,
    the prime-XOR hash otherwise."""
    scale, size, _, res, dense = row
    corners = device_constant(_CORNER_TUPLES, torch.int64, coords.device)
    cell, frac = _cell_frac(coords, scale)
    pos = cell[:, None, :] + corners[None]
    if dense:
        idx = pos[..., 0] + pos[..., 1] * res + pos[..., 2] * (res * res)
    else:
        idx = (((pos[..., 0] * _PRIMES[0]) & _U32)
               ^ ((pos[..., 1] * _PRIMES[1]) & _U32)
               ^ ((pos[..., 2] * _PRIMES[2]) & _U32))
    idx = (idx & _U32) % size
    cw = torch.where(corners[None] == 0, 1.0 - frac[:, None, :],
                     frac[:, None, :])
    return idx, cw[..., 0] * cw[..., 1] * cw[..., 2]


def _traced_plain_forward(table, coords, rows, compute_dtype):
    feats = []
    for row in rows:
        idx, w = _traced_level_corners(coords, row)
        f = table[idx + row[2]].to(compute_dtype) * w.to(compute_dtype)[
            ..., None]
        feats.append(f.sum(dim=1))  # [B, F]
    return torch.cat(feats, dim=1)


def _traced_plain_backward(n_entries, coords, rows, g, compute_dtype):
    """Autodiff of the traced forward: each product of weight and cotangent
    rounded to the compute type, index_add_-ed in float32."""
    b, nf = coords.shape[0], g.shape[1] // len(rows)
    gc = g.to(compute_dtype).reshape(b, len(rows), nf)
    grad = torch.zeros((n_entries, nf), dtype=torch.float32, device=g.device)
    for l, row in enumerate(rows):
        idx, w = _traced_level_corners(coords, row)
        upd = (gc[:, l, None, :] * w.to(compute_dtype)[..., None])
        grad.index_add_(0, (idx + row[2]).reshape(-1),
                        upd.to(torch.float32).reshape(-1, nf))
    return grad


def _traced_plain_coords_backward(table, coords, rows, g, compute_dtype):
    """`_plain_coords_backward` over the rows' levels (tcnn's corners)."""
    b, nf = coords.shape[0], g.shape[1] // len(rows)
    gc = g.to(compute_dtype).to(torch.float32).reshape(b, len(rows), nf)
    sides = device_constant(_CORNER_TUPLES, torch.bool, coords.device)
    grad = torch.zeros((b, 3), dtype=torch.float32, device=coords.device)
    for l, row in enumerate(rows):
        idx, _ = _traced_level_corners(coords, row)
        _, frac = _cell_frac(coords, row[0])
        r = table[idx + row[2]].to(compute_dtype).to(torch.float32)
        grad += _level_coords_grad(r, gc[:, l], frac, sides, row[0])
    return grad


class _TracedEncode(torch.autograd.Function):
    """The traced encode, differentiable with respect to the table (the
    backward's products of weight and cotangent rounded to bwd_dtype) and
    to the coordinates (the forward's compute type, as `_Encode`'s)."""

    @staticmethod
    def forward(ctx, table, coords, rows, n_features, compute_dtype,
                bwd_dtype, kernel):
        ctx.meta = (table.shape[0], table.dtype, rows, n_features,
                    compute_dtype, bwd_dtype, kernel)
        ctx.save_for_backward(coords,
                              table if ctx.needs_input_grad[1] else None)
        if kernel:
            return _launch_forward(table, coords, _rows_kernel_arrays(rows),
                                   n_features, compute_dtype)
        return _traced_plain_forward(table, coords, rows, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        coords, table = ctx.saved_tensors
        (n_entries, dtype, rows, n_features, compute_dtype, bwd_dtype,
         kernel) = ctx.meta
        grad_table = grad_coords = None
        if ctx.needs_input_grad[0]:
            grad_table = (
                _launch_backward(n_entries, coords, _rows_kernel_arrays(rows),
                                 n_features, g, bwd_dtype) if kernel
                else _traced_plain_backward(n_entries, coords, rows, g,
                                            bwd_dtype)).to(dtype)
        if ctx.needs_input_grad[1]:
            grad_coords = (
                _launch_coords_backward(table, coords,
                                        _rows_kernel_arrays(rows), n_features,
                                        g, compute_dtype) if kernel
                else _traced_plain_coords_backward(table, coords, rows, g,
                                                   compute_dtype))
            grad_coords = grad_coords.to(coords.dtype)
        return grad_table, grad_coords, None, None, None, None, None


def _traced(table, coords, rows, n_features, compute_dtype, bwd_dtype):
    if coords.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {coords.device}")
    if table.shape[1] != n_features:
        raise ValueError(f"table rows hold {table.shape[1]} features, not "
                         f"{n_features}")
    kernel = coords.device.type == "cuda"
    if _needs_grad(table, coords):
        return _TracedEncode.apply(table, coords, rows, n_features,
                                   compute_dtype, bwd_dtype, kernel)
    if kernel:
        return _launch_forward(table, coords, _rows_kernel_arrays(rows),
                               n_features, compute_dtype)
    return _traced_plain_forward(table, coords, rows, compute_dtype)


def hash_encode_traced(table: torch.Tensor, coords: torch.Tensor,
                       level_params: dict, n_levels: int, n_features: int,
                       compute_dtype=torch.float32) -> torch.Tensor:
    """`hash_encode` with the per-level parameters as data
    (`level_param_arrays`, or a shard's rows of them with offsets into its
    own table) → [B, n_levels·F]. The same numbers as `hash_encode` on the
    levels' rows; differentiable with respect to `table` (the products of
    weight and cotangent in the compute type, summed in float32) and to
    `coords` (as `hash_encode`)."""
    return _traced(table, coords, _level_rows(level_params, n_levels),
                   n_features, compute_dtype, compute_dtype)


def hash_encode_traced_splitgrad(table: torch.Tensor, coords: torch.Tensor,
                                 level_params: dict, level_caps: tuple,
                                 n_features: int,
                                 compute_dtype=torch.float32) -> torch.Tensor:
    """`hash_encode_traced` with the split-grad backward of the JAX
    package's TP path: float32 products of weight and cotangent, each level
    scattered on its own (level_caps: a static bound on each local level's
    size, the largest over the shards). JAX accumulates levels of ≥ 2^17
    rows in float16 there; this accumulates every level in float32, as the
    single-device backward does, so summing each level into its own buffer
    gives the same numbers as one scatter with float32 products. The
    coordinates get their true gradient, as from `hash_encode_traced`;
    JAX's custom_vjp returns None for them, a silent zero (ROADMAP Queue
    3)."""
    caps = tuple(int(c) for c in level_caps)
    rows = _level_rows(level_params, len(caps))
    if any(row[1] > cap for row, cap in zip(rows, caps)):
        raise ValueError(f"a level is larger than its cap: sizes "
                         f"{[r[1] for r in rows]}, caps {caps}")
    return _traced(table, coords, rows, n_features, compute_dtype,
                   torch.float32)
