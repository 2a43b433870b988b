"""OpenVDB (.vdb) files: a FloatGrid reader and writer (counterpart of
`instantvnr_tpu/data/vdb.py`; the reference reads .vdb through OpenVKL's
OpenVdbVolume, `core/samplers/neural_sampler.cpp:756-770`).

No OpenVDB library exists here, so this module reads and writes the
archive format itself, in real OpenVDB's layout (io/Archive.cc,
io/GridDescriptor.cc, io/Compression.h, tree/RootNode.h,
tree/InternalNode.h, tree/LeafNode.h; file versions 220-224). The JAX
package's reader and writer share three departures from that layout, so a
file of one is no test of the other (ROADMAP Queue 3); here:

- the header's compression byte exists only for 220 ≤ version < 222; from
  222 on the compression flags are per grid;
- each grid's data starts with its uint32 compression flags from 222 on;
- a leaf's buffer repeats its 64-byte value mask before its values.

Layout (little-endian):
  header:  int64 magic 0x56444220, uint32 file version, uint32 library
           major and minor, byte hasGridOffsets, [byte isCompressed,
           220-221], 36-char ASCII uuid, the file's MetaMap, int32 grid
           count; then per grid its descriptor (unique name, type with an
           optional "_HalfFloat" suffix, instance parent, int64 grid, block
           and end offsets) followed by the grid: [uint32 compression,
           ≥ 222], MetaMap (sorted by name), Transform (map type name, the
           map's doubles), topology (int32 buffer count = 1, root
           background, tile and child counts, tiles, children: the 32³ and
           16³ internal nodes' child mask, value mask and compressed values,
           leaves' value masks), buffers (per leaf, depth first: value mask,
           compressed values).
  values:  [int8 layout code, ≥ 222], optional inactive value(s) (always
           full float), optional selection mask between two inactive
           values, then the stored values: the active ones under
           active-mask compression (unless the code is 6, all values), raw
           or zip (int64 byte count, ≤ 0 for -count raw bytes).

A read gives a dense [dz, dy, dx] float32 array over the grid's active
index bounding box (the background elsewhere), the shape of
`data.volume.Volume`, so a .vdb flows through every path of the port.
"""
from __future__ import annotations

import io
import os
import struct
import uuid as _uuid
import zlib
from dataclasses import dataclass, field

import numpy as np

MAGIC = 0x56444220  # " BDV" little-endian
_SUPPORTED_VERSIONS = range(220, 225)
_WRITE_VERSION = 224  # OPENVDB_FILE_VERSION_MULTIPASS_IO, OpenVDB 4-11
_NODE_MASK_COMPRESSION = 222  # per-grid compression, value layout codes
_GRID_INSTANCING = 216
_HALF_SUFFIX = "_HalfFloat"

# compression flags (io/Compression.h)
COMPRESS_NONE = 0
COMPRESS_ZIP = 1
COMPRESS_ACTIVE_MASK = 2
COMPRESS_BLOSC = 4
_COMPRESSION_NAMES = {"none": COMPRESS_NONE, "zip": COMPRESS_ZIP,
                      "mask": COMPRESS_ACTIVE_MASK,
                      "zip+mask": COMPRESS_ZIP | COMPRESS_ACTIVE_MASK}

# value layout codes of readCompressedValues / writeCompressedValues
NO_MASK_OR_INACTIVE_VALS = 0     # inactive = +background
NO_MASK_AND_MINUS_BG = 1         # inactive = −background
NO_MASK_AND_ONE_INACTIVE_VAL = 2
MASK_AND_NO_INACTIVE_VALS = 3    # selection: +background, else −background
MASK_AND_ONE_INACTIVE_VAL = 4
MASK_AND_TWO_INACTIVE_VALS = 5
NO_MASK_AND_ALL_VALS = 6

# Tree_float_5_4_3
_L1_LOG2, _L2_LOG2, _LEAF_LOG2 = 5, 4, 3
_LEAF_DIM = 8
_LEAF_SIZE = 512
_L2_SPAN = 128   # voxels a 16³ node covers
_L1_SPAN = 4096  # voxels a 32³ node covers


class VdbError(ValueError):
    """A file this reader refuses: the message says where and why."""


@dataclass
class VdbGridInfo:
    name: str
    grid_type: str
    file_version: int
    background: float
    bbox_min: tuple[int, int, int]  # the active index bbox, inclusive
    bbox_max: tuple[int, int, int]
    voxel_size: tuple[float, float, float]
    index_to_world: np.ndarray  # [4, 4], row-vector convention
    grid_class: str = ""
    meta: dict = field(default_factory=dict)


def _offset_to_xyz(off: int, log2: int) -> tuple[int, int, int]:
    """The inverse of coordToOffset: offset = (x << 2·log2) | (y << log2)
    | z, each in child units."""
    dim = 1 << log2
    return off >> (2 * log2), (off >> log2) & (dim - 1), off & (dim - 1)


# ---------------------------------------------------------------------------
# reading


class _R:
    def __init__(self, f):
        self.f = f

    def bytes(self, n: int, what: str) -> bytes:
        b = self.f.read(n)
        if len(b) != n:
            raise VdbError(f"truncated file reading {what} "
                           f"({len(b)}/{n} bytes at {self.f.tell()})")
        return b

    def u32(self, what="uint32") -> int:
        return struct.unpack("<I", self.bytes(4, what))[0]

    def i32(self, what="int32") -> int:
        return struct.unpack("<i", self.bytes(4, what))[0]

    def i64(self, what="int64") -> int:
        return struct.unpack("<q", self.bytes(8, what))[0]

    def f32(self, what="float") -> float:
        return struct.unpack("<f", self.bytes(4, what))[0]

    def f64v(self, n: int, what: str) -> np.ndarray:
        return np.frombuffer(self.bytes(8 * n, what), "<f8").copy()

    def byte(self, what="byte") -> int:
        return self.bytes(1, what)[0]

    def string(self, what="string", maxlen=1 << 16) -> str:
        n = self.u32(f"{what} length")
        if n > maxlen:
            raise VdbError(f"implausible {what} length {n} at "
                           f"{self.f.tell()}: a layout mismatch")
        return self.bytes(n, what).decode("utf-8", errors="strict")

    def mask(self, nbits: int, what: str) -> np.ndarray:
        """NodeMask::load: little-endian uint64 words, bit i of word i >> 6
        is offset i → bool [nbits] in offset order."""
        raw = np.frombuffer(self.bytes(nbits // 8, what), np.uint8)
        return np.unpackbits(raw, bitorder="little").astype(bool)


def _read_metamap(r: _R) -> dict:
    """MetaMap::readMeta: uint32 count, then per entry its name, type name,
    uint32 size and value bytes. Known types are decoded, others kept as
    bytes."""
    count = r.u32("metadata count")
    if count > 1 << 20:
        raise VdbError(f"implausible metadata count {count}")
    out = {}
    for _ in range(count):
        name = r.string("metadata name")
        tname = r.string("metadata type")
        n = r.u32("metadata size")
        if n > 1 << 28:
            raise VdbError(f"implausible metadata size {n} for {name!r}")
        raw = r.bytes(n, f"metadata {name!r}")
        fmt = {("bool", 1): "<?", ("int32", 4): "<i", ("int64", 8): "<q",
               ("float", 4): "<f", ("double", 8): "<d", ("vec3i", 12): "<3i",
               ("vec3d", 24): "<3d"}.get((tname, n))
        if tname == "string":
            out[name] = raw.decode("utf-8", errors="replace")
        elif fmt is not None:
            v = struct.unpack(fmt, raw)
            out[name] = v if len(v) > 1 else v[0]
        else:
            out[name] = raw
    return out


def _read_transform(r: _R) -> tuple[np.ndarray, tuple[float, float, float]]:
    """Transform::read: the map's type name, then its serialized doubles →
    (4 × 4 index → world matrix, voxel size). The scale maps' cached
    inverse is checked against their scale."""
    map_type = r.string("map type")
    mat = np.eye(4)

    def scale_map(with_translation: bool):
        if with_translation:
            mat[3, :3] = r.f64v(3, "translation")
        scale = r.f64v(3, "scale")
        r.f64v(3, "voxel size")
        inv = r.f64v(3, "scale inverse")
        r.f64v(3, "inverse scale squared")
        r.f64v(3, "inverse twice scale")
        if not np.allclose(scale * inv, 1.0, rtol=1e-6):
            raise VdbError(f"{map_type}: scale·inverse != 1 ({scale}, {inv}):"
                           " a map layout mismatch")
        mat[0, 0], mat[1, 1], mat[2, 2] = scale

    if map_type == "AffineMap":
        mat = r.f64v(16, "AffineMap matrix").reshape(4, 4)
    elif map_type in ("UniformScaleMap", "ScaleMap"):
        scale_map(False)
    elif map_type in ("UniformScaleTranslateMap", "ScaleTranslateMap"):
        scale_map(True)
    elif map_type == "TranslationMap":
        mat[3, :3] = r.f64v(3, "translation")
    else:
        raise VdbError(f"unsupported transform map {map_type!r} (supported: "
                       "AffineMap, [Uniform]Scale[Translate]Map, "
                       "TranslationMap)")
    voxel = tuple(float(np.linalg.norm(mat[i, :3])) for i in range(3))
    return mat, voxel


class _Stream:
    """What readCompressedValues reads from the stream's metadata: the file
    version, the grid's compression flags, its background, half floats."""

    def __init__(self, version, compression, background, from_half):
        self.version = version
        self.compression = compression
        self.background = np.float32(background)
        self.from_half = from_half


def _read_data(r: _R, count: int, st: _Stream) -> np.ndarray:
    """io::readData (or HalfReader::read): `count` values, raw or zipped
    → float32."""
    dt = np.dtype("<f2") if st.from_half else np.dtype("<f4")
    nbytes = count * dt.itemsize
    if st.compression & COMPRESS_BLOSC:
        raise VdbError("BLOSC-compressed values: no blosc library here; "
                       "save the file with ZIP or no compression")
    if st.compression & COMPRESS_ZIP:
        n = r.i64("zipped byte count")
        if n <= 0:  # stored raw
            raw = r.bytes(-n, "raw values")
        else:
            if n > 1 << 31:
                raise VdbError(f"implausible zip blob size {n}")
            raw = zlib.decompress(r.bytes(n, "zipped values"))
    else:
        raw = r.bytes(nbytes, "raw values")
    if len(raw) != nbytes:
        raise VdbError(f"value payload of {len(raw)} bytes, expected "
                       f"{nbytes} ({count} values)")
    return np.frombuffer(raw, dt).astype(np.float32)


def _read_values(r: _R, count: int, value_mask: np.ndarray,
                 st: _Stream) -> np.ndarray:
    """io::readCompressedValues → float32 [count]."""
    code = NO_MASK_AND_ALL_VALS
    if st.version >= _NODE_MASK_COMPRESSION:
        code = r.byte("value layout code")
        if code > NO_MASK_AND_ALL_VALS:
            raise VdbError(f"unknown value layout code {code} at "
                           f"{r.f.tell() - 1}")
    bg = st.background
    inactive1 = bg
    inactive0 = bg if code == NO_MASK_OR_INACTIVE_VALS else -bg
    if code in (NO_MASK_AND_ONE_INACTIVE_VAL, MASK_AND_ONE_INACTIVE_VAL,
                MASK_AND_TWO_INACTIVE_VALS):
        inactive0 = np.float32(r.f32("inactive value 0"))
        if code == MASK_AND_TWO_INACTIVE_VALS:
            inactive1 = np.float32(r.f32("inactive value 1"))
    selection = None
    if code in (MASK_AND_NO_INACTIVE_VALS, MASK_AND_ONE_INACTIVE_VAL,
                MASK_AND_TWO_INACTIVE_VALS):
        selection = r.mask(count, "selection mask")
    stored = count
    masked = (st.compression & COMPRESS_ACTIVE_MASK
              and code != NO_MASK_AND_ALL_VALS
              and st.version >= _NODE_MASK_COMPRESSION)
    if masked:
        stored = int(value_mask.sum())
    vals = _read_data(r, stored, st)
    if stored == count:
        return vals
    out = np.full(count, inactive0, np.float32)
    if selection is not None:
        out[selection] = inactive1
    out[value_mask] = vals
    return out


@dataclass
class _Node:
    origin: tuple[int, int, int]
    log2: int  # 5, 4 or 3 (a leaf)
    value_mask: np.ndarray
    child_mask: np.ndarray | None = None
    values: np.ndarray | None = None
    children: list = field(default_factory=list)  # (offset, _Node)


def _read_internal(r: _R, origin, log2: int, st: _Stream) -> _Node:
    """InternalNode::readTopology."""
    size = (1 << log2) ** 3
    child_mask = r.mask(size, "child mask")
    value_mask = r.mask(size, "value mask")
    if st.version < _NODE_MASK_COMPRESSION:
        # the values of the non-child slots only, in offset order
        values = np.zeros(size, np.float32)
        values[~child_mask] = _read_values(
            r, int((~child_mask).sum()), value_mask[~child_mask], st)
    else:
        values = _read_values(r, size, value_mask, st)
    node = _Node(tuple(origin), log2, value_mask, child_mask, values)
    span = _L2_SPAN if log2 == _L1_LOG2 else _LEAF_DIM
    for off in np.flatnonzero(child_mask):
        x, y, z = _offset_to_xyz(int(off), log2)
        corigin = (origin[0] + x * span, origin[1] + y * span,
                   origin[2] + z * span)
        if log2 == _L1_LOG2:
            child = _read_internal(r, corigin, _L2_LOG2, st)
        else:  # LeafNode::readTopology: its value mask
            child = _Node(corigin, _LEAF_LOG2,
                          r.mask(_LEAF_SIZE, "leaf value mask"))
        node.children.append((int(off), child))
    return node


def _leaves(node: _Node):
    for _, child in node.children:
        if child.log2 == _LEAF_LOG2:
            yield child
        else:
            yield from _leaves(child)


def _read_buffers(r: _R, roots, st: _Stream):
    """Tree::readBuffers: the leaves depth first in topology order; each
    LeafNode::readBuffers reads the value mask again, then (before 222)
    the origin and the buffer count, then the values."""
    for root in roots:
        for leaf in _leaves(root):
            mask = r.mask(_LEAF_SIZE, "leaf buffer value mask")
            if not np.array_equal(mask, leaf.value_mask):
                raise VdbError(f"leaf {leaf.origin}: the buffer's value mask "
                               "differs from the topology's")
            if st.version < _NODE_MASK_COMPRESSION:
                r.bytes(12, "leaf origin")
                if r.byte("leaf buffer count") != 1:
                    raise VdbError("multi-buffer leaves are unsupported")
            leaf.values = _read_values(r, _LEAF_SIZE, mask, st)


def _read_header(r: _R):
    if r.i64("magic") != MAGIC:
        raise VdbError("not an OpenVDB file (bad magic number)")
    version = r.u32("file version")
    if version not in _SUPPORTED_VERSIONS:
        raise VdbError(f"unsupported OpenVDB file version {version} "
                       f"(supported: {_SUPPORTED_VERSIONS.start}-"
                       f"{_SUPPORTED_VERSIONS.stop - 1})")
    lib = (r.u32("library major"), r.u32("library minor"))
    if not r.byte("hasGridOffsets"):
        raise VdbError("stream-mode archives (no grid offsets) are "
                       "unsupported")
    compression = COMPRESS_NONE
    if version < _NODE_MASK_COMPRESSION:  # 220-221: one flag a file
        compression = COMPRESS_ZIP if r.byte("isCompressed") else \
            COMPRESS_NONE
    pos = r.f.tell()
    u = r.bytes(36, "uuid")
    try:
        _uuid.UUID(u.decode("ascii"))
    except ValueError:
        raise VdbError(f"the uuid at {pos} is not 36 ASCII characters "
                       f"({u[:16]!r}...): a header layout mismatch") from None
    return version, lib, compression


def read_vdb_grids(path: str) -> list[tuple[VdbGridInfo, np.ndarray]]:
    """Every float grid of the archive → [(info, dense [dz, dy, dx])]: the
    dense array covers the grid's active index bounding box, the
    background elsewhere; info.bbox_min is where its index (0, 0, 0) sits
    in the grid's index space."""
    with open(path, "rb") as f:
        r = _R(f)
        version, _, file_compression = _read_header(r)
        _read_metamap(r)
        n_grids = r.i32("grid count")
        if not 0 <= n_grids <= 1 << 16:
            raise VdbError(f"implausible grid count {n_grids}")
        out = []
        for _ in range(n_grids):
            # GridDescriptor::read, then the grid at its offset; the next
            # descriptor follows the grid's end
            name = r.string("grid name").split("\x1e")[0]
            gtype = r.string("grid type")
            from_half = gtype.endswith(_HALF_SUFFIX)
            if from_half:
                gtype = gtype[:-len(_HALF_SUFFIX)]
            parent = (r.string("instance parent")
                      if version >= _GRID_INSTANCING else "")
            gpos, _, epos = r.i64("grid pos"), r.i64("block pos"), r.i64(
                "end pos")
            if parent:
                raise VdbError(f"grid {name!r} is an instance of {parent!r}:"
                               " instancing is unsupported")
            if gtype != "Tree_float_5_4_3":
                raise VdbError(f"grid {name!r} has the unsupported type "
                               f"{gtype!r} (supported: Tree_float_5_4_3)")
            f.seek(gpos)
            out.append(_read_grid(r, name, gtype, version, file_compression,
                                  from_half))
            f.seek(epos)
        return out


def _read_grid(r: _R, name, gtype, version, compression, from_half):
    if version >= _NODE_MASK_COMPRESSION:
        compression = r.u32("grid compression")
        if compression > 7:
            raise VdbError(f"implausible grid compression {compression:#x} "
                           f"at {r.f.tell() - 4}")
    meta = _read_metamap(r)
    mat, voxel = _read_transform(r)
    if r.i32("buffer count") != 1:
        raise VdbError("multi-buffer trees are unsupported")
    background = r.f32("background")
    st = _Stream(version, compression, background, from_half)
    n_tiles, n_children = r.u32("root tile count"), r.u32("root child count")
    if n_tiles > 1 << 24 or n_children > 1 << 24:
        raise VdbError(f"implausible root counts ({n_tiles} tiles, "
                       f"{n_children} children)")
    tiles = []
    for _ in range(n_tiles):
        origin = struct.unpack("<3i", r.bytes(12, "tile origin"))
        value = r.f32("tile value")
        tiles.append((origin, np.float32(value), bool(r.byte("tile active"))))
    roots = [_read_internal(r, struct.unpack("<3i", r.bytes(12,
                                                            "child origin")),
                            _L1_LOG2, st) for _ in range(n_children)]
    _read_buffers(r, roots, st)
    return _densify(name, gtype, version, np.float32(background), tiles,
                    roots, mat, voxel, meta)


def _active_bbox(tiles, roots):
    lo = np.full(3, np.iinfo(np.int64).max)
    hi = np.full(3, np.iinfo(np.int64).min)

    def grow(origin, span):
        np.minimum(lo, origin, out=lo)
        np.maximum(hi, np.asarray(origin) + span - 1, out=hi)

    for origin, _, active in tiles:
        if active:
            grow(origin, _L1_SPAN)

    def walk(node):
        span = _L2_SPAN if node.log2 == _L1_LOG2 else _LEAF_DIM
        for off in np.flatnonzero(node.value_mask & ~node.child_mask):
            x, y, z = _offset_to_xyz(int(off), node.log2)
            grow((node.origin[0] + x * span, node.origin[1] + y * span,
                  node.origin[2] + z * span), span)
        for _, child in node.children:
            if child.log2 != _LEAF_LOG2:
                walk(child)
            elif child.value_mask.any():
                xyz = np.stack(np.unravel_index(np.flatnonzero(
                    child.value_mask), (_LEAF_DIM,) * 3), axis=-1)
                grow(np.asarray(child.origin) + xyz.min(0),
                     1 + xyz.max(0) - xyz.min(0))

    for root in roots:
        walk(root)
    if lo[0] > hi[0]:
        return None, None
    return tuple(int(v) for v in lo), tuple(int(v) for v in hi)


def _densify(name, gtype, version, background, tiles, roots, mat, voxel,
             meta):
    bmin, bmax = meta.get("file_bbox_min"), meta.get("file_bbox_max")
    if not (isinstance(bmin, tuple) and isinstance(bmax, tuple)):
        bmin, bmax = _active_bbox(tiles, roots)
    info = VdbGridInfo(name, gtype, version, float(background),
                       (0, 0, 0) if bmin is None else tuple(bmin),
                       (-1, -1, -1) if bmax is None else tuple(bmax),
                       voxel, mat, str(meta.get("class", "")), meta)
    if bmin is None or any(a > b for a, b in zip(bmin, bmax)):
        return info, np.zeros((0, 0, 0), np.float32)
    n = [b - a + 1 for a, b in zip(bmin, bmax)]  # x, y, z
    if n[0] * n[1] * n[2] > 1 << 33:
        raise VdbError(f"an active bbox of {n[0]}x{n[1]}x{n[2]} is too large "
                       "to densify")
    dense = np.full((n[2], n[1], n[0]), background, np.float32)

    def paint(origin, block):
        """block [z, y, x] at index origin (x, y, z), clipped to the bbox."""
        sl_d, sl_b = [], []
        for a in (2, 1, 0):
            lo = origin[a] - bmin[a]
            size = block.shape[2 - a]
            s0, s1 = max(lo, 0), min(lo + size, n[a])
            if s0 >= s1:
                return
            sl_d.append(slice(s0, s1))
            sl_b.append(slice(s0 - lo, s1 - lo))
        dense[tuple(sl_d)] = block[tuple(sl_b)]

    def paint_tile(origin, span, value):
        paint(origin, np.broadcast_to(np.float32(value), (span,) * 3))

    for origin, value, active in tiles:
        if active or value != background:
            paint_tile(origin, _L1_SPAN, value)

    def walk(node):
        span = _L2_SPAN if node.log2 == _L1_LOG2 else _LEAF_DIM
        tile = (node.value_mask | (node.values != background)) \
            & ~node.child_mask
        for off in np.flatnonzero(tile):
            x, y, z = _offset_to_xyz(int(off), node.log2)
            paint_tile((node.origin[0] + x * span, node.origin[1] + y * span,
                        node.origin[2] + z * span), span,
                       node.values[int(off)])
        for _, child in node.children:
            if child.log2 == _LEAF_LOG2:
                # offset order is x-major: [x, y, z] → [z, y, x]
                paint(child.origin, child.values.reshape(
                    (_LEAF_DIM,) * 3).transpose(2, 1, 0))
            else:
                walk(child)

    for root in roots:
        walk(root)
    return info, dense


def read_vdb(path: str, grid: str | None = None
             ) -> tuple[np.ndarray, VdbGridInfo]:
    """One grid (by name; else the only one, or 'density') → (dense
    [dz, dy, dx] float32, info)."""
    grids = read_vdb_grids(path)
    if not grids:
        raise VdbError(f"{path}: the archive holds no grids")
    names = [info.name for info, _ in grids]
    want = grid if grid is not None else (
        names[0] if len(grids) == 1 else "density")
    for info, dense in grids:
        if info.name == want:
            return dense, info
    if grid is None:
        raise VdbError(f"{path}: grids {names}; pass grid=<name>")
    raise VdbError(f"{path}: no grid named {grid!r} (has: {names})")


def vdb_to_volume(path: str, grid: str | None = None,
                  value_range: tuple | None = None, device="cuda"):
    """.vdb → data.volume.Volume on `device`, normalized as every source is
    (StaticSampler::load, neural_sampler.cpp:244-288)."""
    import torch

    from instantvnr_torch.data.volume import Volume, normalize_array
    from instantvnr_torch.utils.device import resolve_device

    dense, info = read_vdb(path, grid)
    if dense.size == 0:
        raise VdbError(f"{path}: grid {info.name!r} has no active voxels")
    data, rng = normalize_array(dense, value_range)
    dz, dy, dx = dense.shape
    return Volume(data=torch.from_numpy(data).to(resolve_device(device)),
                  dims=(dx, dy, dz), original_range=rng)


# ---------------------------------------------------------------------------
# writing


class _W:
    def __init__(self):
        self.buf = io.BytesIO()

    def raw(self, b: bytes):
        self.buf.write(b)

    def pack(self, fmt: str, *v):
        self.buf.write(struct.pack(fmt, *v))

    def string(self, s: str):
        b = s.encode("utf-8")
        self.pack("<I", len(b))
        self.buf.write(b)

    def mask(self, bits: np.ndarray):
        self.buf.write(np.packbits(bits.astype(np.uint8),
                                   bitorder="little").tobytes())


def _mask_compress(values, value_mask, child_mask, background):
    """MaskCompress (io/Compression.h): the layout code and the two inactive
    values from at most three distinct values of the inactive, non-child
    slots."""
    bg = np.float32(background)
    # the distinct values in the order OpenVDB meets them (offset order)
    found, first = np.unique(values[~value_mask & ~child_mask],
                             return_index=True)
    uniq = [np.float32(v) for v in found[np.argsort(first)]]
    if len(uniq) > 2:
        return NO_MASK_AND_ALL_VALS, (bg, bg)
    if not uniq:
        return NO_MASK_OR_INACTIVE_VALS, (bg, bg)
    if len(uniq) == 1:
        v0 = uniq[0]
        if v0 == bg:
            return NO_MASK_OR_INACTIVE_VALS, (v0, bg)
        if v0 == -bg:
            return NO_MASK_AND_MINUS_BG, (v0, bg)
        return NO_MASK_AND_ONE_INACTIVE_VAL, (v0, bg)
    v0, v1 = uniq
    if v0 != bg and v1 != bg:
        return MASK_AND_TWO_INACTIVE_VALS, (v0, v1)
    if v1 == bg:
        return (MASK_AND_NO_INACTIVE_VALS if v0 == -bg
                else MASK_AND_ONE_INACTIVE_VAL), (v0, v1)
    # v0 is the background: swap
    return (MASK_AND_NO_INACTIVE_VALS if v1 == -bg
            else MASK_AND_ONE_INACTIVE_VAL), (v1, v0)


def _write_data(w: _W, vals: np.ndarray, compression: int):
    """io::writeData: raw, or zipToStream (the zlib stream when smaller,
    else the negated byte count and the raw bytes)."""
    payload = np.asarray(vals, "<f4").tobytes()
    if compression & COMPRESS_ZIP:
        z = zlib.compress(payload)
        if len(z) < len(payload):
            w.pack("<q", len(z))
            w.raw(z)
        else:
            w.pack("<q", -len(payload))
            w.raw(payload)
    else:
        w.raw(payload)


def _write_values(w: _W, vals: np.ndarray, value_mask: np.ndarray,
                  child_mask: np.ndarray, background: float,
                  compression: int):
    """io::writeCompressedValues."""
    vals = np.asarray(vals, np.float32)
    if not compression & COMPRESS_ACTIVE_MASK:
        w.pack("<b", NO_MASK_AND_ALL_VALS)
        _write_data(w, vals, compression)
        return
    code, (i0, i1) = _mask_compress(vals, value_mask, child_mask, background)
    w.pack("<b", code)
    if code in (NO_MASK_AND_ONE_INACTIVE_VAL, MASK_AND_ONE_INACTIVE_VAL,
                MASK_AND_TWO_INACTIVE_VALS):
        w.pack("<f", i0)
        if code == MASK_AND_TWO_INACTIVE_VALS:
            w.pack("<f", i1)
    if code == NO_MASK_AND_ALL_VALS:
        stored = vals
    else:
        if code in (MASK_AND_NO_INACTIVE_VALS, MASK_AND_ONE_INACTIVE_VAL,
                    MASK_AND_TWO_INACTIVE_VALS):
            w.mask(~value_mask & (vals == i1))
        stored = vals[value_mask]
    _write_data(w, stored, compression)


def _blocks(data: np.ndarray, active: np.ndarray, origin, background):
    """The dense array cut into the leaf blocks (8³ cells on the index
    lattice) it overlaps → {(x, y, z) leaf origin: (values [512], mask
    [512]) in offset order} for blocks holding anything but inactive
    background, and {origin: value} for blocks of one active value (the
    tiles OpenVDB's copyFromDense makes of them)."""
    ox, oy, oz = origin
    dz, dy, dx = data.shape
    pad = [(0, -(-n // _LEAF_DIM) * _LEAF_DIM - n) for n in (dz, dy, dx)]
    vals = np.pad(data, pad, constant_values=np.float32(background))
    act = np.pad(active, pad, constant_values=False)
    nbz, nby, nbx = (s // _LEAF_DIM for s in vals.shape)
    # [bz, by, bx, x, y, z]: a block's 512 values in offset order
    shape = (nbz, _LEAF_DIM, nby, _LEAF_DIM, nbx, _LEAF_DIM)
    vb = vals.reshape(shape).transpose(0, 2, 4, 5, 3, 1).reshape(
        nbz, nby, nbx, _LEAF_SIZE)
    ab = act.reshape(shape).transpose(0, 2, 4, 5, 3, 1).reshape(
        nbz, nby, nbx, _LEAF_SIZE)
    leaves, tiles = {}, {}
    for bz, by, bx in zip(*np.nonzero(ab.any(-1) | (
            vb != np.float32(background)).any(-1))):
        v, m = vb[bz, by, bx], ab[bz, by, bx]
        key = (ox + int(bx) * _LEAF_DIM, oy + int(by) * _LEAF_DIM,
               oz + int(bz) * _LEAF_DIM)
        if m.all() and (v == v[0]).all():
            tiles[key] = v[0]
        else:
            leaves[key] = (v, m)
    return leaves, tiles


def _node_origin(xyz, span):
    return tuple(c - (c % span) for c in xyz)


def write_vdb(path: str, data_zyx: np.ndarray, name: str = "density",
              compression: str = "zip", origin=(0, 0, 0),
              voxel_size: float = 1.0, background: float = 0.0,
              active_threshold: float | None = None):
    """A dense [dz, dy, dx] array → a FloatGrid .vdb (file version 224,
    real OpenVDB layout, a UniformScaleMap of `voxel_size`). Index (x, y, z)
    = origin + (i, j, k); origin's coordinates are multiples of 8 (leaf
    aligned). `active_threshold`: voxels above it are active, the rest
    inactive (None: all active). A block of 8³ active voxels of one value
    is written as a tile, a block of inactive background not at all.
    compression: "none", "zip", "mask" (active values only) or "zip+mask"
    (OpenVDB's default without blosc)."""
    data = np.asarray(data_zyx, np.float32)
    if data.ndim != 3:
        raise ValueError(f"need [dz, dy, dx], got {data.shape}")
    if compression not in _COMPRESSION_NAMES:
        raise ValueError(f"compression={compression!r}; expected one of "
                         f"{tuple(_COMPRESSION_NAMES)}")
    if any(int(o) % _LEAF_DIM for o in origin):
        raise ValueError(f"origin {tuple(origin)} is not {_LEAF_DIM}-aligned")
    comp = _COMPRESSION_NAMES[compression]
    bg = np.float32(background)
    origin = tuple(int(o) for o in origin)
    active = (np.ones(data.shape, bool) if active_threshold is None
              else data > active_threshold)
    leaves, tiles = _blocks(data, active, origin, bg)

    # the tree: root children (32³ nodes) by coordinate, as RootNode's
    # std::map orders them; each node's children by offset
    l1 = {}
    for key in list(leaves) + list(tiles):
        l2o = _node_origin(key, _L2_SPAN)
        l1.setdefault(_node_origin(l2o, _L1_SPAN), {}).setdefault(l2o, [])
        l1[_node_origin(l2o, _L1_SPAN)][l2o].append(key)

    def offset(xyz, node_origin, child_span, log2):
        x, y, z = ((c - o) // child_span for c, o in zip(xyz, node_origin))
        return (x << (2 * log2)) | (y << log2) | z

    if active.any():
        az, ay, ax = np.nonzero(active)
        bb_min = (origin[0] + int(ax.min()), origin[1] + int(ay.min()),
                  origin[2] + int(az.min()))
        bb_max = (origin[0] + int(ax.max()), origin[1] + int(ay.max()),
                  origin[2] + int(az.max()))
    else:
        bb_min, bb_max = (0, 0, 0), (-1, -1, -1)
    names = {COMPRESS_NONE: "none", COMPRESS_ZIP: "zip",
             COMPRESS_ACTIVE_MASK: "active values",
             COMPRESS_ZIP | COMPRESS_ACTIVE_MASK: "zip + active values"}
    metas = [("class", "string", b"fog volume"),
             ("file_bbox_max", "vec3i", struct.pack("<3i", *bb_max)),
             ("file_bbox_min", "vec3i", struct.pack("<3i", *bb_min)),
             ("file_compression", "string", names[comp].encode()),
             ("file_voxel_count", "int64", struct.pack(
                 "<q", int(active.sum()))),
             ("is_saved_as_half_float", "bool", b"\x00"),
             ("name", "string", name.encode())]

    w = _W()
    w.pack("<qIII", MAGIC, _WRITE_VERSION, 11, 0)
    w.pack("<B", 1)  # hasGridOffsets
    w.raw(str(_uuid.uuid4()).encode("ascii"))
    w.pack("<I", 0)  # the file's MetaMap
    w.pack("<i", 1)  # grid count
    w.string(name)
    w.string("Tree_float_5_4_3")
    w.string("")  # instance parent
    offsets_at = w.buf.tell()
    w.pack("<3q", 0, 0, 0)
    grid_pos = w.buf.tell()
    w.pack("<I", comp)
    w.pack("<I", len(metas))
    for mname, mtype, mval in metas:
        w.string(mname)
        w.string(mtype)
        w.pack("<I", len(mval))
        w.raw(mval)
    w.string("UniformScaleMap")
    vs = float(voxel_size)
    for vec in ((vs,) * 3, (vs,) * 3, (1.0 / vs,) * 3, (1.0 / vs ** 2,) * 3,
                (0.5 / vs,) * 3):
        w.pack("<3d", *vec)
    # topology
    w.pack("<i", 1)  # buffer count
    w.pack("<f", bg)
    w.pack("<II", 0, len(l1))  # no root tiles
    order = []  # leaves in topology order
    no_child = np.zeros(_LEAF_SIZE, bool)
    for o1 in sorted(l1):
        w.pack("<3i", *o1)
        n1 = 1 << (3 * _L1_LOG2)
        cm = np.zeros(n1, bool)
        for o2 in l1[o1]:
            cm[offset(o2, o1, _L2_SPAN, _L1_LOG2)] = True
        vm = np.zeros(n1, bool)
        w.mask(cm)
        w.mask(vm)
        # a child slot's value is written as zero (writeTopology)
        _write_values(w, np.where(cm, np.float32(0), bg), vm, cm, bg, comp)
        for o2 in sorted(l1[o1], key=lambda o: offset(o, o1, _L2_SPAN,
                                                      _L1_LOG2)):
            n2 = 1 << (3 * _L2_LOG2)
            kids = {offset(k, o2, _LEAF_DIM, _L2_LOG2): k for k in l1[o1][o2]}
            cm2 = np.zeros(n2, bool)
            vm2 = np.zeros(n2, bool)
            v2 = np.full(n2, bg, np.float32)
            for off, k in kids.items():
                if k in tiles:
                    vm2[off] = True
                    v2[off] = tiles[k]
                else:
                    cm2[off] = True
                    v2[off] = 0.0
            w.mask(cm2)
            w.mask(vm2)
            _write_values(w, v2, vm2, cm2, bg, comp)
            for off in sorted(kids):
                if cm2[off]:
                    w.mask(leaves[kids[off]][1])  # a leaf's topology
                    order.append(leaves[kids[off]])
    block_pos = w.buf.tell()
    for vals, msk in order:  # LeafNode::writeBuffers
        w.mask(msk)
        _write_values(w, vals, msk, no_child, bg, comp)
    end_pos = w.buf.tell()
    raw = bytearray(w.buf.getvalue())
    raw[offsets_at:offsets_at + 24] = struct.pack("<3q", grid_pos, block_pos,
                                                  end_pos)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(raw)
    os.replace(tmp, path)
