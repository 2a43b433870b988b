"""OpenVDB files (data/vdb.py) in real OpenVDB's layout, on the CPU (ROADMAP
Queue 1 item 5).

The fixture is built here byte by byte from OpenVDB's layout
(io/Archive.cc writeHeader and writeGrid, io/GridDescriptor.cc,
io/Compression.h writeCompressedValues and MaskCompress,
tree/RootNode.h, tree/InternalNode.h and tree/LeafNode.h writeTopology
and writeBuffers): a FloatGrid of three leaves (two fully active, one half
active), an active tile, the background 0, an active bounding box that
the metadata states, file version 224 (also 222), no ZIP. Nothing is
downloaded. The oracle is the numpy array the fixture is built from; the
reads and `write_vdb`'s bytes are held to it exactly.

The JAX package's reader and writer share three departures from that
layout (ROADMAP Queue 3, "not reproduced"): a header compression field at
version ≥ 222, per-grid compression only from 223, and no value mask
before a leaf's values. So neither package reads the other's files, which
the last tests pin.
"""
import os
import struct
import uuid

import numpy as np
import pytest

from instantvnr_tpu.data import vdb as jvdb
from instantvnr_torch import api
from instantvnr_torch.apps import vnr_cmd_render, vnr_cmd_train
from instantvnr_torch.data import vdb

ORIGIN = (8, 0, 0)  # index (x, y, z) of data[0, 0, 0]
VOXEL = 0.5
UUID = b"0f8fad5b-d9cb-469f-a165-70867728950e"
MASK_COMPRESSION = 2  # COMPRESS_ACTIVE_MASK


def _oracle() -> np.ndarray:
    """[z, y, x] 16³ at ORIGIN: leaf blocks (8, 0, 0) and (8, 0, 8) fully
    active, (16, 0, 0) about half active (the rest 0, the background), the
    block (8, 8, 0) one active value (a tile), the others empty."""
    rng = np.random.default_rng(12)
    d = np.zeros((16, 16, 16), np.float32)
    d[:8, :8, :8] = rng.uniform(0.1, 1.0, (8, 8, 8))
    half = rng.uniform(0.1, 1.0, (8, 8, 8)).astype(np.float32)
    half[rng.random((8, 8, 8)) < 0.5] = 0.0
    half[7, 7, 7] = 0.9  # the bbox's far corner is active
    d[:8, :8, 8:] = half
    d[:8, 8:, :8] = 0.5
    d[8:, :8, :8] = rng.uniform(0.1, 1.0, (8, 8, 8))
    return d


def _s(b: bytes) -> bytes:  # writeString: uint32 length, the bytes
    return struct.pack("<I", len(b)) + b


def _mask(bits) -> bytes:  # NodeMask::save: little-endian uint64 words
    return np.packbits(np.asarray(bits, np.uint8), bitorder="little"
                       ).tobytes()


def _leaf(d, x0, y0, z0):
    """A leaf's values and value mask in offset order (x << 6 | y << 3 |
    z, local coordinates)."""
    ox, oy, oz = ORIGIN
    blk = d[z0 - oz:z0 - oz + 8, y0 - oy:y0 - oy + 8, x0 - ox:x0 - ox + 8]
    vals = blk.transpose(2, 1, 0).reshape(-1).astype("<f4")
    return vals, vals > 0


def _fixture(version=224, compression=MASK_COMPRESSION,
             bbox_meta=True) -> bytes:
    d = _oracle()
    masked = compression & MASK_COMPRESSION
    az, ay, ax = np.nonzero(d > 0)
    bb_min = (ORIGIN[0] + ax.min(), ORIGIN[1] + ay.min(), ORIGIN[2] + az.min())
    bb_max = (ORIGIN[0] + ax.max(), ORIGIN[1] + ay.max(), ORIGIN[2] + az.max())
    names = {0: b"none", 2: b"active values"}
    # MetaMap::writeMeta, sorted by name: name, type, uint32 size, value
    meta = [(b"class", b"string", b"fog volume"),
            (b"file_bbox_max", b"vec3i", struct.pack("<3i", *bb_max)),
            (b"file_bbox_min", b"vec3i", struct.pack("<3i", *bb_min)),
            (b"file_compression", b"string", names[compression]),
            (b"file_voxel_count", b"int64",
             struct.pack("<q", int((d > 0).sum()))),
            (b"is_saved_as_half_float", b"bool", b"\x00"),
            (b"name", b"string", b"density")]
    if not bbox_meta:
        meta = [m for m in meta if not m[0].startswith(b"file_bbox")]

    def values(vals, value_mask, child_mask):
        """writeCompressedValues: with active-mask compression every
        inactive, non-child value here is the background 0 (MaskCompress:
        NO_MASK_OR_INACTIVE_VALS, code 0) and only the active values are
        stored; without it code 6 and all values. No ZIP: raw floats."""
        if not masked:
            return b"\x06" + np.asarray(vals, "<f4").tobytes()
        inactive = np.asarray(vals)[~value_mask & ~child_mask]
        assert (inactive == 0).all()
        return b"\x00" + np.asarray(vals, "<f4")[value_mask].tobytes()

    grid = struct.pack("<I", compression)  # per-grid compression, ≥ 222
    grid += struct.pack("<I", len(meta)) + b"".join(
        _s(n) + _s(t) + struct.pack("<I", len(v)) + v for n, t, v in meta)
    # Transform: UniformScaleMap (ScaleMap::write: scale, voxel size,
    # inverse scale, inverse scale squared, inverse twice scale)
    grid += _s(b"UniformScaleMap") + b"".join(
        struct.pack("<3d", v, v, v) for v in (VOXEL, VOXEL, 1 / VOXEL,
                                              1 / VOXEL ** 2, 0.5 / VOXEL))
    # Tree::writeTopology: buffer count; RootNode: background, tile and
    # child counts, then the one child, the 32³ node at (0, 0, 0)
    grid += struct.pack("<ifII", 1, 0.0, 0, 1) + struct.pack("<3i", 0, 0, 0)
    l1_child = np.zeros(32 ** 3, bool)
    l1_child[0] = True  # the 16³ node at (0, 0, 0)
    grid += _mask(l1_child) + _mask(np.zeros(32 ** 3, bool))
    grid += values(np.zeros(32 ** 3, np.float32), np.zeros(32 ** 3, bool),
                   l1_child)
    # the 16³ node: children at offset (x/8 << 8 | y/8 << 4 | z/8)
    leaves = {256: (8, 0, 0), 257: (8, 0, 8), 512: (16, 0, 0)}
    tile = 272  # (8, 8, 0)
    l2_child = np.zeros(16 ** 3, bool)
    l2_child[list(leaves)] = True
    l2_value = np.zeros(16 ** 3, bool)
    l2_value[tile] = True
    l2_vals = np.zeros(16 ** 3, np.float32)
    l2_vals[tile] = 0.5
    grid += _mask(l2_child) + _mask(l2_value)
    grid += values(l2_vals, l2_value, l2_child)
    for off in sorted(leaves):  # LeafNode::writeTopology: the value mask
        grid += _mask(_leaf(d, *leaves[off])[1])
    buffers = b""
    for off in sorted(leaves):  # LeafNode::writeBuffers: mask, values
        vals, msk = _leaf(d, *leaves[off])
        buffers += _mask(msk) + values(vals, msk, np.zeros(512, bool))

    head = struct.pack("<qIII", 0x56444220, version, 11, 0) + b"\x01" + UUID
    head += struct.pack("<I", 0)  # the file's MetaMap
    head += struct.pack("<i", 1)  # grid count
    head += _s(b"density") + _s(b"Tree_float_5_4_3") + _s(b"")
    grid_pos = len(head) + 24
    block_pos = grid_pos + len(grid)
    end_pos = block_pos + len(buffers)
    return (head + struct.pack("<3q", grid_pos, block_pos, end_pos) + grid
            + buffers)


def _write(tmp_path, name, raw):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(raw)
    return path


@pytest.mark.parametrize("version,compression", [(224, MASK_COMPRESSION),
                                                 (222, MASK_COMPRESSION),
                                                 (224, 0)])
def test_fixture_reads_to_its_array(tmp_path, version, compression):
    path = _write(tmp_path, "f.vdb", _fixture(version, compression))
    dense, info = vdb.read_vdb(path)
    np.testing.assert_array_equal(dense, _oracle())
    assert info.name == "density" and info.grid_type == "Tree_float_5_4_3"
    assert info.file_version == version and info.background == 0.0
    assert info.bbox_min == ORIGIN and info.bbox_max == (23, 15, 15)
    assert info.voxel_size == (VOXEL,) * 3 and info.grid_class == "fog volume"
    assert info.meta["file_voxel_count"] == int((_oracle() > 0).sum())
    # without the metadata's bbox the reader computes the same one from the
    # active voxels and tiles
    path = _write(tmp_path, "g.vdb", _fixture(version, compression,
                                             bbox_meta=False))
    dense, info = vdb.read_vdb(path)
    assert "file_bbox_min" not in info.meta
    assert info.bbox_min == ORIGIN and info.bbox_max == (23, 15, 15)
    np.testing.assert_array_equal(dense, _oracle())


def test_write_vdb_bytes_equal_the_fixture(tmp_path):
    """write_vdb of the oracle writes the fixture byte for byte, but for
    the uuid, which it draws anew."""
    want = _fixture()
    path = str(tmp_path / "w.vdb")
    vdb.write_vdb(path, _oracle(), name="density", compression="mask",
                  origin=ORIGIN, voxel_size=VOXEL, active_threshold=0.0)
    with open(path, "rb") as f:
        got = f.read()
    assert len(got) == len(want)
    at = want.index(UUID)
    uuid.UUID(got[at:at + 36].decode("ascii"))
    assert got[:at] + got[at + 36:] == want[:at] + want[at + 36:]


@pytest.mark.parametrize("compression", ["none", "zip", "mask", "zip+mask"])
def test_write_read_round_trip(tmp_path, compression):
    """Other data, origins and backgrounds through every compression:
    inactive values of their own (the two-inactive-values and all-values
    layout codes), a negative origin, several 16³ nodes."""
    rng = np.random.default_rng(3)
    data = rng.uniform(-1, 1, (20, 9, 300)).astype(np.float32)
    data[:, :, :100] = 0.25  # constant blocks: tiles
    path = str(tmp_path / "r.vdb")
    vdb.write_vdb(path, data, compression=compression, origin=(-136, 8, -16),
                  background=0.25, active_threshold=-0.5)
    dense, info = vdb.read_vdb(path)
    az, ay, ax = np.nonzero(data > -0.5)
    assert info.bbox_min == (-136 + ax.min(), 8 + ay.min(), -16 + az.min())
    sub = data[az.min():az.max() + 1, ay.min():ay.max() + 1,
               ax.min():ax.max() + 1]
    np.testing.assert_array_equal(dense, sub)


def test_two_grids_and_grid_choice(tmp_path):
    """Archive::write puts each grid right after its descriptor; a reader
    takes the next descriptor at the grid's end offset."""
    one = _fixture()
    raw = bytearray(one)
    # a second grid, the same bytes under a name of the same length after
    # the first, its offsets moved
    head_len = one.index(b"Tree_float_5_4_3") + len(b"Tree_float_5_4_3") + 4
    desc_at = one.index(_s(b"density"))
    grid_pos, block_pos, end_pos = struct.unpack("<3q", one[head_len:
                                                             head_len + 24])
    second = bytearray(one[desc_at:end_pos])
    second[:len(_s(b"density"))] = _s(b"smoke02")
    shift = end_pos - desc_at
    off = head_len - desc_at
    second[off:off + 24] = struct.pack("<3q", grid_pos + shift,
                                       block_pos + shift, end_pos + shift)
    at = raw.index(struct.pack("<i", 1) + _s(b"density"))
    raw[at:at + 4] = struct.pack("<i", 2)
    path = _write(tmp_path, "two.vdb", bytes(raw) + bytes(second))
    grids = vdb.read_vdb_grids(path)
    assert [g.name for g, _ in grids] == ["density", "smoke02"]
    for _, dense in grids:
        np.testing.assert_array_equal(dense, _oracle())
    assert vdb.read_vdb(path)[1].name == "density"
    assert vdb.read_vdb(path, grid="smoke02")[1].name == "smoke02"
    with pytest.raises(vdb.VdbError, match="no grid named"):
        vdb.read_vdb(path, grid="nope")


def test_vdb_to_volume_and_simple_volume(tmp_path):
    path = _write(tmp_path, "f.vdb", _fixture())
    vol = vdb.vdb_to_volume(path, device="cpu")
    assert vol.dims == (16, 16, 16) and vol.original_range[0] == 0.0
    d = _oracle()
    np.testing.assert_allclose(vol.data.numpy(), d / d.max(), rtol=1e-6)
    simple = api.SimpleVolume(vol, device="cpu")
    assert simple.dims == (16, 16, 16)
    assert float(simple.macrocell.value_hi.max()) == pytest.approx(1.0)


def test_cli_trains_and_renders_a_vdb(tmp_path):
    """--volume x.vdb through vnr_cmd_train (in core, then out of core
    from a sidecar keyed on the grid's name and the file's size and mtime)
    and vnr_cmd_render."""
    path = _write(tmp_path, "f.vdb", _fixture())
    model = ["--model", str(tmp_path / "m.json")]
    with open(model[1], "w") as f:
        f.write('{"encoding": {"otype": "HashGrid", "n_levels": 2, '
                '"n_features_per_level": 2, "log2_hashmap_size": 10, '
                '"base_resolution": 8}, "network": {"otype": '
                '"FullyFusedMLP", "n_neurons": 16, "n_hidden_layers": 2}}')
    common = ["--volume", path, "--device", "cpu", "--batch", "1024",
              "--max-num-steps", "20"] + model
    nv = vnr_cmd_train.main(common + ["--save", str(tmp_path / "p.npz")])
    assert nv.dims == (16, 16, 16) and nv.step == 20
    nv = vnr_cmd_train.main(common + ["--sampling-mode", "out-of-core",
                                      "--save", str(tmp_path / "q.npz")])
    assert nv.step == 20
    st = os.stat(path)
    sidecar = f"{path}.density.{st.st_size}.{st.st_mtime_ns}.raw"
    np.testing.assert_array_equal(
        np.fromfile(sidecar, np.float32).reshape(16, 16, 16), _oracle())
    # a rewritten file of the same size gets a sidecar of its own
    d = _oracle()
    d[0, 0, 0] = 0.75
    vdb.write_vdb(path, d, compression="mask", origin=ORIGIN,
                  voxel_size=VOXEL, active_threshold=0.0)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    st2 = os.stat(path)
    assert st2.st_size == st.st_size
    desc = vnr_cmd_train.vdb_sidecar(path, None)
    assert desc.filename != sidecar
    assert np.fromfile(desc.filename, np.float32)[0] == np.float32(0.75)
    frame = vnr_cmd_render.main(["--volume", path, "--device", "cpu",
                                 "--mode", "reference", "--size", "16",
                                 "--num-frames", "1", "--warmup", "0",
                                 "--output", str(tmp_path / "f.png")])
    assert frame[..., 3].max() > 0.05


def test_reference_faults_not_reproduced(tmp_path):
    """The real layout has no header compression field at version 224 (the
    uuid follows hasGridOffsets), the grid's own compression flags from 222
    and the value mask before each leaf's values. The JAX package's reader
    refuses such a file; the port's refuses the JAX package's writer's."""
    raw = _fixture()
    assert raw[21:57] == UUID  # magic, version, library, hasGridOffsets
    grid_pos, block_pos, _ = struct.unpack("<3q", raw[
        raw.index(b"Tree_float_5_4_3") + 20:][:24])
    assert struct.unpack("<I", raw[grid_pos:grid_pos + 4])[0] == \
        MASK_COMPRESSION
    first_leaf_mask = _mask(_leaf(_oracle(), 8, 0, 0)[1])
    assert raw[block_pos:block_pos + 64] == first_leaf_mask
    path = _write(tmp_path, "real.vdb", raw)
    with pytest.raises(jvdb.VdbError):
        jvdb.read_vdb(path)
    jpath = str(tmp_path / "jax.vdb")
    jvdb.write_vdb(jpath, _oracle(), compression="none")
    with pytest.raises(vdb.VdbError):
        vdb.read_vdb(jpath)
