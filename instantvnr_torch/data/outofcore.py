"""Out-of-core training sampler for volumes that do not fit (counterpart of
`instantvnr_tpu/data/outofcore.py`).

The Python side of the native block loader `native/libvnr_loader.so`
(`native/vnr_loader.cpp`: the reference's StreamLoader/RandomBuffer,
resident random blocks refreshed by reader threads, trilinear batches
sampled on the host). The library is shared with the JAX package as it
is; this module keeps its own ctypes signatures for it. Without the
library, a numpy implementation of the same block geometry takes over,
unless the caller demands the native one (`use_native=True`).

`OutOfCoreSampler.sample` returns host arrays; `sample_into` writes a
batch into caller-owned host buffers (the pinned pair of
`models/trainer.py::train_out_of_core`).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import time

import numpy as np

from instantvnr_torch.config import VolumeDesc

_DTYPE_CODE = {
    "UNSIGNED_BYTE": 0, "BYTE": 1, "UNSIGNED_SHORT": 2, "SHORT": 3,
    "UNSIGNED_INT": 4, "INT": 5, "FLOAT": 6, "DOUBLE": 7,
}

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")

_ABI_VERSION = 4
_FP = ctypes.POINTER(ctypes.c_float)


def _load_native():
    so = os.path.join(_NATIVE_DIR, "libvnr_loader.so")
    try:
        # incremental make: a no-op when the library is current
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        if not os.path.exists(so):
            return None
    try:
        lib = ctypes.CDLL(so)
        if lib.vnr_loader_abi_version() != _ABI_VERSION:
            return None
    except (OSError, AttributeError):
        return None
    i64, c_int, f32 = ctypes.c_int64, ctypes.c_int, ctypes.c_float
    lib.vnr_loader_create.restype = ctypes.c_void_p
    lib.vnr_loader_create.argtypes = [
        ctypes.c_char_p, i64, i64, i64, c_int, c_int, i64, f32, f32, c_int,
        c_int, c_int, c_int, c_int, ctypes.c_uint64]
    lib.vnr_loader_sample.restype = c_int
    lib.vnr_loader_sample.argtypes = [ctypes.c_void_p, i64, ctypes.c_uint64,
                                      _FP, _FP]
    lib.vnr_loader_ready_blocks.restype = c_int
    lib.vnr_loader_ready_blocks.argtypes = [ctypes.c_void_p]
    lib.vnr_loader_loads.restype = i64
    lib.vnr_loader_loads.argtypes = [ctypes.c_void_p]
    lib.vnr_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.vnr_scan_minmax.restype = c_int
    lib.vnr_scan_minmax.argtypes = [ctypes.c_char_p, i64, i64, i64, c_int,
                                    c_int, i64, c_int, _FP]
    return lib


_LIB = None


def native_lib():
    global _LIB
    if _LIB is None:
        _LIB = _load_native() or False
    return _LIB or None


def default_n_resident(desc: VolumeDesc, block_y: int, block_z: int) -> int:
    """The resident set sized to a host-memory budget, the reference's
    policy (neural_sampler.cpp:1054-1061). `VNR_NUM_BLOCKS` sets the count,
    `VNR_OOC_MEM_MB` (default 1024) the budget; never more blocks than the
    volume has."""
    env = os.environ.get("VNR_NUM_BLOCKS")
    if env:
        return max(1, int(env))
    budget = int(os.environ.get("VNR_OOC_MEM_MB", "1024")) << 20
    block_bytes = (block_y + 1) * (block_z + 1) * desc.dims[0] * 4
    n_blocks_total = (
        -(-desc.dims[1] // block_y) * -(-desc.dims[2] // block_z))
    return int(np.clip(budget // max(block_bytes, 1), 8, n_blocks_total))


def scan_value_range(desc: VolumeDesc,
                     n_threads: int = 8) -> tuple[float, float]:
    """Global (min, max) of a raw volume file in data units (the range the
    reference computes at load when the scene has none,
    neural_sampler.cpp:251-264), in one streaming pass: threaded in the
    native library, chunked through a numpy memmap without it."""
    lib = native_lib()
    if lib is not None:
        out = (ctypes.c_float * 2)()
        dx, dy, dz = desc.dims
        if lib.vnr_scan_minmax(desc.filename.encode(), dx, dy, dz,
                               _DTYPE_CODE[desc.dtype],
                               int(bool(desc.bigendian)), desc.offset,
                               n_threads, out):
            return (float(out[0]), float(out[1]))
    mm = np.memmap(desc.filename, dtype=desc.np_dtype, mode="r",
                   offset=desc.offset, shape=(desc.n_voxels,))
    lo, hi = np.inf, -np.inf
    chunk = 4 << 20  # elements a pass: bounded host memory
    for i in range(0, desc.n_voxels, chunk):
        part = np.asarray(mm[i:i + chunk], np.float32)
        lo = min(lo, float(part.min()))
        hi = max(hi, float(part.max()))
    return (lo, hi)


class OutOfCoreSampler:
    """Streamed random-block sampler over a raw volume file.

    `value_range` (data units) maps values to clamp((v − lo)/(hi − lo), 0,
    1), the reference's convert_volume (neural_sampler.cpp:188-209). None
    takes the scene's `desc.value_range`, else a streaming min/max scan of
    the file: the range the in-core StaticSampler computes, so in-core and
    out-of-core training normalize alike."""

    def __init__(self, desc: VolumeDesc,
                 value_range: tuple[float, float] | None = None,
                 block_y: int = 32, block_z: int = 32,
                 n_resident: int | None = None,
                 n_threads: int = 4, use_native: bool | None = None,
                 seed: int = 1337, odirect: bool | None = None):
        self.desc = desc
        if value_range is None:
            value_range = desc.value_range
        if value_range is None:
            value_range = scan_value_range(desc)
        self.value_range = (float(value_range[0]), float(value_range[1]))
        self.block_y, self.block_z = block_y, block_z
        if n_resident is None:
            n_resident = default_n_resident(desc, block_y, block_z)
        self.n_resident = n_resident
        if odirect is None:
            odirect = os.environ.get("VNR_OOC_ODIRECT", "0") == "1"
        self._seed = seed
        self._counter = 0
        self._native = None
        lib = native_lib() if use_native in (None, True) else None
        if lib is not None:
            dx, dy, dz = desc.dims
            h = lib.vnr_loader_create(
                desc.filename.encode(), dx, dy, dz, _DTYPE_CODE[desc.dtype],
                int(bool(desc.bigendian)), desc.offset, self.value_range[0],
                self.value_range[1], block_y, block_z, n_resident, n_threads,
                int(odirect), seed)
            if h:
                self._native = (lib, ctypes.c_void_p(h))
        if self._native is None:
            if use_native is True:
                raise RuntimeError("native loader unavailable")
            self._mmap = np.memmap(desc.filename, dtype=desc.np_dtype,
                                   mode="r", offset=desc.offset,
                                   shape=(desc.dims[2], desc.dims[1],
                                          desc.dims[0]))
            self._rng = np.random.default_rng(seed)
            # the numpy resident set: a rotating pool of loaded blocks, one
            # refreshed a call (uniform over the resident set, as native)
            self._py_blocks: list = []
            self._py_pool = min(self.n_resident, 16)
            self._py_next = 0

    @property
    def is_native(self) -> bool:
        return self._native is not None

    def ready_blocks(self) -> int:
        if self._native:
            lib, h = self._native
            return lib.vnr_loader_ready_blocks(h)
        return self.n_resident

    def loads(self) -> int:
        """Blocks loaded so far (native; the numpy pool counts none)."""
        if self._native:
            lib, h = self._native
            return int(lib.vnr_loader_loads(h))
        return 0

    def wait_ready(self, min_blocks: int = 1, timeout: float = 60.0):
        t0 = time.time()
        while self.ready_blocks() < min_blocks:
            if time.time() - t0 > timeout:
                raise TimeoutError("loader produced no blocks")
            time.sleep(0.01)

    def sample(self, batch: int) -> tuple[np.ndarray, np.ndarray]:
        """→ (coords [B, 3] float32 in [0,1]³, values [B, 1] float32)."""
        coords = np.empty((max(batch, 0), 3), np.float32)
        values = np.empty((max(batch, 0), 1), np.float32)
        self.sample_into(coords, values)
        return coords, values

    def sample_into(self, coords: np.ndarray, values: np.ndarray) -> None:
        """One batch written into C-contiguous float32 host buffers,
        coords [B, 3] and values [B, 1] (B = len(coords)). The native call
        runs without the interpreter lock."""
        batch = len(coords)
        for name, a, width in (("coords", coords, 3), ("values", values, 1)):
            if (a.dtype != np.float32 or a.shape != (batch, width)
                    or not a.flags.c_contiguous or not a.flags.writeable):
                raise ValueError(f"{name}: expected a writable C-contiguous "
                                 f"float32 [{batch}, {width}] array, got "
                                 f"{a.dtype} {a.shape}")
        self._counter += 1
        if batch <= 0:
            return
        if self._native:
            lib, h = self._native
            while True:
                n = lib.vnr_loader_sample(
                    h, batch, self._seed * 2654435761 + self._counter,
                    coords.ctypes.data_as(_FP), values.ctypes.data_as(_FP))
                if n:  # 0: no block is ready yet
                    return
                self.wait_ready(1)
        c, v = self._sample_numpy(batch)
        coords[...] = c
        values[...] = v

    def _load_block_numpy(self):
        """One random block (with its +1 ghost rows) from the memmap."""
        dx, dy, dz = self.desc.dims
        rng = self._rng
        by0 = int(rng.integers(0, max((dy + self.block_y - 1)
                                      // self.block_y, 1)) * self.block_y)
        bz0 = int(rng.integers(0, max((dz + self.block_z - 1)
                                      // self.block_z, 1)) * self.block_z)
        ny = min(self.block_y + 1, dy - by0)
        nz = min(self.block_z + 1, dz - bz0)
        block = np.asarray(self._mmap[bz0:bz0 + nz, by0:by0 + ny, :],
                           np.float32)
        lo, hi = self.value_range
        if hi > lo:
            # saturate like the reference's convert_volume and the native
            # loader
            block = np.clip((block - lo) / (hi - lo), 0.0, 1.0)
        else:
            block = np.zeros_like(block)  # the native loader's scale = 0
        return (by0, bz0, ny, nz, block)

    def _sample_numpy(self, batch: int):
        """The block geometry of the native loader with synchronous memmap
        reads: a batch draws uniformly over the resident pool, one block
        refreshed a call (neural_sampler.cpp:1066-1120)."""
        dx, dy, dz = self.desc.dims
        rng = self._rng
        if len(self._py_blocks) < self._py_pool:
            self._py_blocks.append(self._load_block_numpy())
        else:
            self._py_blocks[self._py_next] = self._load_block_numpy()
            self._py_next = (self._py_next + 1) % self._py_pool
        k = len(self._py_blocks)
        pick = rng.integers(0, k, batch)
        coords = np.empty((batch, 3), np.float32)
        values = np.empty((batch,), np.float32)
        for bi in range(k):
            m = pick == bi
            n = int(m.sum())
            if n == 0:
                continue
            by0, bz0, ny, nz, block = self._py_blocks[bi]
            # the jitter spans the trilinear support (ny − 1 rows), as the
            # native loader's
            fx = rng.random(n, np.float32) * dx
            fy = rng.random(n, np.float32) * (ny - 1)
            fz = rng.random(n, np.float32) * (nz - 1)
            cx = np.clip(fx - 0.5, 0, dx - 1)
            x0 = cx.astype(np.int32)
            x1 = np.minimum(x0 + 1, dx - 1)
            wx = cx - x0
            y0 = np.minimum(fy.astype(np.int32), max(ny - 2, 0))
            wy = fy - y0
            z0 = np.minimum(fz.astype(np.int32), max(nz - 2, 0))
            wz = fz - z0
            y1 = np.minimum(y0 + 1, ny - 1)
            z1 = np.minimum(z0 + 1, nz - 1)
            c00 = block[z0, y0, x0] * (1 - wx) + block[z0, y0, x1] * wx
            c10 = block[z0, y1, x0] * (1 - wx) + block[z0, y1, x1] * wx
            c01 = block[z1, y0, x0] * (1 - wx) + block[z1, y0, x1] * wx
            c11 = block[z1, y1, x0] * (1 - wx) + block[z1, y1, x1] * wx
            c0 = c00 * (1 - wy) + c10 * wy
            c1 = c01 * (1 - wy) + c11 * wy
            values[m] = c0 * (1 - wz) + c1 * wz
            coords[m] = np.stack([(cx + 0.5) / dx, (by0 + fy + 0.5) / dy,
                                  (bz0 + fz + 0.5) / dz], axis=-1)
        return coords, values[:, None].astype(np.float32)

    def measure_throughput(self, batch: int = 1 << 16,
                           duration: float = 2.0) -> float:
        """Sustained host sampling rate in samples/s (the IO and
        interpolation stage alone)."""
        coords = np.empty((batch, 3), np.float32)
        values = np.empty((batch, 1), np.float32)
        self.sample_into(coords, values)  # warm: the first blocks
        n = 0
        t0 = time.time()
        while time.time() - t0 < duration:
            self.sample_into(coords, values)
            n += batch
        return n / (time.time() - t0)

    def close(self):
        if self._native:
            lib, h = self._native
            lib.vnr_loader_destroy(h)
            self._native = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
