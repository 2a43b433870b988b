"""Build and load the package's CUDA kernels.

Every `csrc/*.cu` is compiled with `nvcc` for `sm_90a` into one shared
library with a plain C interface, loaded with `ctypes` (no PyTorch headers,
so a build takes seconds). The sources compile in parallel, one `nvcc` per
file, and link into `instantvnr_torch/_build/libinstantvnr_torch_<key>.so`,
where the key hashes the sources and flags: a checkout builds at first use
and reuses the library afterwards.

Nothing here runs at import time; the kernel wrappers call
`load_library()` only when they are given CUDA tensors.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# -fmad=false: a*b+c stays two IEEE operations, as in the plain PyTorch
# versions (explicit fmaf calls are FMAs either way)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry points: name → argtypes; each returns cudaGetLastError() as int
SIGNATURES = {
    # x, w, y, B, n_in, width, n_hidden, n_out, act, out_act, count,
    # offset, stream
    "fused_mlp_forward": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P, _L,
                          _P),
    # x, w, z_out, zs, B, n_in, width, n_hidden, n_out, act, stream
    "fused_mlp_train_forward": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P),
    # x, w, zs, z_out, g, dx, dx_bf16, partials, dw, B, n_in, width,
    # n_hidden, n_out, act, out_act, stream
    "fused_mlp_backward": (_P, _P, _P, _P, _P, _P, _I, _P, _P, _L, _I, _I,
                           _I, _I, _I, _I, _P),
    # table, coords, out, B, L, F, scales, levels, table_bf16, out_bf16,
    # paired, count, offset, stream
    "hash_encode_forward": (_P, _P, _P, _L, _I, _I, _P, _P, _I, _I, _I, _P,
                            _L, _P),
    # coords, g, grad, B, L, F, scales, levels, g_bf16, stream
    "hash_encode_backward": (_P, _P, _P, _L, _I, _I, _P, _P, _I, _I, _P),
    # table, coords, g, grad_coords, B, L, F, scales, levels, table_bf16,
    # g_bf16, paired, stream
    "hash_encode_coords_backward": (_P, _P, _P, _P, _L, _I, _I, _P, _P, _I,
                                    _I, _I, _P),
    # vol, jy, wy, jx, wx, covy, covx, corr, ctrl, kc, lut, n_lut, out,
    # D, ay, ax, hi, wi, term_thresh, stream
    "slab_composite_forward": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                               _I, _P, _I, _I, _I, _I, _I, _F, _P),
    # fields, C, shadow, jy, wy, jx, wx, covy, covx, corr, x_src, y_src, zw,
    # ctrl, kc, lut, n_lut, misc, p0, p1, p2, out, D, ay, ax, hi, wi,
    # term_thresh, stream
    "slab_composite_ext_forward": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _P, _P, _P, _I, _P, _I, _P, _I, _I,
                                   _I, _P, _I, _I, _I, _I, _I, _F, _P),
    # fields, jy, wy, jx, wx, covy, covx, iso, out, D, ay, ax, hi, wi,
    # stream
    "iso_sweep_forward": (_P, _P, _P, _P, _P, _P, _P, _F, _P, _I, _I, _I,
                          _I, _I, _P),
    # org, dirn, t_far, t, t_cell_end, ss, max_opacity, mx, my, mz,
    # base_step, rate_scale, R, K, max_skips, samples_per_slot, t_out,
    # tce_out, ss_out, t_x, t_y, valid, stream
    "raymarch_emit": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _L, _I,
                      _I, _I, _P, _P, _P, _P, _P, _P, _P),
    # org, dirn, t_far, t, t_cell_end, ss, max_opacity, mx, my, mz,
    # base_step, rate_scale, R, K, max_skips, samples_per_slot, g_t, g_tce,
    # g_ss, g_tx, g_ty, d_org, d_dirn, d_t_far, d_t, d_tce, d_ss, stream
    "raymarch_emit_backward": (_P,) * 7 + (_I, _I, _I, _F, _F, _L, _I, _I,
                                           _I) + (_P,) * 12,
    # lut, packed, is_half, p, n, dx, dy, dz, mx, my, mz, ss, out, count,
    # offset, stream
    "brick_sample": (_P, _P, _I, _P, _L, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                     _L, _P),
    # active, m, n_leaves, src, dst, row_bytes, copy_back, order, count, ws,
    # stream
    "compact_rows": (_P, _L, _I, _P, _P, _P, _I, _P, _P, _P, _P),
    # perm, m, n_leaves, src, dst, row_bytes, ws, stream
    "scatter_rows": (_P, _L, _I, _P, _P, _P, _P, _P),
    # org, dirn, t, t_far, tau, max_opacity, mx, my, mz, dx, dy, dz,
    # density_scale, cell_skips, R, new_t, new_tau, majorant, crosses,
    # exited, pos_obj, stream
    "pt_track": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _I, _L,
                 _P, _P, _P, _P, _P, _P, _P),
    # org, dirn, t_far, throughput, radiance, scatter_index, shadow, active,
    # new_t, new_tau, majorant, crosses, exited, values, u, ctrl, kc, lut,
    # n_lut, consts, density_scale, light_ambient, R, org_out, dir_out,
    # t_out, tfar_out, tau_out, thr_out, rad_out, si_out, shadow_out,
    # active_out, stream
    "pt_resolve": (_P,) * 16 + (_I, _P, _I, _P, _F, _F, _L) + (_P,) * 11,
    # grid, iso, sz, sy, sx, ws, cases, stream
    "mt_count": (_P, _F, _I, _I, _I, _P, _P, _P),
    # grid, iso, z_offset, sz, sy, sx, ws, cases, tris, ids, stream
    "mt_emit": (_P, _F, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    # table, n_leaves, lr, beta1, one_minus_beta1, beta2, one_minus_beta2,
    # c1, c2, epsilon, l2_reg, stream
    "adam_step": (_P, _I) + (_F,) * 9 + (_P,),
}


def count_ptr(count, device) -> int:
    """The address of a device-side row count: an int32 [1] tensor on
    `device` (the compacted wavefront's count of valid rows)."""
    import torch

    if (count.dtype != torch.int32 or count.device != device
            or count.numel() != 1):
        raise ValueError(f"a row count is int32 [1] on {device}, got "
                         f"{count.dtype} {tuple(count.shape)} on "
                         f"{count.device}")
    return count.data_ptr()


class LaunchCounter:
    """Plain-integer count of a wrapper's kernel launches: the wrapper adds
    one where it launches its kernel, and nowhere else. A replayed CUDA
    graph (render/compaction.py) adds the launches its capture recorded:
    `instances` lists every counter, in the order they were made."""

    instances: list = []

    def __init__(self):
        self.launches = 0
        LaunchCounter.instances.append(self)

    def reset(self):
        self.launches = 0


@dataclass
class Library:
    cdll: ctypes.CDLL
    path: str
    build_seconds: float  # 0.0 when an existing build was reused
    log: str  # nvcc/ptxas output of this process's build

    def call(self, name: str, *args):
        rc = getattr(self.cdll, name)(*args)
        if rc != 0:
            msg = self.cdll.error_string(rc).decode()
            raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build with the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run(cmd: list[str]) -> str:
    p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if p.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed\n{p.stdout}")
    return p.stdout


def _build(lib_path: str) -> str:
    """One nvcc per source, all started together (a single nvcc call
    compiles its inputs one after another), then one link."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as obj_dir:
        objs = [os.path.join(obj_dir, os.path.basename(s) + ".o")
                for s in _sources()]
        with ThreadPoolExecutor(len(objs)) as pool:
            logs = list(pool.map(
                lambda s, o: f"== {os.path.basename(s)}\n"
                + _run([nvcc, *NVCC_FLAGS, "-c", s, "-o", o]),
                _sources(), objs))
        tmp = os.path.join(obj_dir, "lib.so")
        _run([nvcc, "-shared", "-o", tmp, *objs])
        os.replace(tmp, lib_path)  # atomic: a concurrent build never sees half
    return "\n".join(logs)


@functools.lru_cache(maxsize=None)
def load_library() -> Library:
    """Build (if needed) and load the kernel library; cached per process."""
    key = source_key()
    lib_path = os.path.join(BUILD_DIR, f"libinstantvnr_torch_{key}.so")
    t0 = time.perf_counter()
    log = ""
    built = not os.path.exists(lib_path)
    if built:
        os.makedirs(BUILD_DIR, exist_ok=True)
        log = _build(lib_path)
    seconds = time.perf_counter() - t0 if built else 0.0
    cdll = ctypes.CDLL(lib_path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    cdll.error_string.argtypes = [ctypes.c_int]
    cdll.error_string.restype = ctypes.c_char_p
    return Library(cdll=cdll, path=lib_path, build_seconds=seconds, log=log)
