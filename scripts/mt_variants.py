#!/usr/bin/env python3
"""Time designs of marching tetrahedra (mt_count / mt_emit) on one card, in
one process, against the package's kernels and the function's bound.

    python3 scripts/mt_variants.py      (from the repository root)

Builds scripts/mt_variants.cu (the package's csrc/isosurface.cu plus the
designs it does not ship) with the package's nvcc flags, then on two
33-plane slabs of a 128³ grid: chip_smoke.py's (vorts 128³ at its median,
the planes 0-32) and a dense one (uniform noise from the seed at 0.5, a
surface in most cells, as a random-weight decode gives). For designs of
mt_variants.cu (bit 1 32-bit cell arithmetic, 2 the tables in shared
memory and the corners in registers, 4 the folded scan, 8 one thread a
triangle, 16 the packed cases handed from mt_count to mt_emit): the
previous design (0), each change alone, the package's (31) and the
package's without each change, a slab's extraction as the wrapper runs
it (count, the cumulative sum or the workspace's zeroing, the host read
of the total, emit): the device time
of all its kernels and of each pass apart (torch.profiler), the call by
CUDA events, and whether tris and ids equal the plain version's bit for
bit; beside them the package's wrapper (`ops/isosurface.py::
extract_slab`), and the bound (chip_smoke's: the slab read once, 84 B a
live triangle written).

One JSON line per slab, then the card's name and power limit as
nvidia-smi prints them. Needs one card; fails if a design misses the
plain version.
"""
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
from emit_variants import build, chip_smoke  # noqa: E402

BITS = ((1, "int32"), (2, "tables"), (4, "fold"), (8, "per_triangle"),
        (16, "cases"))
ALL = 31
TIMED = (0, *(b for b, _ in BITS), ALL, *(ALL ^ b for b, _ in BITS))


def name_of(v):
    if v == 0:
        return "previous"
    if v == ALL:
        return "all"
    if v.bit_count() == 4:
        return "all_but_" + next(n for b, n in BITS if not v & b)
    return "+".join(n for b, n in BITS if v & b)


def main():
    import torch

    sys.path.insert(0, REPO)
    cs = chip_smoke()
    from instantvnr_torch.data.volume import synthetic_volume
    from instantvnr_torch.ops import isosurface as mt

    lib = build("mt_variants")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mt_variant_count.argtypes = [p, f, i, i, i, p, p, p, i]
    lib.mt_variant_emit.argtypes = [p, f, i, i, i, i, p, p, p, p, p, i]
    lib.mt_variant_count.restype = lib.mt_variant_emit.restype = i
    vol = synthetic_volume(cs.DIMS, "vorts", device="cuda").data
    noise = torch.from_numpy(np.random.default_rng(cs.SEED).random(
        (33,) + cs.DIMS[1:], dtype=np.float32)).cuda()
    stream = torch.cuda.current_stream().cuda_stream
    ok = True
    for name, g, iso in (("vorts 128^3 planes 0-32", vol[:33].contiguous(),
                          float(vol.median())),
                         ("noise 33x128x128", noise, 0.5)):
        sz, sy, sx = g.shape
        n = (sz - 1) * (sy - 1) * (sx - 1)
        blocks = -(-n // 256)
        iso = float(np.float32(iso))

        def extract(v):
            cases = torch.empty(n, dtype=torch.int32, device="cuda")
            if v & 4:
                ends = torch.zeros(1 + blocks, dtype=torch.int64,
                                   device="cuda")
                rc = lib.mt_variant_count(g.data_ptr(), iso, sz, sy, sx,
                                          ends.data_ptr(), cases.data_ptr(),
                                          stream, v)
                k = int(ends[0]) if rc == 0 else 0
            else:
                counts = torch.empty(n, dtype=torch.int32, device="cuda")
                rc = lib.mt_variant_count(g.data_ptr(), iso, sz, sy, sx,
                                          counts.data_ptr(),
                                          cases.data_ptr(), stream, v)
                ends = torch.cumsum(counts, 0, dtype=torch.int64)
                k = int(ends[-1]) if rc == 0 else 0
            if rc:
                raise RuntimeError(f"mt_variant_count({v}): error {rc}")
            tris = torch.empty((k, 3, 3), device="cuda")
            ids = torch.empty((k, 3, 4), dtype=torch.int32, device="cuda")
            rc = lib.mt_variant_emit(g.data_ptr(), iso, 0, sz, sy, sx,
                                     ends.data_ptr(), cases.data_ptr(),
                                     tris.data_ptr(), ids.data_ptr(), stream,
                                     v)
            if rc:
                raise RuntimeError(f"mt_variant_emit({v}): error {rc}")
            return tris, ids

        pt, pi = cs.mt_plain(g, iso, 0)
        k = int(pt.shape[0])
        b_ms, b_by = cs.bound_ms(cs.nbytes(g) + 84 * k, 0,
                                 cs.H100_FP32_FLOPS)
        rec = {"slab": name, "cells": n, "isovalue": iso,
               "live_triangles": k, "bound_ms": b_ms, "bound_by": b_by}
        for v in TIMED:
            tris, ids = extract(v)
            torch.cuda.synchronize()
            same = (cs.bits_equal(torch, tris, pt)
                    and cs.bits_equal(torch, ids, pi))
            run = lambda v=v: extract(v)  # noqa: E731
            rec[name_of(v)] = {
                "variant": v, "device_ms": cs.device_ms(torch, run, ("",)),
                "count_ms": cs.device_ms(torch, run, ("mtv_count",)),
                "emit_ms": cs.device_ms(torch, run, ("mtv_emit",)),
                "call_ms": cs.cuda_ms(torch, run), "same_bits": same}
            ok &= same
        tris, ids = mt.extract_slab(g, iso, 0)
        same = cs.bits_equal(torch, tris, pt) and cs.bits_equal(torch, ids,
                                                                 pi)
        run = lambda: mt.extract_slab(g, iso, 0)  # noqa: E731
        rec["package"] = {
            "device_ms": cs.device_ms(torch, run, ("",)),
            "kernels_ms": cs.device_ms(torch, run, ("mt_count", "mt_emit")),
            "call_ms": cs.cuda_ms(torch, run), "same_bits": same}
        ok &= same
        rec["package_kernels_over_bound"] = (rec["package"]["kernels_ms"]
                                             / b_ms)
        print(json.dumps(rec), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if not ok:
        raise AssertionError("a marching-tetrahedra design misses the plain "
                             "version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
