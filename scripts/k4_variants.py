#!/usr/bin/env python3
"""Time designs of the hash-grid backward scatter (K4) on one card, in one
process, against the package's kernel and `index_add_`.

    python3 scripts/k4_variants.py      (from the repository root)

Builds scripts/k4_variants.cu (the package's csrc/hash_encode.cu plus the
designs it does not ship) with the package's nvcc flags, then on the 2^14
and 2^19 layouts of the reference schema at B = 2^16, F = 8, bf16
cotangents (chip_smoke.hash_inputs, as a training step runs K4): each
design's result against the plain index_add_ at chip_smoke's tolerances,
and its device time (torch.profiler: its kernel and the zeroing of the
table). Also from the data: the share of a warp instruction's rows that
repeat within it (what warp aggregation could save) and the adds per
distinct row of each level (contention). One JSON line per layout, then
the card's name and power limit as nvidia-smi prints them.
"""
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"scalar": 0, "pair_v4": 1}


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build():
    from instantvnr_torch.ops import cuda_lib

    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    out = os.path.join(cuda_lib.BUILD_DIR, "libk4_variants.so")
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o",
                    out, os.path.join(REPO, "scripts", "k4_variants.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.k4_variant_backward.argtypes = [p, p, p, ll, i, i, p, p, i, i, p]
    lib.k4_variant_backward.restype = ctypes.c_int
    return lib


def warp_repeats(torch, idx, spec):
    """Share of rows that repeat within one warp instruction of the
    package's scatter: 16 (sample, level) pairs, consecutive in
    sample · L + level, at one corner."""
    rows = idx.reshape(-1, 8)  # [B·L, 8]: row of pair t at each corner
    rows = rows[: rows.shape[0] // 16 * 16].reshape(-1, 16, 8)
    srt = torch.sort(rows, dim=1).values
    return float((srt[:, 1:] == srt[:, :-1]).float().sum() / rows.numel())


def main():
    import torch

    sys.path.insert(0, REPO)
    cs = chip_smoke()
    from instantvnr_torch.ops import hash_encoding as he

    lib = build()
    bf16 = torch.bfloat16
    for log2 in (14, 19):
        spec, _, coords, g = cs.hash_inputs(torch, log2)
        n = spec.n_entries
        ref = he._plain_backward(n, coords, spec, g, bf16)
        _, scales, levels = he._kernel_args(None, coords, spec, bf16)
        gc = g.contiguous()

        def variant(v):
            grad = torch.zeros((n, spec.n_features), device="cuda")
            rc = lib.k4_variant_backward(
                coords.data_ptr(), gc.data_ptr(), grad.data_ptr(),
                coords.shape[0], spec.n_levels, spec.n_features,
                scales.ctypes.data, levels.ctypes.data, 1,
                v, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"k4_variant_backward({v}): error {rc}")
            return grad

        idx, w = he.corner_indices_and_weights(spec, coords)
        contrib = (g.float().reshape(-1, spec.n_levels, 1, spec.n_features)
                   * w.reshape(-1, spec.n_levels, 8, 1)
                   ).reshape(-1, spec.n_features)
        flat = idx.reshape(-1)
        runs = {name: (lambda v=v: variant(v), ("k4_per_pair_kernel",
                                                "FillFunctor"))
                for name, v in VARIANTS.items()}
        runs["rows (package)"] = (
            lambda: he._kernel_backward(n, coords, spec, g, bf16),
            cs.K4_KERNELS)
        rec = {"layout": f"2^{log2}", "batch": coords.shape[0],
               "features": spec.n_features}
        for name, (fn, pattern) in runs.items():
            got = fn()
            torch.cuda.synchronize()
            err = (got - ref).abs()
            ok = bool(err.le(cs.HASH_BWD_ATOL
                             + cs.HASH_BWD_RTOL * ref.abs()).all())
            rec[name] = {"ms": cs.device_ms(torch, fn, pattern),
                         "max_abs_err": float(err.max()), "ok": ok}
        rec["index_add_ms"] = cs.device_ms(
            torch, lambda: torch.zeros((n, spec.n_features), device="cuda"
                                       ).index_add_(0, flat, contrib), ("",))
        rec["warp_row_repeat_share"] = warp_repeats(torch, idx, spec)
        per_level = idx.reshape(-1, spec.n_levels, 8)
        rec["adds_per_distinct_row"] = [
            float(per_level[:, lvl].numel()
                  / torch.unique(per_level[:, lvl]).numel())
            for lvl in range(spec.n_levels)]
        print(json.dumps(rec), flush=True)
        if not all(rec[name]["ok"] for name in runs):
            raise AssertionError(f"a K4 design disagrees: {rec}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
