#!/usr/bin/env python3
"""Time designs of the hash encoding's coordinate backward
(hash_encode_coords_backward) on one card, in one process, against the
package's kernel.

    python3 scripts/coords_variants.py      (from the repository root)

Builds scripts/coords_variants.cu (the package's csrc/hash_encode.cu plus
the designs it does not ship: level-major lanes, the coarse dense levels
from shared memory, two (sample, level) pairs a lane) with the package's
nvcc flags, then on the 2^19 schema (8 levels × 8 features, the f32 master
table seeded as chip_smoke.phase_hash_coords_grad seeds it), in the tcnn
and paired layouts and in f32 and bf16 compute, on two inputs: B = 2^16
uniform coords (the smoke's) and one sampling superstep's sample positions
of the differentiable march's 128² ray frame (chip_smoke.frame_positions:
coherent along rays). For each: every design's device time (torch.profiler)
twice, in turns (the package, each design, each design again in reverse,
the package), whether its output equals the package kernel's bit for bit,
its max abs error against the plain version (chip_smoke.HASH_COORDS_RTOL
of the largest entry), and the bytes bound (chip_smoke's: each distinct
row once, the coords, the cotangent and the gradient).

One JSON line per (input, layout, compute), then the card's name and power
limit as nvidia-smi prints them.
"""
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"level_major": (1, "coords_v_level_major"),
            "smem_dense": (2, "coords_v_smem_dense"),
            "two_a_lane": (3, "coords_v_two")}
PACKAGE = "hash_encode_coords_backward_kernel"


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build():
    from instantvnr_torch.ops import cuda_lib

    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    out = os.path.join(cuda_lib.BUILD_DIR, "libcoords_variants.so")
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o",
                    out, os.path.join(REPO, "scripts", "coords_variants.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.coords_variant.argtypes = [p, p, p, p, ll, i, p, p, i, i, i, p]
    lib.coords_variant.restype = ctypes.c_int
    return lib


def main():
    import torch

    sys.path.insert(0, REPO)
    cs = chip_smoke()
    from instantvnr_torch import api
    from instantvnr_torch.config import EncodingConfig
    from instantvnr_torch.ops import hash_encoding as he

    torch.backends.cuda.matmul.allow_tf32 = False
    lib = build()
    stream = torch.cuda.current_stream().cuda_stream
    sv = api.SimpleVolume.synthetic(cs.DIMS, "vorts", device="cuda")
    frame = cs.frame_positions(torch, sv)
    ok = True
    for input_name in ("uniform", "frame"):
        for variant in ("tcnn", "paired"):
            spec = he.HashGridSpec.from_config(EncodingConfig(
                hash_variant=variant))
            scales, levels = he._level_arrays(spec)
            gen = torch.Generator(device="cuda").manual_seed(
                cs.SEED + 30 + (variant == "paired"))
            table = torch.rand((spec.n_entries, spec.n_features),
                               generator=gen, device="cuda") * 2.0 - 1.0
            coords = torch.rand((cs.TRAIN_BATCH, 3), generator=gen,
                                device="cuda")
            if input_name == "frame":
                coords = frame
            n = coords.shape[0]
            g32 = torch.randn((n, spec.n_output_dims), generator=gen,
                              device="cuda")
            rows = int(torch.unique(he._corners(spec, coords)[0]).numel())
            for cname, cdt in (("f32", torch.float32),
                               ("bf16", torch.bfloat16)):
                g = g32.to(cdt).contiguous()

                def design(v):
                    out = torch.empty((n, 3), device="cuda")
                    rc = lib.coords_variant(
                        table.data_ptr(), coords.data_ptr(), g.data_ptr(),
                        out.data_ptr(), n, spec.n_levels, scales.ctypes.data,
                        levels.ctypes.data, int(cdt == torch.bfloat16),
                        int(spec.paired), v, stream)
                    if rc:
                        raise RuntimeError(f"coords_variant({v}): {rc}")
                    return out

                runs = {"package": (lambda: he._kernel_coords_backward(
                    table, coords, spec, g, cdt), PACKAGE)}
                runs.update({k: (lambda v=v: design(v), name)
                             for k, (v, name) in VARIANTS.items()})
                package = runs["package"][0]()
                ref = he._plain_coords_backward(table, coords, spec, g, cdt)
                torch.cuda.synchronize()
                largest = float(ref.abs().max())
                rec = {"input": input_name, "layout": variant,
                       "compute": cname, "batch": n, "distinct_rows": rows}
                for k, (fn, _) in runs.items():
                    got = fn()
                    torch.cuda.synchronize()
                    err = float((got - ref).abs().max())
                    rec[k] = {"ms": [], "max_abs_err": err,
                              "equals_package": bool(torch.equal(got,
                                                                 package))}
                    ok &= (err <= cs.HASH_COORDS_RTOL * largest
                           and rec[k]["equals_package"])
                names = list(VARIANTS)
                for k in ["package", *names, *names[::-1], "package"]:
                    fn, pattern = runs[k]
                    rec[k]["ms"].append(cs.device_ms(torch, fn, (pattern,),
                                                     per_call=1))
                n_bytes = (rows * spec.n_features * 4
                           + cs.nbytes(coords, g, package))
                rec["bound_ms"] = n_bytes / cs.H100_BYTES_PER_S * 1e3
                rec["mbytes"] = n_bytes / 1e6
                for k in runs:
                    rec[k]["mean_ms"] = sum(rec[k]["ms"]) / 2
                    rec[k]["over_bound"] = rec[k]["mean_ms"] / rec["bound_ms"]
                print(json.dumps(rec), flush=True)
            del table, coords, g32
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if not ok:
        raise AssertionError("a coordinate design misses the package kernel "
                             "or the plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
