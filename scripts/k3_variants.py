#!/usr/bin/env python3
"""Time designs of the hash-grid forward gather (K3) on one card, in one
process, against the package's kernel, a gather floor and `embedding_bag`.

    python3 scripts/k3_variants.py      (from the repository root)

Builds scripts/k3_variants.cu (the package's csrc/hash_encode.cu plus the
designs it does not ship) with the package's nvcc flags, then on three
inputs of the reference schema (F = 8, bf16 compute): the 2^14 and 2^19
layouts' f32 master tables at B = 2^16 (chip_smoke.hash_inputs, as a
training step runs K3), and the 2^19 layout's bf16 table on a decode blob
(262,144 grid points of the 128³ volume, as a decode runs it). For each:

- the previous design; each change alone (the integer fixes, vector
  stores, the output staged in shared memory, level-major lanes); tcnn's
  level-major design with all three of its changes; and the package's
  kernel (the integer fixes and vector stores):
  device time (torch.profiler), max abs error against the plain gather
  (chip_smoke.HASH_FWD_ATOL), and whether the output equals the package
  kernel's bit for bit;
- the gather floor: each lane only loads its 8 rows from precomputed
  indices and sums them (the access pattern's own cost on this card);
- `embedding_bag` on the same rows and weights, and the bytes bound
  (chip_smoke's: each distinct row once, the coords and the features).

One JSON line per input, then the card's name and power limit as
nvidia-smi prints them.
"""
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"previous": 0, "int_only": 1, "vector_stores_only": 2,
            "staged_only": 3, "level_major_only": 4,
            "level_major_staged": 5}


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build():
    from instantvnr_torch.ops import cuda_lib

    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    out = os.path.join(cuda_lib.BUILD_DIR, "libk3_variants.so")
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o",
                    out, os.path.join(REPO, "scripts", "k3_variants.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.k3_variant_forward.argtypes = [p, p, p, ll, i, i, p, p, i, i, i, p]
    lib.k3_variant_forward.restype = ctypes.c_int
    lib.k3_gather_floor.argtypes = [p, p, p, ll, i, i, i, i, p]
    lib.k3_gather_floor.restype = ctypes.c_int
    return lib


def inputs(torch, cs, name):
    """(spec, table, coords) of one of the three inputs."""
    from instantvnr_torch.models.metrics import _grid_coords_slab

    if name == "decode 2^19":
        spec, table, _, _ = cs.hash_inputs(torch, 19)
        coords = _grid_coords_slab(cs.DIMS, 0, 16, "cuda")
        return spec, table.to(torch.bfloat16), coords
    log2 = int(name.split("^")[1])
    spec, table, coords, _ = cs.hash_inputs(torch, log2)
    return spec, table, coords


def main():
    import torch

    sys.path.insert(0, REPO)
    cs = chip_smoke()
    from instantvnr_torch.ops import hash_encoding as he

    lib = build()
    bf16 = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream
    ok = True
    for name in ("train 2^14", "train 2^19", "decode 2^19"):
        spec, table, coords = inputs(torch, cs, name)
        n, nl, nf = coords.shape[0], spec.n_levels, spec.n_features
        _, scales, levels = he._kernel_args(table, coords, spec, bf16)
        table_bf16 = int(table.dtype == bf16)
        ref = he.hash_encode_reference(table, coords, spec, bf16)
        idx, w = he.corner_indices_and_weights(spec, coords)
        idx_lm = idx.reshape(n, nl, 8).permute(1, 2, 0).to(
            torch.int32).contiguous()  # [L, 8, n]

        def variant(v):
            out = torch.empty((n, nl * nf), dtype=bf16, device="cuda")
            rc = lib.k3_variant_forward(
                table.data_ptr(), coords.data_ptr(), out.data_ptr(), n, nl,
                nf, scales.ctypes.data, levels.ctypes.data, table_bf16, 1, v,
                stream)
            if rc:
                raise RuntimeError(f"k3_variant_forward({v}): error {rc}")
            return out

        idx_sm = idx.to(torch.int32).contiguous()  # [n, L·8]

        def floor(mapping):
            out = torch.empty((n, nl * nf), dtype=bf16, device="cuda")
            rc = lib.k3_gather_floor(
                table.data_ptr(), (idx_sm if mapping else idx_lm).data_ptr(),
                out.data_ptr(), n, nl, table_bf16, 1, mapping, stream)
            if rc:
                raise RuntimeError(f"k3_gather_floor({mapping}): error {rc}")
            return out

        package = he._kernel_forward(table, coords, spec, bf16)
        runs = {k: (lambda v=v: variant(v), ("k3_v",))
                for k, v in VARIANTS.items()}
        runs["package"] = (lambda: he._kernel_forward(table, coords, spec,
                                                      bf16),
                           ("hash_encode_forward_kernel",))
        rec = {"input": name, "batch": n, "levels": nl, "features": nf,
               "table": str(table.dtype).removeprefix("torch."),
               "table_mb": cs.nbytes(table) / 1e6}
        for k, (fn, pattern) in runs.items():
            got = fn()
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            rec[k] = {"ms": cs.device_ms(torch, fn, pattern),
                      "max_abs_err": err,
                      "equals_package": bool(torch.equal(got, package))}
            ok &= err <= cs.HASH_FWD_ATOL
        rec["gather_floor_ms"] = {
            name: cs.device_ms(torch, lambda m=m: floor(m), ("k3_floor",))
            for name, m in (("level_major_staged", 0),
                            ("package_mapping", 1))}
        bags, bag_w = idx.reshape(-1, 8), w.reshape(-1, 8).to(table.dtype)
        rec["embedding_bag_ms"] = cs.device_ms(
            torch, lambda: torch.nn.functional.embedding_bag(
                bags, table, per_sample_weights=bag_w, mode="sum"), ("",))
        rows = int(torch.unique(idx).numel())
        row_bytes = nf * table.element_size()
        n_bytes = rows * row_bytes + cs.nbytes(coords, package)
        rec["distinct_rows"] = rows
        rec["gathered_mb"] = n * nl * 8 * row_bytes / 1e6
        rec["bound_ms"] = n_bytes / cs.H100_BYTES_PER_S * 1e3
        rec["package_over_floor"] = (rec["package"]["ms"] / min(
            rec["gather_floor_ms"].values()))
        rec["package_over_bound"] = rec["package"]["ms"] / rec["bound_ms"]
        print(json.dumps(rec), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if not ok:
        raise AssertionError("a K3 design misses the plain gather")
    return 0


if __name__ == "__main__":
    sys.exit(main())
