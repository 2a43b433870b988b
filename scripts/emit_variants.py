#!/usr/bin/env python3
"""Time designs of the wavefront's emission (raymarch_emit) on one card, in
one process, against the package's kernel and the function's bound.

    python3 scripts/emit_variants.py      (from the repository root)

Builds scripts/emit_variants.cu (the package's csrc/raymarch_emit.cu plus
the designs it does not ship) with the package's nvcc flags, then on the
inputs of chip_smoke.py's raymarch_emit phase (the R = 512² rays of an
orbit frame over vorts 128³, 8 skips, the state after a first superstep)
at K = 8 (the neural wavefront's slots) and K = 16 (the default n_iters),
for each design of emit_variants.cu (the previous design, each change
alone, the package's, the per-ray alternative): its device time
(torch.profiler) and whether its seven outputs equal the plain
_emit_samples bit for bit; beside them the package's kernel through its
wrapper, and the bound (chip_smoke's: the function's bytes and the
operations of the probes these inputs need).

One JSON line per K, then the card's name and power limit as nvidia-smi
prints them. Needs one card; fails if a design misses the plain version.
"""
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"previous": 0, "int32_only": 1, "staged_scalar": 2,
            "staged_vector": 3, "staged_smem_rays": 4, "staged_smem_occ": 5,
            "per_ray_vector": 6}


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(name):
    """nvcc scripts/<name>.cu into the package's build directory, loaded."""
    from instantvnr_torch.ops import cuda_lib

    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    out = os.path.join(cuda_lib.BUILD_DIR, f"lib{name}.so")
    p = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared",
                        "-o", out, os.path.join(REPO, "scripts",
                                                f"{name}.cu")],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"nvcc {name}.cu failed\n{p.stdout}{p.stderr}")
    return ctypes.CDLL(out)


def main():
    import torch

    sys.path.insert(0, REPO)
    cs = chip_smoke()
    from instantvnr_torch import api
    from instantvnr_torch.ops.cuda_lib import SIGNATURES
    from instantvnr_torch.render import raymarch as rm

    lib = build("emit_variants")
    lib.emit_variant.argtypes = [*SIGNATURES["raymarch_emit"], ctypes.c_int]
    lib.emit_variant.restype = ctypes.c_int
    sv = api.SimpleVolume.synthetic(cs.DIMS, "vorts", device="cuda")
    org, dirn, t0, t1, _ = cs.wavefront_rays(
        torch, sv, cs.SIZE, cs.SIZE, cs.orbit(1, cs.N_FRAMES, max(cs.DIMS)))
    mc = sv.macrocell
    mx, my, mz = mc.dims
    skips = 8
    r = org.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    ok = True
    for k in (8, 16):
        state = rm.init_ray_state(t0, t1)
        (t, tce, ss), *_ = rm._emit_samples(org, dirn, t1, state, mc, 1.0, k,
                                            skips)
        state = state._replace(t=t, t_cell_end=tce, ss=ss)
        ref = rm._emit_samples(org, dirn, t1, state, mc, 1.0, k, skips)
        ref = ref[0] + ref[1:]
        outs = [torch.empty(r, device="cuda") for _ in range(3)] + [
            torch.empty((r, k), device="cuda") for _ in range(2)] + [
            torch.empty((r, k), dtype=torch.bool, device="cuda")]

        def variant(v):
            rc = lib.emit_variant(
                *(a.data_ptr() for a in (org, dirn, t1, state.t,
                                         state.t_cell_end, state.ss,
                                         mc.max_opacity)),
                mx, my, mz, 1.0, 15.0, r, k, skips, 1,
                *(o.data_ptr() for o in outs), stream, v)
            if rc:
                raise RuntimeError(f"emit_variant({v}): error {rc}")

        probes = rm._emit_samples(org, dirn, t1, state, mc, 1.0, k, skips,
                                  count_probes=True)[-1]
        n_bytes = (cs.nbytes(org, dirn, t1, state.t, state.t_cell_end,
                             state.ss, mc.max_opacity) + cs.nbytes(*ref))
        ops = probes * cs.EMIT_PROBE_OPS + r * k * cs.EMIT_SLOT_OPS
        b_ms, b_by = cs.bound_ms(n_bytes, ops, cs.H100_FP32_FLOPS)
        rec = {"rays": r, "slots": k, "max_skips": skips, "probes": probes,
               "bound_ms": b_ms, "bound_by": b_by}
        for name, v in VARIANTS.items():
            for o in outs:
                o.zero_()
            variant(v)
            torch.cuda.synchronize()
            same = all(torch.equal(o, x) for o, x in zip(outs, ref))
            rec[name] = {"ms": cs.device_ms(torch, lambda v=v: variant(v),
                                            ("",)),
                         "same_bits": same}
            ok &= same
        got = rm.raymarch_emit(org, dirn, t1, state, mc, 1.0, k, skips)
        same = all(torch.equal(g, x) for g, x in zip(got[0] + got[1:], ref))
        rec["package"] = {
            "ms": cs.device_ms(torch, lambda: rm.raymarch_emit(
                org, dirn, t1, state, mc, 1.0, k, skips),
                ("raymarch_emit_kernel",)),
            "same_bits": same}
        ok &= same
        rec["package_over_bound"] = rec["package"]["ms"] / b_ms
        print(json.dumps(rec), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if not ok:
        raise AssertionError("an emission design misses the plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
