#!/usr/bin/env python3
"""Time designs of the emission's backward (raymarch_emit_backward) on one
card, in one process, against the package's kernel and the function's
bound.

    python3 scripts/emit_backward_variants.py      (from the repository root)

Builds scripts/emit_backward_variants.cu (the package's
csrc/raymarch_emit.cu plus the designs it does not ship: the first design
as it was, alone and with each change, and the package's design over a
lane type, at other lane counts a ray, block sizes, register caps and with
staged cotangents) with the package's nvcc
flags, then at chip_smoke.emit_backward_shapes' three shapes (R = 512²
orbit rays over vorts 128³, K = 8, 8 skips, the state after a first
superstep; the differentiable march's 128² frame, K = FIXED_ITERS, from
the fresh state and after a first superstep), on the smoke's random
cotangents of all five outputs: each design's device time
(torch.profiler, one kernel a call) twice, in turns (the package, each
design, each design again in reverse, the package), its largest error
against the plain backward (chip_smoke.EMIT_BWD_RTOL of each leaf's
largest entry), whether two launches give the same bits, and the bound
(chip_smoke's: the function's bytes and the operations of the probes its
data needs). The ptxas lines of each backward kernel (registers, stack,
spills) come first.

One JSON line per shape, then the card's name and power limit as
nvidia-smi prints them. Needs one card; fails if a design misses the plain
version.
"""
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"previous": 0, "previous_fma": 1, "previous_staged": 2,
            "lean": 3, "lean_staged": 4, "lanes2": 5, "lanes2_staged": 6,
            "lanes5": 7, "lanes5_staged": 8, "lanes10_staged": 9,
            "lean_staged_64": 10, "lean_staged_8": 11,
            "lanes2_staged_256": 12, "lean_64": 13, "lean_256": 14,
            "lean_6": 15, "lean_7": 16}
KERNELS = ("raymarch_emit_backward_kernel", "prev_backward_kernel",
           "lanes_backward_kernel")
LEAVES = ("org", "dirn", "t_far", "t", "t_cell_end", "ss")


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build():
    """nvcc scripts/emit_backward_variants.cu into the package's build
    directory → (the loaded library, ptxas's lines of the backward
    kernels)."""
    from instantvnr_torch.ops import cuda_lib
    from instantvnr_torch.ops.cuda_lib import SIGNATURES

    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    out = os.path.join(cuda_lib.BUILD_DIR, "libemit_backward_variants.so")
    p = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared",
                        "-o", out, os.path.join(REPO, "scripts",
                                                "emit_backward_variants.cu")],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"nvcc failed\n{p.stdout}{p.stderr}")
    lib = ctypes.CDLL(out)
    lib.emit_backward_variant.argtypes = [
        *SIGNATURES["raymarch_emit_backward"], ctypes.c_int]
    lib.emit_backward_variant.restype = ctypes.c_int
    lines, name = [], None
    for ln in p.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
        elif name and any(k in name for k in KERNELS) and (
                "registers" in ln or "stack frame" in ln):
            lines.append(f"{name}: {ln.strip()}")
    return lib, lines


def main():
    import torch

    sys.path.insert(0, REPO)
    cs = chip_smoke()
    from instantvnr_torch import api
    from instantvnr_torch.render import raymarch as rm

    lib, ptxas = build()
    for ln in ptxas:
        print(ln, flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    sv = api.SimpleVolume.synthetic(cs.DIMS, "vorts", device="cuda")
    mc = sv.macrocell
    ok = True
    shapes = cs.emit_backward_shapes(torch, sv)
    for name, org, dirn, t_far, state, k in shapes:
        skips, r = 8, org.shape[0]
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 40 + k)
        grads = [torch.randn(sh, generator=gen, device="cuda")
                 for sh in ((r,),) * 3 + ((r, k),) * 2]
        ins = (org, dirn, t_far, state.t, state.t_cell_end, state.ss)
        args = (mc, 1.0, k, skips, 1)
        need = (True,) * 6
        ins_d = rm._emit_inputs("variant", *ins, mc)

        def design(v):
            outs = [torch.empty(sh, device="cuda")
                    for sh in ((r, 3), (r, 3)) + ((r,),) * 4]
            rc = lib.emit_backward_variant(
                *(ins_d[n].data_ptr() for n in rm._EMIT_INPUTS),
                *rm._emit_scalars(mc, 1.0, r, k, skips, 1),
                *(x.data_ptr() for x in grads + outs), stream, v)
            if rc:
                raise RuntimeError(f"emit_backward_variant({v}): error {rc}")
            return outs

        runs = {"package": lambda: rm._kernel_emit_backward(*ins, grads,
                                                            need, *args)}
        runs.update({n: (lambda v=v: design(v)) for n, v in VARIANTS.items()})
        ref = rm._plain_emit_backward(*ins, grads, need, *args)
        torch.cuda.synchronize()
        largest = {n: float(w.abs().max()) for n, w in zip(LEAVES, ref)}
        probes = rm._emit_samples(org, dirn, t_far, state, mc, 1.0, k, skips,
                                  count_probes=True)[-1]
        n_bytes = (cs.nbytes(*ins, mc.max_opacity) + cs.nbytes(*grads)
                   + cs.nbytes(*ref))
        ops = (probes * cs.EMIT_BWD_PROBE_OPS + r * k * cs.EMIT_BWD_SLOT_OPS
               + r * cs.EMIT_BWD_RAY_OPS)
        b_ms, b_by = cs.bound_ms(n_bytes, ops, cs.H100_FP32_FLOPS)
        rec = {"shape": name, "rays": r, "slots": k, "max_skips": skips,
               "probes": probes, "bound_ms": b_ms, "bound_by": b_by,
               "mbytes": n_bytes / 1e6}
        for n, fn in runs.items():
            got, again = fn(), fn()
            torch.cuda.synchronize()
            errs = {leaf: float((g - w).abs().max())
                    for leaf, g, w in zip(LEAVES, got, ref)}
            rel = max(errs[leaf] / largest[leaf] if largest[leaf] else
                      errs[leaf] for leaf in LEAVES)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            rec[n] = {"ms": [], "max_err_of_largest": rel, "same_bits": same,
                      "finite": finite}
            ok &= rel <= cs.EMIT_BWD_RTOL and same and finite
        names = list(VARIANTS)
        for n in ["package", *names, *names[::-1], "package"]:
            rec[n]["ms"].append(cs.device_ms(torch, runs[n], KERNELS,
                                             per_call=1))
        for n in runs:
            rec[n]["mean_ms"] = sum(rec[n]["ms"]) / 2
            rec[n]["over_bound"] = rec[n]["mean_ms"] / b_ms
        print(json.dumps(rec), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if not ok:
        raise AssertionError("an emission backward design misses the plain "
                             "version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
