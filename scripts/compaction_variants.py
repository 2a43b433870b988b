#!/usr/bin/env python3
"""Time the ray-compaction kernels at each tile size (compact_rows'
partition tile, scatter_rows' gather tile) on one card, in one process.

    python3 scripts/compaction_variants.py      (from the repository root)

Builds scripts/compaction_variants.cu (the package's csrc/compaction.cu
with entries that take the tile) with the package's nvcc flags, then, on
chip_smoke.py's shapes and seeded rows (the band's compaction of the
wavefront's 14 leaves and the path tracer's 11 at m = 2^18 with copy
back, the select form at 2^21 with its order; scatter_rows' five leaves
at 2^18 on a compaction's order, a frame's after three compactions and a
random permutation), for each tile: whether every output equals the plain version's bit for bit, and
the device time of every kernel the call launches (torch.profiler), by
kernel. Beside them the package's own entry through its wrapper.

One JSON line a measurement, then the card's name and power limit as
nvidia-smi prints them. Needs one card; fails if a tile misses the plain
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
ROWS_PER_THREAD = (1, 2, 4, 8)
SMEM_MAX = 200 * 1024  # a block's staging, within the card's 227 KB


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build():
    """nvcc scripts/compaction_variants.cu into the package's build
    directory, loaded."""
    from instantvnr_torch.ops import cuda_lib

    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    out = os.path.join(cuda_lib.BUILD_DIR, "libcompaction_variants.so")
    p = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared",
                        "-o", out, os.path.join(REPO, "scripts",
                                                "compaction_variants.cu")],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"nvcc failed\n{p.stdout}{p.stderr}")
    lib = ctypes.CDLL(out)
    _I = ctypes.c_int
    lib.compact_variant.argtypes = (
        (_I,) + cuda_lib.SIGNATURES["compact_rows"])
    lib.scatter_variant.argtypes = (_I,) + cuda_lib.SIGNATURES["scatter_rows"]
    return lib


def by_kernel(torch, cs, fn, iters=20):
    """Device ms a call of every kernel fn launches, by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            found = re.search(r"\w+_kernel", e.name)
            name = found.group(0) if found else e.name
            out[name] = out.get(name, 0.0) + cs.kernel_us(e) / iters / 1e3
    return out


def main():
    import torch

    sys.path.insert(0, REPO)
    cs = chip_smoke()
    from instantvnr_torch.ops import compaction as ops
    from instantvnr_torch.render.compaction import (_OUT_LEAVES,
                                                    WAVEFRONT_LEAVES)
    from instantvnr_torch.render.pathtrace import PT_LEAVES

    lib = build()
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 14)
    m = cs.COMPACT_ROWS
    cases = {}
    for name, spec in (("band", WAVEFRONT_LEAVES), ("pathtrace", PT_LEAVES)):
        leaves = list(cs.seeded_rows(torch, spec, m, g).values())
        flags = leaves[list(spec).index("active")].clone()
        cases[name] = (flags, leaves, True, False)
    n = cs.SELECT_SLOTS
    cases["select"] = (
        torch.rand(n, generator=g, device="cuda") < cs.COMPACT_LIVE,
        [torch.rand((n, 3), generator=g, device="cuda")], False, True)
    ok = True
    for name, (flags, leaves, back, with_order) in cases.items():
        rows = flags.shape[0]
        src = [x.clone() for x in leaves]
        scratch = [torch.empty_like(x) for x in src]
        count = torch.empty(1, dtype=torch.int32, device="cuda")
        order = (torch.empty(rows, dtype=torch.int32, device="cuda")
                 if with_order else None)
        want = [x.clone() for x in leaves]
        wscr = [torch.empty_like(x) for x in want]
        wcount = torch.empty(1, dtype=torch.int32, device="cuda")
        worder = (torch.empty(rows, dtype=torch.int32, device="cuda")
                  if with_order else None)
        ops.compact_rows_reference(flags, want, wscr, wcount, worder, back)
        s_ptr, d_ptr, rb = ops._leaf_arrays(src, scratch, rows, flags.device)
        nb = -(-rows // 256)
        ws = torch.empty(nb + -(-nb // 8), dtype=torch.int32, device="cuda")

        def call(r):
            return lib.compact_variant(
                r, flags.data_ptr(), rows, len(src),
                s_ptr.ctypes.data, d_ptr.ctypes.data, rb.ctypes.data,
                int(back), 0 if order is None else order.data_ptr(),
                count.data_ptr(), ws.data_ptr(), stream)

        row_bytes = int(rb.sum()) + (4 if with_order else 0)
        for r in ROWS_PER_THREAD:
            if 256 * r * row_bytes + 32 * (len(src) + 1) > SMEM_MAX:
                continue
            for x, y in zip(src, leaves):
                x.copy_(y)
            rc = call(r)
            torch.cuda.synchronize()
            if rc:
                raise RuntimeError(f"{name} R={r}: rc {rc}")
            same = (all(torch.equal(a, b) for a, b in
                        zip(src + scratch if back else scratch,
                            want + wscr if back else wscr))
                    and torch.equal(count, wcount)
                    and (order is None or torch.equal(order, worder)))
            ok &= same
            ms = by_kernel(torch, cs, lambda: call(r))
            print(json.dumps({"case": name, "rows_per_thread": r,
                              "same_bits": same, "ms": sum(ms.values()),
                              "by_kernel": ms}), flush=True)
        ms = by_kernel(torch, cs, lambda: ops.compact_rows(
            flags, src, scratch, count=count, order=order, copy_back=back))
        print(json.dumps({"case": name, "tile": "package wrapper",
                          "ms": sum(ms.values()), "by_kernel": ms}),
              flush=True)
    leaves = list(cs.seeded_rows(torch, {k: WAVEFRONT_LEAVES[k]
                                         for k in _OUT_LEAVES}, m,
                                 g).values())
    live = torch.rand(m, generator=g, device="cuda") < cs.COMPACT_LIVE
    perms = {"partition": torch.argsort(~live, stable=True),
             "frame": cs.frame_permutation(torch, m, g),
             "random": torch.randperm(m, generator=g, device="cuda")}
    outs = [torch.empty_like(x) for x in leaves]
    want = [torch.empty_like(x) for x in leaves]
    s_ptr, d_ptr, rb = ops._leaf_arrays(leaves, outs, m, live.device)
    inv = torch.empty(m, dtype=torch.int32, device="cuda")
    for name, p in perms.items():
        p32 = p.to(torch.int32)
        ops.scatter_rows_reference(p32, leaves, want)
        for r in ROWS_PER_THREAD:
            def call(r=r):
                return lib.scatter_variant(
                    r, p32.data_ptr(), m, len(leaves), s_ptr.ctypes.data,
                    d_ptr.ctypes.data, rb.ctypes.data, inv.data_ptr(),
                    stream)

            for o in outs:
                o.zero_()
            rc = call()
            torch.cuda.synchronize()
            same = rc == 0 and all(torch.equal(a, b)
                                   for a, b in zip(outs, want))
            ok &= same
            ms = by_kernel(torch, cs, call)
            print(json.dumps({"case": f"scatter_{name}",
                              "rows_per_thread": r, "same_bits": same,
                              "ms": sum(ms.values()), "by_kernel": ms}),
                  flush=True)
        ms = by_kernel(torch, cs, lambda: ops.scatter_rows(p32, leaves, outs))
        print(json.dumps({"case": f"scatter_{name}",
                          "tile": "package wrapper",
                          "ms": sum(ms.values()), "by_kernel": ms}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
