#!/usr/bin/env python3
"""Split the backward of the differentiable march's frame differentiated in
its rays (chip_smoke's 128² `fixed_steps` frame of the 2^19 model, params
frozen) in several checkouts on one card, one process a run, in the order
given (parent, change, change, parent compares two commits).

    python3 scripts/ray_frame_split.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository: its
instantvnr_torch is built and imported there, and the frame is driven with
this checkout's chip_smoke.py helpers (`_fixed_steps_frame`,
`backward_split`), which run on any tree whose frame differentiates in its
rays. Per run, one JSON
line: the forward and backward ms of three frames (host clock, each ended
by a synchronize), then one backward under torch.profiler split by device
time into the emission's backward (every kernel launched inside
render/raymarch.py::_Emit.backward: the kernel, or in a tree without it
the plain emission's recompute and its autograd), the coordinate pass,
K2 and the rest, with the profiled backward's host clock and each part's
kernel count. Then the card's name and power limit, as nvidia-smi prints
them. Needs one card.
"""
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure():
    """One run in the current directory's checkout → one JSON line."""
    import torch

    sys.path.insert(0, os.getcwd())
    cs = chip_smoke()
    from instantvnr_torch import api
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.models.network import NeuralField
    from instantvnr_torch.ops import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_lib.load_library()
    sv = api.SimpleVolume.synthetic(cs.DIMS, "vorts", device="cuda")
    cs._VORTS.append(sv.volume.data.cpu().numpy())
    field = NeuralField.from_config(ModelConfig())
    p_np = cs.seeded_params(field, cs.SEED + 20)

    def frame(**kw):
        return cs._fixed_steps_frame(torch, "cuda", field, p_np,
                                     cs.FIXED_SIZE, rays=True, **kw)

    frame()  # warm-up: the first frame pays allocations
    runs = [frame()[1:3] for _ in range(3)]
    split = {}
    frame(backward=lambda loss: cs.backward_split(torch, loss, split))
    print(json.dumps({"tree": os.getcwd(),
                      "forward_ms": [r[0] for r in runs],
                      "backward_ms": [r[1] for r in runs],
                      "backward_split": split}), flush=True)


def main():
    if sys.argv[1:] == ["--measure"]:
        measure()
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in sys.argv[1:]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--measure"], cwd=os.path.abspath(tree),
                             capture_output=True, text=True)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
        if out.returncode or not lines:
            sys.stderr.write(out.stderr[-4000:])
            print(json.dumps({"tree": tree, "rc": out.returncode}),
                  flush=True)
            rc = 1
            continue
        rec = json.loads(lines[-1])
        rec["tree"] = tree
        print(json.dumps(rec), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
