"""The readings that a cell's limits are set from, for many seeds in one
process: the program's numbers, the control's and the planted faults'.

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 3 ... \
        [--seconds 2] [--out readings.jsonl]

Each seed makes its inputs, runs the cell's set-up and a short window at
the cell's own sizes, frees the program's state and prints one JSON line
of readings. The benchmark's own runs do not run this.
"""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        harness.log("calibration needs a CUDA device")
        return 3
    manifest = harness.load_manifest(ROOT)
    cell = {w["name"]: w for w in manifest["workloads"]}[args.workload]
    config = harness.data_file(ROOT, "configs", cell["config"])
    traffic = harness.data_file(ROOT, "workloads", cell["traffic"])
    kind = harness.load_module(ROOT, "traffic", traffic["kind"])
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = harness.Context(root=ROOT, cell=cell, config=config,
                              traffic=traffic, seed=seed,
                              device=torch.device("cuda"))
        sess = kind.Session(ctx)
        sess.setup()
        torch.cuda.synchronize()
        sess.run_until(time.perf_counter() + args.seconds, harness.Spans())
        sess.release()
        gc.collect()
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        rec = {"workload": args.workload, "seed": seed,
               **sess.calibration(),
               "seconds": time.perf_counter() - t0}
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del sess
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main(sys.argv[1:]))
