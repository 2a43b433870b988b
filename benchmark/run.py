"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(also `python3 -m benchmark.run ...` from the repository root). The cell's
entry in BENCHMARK.json names its configuration and its traffic; the run
makes its inputs from the seed, warms up, measures for --seconds, checks
what the timed path produced against the plain reference under
benchmark/reference/, and prints one JSON object as the last line of
standard output. It needs an NVIDIA GPU and never falls back to the CPU.
"""
import os
import sys
import time

T_PROCESS = time.perf_counter()  # set-up is counted from here

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _caches():
    """Every compile cache at a fixed path inside the checkout, so that a
    cell's second run finds the first run's builds (the port's own kernel
    library builds into instantvnr_torch/_build/)."""
    base = os.path.join(ROOT, "benchmark", ".cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


if __name__ == "__main__":
    # the script's own folder must not shadow standard modules
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
            os.path.abspath(__file__)):
        sys.path[0] = ROOT
    elif ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    _caches()
    from benchmark.harness import main

    sys.exit(main(sys.argv[1:], T_PROCESS))
