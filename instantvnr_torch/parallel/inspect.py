"""Structural pins of the parallel programs: count their collectives
(counterpart of `instantvnr_tpu/parallel/inspect.py`).

The performance claims of the parallel paths are counts: a DP step issues
ONE fused all-reduce (parallel/train.py), a TP step two (the forward's
over "model" and the fused gradient mean over "data"; parallel/tp.py), an
EP step and decode none (parallel/ep.py), and a ray- or slab-sharded frame
one all_gather (parallel/render.py, parallel/slab.py). Every collective
goes through parallel/mesh.py, which counts it; `count_collectives` runs a
program once and reads the counts, so a change that adds a collective to a
hot step fails its pin instead of shipping silently. The JAX package counts
the equations of a traced program; here a program runs, so a program of
n steps counts each step's collectives n times.
"""
from __future__ import annotations

from instantvnr_torch.parallel.mesh import collective_counters


def count_collectives(fn, *args, **kwargs) -> dict:
    """Run fn(*args, **kwargs) once → {collective: count} of the
    collectives it issued (the nonzero ones)."""
    before = {k: c.launches for k, c in collective_counters().items()}
    fn(*args, **kwargs)
    got = {k: c.launches - before[k]
           for k, c in collective_counters().items()}
    return {k: v for k, v in got.items() if v}


def assert_collectives(fn, expected: dict, *args, _what: str = "program",
                       **kwargs) -> dict:
    """Run the program and assert its collective profile equals `expected`
    (missing keys mean zero) → the counts."""
    got = count_collectives(fn, *args, **kwargs)
    want = {k: v for k, v in expected.items() if v}
    if got != want:
        raise AssertionError(
            f"{_what}: collective profile changed — expected {want}, "
            f"counted {got}. A new collective on a hot step is a perf "
            "regression; update the expectation only if intentional.")
    return got
