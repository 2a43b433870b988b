"""instantvnr_torch — the PyTorch + CUDA port of instantvnr_tpu for NVIDIA
Hopper (H100).

The JAX package `instantvnr_tpu` is the reference; this package mirrors its
module layout one file for one file and never imports it (or JAX). Each
TPU (Pallas) kernel on a ported path has a hand-written CUDA counterpart
under `csrc/`, built with nvcc at first use (`ops/cuda_lib.py`), beside a
plain PyTorch version of the same function. A CUDA tensor takes the
kernel; a CPU tensor takes the plain version.

What is ported: every module of the JAX package but its TPU schedule
(`render/compaction.py`), sharding over ranks (`parallel/`) included;
ROADMAP.md ("Where the port stands").
"""

__version__ = "0.1.0"
