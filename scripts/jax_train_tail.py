#!/usr/bin/env python3
"""PSNR of the JAX package's own training over the last 100 of 1000 steps.

    python3 scripts/jax_train_tail.py [--seeds 0 1] [--platform cpu]

Trains the reference package (instantvnr_tpu) on vorts 128³ with the 2^14
schema at B = 2^16, chunks of 10 steps, and prints one JSON line per seed
with the PSNR after each of steps 910, 920, ..., 1000: how far the
1000-step quality of the reference itself moves from one 10-step chunk to
the next. The PyTorch port's chip_smoke.py records the same tail for the
port on the card.
"""
import argparse
import json
import os
import sys
import time

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--platform", default="cpu")
    args = ap.parse_args()
    jax.config.update("jax_platforms", args.platform)
    from instantvnr_tpu.config import EncodingConfig, ModelConfig
    from instantvnr_tpu.data import synthetic_volume
    from instantvnr_tpu.models import (NeuralField, create_train_state,
                                       train_steps)
    from instantvnr_tpu.models.metrics import psnr_vs

    vol = synthetic_volume((128, 128, 128), kind="vorts")
    field = NeuralField.from_config(
        ModelConfig(encoding=EncodingConfig(log2_hashmap_size=14)))
    for seed in args.seeds:
        t0 = time.time()
        state = create_train_state(jax.random.PRNGKey(seed), field)
        tail = []
        for chunk in range(100):
            state = train_steps(field, vol.data, state, 10, 1 << 16)
            if chunk >= 90:
                tail.append(round(float(psnr_vs(field, state.params,
                                                 vol.data)), 2))
        print(json.dumps({"seed": seed, "platform": jax.default_backend(),
                          "steps": list(range(910, 1001, 10)),
                          "psnr": tail, "seconds": time.time() - t0}),
              flush=True)


if __name__ == "__main__":
    main()
