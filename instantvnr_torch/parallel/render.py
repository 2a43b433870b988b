"""Ray-sharded rendering (counterpart of `instantvnr_tpu/parallel/
render.py`): the R rays of a frame split over the "data" axis (rays are
independent, so the march needs no communication), the macrocell, transfer
function and sample context replicated, and one all_gather of the ranks'
[R/D, 4] results assembling the frame. On the card each rank's march
emits its samples through `raymarch_emit`.
"""
from __future__ import annotations

from functools import partial

import torch

from instantvnr_torch.render.raymarch import RaymarchSettings, raymarch
from instantvnr_torch.parallel.mesh import Mesh, all_gather


def make_sharded_render_fn(sample_fn, mesh: Mesh,
                           settings: RaymarchSettings):
    """→ fn(sample_ctx, org, dirn, t0, t1, mc, tf, jitter) → rgba [R, 4] on
    every rank. The ray arrays are the whole frame's (the same on every
    rank); each rank marches its contiguous R/D of them. The ray count must
    divide by the data axis."""
    n = mesh.shape["data"]
    idx = mesh.axis_index("data")

    def fn(sample_ctx, org, dirn, t0, t1, mc, tf, jitter) -> torch.Tensor:
        r = org.shape[0]
        if r % n:
            raise ValueError(f"{r} rays not divisible by the data axis "
                             f"({n})")
        k = r // n
        sl = slice(idx * k, (idx + 1) * k)
        part = raymarch(partial(sample_fn, sample_ctx), org[sl], dirn[sl],
                        t0[sl], t1[sl], mc, tf, jitter[sl], settings)
        return all_gather(part, mesh, "data").reshape(r, 4)

    return fn
