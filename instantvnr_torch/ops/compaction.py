"""Ray compaction: the `compact_rows` and `scatter_rows` CUDA kernels
(`csrc/compaction.cu`) and their plain versions, counterpart of the JAX
package's XLA `_compact_body`, `_count_active` and `_unpermute`
(`instantvnr_tpu/render/compaction.py:168-211, :589, :816`).

- `compact_rows(active, leaves, scratch, ...)`: a stable partition of m
  rows by `active` (live rows keep their order at the front, dead rows
  theirs behind them), applied to every leaf (tensors of m rows, each in
  its own type), with the live count written to a device int32 and,
  optionally, the source row of every destination (`order`). The rows go
  to `scratch` and, with `copy_back`, back into the leaves, whose addresses
  stay those a captured CUDA graph reads.
- `scatter_rows(perm, leaves, outs)`: row i of every leaf to row perm[i]
  of its output (the slot → pixel unpermute).

The wrappers take the plain version only for CPU tensors; on CUDA tensors
they launch the kernel or raise.
"""
from __future__ import annotations

import numpy as np
import torch

from instantvnr_torch.ops.cuda_lib import LaunchCounter, load_library

compact_counter = LaunchCounter()  # compact_rows
scatter_counter = LaunchCounter()  # scatter_rows

_MAX_LEAVES = 16
_MIN_TILE = 256  # rows a block of the kernel at least (kThreads)


def _partition_order(active: torch.Tensor):
    """JAX's cumsum-and-scatter (`_compact_body` :185-193) → (order [m]
    int64, the source row of every destination; n_live [1] int32)."""
    live = active.to(torch.int32)
    n_live = live.sum(dtype=torch.int32).reshape(1)
    pos_live = torch.cumsum(live, 0, dtype=torch.int32) - 1
    pos_dead = n_live + torch.cumsum(1 - live, 0, dtype=torch.int32) - 1
    dest = torch.where(active, pos_live, pos_dead).to(torch.int64)
    m = active.shape[0]
    order = torch.empty(m, dtype=torch.int64, device=active.device)
    order[dest] = torch.arange(m, device=active.device)
    return order, n_live


def compact_rows_reference(active: torch.Tensor, leaves: list, scratch: list,
                           count: torch.Tensor | None = None,
                           order: torch.Tensor | None = None,
                           copy_back: bool = False):
    """Plain version of `compact_rows`, on any device."""
    o, n_live = _partition_order(active)
    for src, dst in zip(leaves, scratch):
        dst.copy_(src[o])
        if copy_back:
            src.copy_(dst)
    if count is not None:
        count.copy_(n_live)
    if order is not None:
        order.copy_(o)


def scatter_rows_reference(perm: torch.Tensor, leaves: list, outs: list):
    """Plain version of `scatter_rows`, on any device."""
    p = perm.to(torch.int64)
    for src, dst in zip(leaves, outs):
        dst[p] = src


def _leaf_arrays(srcs, dsts, m: int, device):
    """(src addresses, dst addresses, row bytes) as host arrays for the C
    entries; checks that every leaf is m contiguous rows on `device`."""
    if not 0 < len(srcs) <= _MAX_LEAVES or len(srcs) != len(dsts):
        raise ValueError(f"compaction kernels take 1 to {_MAX_LEAVES} "
                         f"leaves, got {len(srcs)} and {len(dsts)}")
    row_bytes = []
    for s, d in zip(srcs, dsts):
        if (s.device != device or d.device != device or s.dtype != d.dtype
                or not s.is_contiguous() or not d.is_contiguous()
                or s.shape[0] != m or s.shape[1:] != d.shape[1:]):
            raise ValueError(
                f"compaction kernels: a leaf of {m} contiguous rows on "
                f"{device} with a matching output (got {tuple(s.shape)} "
                f"{s.dtype} on {s.device}, {tuple(d.shape)} {d.dtype} on "
                f"{d.device})")
        row_bytes.append(s[:1].numel() * s.element_size() if m else 0)
    return (np.array([s.data_ptr() for s in srcs], np.uint64),
            np.array([d.data_ptr() for d in dsts], np.uint64),
            np.array(row_bytes, np.int32))


def compact_rows(active: torch.Tensor, leaves: list, scratch: list,
                 count: torch.Tensor | None = None,
                 order: torch.Tensor | None = None,
                 copy_back: bool = False):
    """Stable partition of the m = len(active) rows of every leaf by
    `active` into `scratch` (and back into the leaves with copy_back);
    `count` [1] int32 receives the live count, `order` [m] int32 the source
    row of every destination. The plain version for CPU tensors, the
    `compact_rows` kernel (two launches, and a third with copy_back) for
    CUDA tensors."""
    m = active.shape[0]
    # both paths alike: a short scratch leaf would take the kernel past its
    # end, and the plain copy would broadcast a one-row one
    if len(scratch) != len(leaves) or any(
            t.shape[0] != m for t in (*leaves, *scratch)):
        raise ValueError(
            f"compact_rows: every leaf and scratch leaf has the flags' {m} "
            f"rows (got {[tuple(t.shape) for t in leaves]} and "
            f"{[tuple(t.shape) for t in scratch]})")
    if active.device.type == "cpu":
        return compact_rows_reference(active, leaves, scratch, count, order,
                                      copy_back)
    if active.device.type != "cuda":
        raise ValueError(f"unsupported device {active.device}")
    if active.dtype != torch.bool or not active.is_contiguous():
        raise ValueError("compact_rows: active must be contiguous bool")
    for t, dt in ((count, torch.int32), (order, torch.int32)):
        if t is not None and (t.dtype != dt or t.device != active.device
                              or not t.is_contiguous()):
            raise ValueError("compact_rows: count and order are int32 on "
                             "the flags' device")
    if order is not None and order.shape[0] != m:
        raise ValueError("compact_rows: order must have m rows")
    src, dst, rb = _leaf_arrays(leaves, scratch, m, active.device)
    # the count pass's tile counts and their sums by eight
    nb = -(-m // _MIN_TILE)
    ws = torch.empty(nb + -(-nb // 8), dtype=torch.int32,
                     device=active.device)
    load_library().call(
        "compact_rows", active.data_ptr(), m, len(leaves), src.ctypes.data,
        dst.ctypes.data, rb.ctypes.data, int(copy_back),
        0 if order is None else order.data_ptr(),
        0 if count is None else count.data_ptr(), ws.data_ptr(),
        torch.cuda.current_stream(active.device).cuda_stream)
    compact_counter.launches += 1


def select_rows(mask: torch.Tensor, rows: torch.Tensor):
    """The valid-slot selection of a compacted superstep: `rows` [n, ...]
    stably partitioned by `mask` [n] → (rows with the selected ones first,
    order [n] int32 their source rows, count [1] int32), all on the device
    (no host read: a CUDA graph can capture it)."""
    out = torch.empty_like(rows)
    order = torch.empty(mask.shape[0], dtype=torch.int32, device=mask.device)
    count = torch.empty(1, dtype=torch.int32, device=mask.device)
    compact_rows(mask, [rows], [out], count=count, order=order)
    return out, order, count


def scatter_rows(perm: torch.Tensor, leaves: list, outs: list):
    """Row i of every leaf to row perm[i] of its output (perm [m] int32, a
    permutation). The plain version for CPU tensors, the `scatter_rows`
    kernel (the inverse permutation, then a gather) for CUDA tensors."""
    if perm.device.type == "cpu":
        return scatter_rows_reference(perm, leaves, outs)
    if perm.device.type != "cuda":
        raise ValueError(f"unsupported device {perm.device}")
    m = perm.shape[0]
    if perm.dtype != torch.int32 or not perm.is_contiguous():
        raise ValueError("scatter_rows: perm must be contiguous int32")
    for s, d in zip(leaves, outs):
        if d.shape[0] != m:
            raise ValueError("scatter_rows: each output has m rows")
    src, dst, rb = _leaf_arrays(leaves, outs, m, perm.device)
    inv = torch.empty(m, dtype=torch.int32, device=perm.device)
    load_library().call("scatter_rows", perm.data_ptr(), m, len(leaves),
                        src.ctypes.data, dst.ctypes.data, rb.ctypes.data,
                        inv.data_ptr(),
                        torch.cuda.current_stream(perm.device).cuda_stream)
    scatter_counter.launches += 1
