"""Adam's update in one streaming pass: the `adam_step` CUDA kernel
(`csrc/adam.cu`), which `models/optimizer.py::adam_update` launches for a
tree on CUDA. Its plain form is `models/optimizer.py::adam_update_plain`
(the `torch._foreach_*` passes), bit for bit the same on the card.

- `adam_step(params, grads, mu, nu, l2, scalars)`: lists of float32
  leaves → new lists (p', m', v') from `torch.empty_like`, the inputs
  untouched. A tree of up to `MAX_LEAVES` leaves is one launch, a longer one
  a launch for every `MAX_LEAVES`.
- `pack_groups`: the host table the C entry reads, a row a leaf, cut into
  launch groups.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from instantvnr_torch.ops.cuda_lib import LaunchCounter, load_library

counter = LaunchCounter()

MAX_LEAVES = 8  # kMaxLeaves: the leaves a launch takes
# a leaf's row of the host table (csrc/adam.cu kFields): seven addresses,
# the element count, whether the leaf moves as float4 words, the l2 flag
FIELDS = ("p", "g", "m", "v", "p_out", "m_out", "v_out", "n", "vec", "l2")


class AdamScalars(NamedTuple):
    """A step's factors as the plain form hands them to PyTorch (Python
    floats); PyTorch's kernels and the ctypes binding both round each to
    float32 (`1 − β1` is rounded from the double, not worked out in
    float32)."""

    lr: float
    beta1: float
    one_minus_beta1: float
    beta2: float
    one_minus_beta2: float
    c1: float  # 1 − β1^t
    c2: float  # 1 − β2^t
    epsilon: float
    l2_reg: float


def pack_groups(ins: list, outs: list, l2: list) -> list:
    """The C entry's table, a row a leaf, in launch groups of at most
    MAX_LEAVES rows (int64 [k, len(FIELDS)] each). `ins[i]` is leaf i's
    (p, g, m, v) and `outs[i]` its (p', m', v'); a leaf vectorises where
    all seven are 16-byte aligned. Leaves with no elements are left out."""
    flat = []
    for (p, g, m, v), (po, mo, vo), use in zip(ins, outs, l2, strict=True):
        n = p.numel()
        if n:
            ptrs = (p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                    po.data_ptr(), mo.data_ptr(), vo.data_ptr())
            vec = not (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3] | ptrs[4]
                       | ptrs[5] | ptrs[6]) & 15
            flat += (*ptrs, n, vec, use)
    table = np.array(flat, np.int64).reshape(-1, len(FIELDS))
    return [table[i:i + MAX_LEAVES] for i in range(0, len(table), MAX_LEAVES)]


def _check(leaf: tuple, device):
    """A leaf's (p, g, m, v): contiguous float32 of p's shape on
    `device`."""
    shape = leaf[0].shape
    for t in leaf:
        if not (t.dtype is torch.float32 and t.is_contiguous()
                and t.shape == shape and t.device == device):
            raise ValueError(
                f"adam_step takes contiguous float32 leaves of the params' "
                f"shapes on {device} (got {t.dtype} {tuple(t.shape)}, "
                f"contiguous={t.is_contiguous()}, on {t.device}; param "
                f"{tuple(shape)})")


def adam_step(params: list, grads: list, mu: list, nu: list, l2: list,
              s: AdamScalars):
    """One Adam step over every leaf on CUDA → (p', m', v') lists of new
    tensors; `l2[i]` says whether leaf i takes the l2 term."""
    device = params[0].device
    if device.type != "cuda":
        raise ValueError(f"adam_step runs on CUDA tensors, got {device}")
    ins = list(zip(params, grads, mu, nu, strict=True))
    for leaf in ins:
        _check(leaf, device)
    outs = [(torch.empty_like(p), torch.empty_like(m), torch.empty_like(v))
            for p, _, m, v in ins]
    lib = load_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    for table in pack_groups(ins, outs, l2):
        lib.call("adam_step", table.ctypes.data, len(table), *s, stream)
        counter.launches += 1
    return tuple(list(x) for x in zip(*outs))
