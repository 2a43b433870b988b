"""Brick-pool sampling: the `brick_sample` CUDA kernel
(`csrc/brick_sample.cu`) and its plain version, counterpart of the JAX
package's XLA `brick_sample_fn` / `_pool_lookup`
(`instantvnr_tpu/render/brickcache.py:731-779`).

Per sample p in [0,1]³ (render/brickcache.py holds the pool's layout):

    cell  = clamp(floor(p·dims / 16), 0, mcdims − 1);  slot = lut[cell]
    x     = clamp(p · ss(dims − 1), 0, ss(dims − 1));  i0 = floor(x)
    local = clamp(i0 − (cell·16·ss − GHOST·ss), 0, brick − 2)
    row   = packed[max(slot, 0)·brick³ + (lz·brick + ly)·brick + lx]
    value = Σ_c row[c]·w[c]  (w[c] = (wz·wy)·wx, corners x fastest)

and 0 where slot < 0 (a macrocell the pool does not hold). The eight-term
sum is an explicit left-to-right chain in both versions, so the kernel
equals the plain version bit for bit; the JAX package's `jnp.sum` over
the corners sums in its own order, within 1e-6.
"""
from __future__ import annotations

import torch

from instantvnr_torch.ops.cuda_lib import LaunchCounter, count_ptr

counter = LaunchCounter()

GHOST = 2  # ghost voxels a side: the cell-centred remap's ≤1-texel shift,
# the floor, and ±1-voxel gradient probes (through the dilated neighbour)
BRICK = 16 + 2 * GHOST  # a macrocell (16³ voxels) and its ghosts: 20
_CELL = 16.0


def _brick_edge(ss: int) -> int:
    return ss * (BRICK - 1) + 1


def _rows(lut: torch.Tensor, p: torch.Tensor, dims: tuple, mcdims: tuple,
          ss: int = 1):
    """The pool addressing of samples p [N, 3] → (slot [N] int64, -1 on a
    miss; idx [N] int64, the corner-packed row, clamped to slot 0 on a
    miss; frac [N, 3], the trilinear fractions)."""
    dev = p.device
    brick = _brick_edge(ss)
    dims_t = torch.tensor([float(d) for d in dims], dtype=torch.float32,
                          device=dev)
    mcd = torch.tensor(list(mcdims), dtype=torch.int64, device=dev)
    pos_v = p * dims_t
    cell = torch.minimum(torch.clamp(torch.floor(pos_v / _CELL).to(
        torch.int64), min=0), mcd - 1)
    cflat = (cell[:, 2] * mcdims[1] + cell[:, 1]) * mcdims[0] + cell[:, 0]
    slot = lut[cflat].to(torch.int64)
    top = float(ss) * (dims_t - 1.0)
    x = torch.minimum(torch.clamp(p * top, min=0.0), top)
    i0f = torch.floor(x)
    frac = x - i0f
    local = torch.clamp(i0f.to(torch.int64) - (cell * (16 * ss) - GHOST * ss),
                        0, brick - 2)
    lflat = (local[:, 2] * brick + local[:, 1]) * brick + local[:, 0]
    idx = torch.clamp(slot, min=0) * brick ** 3 + lflat
    return slot, idx, frac


def brick_sample_reference(lut: torch.Tensor, packed: torch.Tensor,
                           p: torch.Tensor, dims: tuple, mcdims: tuple,
                           ss: int = 1) -> torch.Tensor:
    """Plain version: p [N, 3] → values [N] float32."""
    slot, idx, frac = _rows(lut, p, dims, mcdims, ss)
    rows = packed[idx].to(torch.float32)  # [N, 8]
    fx, fy, fz = frac[:, 0], frac[:, 1], frac[:, 2]
    wx = (1.0 - fx, fx)
    wy = (1.0 - fy, fy)
    wz = (1.0 - fz, fz)
    val = None
    for c in range(8):
        w = wz[(c >> 2) & 1] * wy[(c >> 1) & 1] * wx[c & 1]
        term = rows[:, c] * w
        val = term if val is None else val + term
    return torch.where(slot >= 0, val, 0.0)


def brick_sample(lut: torch.Tensor, packed: torch.Tensor, p: torch.Tensor,
                 dims: tuple, mcdims: tuple, ss: int = 1,
                 count: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version for CPU tensors, the `brick_sample` kernel (one
    thread a sample) for CUDA tensors.

    lut [mx·my·mz] int32, packed [n·brick³, 8] float32 or float16, p [N, 3]
    float32; dims (dx, dy, dz), mcdims (mx, my, mz), ss 1 or 2. count: an
    optional int32 [1] on the device, the compacted wavefront's count of
    valid rows: the rows past it are not sampled and hold no value (the
    plain version reads it on the host and samples the rows below it)."""
    if p.device.type == "cpu":
        if count is not None:
            n = int(count)
            out = p.new_zeros(p.shape[0])
            out[:n] = brick_sample_reference(lut, packed, p[:n], dims, mcdims,
                                             ss)
            return out
        return brick_sample_reference(lut, packed, p, dims, mcdims, ss)
    if p.device.type != "cuda":
        raise ValueError(f"unsupported device {p.device}")
    n = p.shape[0]
    mx, my, mz = (int(v) for v in mcdims)
    if ss not in (1, 2):
        raise ValueError(f"brick_sample: supersample {ss} (1 or 2)")
    if packed.dtype not in (torch.float32, torch.float16):
        raise ValueError(f"brick_sample: pool dtype {packed.dtype}")
    for name, a, shape, dt in (("p", p, (n, 3), torch.float32),
                               ("lut", lut, (mx * my * mz,), torch.int32),
                               ("packed", packed, (packed.shape[0], 8),
                                packed.dtype)):
        if a.device != p.device or a.dtype != dt or tuple(a.shape) != shape:
            raise ValueError(f"brick_sample: expected {name} {dt} {shape} on "
                             f"{p.device}, got {a.dtype} {tuple(a.shape)} on "
                             f"{a.device}")
    if packed.shape[0] % _brick_edge(ss) ** 3:
        raise ValueError("brick_sample: the pool is not whole bricks")
    p = p.contiguous()
    packed = packed.contiguous()
    if packed.data_ptr() % 16:
        packed = packed.clone()
    lut = lut.contiguous()
    from instantvnr_torch.ops.cuda_lib import load_library

    lib = load_library()
    out = torch.empty((n,), dtype=torch.float32, device=p.device)
    dx, dy, dz = (int(v) for v in dims)
    lib.call("brick_sample", lut.data_ptr(), packed.data_ptr(),
             int(packed.dtype == torch.float16), p.data_ptr(), n, dx, dy, dz,
             mx, my, mz, int(ss), out.data_ptr(),
             0 if count is None else count_ptr(count, p.device), 0,
             torch.cuda.current_stream(p.device).cuda_stream)
    counter.launches += 1
    return out
