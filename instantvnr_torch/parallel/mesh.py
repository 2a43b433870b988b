"""Process groups over ranks (counterpart of `instantvnr_tpu/parallel/
mesh.py`; the reference is single-GPU with no distributed backend at all).

Axis conventions, as in the JAX package:
  "data"  — rays / pixels / training samples (pure DP; rays are independent)
  "model" — hash-grid levels + first-MLP-layer rows (tensor parallel)
  "expert" — one expert field a rank (parallel/ep.py)

A `Mesh` lays the world's ranks out row-major over its axes, as
`np.reshape(devices, (n // tp, tp))` lays devices out in JAX: rank r sits at
data index r // tp and model index r % tp. Each axis has one process group
per line of ranks along it, made on every rank in the same order (as
`torch.distributed.new_group` requires), and each rank keeps the group of its
own line. A rank drives one device, `cuda:{LOCAL_RANK % device_count}` by
default, or the CPU when asked.

Every collective of the package goes through the four functions at the end
of this module (`all_reduce_mean_flat`, `all_reduce_sum`, `all_gather`,
`broadcast`), each of which adds one to its plain-integer counter where it
issues its collective, as the kernel wrappers count their launches;
parallel/inspect.py pins a program's counts.

`init_distributed` joins (or forms) the default group from torchrun's
environment or from explicit arguments, and `spawn` starts a group of rank
processes on this host and collects what each returns.
"""
from __future__ import annotations

import itertools
import math
import os
import queue
import socket
import time
import traceback
from dataclasses import dataclass, field
from datetime import timedelta

import torch
import torch.distributed as dist

from instantvnr_torch.ops.cuda_lib import LaunchCounter
from instantvnr_torch.utils.device import resolve_device

# a group that cannot form within this raises
GROUP_TIMEOUT = timedelta(seconds=300)

all_reduce_counter = LaunchCounter()
all_gather_counter = LaunchCounter()
broadcast_counter = LaunchCounter()


def collective_counters() -> dict:
    """Every collective's counter, by collective name."""
    return {"all_reduce": all_reduce_counter,
            "all_gather": all_gather_counter,
            "broadcast": broadcast_counter}


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a layout of the world's ranks over named axes.

    shape   {axis: size}, in axis order; the product is the world size
    index   {axis: this rank's index along the axis}
    groups  {axis: the process group of this rank's line along the axis}
    device  the device this rank computes on
    """

    shape: dict
    index: dict
    groups: dict = field(repr=False)
    device: torch.device

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    def axis_index(self, axis: str) -> int:
        return self.index[axis]


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: for a bare "cuda", cuda:{LOCAL_RANK mod the
    visible device count}; raises without CUDA (utils/device.py)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def init_distributed(device="cuda", backend: str | None = None,
                     rank: int | None = None, world_size: int | None = None,
                     init_method: str | None = None) -> torch.device:
    """Join the default process group and return this rank's device.

    The rank, world size and rendezvous come from the arguments, else from
    torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT). The backend is the caller's: a CUDA rank takes "nccl"
    unless it names "gloo" (two ranks sharing one card, which NCCL
    refuses); a CPU rank takes "gloo". A group that cannot form raises."""
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists")
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if init_method is None:
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=GROUP_TIMEOUT)
    return dev


def _require_group():
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call "
                           "parallel.mesh.init_distributed (or run under "
                           "parallel.mesh.spawn) first")


def _line_groups(shape: tuple, axis: int) -> tuple[list, list]:
    """Every line of ranks along `axis` of a row-major layout of `shape`
    → (lines, each a list of ranks; the index of each rank's line)."""
    coords = list(itertools.product(*(range(s) for s in shape)))
    lines: dict = {}
    for r, c in enumerate(coords):
        lines.setdefault(c[:axis] + c[axis + 1:], []).append(r)
    keys = list(lines)
    line_of = [keys.index(c[:axis] + c[axis + 1:]) for c in coords]
    return [lines[k] for k in keys], line_of


def _make_mesh(names: tuple, shape: tuple, dev: torch.device) -> Mesh:
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs "
                         f"{math.prod(shape)} ranks, the world has {world}")
    groups, index = {}, {}
    for a, name in enumerate(names):
        lines, line_of = _line_groups(shape, a)
        made = [dist.group.WORLD if len(line) == world
                else dist.new_group(line) for line in lines]
        line = lines[line_of[rank]]
        groups[name] = made[line_of[rank]]
        index[name] = line.index(rank)
    return Mesh(shape=dict(zip(names, shape)), index=index, groups=groups,
                device=dev)


def make_mesh(tp: int = 1, device="cuda") -> Mesh:
    """A 1-D ("data",) mesh over the world, or with tp > 1 a 2-D
    ("data", "model") mesh of world / tp rows of tp ranks."""
    dev = rank_device(device)
    _require_group()
    n = dist.get_world_size()
    if tp <= 1:
        return _make_mesh(("data",), (n,), dev)
    if n % tp:
        raise ValueError(f"{n} ranks not divisible by tp={tp}")
    return _make_mesh(("data", "model"), (n // tp, tp), dev)


def make_axis_mesh(name: str, device="cuda") -> Mesh:
    """A 1-D mesh over the world with one named axis."""
    dev = rank_device(device)
    _require_group()
    return _make_mesh((name,), (dist.get_world_size(),), dev)


def data_axis_size(mesh: Mesh) -> int:
    return mesh.shape["data"]


# -- the collectives ----------------------------------------------------------


def all_reduce_mean_flat(tensors: list, mesh: Mesh, axis: str) -> list:
    """The mean over `axis` of every tensor as ONE collective: all of them
    flattened into one float32 vector, one sum all-reduce, a division by
    the axis size, then split back into their shapes and dtypes."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.groups[axis])
    all_reduce_counter.launches += 1
    flat = flat / mesh.shape[axis]
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[off:off + n].reshape(t.shape).to(t.dtype))
        off += n
    return out


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of x over `axis`, in a new tensor."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.groups[axis])
    all_reduce_counter.launches += 1
    return out


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Every rank's x along `axis`, stacked in axis order → [n, *x.shape]."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x, group=mesh.groups[axis])
    all_gather_counter.launches += 1
    return torch.stack(parts)


def broadcast(x: torch.Tensor, mesh: Mesh, axis: str,
              src_index: int = 0) -> torch.Tensor:
    """x of the rank at `src_index` along `axis`, on every rank of the
    line, in a new tensor."""
    group = mesh.groups[axis]
    out = x.contiguous().clone()
    dist.broadcast(out, src=dist.get_global_rank(group, src_index),
                   group=group)
    broadcast_counter.launches += 1
    return out


# -- a group of rank processes on this host -----------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world_size, port, device, backend, args, results):
    os.environ["LOCAL_RANK"] = str(rank)  # one host: the local rank
    if device == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        dev = init_distributed(device, backend, rank=rank,
                               world_size=world_size,
                               init_method=f"tcp://127.0.0.1:{port}")
        try:
            out = fn(rank, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world_size: int, *args, device="cuda", backend=None,
          timeout: float = 600.0) -> list:
    """Run fn(rank, device, *args) in `world_size` new processes that form
    one process group on this host (over 127.0.0.1) → the list of their
    return values, by rank (each must pickle: numpy, not CUDA tensors).

    fn must be importable by name (a module-level function). The calling
    process joins no group. If a rank raises, exits or outlives `timeout`,
    every rank is killed and this raises with the rank's traceback."""
    import multiprocessing as mp

    if device != "cpu":
        resolve_device(device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, port, device, backend,
                               args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world_size:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the ranks did not finish within "
                                       f"{timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world_size)]
