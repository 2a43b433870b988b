"""Bucketed ray compaction, schedule replay and whole-frame CUDA graphs
for the wavefront and the path tracer (counterpart of
`instantvnr_tpu/render/compaction.py`).

The masked wavefront marches every ray until the last one dies: each
superstep pays for all R rays however few are alive, and on the card each
waits on the host twice (the valid-slot selection and the any(active)
test). This module keeps the live rays in a prefix [0:m] of full-size
per-ray buffers:

  - a superstep runs on the prefix only, selects its valid slots on the
    device (render/raymarch.py::_Slots) and leaves the live count in
    device memory, copied to pinned host memory without a wait;
  - when the count falls to a smaller bucket (`_bucket`: powers of two from
    `_MIN_BUCKET`, with their 1.5× midpoints), `compact_rows`
    (ops/compaction.py, a kernel of csrc/compaction.cu) moves the live rays
    to the front, with their inputs, state and slot → pixel permutation,
    and the prefix shrinks;
  - at or below `finish_bucket` the tail runs to completion ("F"), in
    chunks of `_FINISH_CHUNK` supersteps with one count read after each (a
    CUDA graph cannot loop on a device condition), the last chunk cut to
    the budget left;
  - `scatter_rows` puts the slots back in pixel order.

The schedule of a frame (`ops`: ("S", m) supersteps, ("C", m, count)
compactions, ("F", m) the finisher) is JAX's for the same counts. The next
frame of a progressive accumulation replays it without waiting on any count
(`_replay`), and checks afterwards that every compaction kept its live rays
(a count before a compaction ≤ its bucket), at once or at the next frame
(`deferred_validation`, `settle_pending`); an invalid frame is rolled back
and re-rendered serialized. A ray's march does not depend on its slot, so
every schedule gives the masked march's frame.

On the card each bucket's superstep, finisher chunk and compaction runs
eagerly the first time and is captured as a CUDA graph the second
(`_Programs`); every graph shares one memory pool and reads buffers whose
addresses stay fixed (the per-ray buffers, a static light and, for the
path tracer, static frame constants). A graph's inputs are fingerprinted:
new weights, a new transfer function or pool that lands at other addresses
makes the programs be captured anew, never replay stale reads. Once a
schedule has replayed unchanged twice (JAX's trigger for its fused
program), the whole recorded frame (the initial state, every band's
schedule, the unpermute and the accumulation) is captured as one graph
(`fused_frame`), its live counts written to one device row that is copied
to the host once; its finisher runs the supersteps the recorded frame
needed, rounded up to a chunk, and a count after it joins the validity
checks. A replay adds to each kernel's launch counter the launches its
capture recorded. A failed capture raises.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import time
from collections import deque

import torch

from instantvnr_torch.ops.compaction import compact_rows, scatter_rows
from instantvnr_torch.ops.cuda_lib import LaunchCounter

_MIN_BUCKET = 8192
# Midpoint buckets: admit 3·2^k prefix sizes between the powers of two
# (JAX's default; VNR_BUCKET_MIDPOINTS=0 keeps powers of two only).
_MIDPOINT_BUCKETS = os.environ.get("VNR_BUCKET_MIDPOINTS", "1") == "1"
# at or below this prefix the tail runs to completion (the JAX package's
# threshold; RaymarchSettings.finish_bucket overrides it)
_FINISH_BUCKET = 32768
_REPLAY_HEADROOM = 0.95  # see _replay
# supersteps between two count reads of a finisher
_FINISH_CHUNK = 8
# a fused frame is captured once its schedule repeats unchanged (tests turn
# it off to pin the per-dispatch path)
FUSED_AUTOCOMPILE = True
_FUSED_MAX = 64  # fused frames kept per renderer


def _bucket(count: int, r: int) -> int:
    """Smallest admissible prefix ≥ count (≥ _MIN_BUCKET, ≤ r): powers of
    two, plus their 1.5× midpoints when _MIDPOINT_BUCKETS."""
    m = _MIN_BUCKET
    while m < count:
        if _MIDPOINT_BUCKETS and count <= m + m // 2:
            return min(m + m // 2, r)
        m *= 2
    return min(m, r)


def _next_bucket(m: int, r: int) -> int:
    """The admissible size one rung above m (replay's headroom bump)."""
    return min(_bucket(m + 1, r), r)


def bucket_sizes(r: int) -> list[int]:
    """Every bucket the loop can run for frame size r, descending: r and
    the powers of two in [_MIN_BUCKET, r) (with their midpoints)."""
    sizes = [r]
    m = _MIN_BUCKET
    while m < r:
        sizes.append(m)
        if _MIDPOINT_BUCKETS and m + m // 2 < r:
            sizes.append(m + m // 2)
        m *= 2
    return sorted(set(sizes), reverse=True)


def _fusable(ops) -> bool:
    """Only a schedule that ends in a finisher can fuse: anything else needs
    count reads mid-frame to end."""
    return bool(ops) and ops[-1][0] == "F"


def strip_counts(ops) -> tuple:
    """Recorded ops as (kind, bucket) pairs: a fused frame depends on the
    bucket sequence, not on the counts a "C" op carries."""
    return tuple((op[0], op[1]) for op in ops)


def bump_schedule(ops, r: int) -> tuple:
    """One rung of motion tolerance on a stripped schedule: every
    compaction moves to the next admissible bucket, "S"/"F" follow, and a
    compaction that no longer shrinks the prefix is dropped (JAX's
    `bump_schedule`). A renderer sets schedule_cache["bump_next"] on a
    change of camera, TF or weights; the recorded schedule stays tight."""
    out = []
    m = r
    for kind, bucket in ops:
        if kind == "C":
            nb = min(_next_bucket(bucket, r), r)
            if nb >= m:
                continue
            m = nb
            out.append(("C", m))
        else:
            out.append((kind, m))
    return tuple(out)


# -- counts on the host --------------------------------------------------


class _Count:
    """A live count copied from the device without a wait (pinned memory
    and an event on the card); int() waits for that copy only."""

    __slots__ = ("host", "event")

    def __init__(self, dev: torch.Tensor):
        if dev.device.type == "cuda":
            self.host = torch.empty(dev.numel(), dtype=torch.int32,
                                    pin_memory=True)
            self.host.copy_(dev.reshape(-1), non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = dev.reshape(-1).clone()
            self.event = None

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        return self.host

    def __int__(self):
        return int(self.wait()[0])


class _CountRow:
    """int() of one entry of a fused frame's counts row (the row is copied
    once, read per entry)."""

    __slots__ = ("row", "i")

    def __init__(self, row: _Count, i: int):
        self.row = row
        self.i = i

    def __int__(self):
        return int(self.row.wait()[self.i])


# -- programs: eager first, then CUDA graphs -------------------------------


def _snapshot() -> list:
    return [c.launches for c in LaunchCounter.instances]


def _add_launches(delta):
    for c, d in zip(LaunchCounter.instances, delta):
        c.launches += d


# device → (the graphs' shared memory pool, a graph that keeps it): a
# pool is released once no graph captured into it is alive, and its handle
# must not be used again then, so one small graph lives as long as the
# process
_POOLS: dict = {}
# graphs captured in this process and their capture ms (for reports)
CAPTURED = {"graphs": 0, "ms": 0.0}


_STREAMS: dict = {}  # device → the side stream graphs are captured on


def _capture(device, fn, generators=()):
    """Capture fn() as a CUDA graph in the shared pool, on a side stream →
    (graph, the launches the capture recorded, capture ms). The capture
    executes nothing; the counters are set back to what they were. Raises
    if the capture fails."""
    before = _snapshot()
    t0 = time.perf_counter()
    stream = _STREAMS.get(device)
    if stream is None:
        stream = _STREAMS[device] = torch.cuda.Stream(device)
    main = torch.cuda.current_stream(device)
    free, total = torch.cuda.mem_get_info(device)
    if free < total // 4:
        # the cached blocks go back first (torch.cuda.graph does so at
        # every capture): a pool that runs out of memory mid-capture would
        # make the allocator free cached blocks, and a cudaFree there
        # invalidates the capture
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    stream.wait_stream(main)
    if device not in _POOLS:
        keeper = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            keeper.capture_begin(capture_error_mode="thread_local")
            torch.zeros(1, device=device)
            keeper.capture_end()
        _POOLS[device] = (keeper.pool(), keeper)
    g = torch.cuda.CUDAGraph()
    for gen in generators:
        g.register_generator_state(gen)
    # no collection of cyclic garbage mid-capture (a pinned host buffer
    # freed there makes PyTorch's host allocator query events on the card,
    # which invalidates the capture; it is collected after), and an
    # operation that waits for the card raises where it is called
    gc.disable()
    sync_mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(stream), torch.no_grad():
            g.capture_begin(pool=_POOLS[device][0],
                            capture_error_mode="thread_local")
            try:
                fn()
            finally:
                g.capture_end()
    finally:
        torch.cuda.set_sync_debug_mode(sync_mode)
        gc.enable()
    main.wait_stream(stream)
    ms = (time.perf_counter() - t0) * 1e3
    CAPTURED["graphs"] += 1
    CAPTURED["ms"] += ms
    after = _snapshot()
    delta = [a - b for a, b in zip(after, before)]
    _add_launches([-d for d in delta])
    return g, delta, ms


class _Programs:
    """The bucket programs of one band: each key ((kind, bucket[, steps]))
    runs eagerly the first time it is asked for and, on the card, is
    captured as a CUDA graph the second time and replayed from then on.
    `key` fingerprints what the programs read; a new fingerprint drops
    them."""

    def __init__(self, device, key=None, generators=(), graphs=True):
        self.device = device
        self.key = key
        self.generators = tuple(generators)
        self.eager = device.type != "cuda" or not graphs
        self.graphs: dict = {}
        self.seen: set = set()

    def run(self, key, fn):
        if self.eager:
            fn()
            return
        entry = self.graphs.get(key)
        if entry is None:
            if key not in self.seen:
                self.seen.add(key)
                fn()
                return
            g, delta, _ = _capture(self.device, fn, self.generators)
            entry = self.graphs[key] = (g, delta)
        entry[0].replay()
        _add_launches(entry[1])


def fingerprint(obj):
    """Hashable description of what a program reads: each tensor by its
    address, shape, type and device; containers, dataclasses and named
    tuples by their parts; anything else by value (or identity)."""
    if isinstance(obj, torch.Tensor):
        return ("T", obj.data_ptr(), tuple(obj.shape), str(obj.dtype),
                str(obj.device))
    if isinstance(obj, dict):
        return ("D",) + tuple((k, fingerprint(obj[k]))
                              for k in sorted(obj, key=str))
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__,) + tuple(fingerprint(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            fingerprint(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    try:
        hash(obj)
        return obj
    except TypeError:
        return ("id", id(obj))


# -- the loop --------------------------------------------------------------


def _serial_loop(r, m, used, count, frame, ops, budget_total, budget_step,
                 finish_bucket, speculate):
    """The serialized bucketed loop, shared by a fresh frame and the
    continuation after a replay. Appends every op it runs to `ops`.
    `speculate` > 0 keeps that many counts in flight and acts on them stale
    (counts only fall within a frame, so the bucket stays ≥ live)."""
    spec = max(int(speculate), 0)
    pending = deque()
    while count > 0 and used < budget_total:
        if m <= finish_bucket:
            frame.finish(m, budget_total - used)
            ops.append(("F", m))
            break
        n_live = frame.superstep(m)
        used += budget_step
        ops.append(("S", m))
        pending.append(n_live)
        if len(pending) > spec:
            count = int(pending.popleft())  # a host read (stale by spec)
            if count > 0 and _bucket(count, r) < m:
                ops.append(("C", _bucket(count, r), count))
                frame.compact(m)
                m = _bucket(count, r)


def _record(schedule_cache, ops, frame):
    schedule_cache["ops"] = ops
    schedule_cache["finish_steps"] = frame.finish_steps


def _replay(r, frame, budget_total, budget_step, finish_bucket, speculate,
            schedule_cache, defer=False, bump=False):
    """Replay the previous frame's schedule without reading a count until
    its end (JAX's `_replay`): a compaction was safe iff the count just
    before it was ≤ its bucket. A compaction bucket gets one rung of
    headroom where the recorded count was within _REPLAY_HEADROOM of it,
    or under `bump` (motion): one rung either way, bump_schedule's. (JAX
    stacks the two, :678-683, two rungs for a near-boundary count under
    motion, against its own fused path's one; ROADMAP Queue 3.) With
    defer the checks are left in schedule_cache["pending"] for
    `settle_pending`; otherwise they are read here and an unsafe replay
    returns False (the caller re-renders serialized)."""
    ops = schedule_cache["ops"]
    frame.initial()
    init_handle = frame.count_handle()
    m = r
    used = 0
    counts = []  # count handles, one a replayed superstep
    checks = []  # (index into counts just before a compaction, bucket)
    replayed = []
    for op in ops:
        if op[0] == "C":
            m_new, c_just = op[1], op[2]
            if bump or c_just > _REPLAY_HEADROOM * m_new:
                m_new = _next_bucket(m_new, r)
            if m_new >= m:
                continue
            checks.append((len(counts) - 1, m_new))
            frame.compact(m)
            replayed.append(("C", m_new, c_just))
            m = m_new
        elif op[0] == "S":
            if used >= budget_total or m <= finish_bucket:
                break  # the finisher below takes over
            counts.append(frame.superstep(m))
            used += budget_step
            replayed.append(("S", m))
        else:  # "F": run by the tail below
            break
    pend = [(init_handle if ci < 0 else counts[ci], m_new)
            for ci, m_new in checks]
    if used < budget_total and m <= finish_bucket:
        frame.finish(m, budget_total - used)
        replayed.append(("F", m))
        if not bump:  # a bumped replay never overwrites the tight record
            _record(schedule_cache, replayed, frame)
        if defer:
            if pend:
                schedule_cache["pending"] = pend
            return True
        return all(int(h) <= m_new for h, m_new in pend)
    # the bucket is still above the finisher's: validate now, continue
    # serialized
    if not all(int(h) <= m_new for h, m_new in pend):
        return False
    if used < budget_total:
        live = int(counts[-1]) if counts else int(init_handle)
        if live > 0:
            if _bucket(live, r) < m:
                replayed.append(("C", _bucket(live, r), live))
                frame.compact(m)
                m = _bucket(live, r)
            _serial_loop(r, m, used, live, frame, replayed, budget_total,
                         budget_step, finish_bucket, speculate)
    if not bump:
        _record(schedule_cache, replayed, frame)
    return True


def settle_pending(schedule_cache: dict) -> bool:
    """Resolve a deferred replay's checks (schedule_cache["pending"]): True
    when the provisional frame was valid. On False the caller discards that
    frame; the recorded schedule (of every band in
    schedule_cache["pending_subs"]) is cleared so the next frame records
    anew. True when nothing is pending."""
    pend = schedule_cache.pop("pending", None)
    subs = schedule_cache.pop("pending_subs", None)
    if not pend:
        return True
    if all(int(h) <= m_new for h, m_new in pend):
        return True
    for c in (subs or [schedule_cache]):
        c.pop("ops", None)
    schedule_cache["invalidated"] = schedule_cache.get("invalidated", 0) + 1
    return False


def drive_compacted(r, frame, budget_total, budget_step, finish_bucket,
                    speculate=0, schedule_cache=None, sched_key=None,
                    defer=False):
    """Host orchestration shared by the compacted wavefront and path tracer:
    bucketed supersteps, compaction and the finisher, with schedule replay
    when `schedule_cache` is a dict the caller owns. `frame` runs the
    programs: initial(), count_handle(), superstep(m) → count handle,
    finish(m, budget), compact(m), and keeps finish_steps. The results stay
    in the frame's buffers."""
    bump = (bool(schedule_cache.pop("bump_next", False))
            if schedule_cache is not None else False)
    if (schedule_cache is not None and schedule_cache.get("ops")
            and schedule_cache.get("key") == sched_key):
        if _replay(r, frame, budget_total, budget_step, finish_bucket,
                   speculate, schedule_cache, defer=defer, bump=bump):
            schedule_cache["replays"] = schedule_cache.get("replays", 0) + 1
            return
        schedule_cache["invalidated"] = (
            schedule_cache.get("invalidated", 0) + 1)
    if schedule_cache is not None:
        schedule_cache["serialized"] = schedule_cache.get("serialized", 0) + 1
    frame.initial()
    ops = []
    m = r
    count = int(frame.count_handle())
    # compact at once if most rays miss (an all-miss frame skips even that)
    if count > 0 and _bucket(count, r) < m:
        ops.append(("C", _bucket(count, r), count))
        frame.compact(m)
        m = _bucket(count, r)
    _serial_loop(r, m, 0, count, frame, ops, budget_total, budget_step,
                 finish_bucket, speculate)
    if schedule_cache is not None:
        schedule_cache["key"] = sched_key
        _record(schedule_cache, ops, frame)


def _chunks(n: int):
    """n supersteps as powers of two, largest first (one graph each)."""
    out, p = [], _FINISH_CHUNK
    while n > 0:
        while p > n:
            p //= 2
        out.append(p)
        n -= p
    return out


class Band:
    """One band's full-size per-ray buffers (`home`; `scratch` their twins
    for the compaction), a live count and the band's programs. A renderer
    keeps one in each schedule cache it drives (`band_of`), so the
    addresses its graphs read stay fixed across frames."""

    def __init__(self, r: int, device, leaves: dict):
        self.r = r
        self.device = device
        self.home = {n: torch.zeros((r,) + shape, dtype=dt, device=device)
                     for n, (shape, dt) in leaves.items()}
        self.scratch = {n: torch.empty_like(t) for n, t in self.home.items()}
        self.count = torch.zeros(1, dtype=torch.int32, device=device)
        # the count after each superstep of a finisher chunk
        self.fcounts = torch.zeros(_FINISH_CHUNK, dtype=torch.int32,
                                   device=device)
        self.statics: dict = {}
        self.programs = _Programs(device)

    def static(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """A buffer of fixed address holding `value` (copied in)."""
        buf = self.statics.get(name)
        if (buf is None or buf.shape != value.shape
                or buf.dtype != value.dtype):
            buf = self.statics[name] = torch.empty_like(value)
        buf.copy_(value)
        return buf

    def use(self, key, generators=(), graphs=True):
        """Keep the programs if `key` is the fingerprint they were made
        for, else start anew (eager only without `graphs`: a uniform source
        a graph cannot capture)."""
        if self.programs.key != key:
            self.programs = _Programs(self.device, key, generators, graphs)

    def compact_now(self, m: int):
        """compact_rows over the prefix [0:m] of every leaf, in place."""
        h, s = self.home, self.scratch
        names = list(h)
        compact_rows(h["active"][:m], [h[n][:m] for n in names],
                     [s[n][:m] for n in names], copy_back=True)

    def compact(self, m: int):
        self.programs.run(("C", m), lambda: self.compact_now(m))

    def count_handle(self) -> _Count:
        self.count.copy_(self.home["active"].sum(dtype=torch.int32)
                         .reshape(1))
        return _Count(self.count)


def band_of(schedule_cache, r: int, device, leaves: dict) -> Band:
    """The band kept in a schedule cache (made or remade for this size)."""
    if schedule_cache is None:
        return Band(r, device, leaves)
    band = schedule_cache.get("_band")
    if band is None or band.r != r or band.device != device or set(
            band.home) != set(leaves):
        band = schedule_cache["_band"] = Band(r, device, leaves)
    return band


class BandFrame:
    """The programs of one frame on a band (the `frame` of
    drive_compacted): `step(m)` advances the prefix [0:m] in place by one
    superstep (or the path tracer's events_per_dispatch events) and leaves
    its live count in band.count; `load()` writes the initial state."""

    def __init__(self, band: Band, step, load, unit: int = 1,
                 stats: dict | None = None, stat_name: str = "supersteps",
                 light: torch.Tensor | None = None, restart=None):
        self.band = band
        self.step = step
        self.load = load
        self.unit = unit  # events (supersteps) a superstep dispatch runs
        self.light = light  # the static light the steps read
        self.restart = restart  # (mark, rewind) of the frame's draws
        self.started = False
        self.stats = stats
        self.stat_name = stat_name
        self.finish_steps = 0

    def _stat(self, n: int):
        if self.stats is not None:
            self.stats[self.stat_name] = self.stats.get(self.stat_name, 0) + n

    def initial(self):
        if self.restart is not None:
            self.restart[1 if self.started else 0]()
        self.started = True
        self.load()

    def count_handle(self) -> _Count:
        return self.band.count_handle()

    def superstep(self, m: int) -> _Count:
        self.band.programs.run(("S", m), lambda: self.step(m, 1))
        self._stat(self.unit)
        return _Count(self.band.count)

    def finish(self, m: int, budget: int):
        """Run the tail to completion: chunks of _FINISH_CHUNK steps (the
        last cut to the budget left, as powers of two), one read after each
        of the counts its steps left in band.fcounts. finish_steps: the
        steps until no ray was left (the budget if some outlived it)."""
        used = ran = 0
        while used < budget:
            for p in _chunks(min(_FINISH_CHUNK, budget - used)):
                self.band.programs.run(("F", m, p),
                                       lambda p=p: self.step(m, p, True))
                ran += p
                dead = (_Count(self.band.fcounts[:p]).wait() == 0).nonzero()
                if dead.numel():
                    used += int(dead[0, 0]) + 1
                    break
                used += p
            else:
                continue
            break
        self._stat(ran)
        self.finish_steps = used

    def compact(self, m: int):
        self.band.compact(m)


# -- the compacted wavefront ------------------------------------------------

_F32, _BOOL, _I32 = torch.float32, torch.bool, torch.int32
WAVEFRONT_LEAVES = {
    "org": ((3,), _F32), "dirn": ((3,), _F32), "t_far": ((), _F32),
    "jitter": ((), _F32), "t": ((), _F32), "t_cell_end": ((), _F32),
    "ss": ((), _F32), "alpha": ((), _F32), "color": ((3,), _F32),
    "active": ((), _BOOL), "best_w": ((), _F32), "best_pos": ((3,), _F32),
    "best_rgb": ((3,), _F32), "perm": ((), _I32)}
_STATE_LEAVES = ("t", "t_cell_end", "ss", "alpha", "color", "active",
                 "best_w", "best_pos", "best_rgb")
_OUT_LEAVES = ("color", "alpha", "best_w", "best_pos", "best_rgb")


def _wavefront_frame(band: Band, sample_fn, sample_ctx, mc, tf, settings,
                     light, scale, shadow_vol, inputs, stats) -> BandFrame:
    """A BandFrame of the wavefront: inputs = (org, dirn, t_near, t_far,
    jitter) of the band's rays."""
    from functools import partial

    from instantvnr_torch.render.raymarch import _RayState, _superstep

    band.use((fingerprint(sample_fn), fingerprint(sample_ctx),
              fingerprint(mc), fingerprint(tf), settings,
              fingerprint(scale), fingerprint(shadow_vol)))
    light_s = band.static("light", light)
    fn = partial(sample_fn, sample_ctx)
    h = band.home

    def load():
        org, dirn, t_near, t_far, jitter = inputs
        h["org"].copy_(org)
        h["dirn"].copy_(dirn)
        h["t_far"].copy_(t_far)
        h["jitter"].copy_(jitter)
        h["t"].copy_(t_near)
        h["t_cell_end"].copy_(t_near)
        h["ss"].fill_(float("inf"))
        for n in ("alpha", "color", "best_w", "best_pos", "best_rgb"):
            h[n].zero_()
        torch.lt(t_near, t_far, out=h["active"])
        torch.arange(band.r, dtype=_I32, device=band.device, out=h["perm"])

    def step(m: int, n: int, finishing: bool = False):
        """n supersteps on [0:m]; a finisher's leave each count in
        band.fcounts."""
        for i in range(n):
            state = _RayState(*(h[k][:m] for k in _STATE_LEAVES))
            new = _superstep(fn, h["org"][:m], h["dirn"][:m], h["t_far"][:m],
                             h["jitter"][:m], mc, tf, settings, light_s,
                             state, scale=scale, shadow_vol=shadow_vol,
                             counted=True)
            for k, old, val in zip(_STATE_LEAVES, state, new):
                if val is not old:
                    h[k][:m].copy_(val)
            if finishing:
                band.fcounts[i:i + 1].copy_(
                    h["active"][:m].sum(dtype=_I32).reshape(1))
        band.count.copy_(h["active"][:m].sum(dtype=_I32).reshape(1))

    return BandFrame(band, step, load, stats=stats, light=light_s)


def _unpermute_wavefront(band: Band):
    """Slot → pixel order (scatter_rows) → (color, alpha, best_w, best_pos,
    best_rgb) in pixel order."""
    h = band.home
    outs = [torch.empty_like(h[n]) for n in _OUT_LEAVES]
    scatter_rows(h["perm"], [h[n] for n in _OUT_LEAVES], outs)
    return outs


def _band_layout(r: int, settings, scale, shadow_vol):
    """The (start, stop, sub_settings, sub_cache_key, sched_key) of every
    band of a frame (JAX's `_band_layout`; mirrors raymarch_compacted)."""
    t_ = settings.tiles
    if t_ <= 1:
        sk = (r, dataclasses.astuple(settings), scale is None,
              shadow_vol is None)
        return [(0, r, settings, None, sk)]
    band = -(-r // t_)
    sub_settings = dataclasses.replace(settings, tiles=1)
    out = []
    for i in range(t_):
        a = i * band
        b = min((i + 1) * band, r)
        if a >= r:
            break
        sk = (b - a, dataclasses.astuple(sub_settings), scale is None,
              shadow_vol is None)
        out.append((a, b, sub_settings, f"tile{i}", sk))
    return out


@torch.no_grad()
def raymarch_compacted(sample_fn, org, dirn, t_near, t_far, mc, tf, jitter,
                       settings, light_dir=None, sample_ctx=None, scale=None,
                       clip_lower=None, clip_upper=None, shadow_vol=None,
                       schedule_cache: dict | None = None,
                       defer: bool = False, stats: dict | None = None):
    """`raymarch` with bucketed ray compaction: the same frame (rgba [R,
    4]), bit for bit on the card, under any schedule. sample_fn is called
    as sample_fn(sample_ctx, positions) (and with count= where it takes
    one). schedule_cache: the caller's dict for replay (and the band's
    buffers and programs); defer: leave the replay's checks pending for
    `settle_pending`. stats: an optional dict whose "supersteps" this frame
    adds to."""
    from instantvnr_torch.render.raymarch import ssh_deferred_shade
    from instantvnr_torch.utils.device import device_constant
    from instantvnr_torch.utils.math import normalize

    r = org.shape[0]
    if settings.tiles > 1:
        # frame tiling: each contiguous band of rays through its own
        # schedule (RaymarchSettings.tiles); the pendings gather in the top
        # cache so the renderer settles one verdict a frame
        t_ = settings.tiles
        band = -(-r // t_)
        sub_settings = dataclasses.replace(settings, tiles=1)
        if (schedule_cache is not None
                and schedule_cache.pop("bump_next", False)):
            for i in range(t_):
                schedule_cache.setdefault(f"tile{i}", {})["bump_next"] = True
        outs, pend, subs = [], [], []
        for i in range(t_):
            sl = slice(i * band, min((i + 1) * band, r))
            if sl.start >= r:
                break
            sub_cache = (None if schedule_cache is None
                         else schedule_cache.setdefault(f"tile{i}", {}))
            outs.append(raymarch_compacted(
                sample_fn, org[sl], dirn[sl], t_near[sl], t_far[sl], mc, tf,
                jitter[sl], sub_settings, light_dir=light_dir,
                sample_ctx=sample_ctx, scale=scale, clip_lower=clip_lower,
                clip_upper=clip_upper, shadow_vol=shadow_vol,
                schedule_cache=sub_cache, defer=defer, stats=stats))
            if sub_cache is not None and "pending" in sub_cache:
                pend.extend(sub_cache.pop("pending"))
                subs.append(sub_cache)
        if pend:
            schedule_cache["pending"] = pend
            schedule_cache["pending_subs"] = subs
        return torch.cat(outs, dim=0)
    dev = org.device
    dims = device_constant(tuple(float(d) for d in mc.volume_dims), _F32, dev)
    if light_dir is None:
        light_dir = device_constant(tuple(settings.light_dir), _F32, dev)
    light_dir = normalize(light_dir)
    replay_cache = schedule_cache if settings.schedule_replay else None
    band = band_of(schedule_cache, r, dev, WAVEFRONT_LEAVES)
    frame = _wavefront_frame(band, sample_fn, sample_ctx, mc, tf, settings,
                             light_dir, scale, shadow_vol,
                             (org, dirn, t_near, t_far, jitter), stats)
    sched_key = (r, dataclasses.astuple(settings), scale is None,
                 shadow_vol is None)
    drive_compacted(r, frame, settings.max_supersteps, 1,
                    settings.finish_bucket or _FINISH_BUCKET,
                    speculate=settings.speculate,
                    schedule_cache=replay_cache, sched_key=sched_key,
                    defer=defer)
    color, alpha, bw, bp, bc = _unpermute_wavefront(band)
    if settings.shading == "ssh":
        # the deferred single-shade pass, in pixel order; its shadow rays
        # march through the same loop too, in their own schedule cache
        def march_shadow(org2, dir2, t0b, t1b, sh_settings, sh_jitter):
            return raymarch_compacted(
                sample_fn, org2, dir2, t0b, t1b, mc, tf, sh_jitter,
                sh_settings, sample_ctx=sample_ctx, scale=scale,
                clip_lower=clip_lower, clip_upper=clip_upper,
                schedule_cache=(None if schedule_cache is None
                                else schedule_cache.setdefault("ssh", {})),
                stats=stats)

        color = ssh_deferred_shade(march_shadow, color, alpha, bw, bp, bc,
                                   light_dir, dims, settings, scale,
                                   clip_lower, clip_upper, jitter)
    return torch.cat([color, alpha[:, None]], dim=-1)


@torch.no_grad()
def warmup_programs(sample_fn, settings, mc, tf, r: int, sample_ctx=None,
                    scale=None, shadow_vol=None, schedule_cache=None) -> int:
    """Run the bucket family of frame size r once (JAX's warmup_programs):
    each bucket's superstep or finisher chunk and its compaction, on rays
    that all miss (t_far = 0), twice, so that on the card every program's
    CUDA graph is captured before the first timed frame. Returns the
    number of bucket sizes warmed."""
    dev = mc.max_opacity.device
    zeros = torch.zeros(r, dtype=_F32, device=dev)
    dirn = torch.zeros((r, 3), dtype=_F32, device=dev)
    dirn[:, 2] = 1.0
    cache = {} if schedule_cache is None else schedule_cache
    band = band_of(cache, r, dev, WAVEFRONT_LEAVES)
    light = torch.tensor(settings.light_dir, dtype=_F32, device=dev)
    from instantvnr_torch.utils.math import normalize

    frame = _wavefront_frame(band, sample_fn, sample_ctx, mc, tf, settings,
                             normalize(light), scale, shadow_vol,
                             (zeros[:, None].expand(r, 3), dirn, zeros, zeros,
                              zeros), None)
    finish_bucket = settings.finish_bucket or _FINISH_BUCKET
    sizes = bucket_sizes(r)
    for _ in range(2):
        frame.initial()
        for m in sizes:
            if m <= finish_bucket:
                for p in _chunks(_FINISH_CHUNK):
                    band.programs.run(("F", m, p),
                                      lambda m=m, p=p: frame.step(m, p))
            else:
                band.programs.run(("S", m), lambda m=m: frame.step(m, 1))
            band.compact(m)
    n = len(sizes)
    if settings.shading == "ssh":
        from instantvnr_torch.render.raymarch import ssh_shadow_settings

        n += warmup_programs(sample_fn, ssh_shadow_settings(settings), mc, tf,
                             r, sample_ctx=sample_ctx, scale=scale,
                             schedule_cache=(None if schedule_cache is None
                                             else schedule_cache.setdefault(
                                                 "ssh", {})))
    return n


# -- the fused whole frame -------------------------------------------------


class FusedFrame:
    """One recorded schedule as one program: static inputs (the frame's
    rays and jitter, the light), every band's initial state, schedule and
    unpermute, and the accumulation into a static accum with a device-side
    frame counter. On the card a CUDA graph; on the CPU the same function
    run eagerly. `pend_layout` maps the counts row to the validity
    checks."""

    def __init__(self, device, r: int, inputs: dict):
        self.device = device
        self.inputs = {n: torch.zeros((r,) + shape, dtype=_F32, device=device)
                       for n, shape in inputs.items()}
        self.accum, self.frame, self.rgba = (
            torch.zeros((r, 4), dtype=_F32, device=device) for _ in range(3))
        self.fidx = torch.zeros(1, dtype=_I32, device=device)
        self.light = torch.zeros(3, dtype=_F32, device=device)
        self.counts = None
        self.pend_layout = []
        self.supersteps = 0
        self.body = None
        self.graph = None
        self.delta = None

    def capture(self, generators=(), stats=None, stat_name="supersteps"):
        """On the card, capture the body as a CUDA graph, after one eager
        run (on the static inputs as they are: zeros at first, rays that
        all miss) that sets up what a capture cannot (cached constants,
        the first launch of a kernel); its supersteps go to `stats`."""
        if self.device.type == "cuda":
            with torch.no_grad():
                self.body()
            if stats is not None:
                stats[stat_name] = stats.get(stat_name, 0) + self.supersteps
            self.graph, self.delta, _ = _capture(self.device, self.body,
                                                 generators)

    @torch.no_grad()
    def run(self):
        if self.graph is not None:
            self.graph.replay()
            _add_launches(self.delta)
        else:
            self.body()


def _fused_finish(f_steps: int, left: int) -> int:
    """A fused frame's finisher: the supersteps the recorded frame's
    needed and half as many again (at least 2), within the budget left; a
    count after it tells whether that was enough (if not, the frame rolls
    back and the fused program is made anew from the next record)."""
    return min(left, f_steps + max(2, f_steps // 2))


def _fused_counts_body(frames, band_ops, budget_total, budget_step,
                       finish_steps, counts_out):
    """The schedule part of a fused frame for every band: → the list of
    count tensors (row entries) and the (entry index, bound) checks."""
    entries, checks = [], []
    for frame, ops, f_steps in zip(frames, band_ops, finish_steps):
        band = frame.band
        frame.load()
        entries.append(band.home["active"].sum(dtype=_I32).reshape(1))
        used = 0
        m = band.r
        for op in ops:
            if op[0] == "S":
                frame.step(m, 1)
                entries.append(band.count.clone())
                used += budget_step
            elif op[0] == "C":
                checks.append((len(entries) - 1, op[1]))
                band.compact_now(m)
                m = op[1]
            else:  # "F": the recorded frame's supersteps and headroom
                mf = op[1]
                left = budget_total - used
                n = _fused_finish(f_steps, left)
                for p in _chunks(n):
                    frame.step(mf, p, True)
                entries.append(band.count.clone())
                if n < left:
                    checks.append((len(entries) - 1, 0))
    counts_out.append(torch.cat(entries))
    return checks


def stable_bands(schedule_cache: dict, layout):
    """The bands ((start, stop, ops), ...) of a frame whose every band has
    a recorded schedule that ends in a finisher (bumped one rung under
    bump_next), with their caches and the finishers' recorded steps;
    (None, None, None) otherwise."""
    bump = bool(schedule_cache.get("bump_next"))
    bands, sub_caches = [], []
    for (a, b, _sub_settings, cache_key, sk) in layout:
        sub = (schedule_cache if cache_key is None
               else schedule_cache.get(cache_key))
        if (not sub or not sub.get("ops") or sub.get("key") != sk
                or not _fusable(tuple(sub["ops"]))):
            return None, None, None
        ops_sb = strip_counts(sub["ops"])
        if bump:
            ops_sb = bump_schedule(ops_sb, b - a)
            if not _fusable(ops_sb):
                return None, None, None
        bands.append((a, b, ops_sb))
        sub_caches.append(sub)
    return (tuple(bands), sub_caches,
            [int(c.get("finish_steps", 0)) for c in sub_caches])


def fused_lookup(schedule_cache: dict, key, build):
    """The fused frame of `key` (the schedule and what it reads), made by
    build() on the frame the schedule first repeats; None until then (and
    on that frame, which replays per dispatch)."""
    exes = schedule_cache.setdefault("_fused", {})
    exe = exes.get(key)
    if exe is None:
        if FUSED_AUTOCOMPILE and schedule_cache.get("_fused_prev") == key:
            if len(exes) >= _FUSED_MAX:
                exes.clear()
            exes[key] = build()
        schedule_cache["_fused_prev"] = key
    return exe


def fused_run(exe: "FusedFrame", accum, frame_index: int, schedule_cache,
              stats, stat_name: str = "supersteps"):
    """Run a fused frame after its static inputs were written: → (accum,
    frame, rgba, pend). The counts row is copied to the host without a
    wait; pend pairs each check's entry with its bound."""
    schedule_cache.pop("bump_next", None)  # consumed by this frame
    if accum is not None and accum is not exe.accum:
        exe.accum.copy_(accum)
    exe.fidx.fill_(frame_index)
    exe.run()
    counts = _Count(exe.counts)
    pend = [(_CountRow(counts, i), bound) for i, bound in exe.pend_layout]
    if stats is not None:
        stats[stat_name] = stats.get(stat_name, 0) + exe.supersteps
    schedule_cache["replays"] = schedule_cache.get("replays", 0) + 1
    schedule_cache["fused_frames"] = schedule_cache.get("fused_frames", 0) + 1
    return exe.accum, exe.frame.clone(), exe.rgba.clone(), pend


def make_fused(exe: "FusedFrame", frames, band_ops, f_steps, budget_total,
               budget_step, rgba_of, prologue=None, generators=(),
               stats=None, stat_name="supersteps"):
    """Give `exe` the body of a recorded frame and, on the card, capture it:
    prologue(), then every band's initial state and schedule
    (`_fused_counts_body`), rgba_of(frame) of each band into exe.rgba, and
    the accumulation."""
    exe.supersteps = 0
    for ops, fs in zip(band_ops, f_steps):
        used = 0
        for op in ops:
            if op[0] == "S":
                used += budget_step
                exe.supersteps += budget_step
            elif op[0] == "F":
                exe.supersteps += _fused_finish(fs, budget_total - used)
    holder = []

    def body():
        if prologue is not None:
            prologue()
        holder.clear()
        exe.pend_layout = _fused_counts_body(frames, band_ops, budget_total,
                                             budget_step, f_steps, holder)
        exe.counts = holder[0]
        parts = [rgba_of(frame) for frame in frames]
        exe.rgba.copy_(parts[0] if len(parts) == 1 else torch.cat(parts))
        _accumulate_into(exe)

    exe.body = body
    exe.capture(generators, stats, stat_name)
    return exe


@torch.no_grad()
def fused_frame(sample_fn, settings, schedule_cache: dict, mc, tf, light,
                rays, jitter, accum, frame_index: int, sample_ctx=None,
                scale=None, shadow_vol=None, stats=None):
    """Render this frame as one program if its schedule is stable (JAX's
    `fused_frame`). rays = (org, dirn, t_near, t_far) of the whole frame;
    jitter [R]; accum the current accumulation (or None) and frame_index
    the previous frame's count. Returns None (no stable schedule yet: the
    caller replays per dispatch; on the frame the schedule first repeats
    the program is made here, in the render thread, and on the card
    captured) or

        (accum, frame, rgba, pend, sub_caches)

    always provisional: the caller checks `pend` ((count, bound) pairs)
    later and on failure clears every cache in sub_caches' "ops" and rolls
    the frame's rgba out of the accumulation."""
    if settings.shading == "ssh" or not (settings.fused_replay
                                         and settings.schedule_replay):
        return None  # ssh's deferred shadow pass marches separately
    org = rays[0]
    r = org.shape[0]
    dev = org.device
    layout = _band_layout(r, settings, scale, shadow_vol)
    bands, sub_caches, f_steps = stable_bands(schedule_cache, layout)
    if bands is None:
        schedule_cache.pop("_fused_prev", None)
        return None
    key = (bands, fingerprint(sample_fn), fingerprint(sample_ctx),
           fingerprint(mc), fingerprint(tf), layout[0][2], fingerprint(scale),
           fingerprint(shadow_vol), r, str(dev))
    exe = fused_lookup(schedule_cache, key, lambda: _build_fused(
        sample_fn, layout, bands, f_steps, schedule_cache, mc, tf, light,
        sample_ctx, scale, shadow_vol, dev, r, stats))
    if exe is None:
        return None
    fin = exe.inputs
    for name, t in zip(("org", "dirn", "t_near", "t_far"), rays):
        fin[name].copy_(t)
    fin["jitter"].copy_(jitter)
    exe.light.copy_(light)
    return fused_run(exe, accum, frame_index, schedule_cache, stats) + (
        sub_caches,)


def _build_fused(sample_fn, layout, bands, f_steps, schedule_cache, mc, tf,
                 light, sample_ctx, scale, shadow_vol, dev, r,
                 stats=None) -> "FusedFrame":
    from instantvnr_torch.utils.math import normalize

    exe = FusedFrame(dev, r, {"org": (3,), "dirn": (3,), "t_near": (),
                              "t_far": (), "jitter": ()})
    exe.light.copy_(light)
    frames = []
    fin = exe.inputs
    for (a, b, sub_settings, cache_key, _sk) in layout:
        sub = (schedule_cache if cache_key is None
               else schedule_cache[cache_key])
        band = band_of(sub, b - a, dev, WAVEFRONT_LEAVES)
        frames.append(_wavefront_frame(
            band, sample_fn, sample_ctx, mc, tf, sub_settings,
            normalize(exe.light), scale, shadow_vol,
            tuple(fin[n][a:b] for n in ("org", "dirn", "t_near", "t_far",
                                        "jitter")), None))

    def prologue():
        ln = normalize(exe.light)
        for frame in frames:
            frame.light.copy_(ln)

    def rgba_of(frame):
        color, alpha, *_ = _unpermute_wavefront(frame.band)
        return torch.cat([color, alpha[:, None]], dim=-1)

    return make_fused(exe, frames, [b[2] for b in bands], f_steps,
                      layout[0][2].max_supersteps, 1, rgba_of, prologue,
                      stats=stats)


def _accumulate_into(exe: FusedFrame):
    """The progressive accumulation on the device-side counter, rounded as
    render/renderer.py::_accumulate's `accum / float(frame_index)` is: on
    the card PyTorch divides by a host scalar as a product with its float32
    reciprocal, on the CPU it divides."""
    exe.fidx.add_(1)
    first = exe.fidx == 1
    exe.accum.copy_(torch.where(first[:, None], exe.rgba,
                                exe.accum + exe.rgba))
    n = exe.fidx.to(_F32)
    exe.frame.copy_(exe.accum * torch.reciprocal(n) if n.is_cuda
                    else exe.accum / n)


def wait_fused_compiles(timeout: float | None = None) -> bool:
    """A fused frame is captured in the render thread: nothing is ever in
    flight (JAX compiles in the background and waits here)."""
    return True
