"""Macrocell-guided brick cache (counterpart of
`instantvnr_tpu/render/brickcache.py`).

The network is decoded once per OCCUPIED macrocell (16³ voxels and a ghost
ring of GHOST voxels a side) into a brick pool, stored corner-packed: row
i of the pool holds the 8 trilinear corners of the dual cell whose min
corner is texel i. A sample then reads the cell's LUT slot and one row
instead of evaluating the network (`brick_sample_fn`, on the card the
`brick_sample` kernel of `ops/brick_sample.py`). Memory scales with the
occupied fraction under the current transfer function.

Two decode lattices (`ctx_convention`): "decoded" (texel g holds
net((g/ss + 0.5)/N), the lattice of `models.metrics.decode_volume`, so on
occupied cells the pool reproduces the decoded grid's trilinear sample) and
"exact" (texel g holds net(g/(ss(N−1))), the positions the sampler
interpolates at, so pool(p) → net(p) as the supersample factor ss grows).
A pool may be decoded at ss = 2 (the "hq" policy): a nested refinement of
the 1× lattice.

The ctx is a plain dict: {"lut" [n_cells] int32 (slot or −1), "packed"
[n·brick³, 8] float32 or float16, "dims" (dx, dy, dz), "mcdims" (mx, my,
mz), "ss" int, "convention" str}. The JAX package's fused-emission row
("occ_slot") and its parity handle are not ported: the `brick_sample`
kernel reads the LUT slot itself, and its values equal the fused
sampler's.
"""
from __future__ import annotations

import numpy as np
import torch

from instantvnr_torch.accel.macrocell import MACROCELL_SIZE, MacroCell
from instantvnr_torch.ops.brick_sample import BRICK, GHOST, _brick_edge


def _ss_geom(ss: int) -> tuple:
    """(brick edge, brick texels) at supersample `ss`: the edge covers the
    1× brick's span, [cell·16 − GHOST, + BRICK) voxels."""
    b = _brick_edge(ss)
    return b, b * b * b


def ctx_supersample(ctx: dict) -> int:
    return int(ctx.get("ss", 1))


def ctx_convention(ctx: dict) -> str:
    """"decoded" (the decoded grid's half-texel lattice) or "exact" (the
    align-corner lattice the sampler interpolates at)."""
    return ctx.get("convention", "decoded")


@torch.no_grad()
def _decode_brick_chunk(field, params, cell_ids: np.ndarray, mc_dims: tuple,
                        vol_dims: tuple, ss: int = 1,
                        convention: str = "decoded") -> torch.Tensor:
    """Decode `len(cell_ids)` bricks → [n, brick³] float32 (texels in z-y-x
    order), through `network_apply_chunked` (on the card K3 on the params'
    table, then K1). Texel g = ss·(cell·16 − GHOST) + local sits at
    (g/ss + 0.5)/N, g/ss clamped to the grid, on the "decoded" lattice, and
    at g/(ss(N−1)) clamped to [0, 1] on the "exact" one."""
    from instantvnr_torch.models.network import network_apply_chunked

    brick, brick3 = _ss_geom(ss)
    dev = params["table"].device
    mx, my, _ = mc_dims
    ids = torch.as_tensor(np.asarray(cell_ids, np.int64), device=dev)
    cell = torch.stack([ids % mx, (ids // mx) % my, ids // (mx * my)], -1)
    l1 = torch.arange(brick, dtype=torch.int64, device=dev)
    lz, ly, lx = torch.meshgrid(l1, l1, l1, indexing="ij")
    local = torch.stack([lx, ly, lz], dim=-1).reshape(-1, 3)
    g = (cell[:, None, :] * (MACROCELL_SIZE * ss) - GHOST * ss
         + local[None, :, :]).to(torch.float32)
    dims = torch.tensor([float(d) for d in vol_dims], dtype=torch.float32,
                        device=dev)
    if convention == "exact":
        coords = torch.clamp(g / (float(ss) * (dims - 1.0)), 0.0, 1.0)
    else:
        u = torch.minimum(torch.clamp(g / float(ss), min=0.0), dims - 1.0)
        coords = (u + 0.5) / dims
    vals = network_apply_chunked(params, coords.reshape(-1, 3), field)
    return vals[:, 0].reshape(-1, brick3)


def _pack_corners(pool_flat: torch.Tensor, ss: int = 1) -> torch.Tensor:
    """[M] texel pool → [M, 8] corner-packed rows, corner c at offset
    (c_z·brick + c_y)·brick + c_x (x fastest, as ops/trilinear.py's
    corners). The flat shifts never cross a brick for an addressed row
    (local ≤ brick − 2)."""
    brick, _ = _ss_geom(ss)
    m = pool_flat.shape[0]
    cols = []
    for c in range(8):
        off = (((c >> 2) & 1) * brick * brick + ((c >> 1) & 1) * brick
               + (c & 1))
        cols.append(pool_flat if off == 0 else torch.cat(
            [pool_flat[off:], pool_flat.new_zeros(off)]))
    return torch.stack(cols, dim=1).reshape(m, 8)


def occupied_cells(mc: MacroCell, dilate: int = 1,
                   eps: float = 1e-6) -> np.ndarray:
    """Flat ids of macrocells with max opacity > eps (host-side), dilated
    by `dilate` face-neighbour steps so gradient probes and cell-wall
    jitter resolve."""
    occ = mc.max_opacity.detach().cpu().numpy() > eps  # [mz, my, mx]
    for _ in range(dilate):
        pad = np.pad(occ, 1, constant_values=False)
        grown = occ.copy()
        for ax in range(3):
            sl_lo = [slice(1, -1)] * 3
            sl_hi = [slice(1, -1)] * 3
            sl_lo[ax] = slice(0, -2)
            sl_hi[ax] = slice(2, None)
            grown |= pad[tuple(sl_lo)] | pad[tuple(sl_hi)]
        occ = grown
    return np.flatnonzero(occ.reshape(-1)).astype(np.int32)


def _lut_and_cells(mc: MacroCell, dilate: int):
    """(cells [n] slot-ordered flat ids, lut [n_cells] slot-or−1, mc_dims,
    vol_dims). A TF-empty scene gets one dummy brick no LUT entry points
    at. The LUT is the pool's layout contract (refresh_brick_pool)."""
    cells = occupied_cells(mc, dilate=dilate)
    mc_dims = tuple(int(d) for d in mc.dims)
    vol_dims = tuple(int(d) for d in mc.volume_dims)
    lut = np.full(mc_dims[0] * mc_dims[1] * mc_dims[2], -1, np.int32)
    lut[cells] = np.arange(cells.size, dtype=np.int32)
    if cells.size == 0:
        cells = np.zeros((1,), np.int32)
    return cells, lut, mc_dims, vol_dims


def _brick_ctx(lut: np.ndarray, packed: torch.Tensor, vol_dims, mc_dims,
               ss: int = 1, convention: str = "decoded") -> dict:
    return {"lut": torch.as_tensor(lut, device=packed.device),
            "packed": packed, "dims": tuple(int(d) for d in vol_dims),
            "mcdims": tuple(int(d) for d in mc_dims), "ss": int(ss),
            "convention": convention}


def _chunks(n: int, chunk_bricks: int, ss: int):
    """Brick ranges of one decode each: fewer bricks a chunk at ss > 1, as
    a brick grows ~ss³."""
    step = max(1, chunk_bricks // (ss * ss * ss))
    return [(i, min(i + step, n)) for i in range(0, n, step)]


def build_brick_cache(field, params, mc: MacroCell, dilate: int = 1,
                      dtype=torch.float32, chunk_bricks: int = 32,
                      supersample: int = 1,
                      convention: str = "decoded") -> dict:
    """Decode the occupied bricks (`chunk_bricks` a decode call) and
    return the sample ctx of `brick_sample_fn`."""
    ss = int(supersample)
    cells, lut, mc_dims, vol_dims = _lut_and_cells(mc, dilate)
    parts = [_decode_brick_chunk(field, params, cells[a:b], mc_dims, vol_dims,
                                 ss, convention)
             for a, b in _chunks(int(cells.size), chunk_bricks, ss)]
    pool = torch.cat(parts, dim=0).to(dtype)
    packed = _pack_corners(pool.reshape(-1), ss)
    return _brick_ctx(lut, packed, vol_dims, mc_dims, ss=ss,
                      convention=convention)


def build_brick_cache_from_grid(vol: torch.Tensor, mc: MacroCell,
                                dilate: int = 1,
                                dtype=torch.float32) -> dict:
    """Corner-packed brick pool of a decoded or ground-truth grid [dz, dy,
    dx] (no network): texels are the grid's voxels (g = cell·16 − GHOST +
    local, clamp addressing), so `brick_sample_fn` reproduces
    `ops.trilinear.sample_volume` on occupied cells up to the trilinear
    summation order."""
    cells, lut, mc_dims, _ = _lut_and_cells(mc, dilate)
    dz, dy, dx = vol.shape
    dev = vol.device
    ids = torch.as_tensor(cells.astype(np.int64), device=dev)
    cx = ids % mc_dims[0]
    cy = (ids // mc_dims[0]) % mc_dims[1]
    cz = ids // (mc_dims[0] * mc_dims[1])
    l1 = torch.arange(BRICK, dtype=torch.int64, device=dev)
    lz, ly, lx = (a.reshape(-1) for a in torch.meshgrid(l1, l1, l1,
                                                        indexing="ij"))

    def axis(c, l_, d):
        return torch.clamp(c[:, None] * MACROCELL_SIZE - GHOST + l_[None],
                           0, d - 1)

    gx, gy, gz = axis(cx, lx, dx), axis(cy, ly, dy), axis(cz, lz, dz)
    pool = vol.to(torch.float32)[gz, gy, gx]  # [n, BRICK³]
    packed = _pack_corners(pool.reshape(-1).to(dtype))
    return _brick_ctx(lut, packed, (dx, dy, dz), mc_dims)


def refresh_brick_pool(field, params, ctx: dict, start: int = 0,
                       n_bricks: int | None = None,
                       chunk_bricks: int = 32) -> tuple:
    """Re-decode bricks [start, start + n_bricks) of an existing pool
    against fresh params (the online-training refresh). The bricks come
    from the ctx's OWN LUT in slot order, never from a recomputed
    occupancy: a grown macrocell would shift slot assignments and write
    bricks into neighbouring cells' rows. Returns (new ctx, next start),
    the start wrapping to 0 after the last brick."""
    lut_np = ctx["lut"].detach().cpu().numpy()
    cached = np.flatnonzero(lut_np >= 0).astype(np.int32)
    if cached.size == 0:
        return ctx, 0
    cells = cached[np.argsort(lut_np[cached], kind="stable")]
    total = int(cells.size)
    start = min(start, total)
    n = total - start if n_bricks is None else min(n_bricks, total - start)
    if n <= 0:
        return ctx, 0
    ss = ctx_supersample(ctx)
    _, brick3 = _ss_geom(ss)
    packed = ctx["packed"].clone()  # a dispatched frame may hold the old
    for a, b in _chunks(n, chunk_bricks, ss):
        lo, hi = start + a, start + b
        vals = _decode_brick_chunk(field, params, cells[lo:hi], ctx["mcdims"],
                                   ctx["dims"], ss, ctx_convention(ctx))
        rows = _pack_corners(vals.reshape(-1).to(packed.dtype), ss)
        packed[lo * brick3:hi * brick3] = rows
    new_ctx = dict(ctx)
    new_ctx["packed"] = packed
    nxt = start + n
    return new_ctx, (0 if nxt >= total else nxt)


def brick_cache_bytes(mc: MacroCell, dilate: int = 1, dtype=torch.float32,
                      supersample: int = 1) -> int:
    """Device bytes the packed pool would take (the memory gates)."""
    n = max(int(occupied_cells(mc, dilate=dilate).size), 1)
    _, brick3 = _ss_geom(int(supersample))
    itemsize = torch.empty((), dtype=dtype).element_size()
    return n * brick3 * 8 * itemsize


# ---------------------------------------------------------------------------
# Lazy (view-driven) brick decode


def view_cells(mc: MacroCell, cam, width: int, height: int, scale=None,
               margin: float = 4.0, cells: np.ndarray | None = None
               ) -> np.ndarray:
    """Flat ids of the macrocells whose margin-inflated box meets the
    camera's view frustum (host-side numpy, conservative: a cell survives
    unless all 8 corners fall outside one plane). Planes are built in
    voxel space, where cells are axis-aligned boxes; `cells` restricts the
    test to the given ids."""

    def nrm(v):
        return v / max(float(np.linalg.norm(v)), 1e-12)

    dims = np.asarray([float(d) for d in mc.volume_dims], np.float64)
    s = (np.ones(3, np.float64) if scale is None
         else np.asarray(scale, np.float64))
    eye = np.asarray(cam.eye, np.float64) / s + dims / 2.0
    direction = nrm(np.asarray(cam.center, np.float64)
                    - np.asarray(cam.eye, np.float64))
    t = 2.0 * np.tan(np.deg2rad(float(cam.fovy)) / 2.0)
    aspect = width / float(height)
    horizontal = t * aspect * nrm(np.cross(direction,
                                           np.asarray(cam.up, np.float64)))
    vertical = np.cross(horizontal, direction) / aspect
    # the 4 image-corner ray directions, in cyclic order, voxel space
    cd = [(direction + (sx - 0.5) * horizontal + (sy - 0.5) * vertical) / s
          for sx, sy in ((0, 0), (1, 0), (1, 1), (0, 1))]
    dc = direction / s
    # the behind-the-eye plane: a half-space normal maps world → voxel by
    # the inverse transpose, s·d (the ray directions above map by 1/s)
    planes = [s * direction]
    for i in range(4):
        n = np.cross(cd[i], cd[(i + 1) % 4])
        if float(np.dot(n, dc)) < 0:
            n = -n
        planes.append(n)
    planes = np.stack(planes)  # [5, 3], inward normals through the eye

    mx, my, mz = (int(d) for d in mc.dims)
    if cells is None:
        cells = np.arange(mx * my * mz, dtype=np.int32)
    cells = np.asarray(cells, np.int32)
    if cells.size == 0:
        return cells
    cx = cells % mx
    cy = (cells // mx) % my
    cz = cells // (mx * my)
    lo = (np.stack([cx, cy, cz], -1).astype(np.float64) * MACROCELL_SIZE
          - margin)
    hi = lo + MACROCELL_SIZE + 2.0 * margin
    rel = np.empty((cells.size, 8, 3), np.float64)
    for c in range(8):
        sel = np.array([(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1], bool)
        rel[:, c, :] = np.where(sel, hi, lo) - eye
    d = rel @ planes.T  # [n, 8, 5]
    inside = (d.max(axis=1) >= 0.0).all(axis=1)
    return cells[inside]


def light_swept_cells(mc: MacroCell, cells: np.ndarray,
                      light_voxel) -> np.ndarray:
    """A superset of the macrocells a ray starting anywhere in `cells` and
    marching along +light_voxel can touch before it leaves the grid (the
    bound of a lazy SSH decode): the cell mask sheared along the light in
    ≤ ½-cell substeps, OR-accumulated until the front leaves the grid, then
    dilated by one cell (Chebyshev)."""
    mx, my, mz = (int(d) for d in mc.dims)
    cells = np.asarray(cells, np.int64)
    mask = np.zeros((mz, my, mx), bool)
    mask.reshape(-1)[cells] = True

    d = np.asarray(light_voxel, np.float64)
    n = float(np.max(np.abs(d)))
    if n < 1e-12 or not mask.any():
        swept = mask
    else:
        step = d / n * 0.5  # (x, y, z) in cell units, ≤ ½ cell a substep
        swept = mask.copy()
        cur = mask
        prev_off = np.zeros(3, np.int64)
        k = 1
        cap = 2 * (mx + my + mz) + 4
        while cur.any() and k <= cap:
            off = np.round(step * k).astype(np.int64)  # (dx, dy, dz)
            delta = off - prev_off
            prev_off = off
            if np.any(delta):
                dx, dy, dz = (int(v) for v in delta)
                nxt = np.zeros_like(cur)
                src = [slice(max(-dz, 0), mz - max(dz, 0)),
                       slice(max(-dy, 0), my - max(dy, 0)),
                       slice(max(-dx, 0), mx - max(dx, 0))]
                dst = [slice(max(dz, 0), mz - max(-dz, 0)),
                       slice(max(dy, 0), my - max(-dy, 0)),
                       slice(max(dx, 0), mx - max(-dx, 0))]
                nxt[tuple(dst)] = cur[tuple(src)]
                cur = nxt
                swept |= cur
            k += 1
    pad = np.pad(swept, 1, constant_values=False)
    out = np.zeros_like(swept)
    for dz in (0, 1, 2):
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                out |= pad[dz:dz + mz, dy:dy + my, dx:dx + mx]
    return np.flatnonzero(out.reshape(-1)).astype(np.int32)


class LazyBrickCache:
    """`build_brick_cache` with each brick's decode deferred until a view
    can touch it: the full-capacity pool (zeros) and the LUT are made at
    once, and

      - `ensure_view(cam, w, h, scale)` decodes the undecoded occupied
        bricks the camera frustum meets (`view_cells`);
      - `ensure_view_ssh` adds the light-swept superset (SSH shadow rays);
      - `ensure_all()` completes the pool;
      - `set_params(params)` marks every brick stale; `refresh(params,
        budget_bricks)` re-decodes at most that many decoded bricks a call
        (round-robin over slots).

    Memory is not reduced (slots are the LUT's layout contract); the win
    is the time to the first frame. Never-decoded cells sample 0.0, so
    callers ensure the bricks of the rays they are about to march
    (api.VNRenderer does so every render())."""

    def __init__(self, field, params, mc: MacroCell, dilate: int = 1,
                 dtype=torch.float32, chunk_bricks: int = 32,
                 supersample: int = 1, convention: str = "decoded"):
        cells, lut, self._mc_dims, self._vol_dims = _lut_and_cells(
            mc, dilate)
        self._ss = int(supersample)
        _, self._brick3 = _ss_geom(self._ss)
        n = int(cells.size)
        self._cells = cells  # slot i ↔ cells[i] (the LUT's inverse)
        self._lut_np = lut
        # slots no LUT entry points at (the TF-empty dummy brick) stay
        # "decoded", so a degenerate pool reaches its steady state
        self._orphan = np.setdiff1d(np.arange(n), lut[lut >= 0])
        self._decoded = np.zeros(n, bool)
        self._decoded[self._orphan] = True
        self._cursor = 0  # refresh()'s round-robin position (slot index)
        self.field = field
        self.params = params
        self.mc = mc
        self.chunk_bricks = int(chunk_bricks)
        self._conv = convention
        dev = mc.max_opacity.device
        self.ctx = _brick_ctx(
            lut, torch.zeros((n * self._brick3, 8), dtype=dtype, device=dev),
            self._vol_dims, self._mc_dims, ss=self._ss, convention=convention)

    @property
    def n_bricks(self) -> int:
        return int(self._cells.size)

    @property
    def n_decoded(self) -> int:
        return int(self._decoded.sum())

    def set_params(self, params):
        """New network params: every brick is stale until re-ensured."""
        self.params = params
        self._decoded[:] = False
        self._decoded[self._orphan] = True

    def ensure_cells(self, cell_ids: np.ndarray) -> int:
        """Decode the not-yet-decoded occupied bricks among `cell_ids`
        (unoccupied ids are ignored) → the number decoded."""
        if np.asarray(cell_ids).size == 0:
            return 0
        slots = self._lut_np[np.asarray(cell_ids, np.int64)]
        slots = np.unique(slots[slots >= 0])
        need = slots[~self._decoded[slots]]
        if need.size == 0:
            return 0
        packed = self.ctx["packed"].clone()  # a dispatched frame holds it
        b3 = self._brick3
        rows_of = torch.arange(b3, dtype=torch.int64, device=packed.device)
        for a, b in _chunks(int(need.size), self.chunk_bricks, self._ss):
            sl = need[a:b]
            vals = _decode_brick_chunk(self.field, self.params,
                                       self._cells[sl], self._mc_dims,
                                       self._vol_dims, self._ss, self._conv)
            rows = _pack_corners(vals.reshape(-1).to(packed.dtype), self._ss)
            dst = (torch.as_tensor(sl.astype(np.int64), device=packed.device
                                   )[:, None] * b3 + rows_of).reshape(-1)
            packed[dst] = rows
        self._decoded[need] = True
        self.ctx = dict(self.ctx)
        self.ctx["packed"] = packed
        return int(need.size)

    def ensure_view(self, cam, width: int, height: int, scale=None,
                    margin: float = 4.0) -> int:
        pending = self._cells[~self._decoded]
        if pending.size == 0:
            return 0
        return self.ensure_cells(view_cells(
            self.mc, cam, width, height, scale=scale, margin=margin,
            cells=pending))

    def ensure_all(self) -> int:
        return self.ensure_cells(self._cells[~self._decoded])

    def ensure_view_ssh(self, cam, width: int, height: int, light_voxel,
                        scale=None, margin: float = 4.0) -> int:
        """The view frustum's bricks and their light-swept superset (the
        deferred shadow rays march from in-frustum samples along the
        light)."""
        if self.n_decoded == self.n_bricks:
            return 0
        frustum = view_cells(self.mc, cam, width, height, scale=scale,
                             margin=margin)
        return self.ensure_cells(
            light_swept_cells(self.mc, frustum, light_voxel))

    def refresh(self, params, budget_bricks: int | None = None) -> int:
        """Online-training refresh: re-decode at most `budget_bricks` of the
        decoded bricks (round-robin over slots) against `params`;
        undecoded bricks wait for their first visibility. None restales
        everything instead. → the number re-decoded now."""
        if budget_bricks is None:
            self.set_params(params)
            return 0
        self.params = params
        n = self.n_bricks
        order = (np.arange(n) + self._cursor) % n
        # orphan slots are permanent placeholders: restaling one would
        # wedge n_decoded below n_bricks
        dec = order[self._decoded[order]
                    & (self._lut_np[self._cells[order]] >= 0)]
        sel = dec[:budget_bricks]
        if sel.size == 0:
            return 0
        self._cursor = (int(sel[-1]) + 1) % n
        self._decoded[sel] = False
        return self.ensure_cells(self._cells[sel])


def brick_sample_fn(ctx: dict, p: torch.Tensor,
                    count: torch.Tensor | None = None) -> torch.Tensor:
    """Sample the brick pool at object-space positions p [N, 3] → [N], the
    convention of `ops.trilinear.sample_volume` (cell-centred remap, clamp
    addressing). A query whose macrocell is not cached returns 0.0: those
    cells are TF-empty (`dilate` covers probes across cell walls). On the
    card one `brick_sample` launch; with a device-side `count` (the
    compacted wavefront's valid rows) the rows past it are skipped."""
    from instantvnr_torch.ops.brick_sample import brick_sample

    return brick_sample(ctx["lut"], ctx["packed"], p, ctx["dims"],
                        ctx["mcdims"], ctx_supersample(ctx), count=count)


brick_sample_fn.takes_count = True
