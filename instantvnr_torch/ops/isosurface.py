"""Isosurface extraction by marching tetrahedra (counterpart of
`instantvnr_tpu/ops/isosurface.py`; the reference's five-phase GPU
marching cubes, `core/marching_cube.cu:397-450`).

Each cell of a z-slab splits into the 6 Kuhn tetrahedra; a tetrahedron
whose corners straddle the isovalue emits one or two triangles whose
vertices lie on its edges. `extract_slab` returns the live triangles of a
slab: for CUDA grids the two kernels of `csrc/isosurface.cu` (`mt_count`
counts each cell's triangles and publishes each block's sum, `mt_emit`
writes a block's triangles after those of the blocks before it), for CPU
grids the plain version
`_extract_slab_reference` (JAX's dense emission of every slot with a
validity mask, line for line) followed by the masked gather. Both give
the triangles in the same order: cell-major (z, y, x), then tetrahedron,
then triangle; the kernel's positions and edge ids equal the plain
version's bit for bit.

`weld_triangles` turns the soup into an indexed mesh on exact lattice-edge
keys (an exact `unique`, on the triangles' device). The entry points
return JAX's types: numpy verts [M, 3] float32, faces [T, 3] int32.
"""
from __future__ import annotations

import numpy as np
import torch

from instantvnr_torch.ops.cuda_lib import LaunchCounter
from instantvnr_torch.utils.profiling import span

counter = LaunchCounter()  # one a launch: mt_count and mt_emit, per slab
_CELLS_A_BLOCK = 256  # csrc/isosurface.cu kCells

# Kuhn/Freudenthal 6-tetrahedron subdivision: each tet is a monotone path
# 0 → 7 adding one axis bit at a time, so adjacent cubes share their face
# triangulations (a crack-free surface). Corner bit 0 = +x, 1 = +y, 2 = +z.
_TETS = np.array([[0, 1, 3, 7], [0, 1, 5, 7], [0, 2, 3, 7],
                  [0, 2, 6, 7], [0, 4, 5, 7], [0, 4, 6, 7]], np.int32)

# a tet's edges as local corner pairs (a, b, c, d), edge ids 0..5
_EDGE_PAIRS = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]],
                       np.int32)

# each case's triangles as edge ids, -1 unused; case bit i = corner i
# inside. In a positive-chirality tet the triangles wind so that the normal
# points to the outside (< isovalue).
_CASE_TRIS = -np.ones((16, 2, 3), np.int32)
_CASE_TRIS[1, 0] = (0, 1, 2)
_CASE_TRIS[2, 0] = (0, 4, 3)
_CASE_TRIS[4, 0] = (1, 3, 5)
_CASE_TRIS[8, 0] = (2, 5, 4)
_CASE_TRIS[3] = [(1, 2, 4), (1, 4, 3)]
_CASE_TRIS[5] = [(0, 3, 5), (0, 5, 2)]
_CASE_TRIS[9] = [(0, 5, 4), (0, 1, 5)]
_CASE_TRIS[6] = [(0, 4, 5), (0, 5, 1)]
_CASE_TRIS[10] = [(0, 2, 5), (0, 5, 3)]
_CASE_TRIS[12] = [(1, 4, 2), (1, 3, 4)]
_CASE_TRIS[7, 0] = (2, 4, 5)
_CASE_TRIS[11, 0] = (1, 5, 3)
_CASE_TRIS[13, 0] = (0, 3, 4)
_CASE_TRIS[14, 0] = (0, 2, 1)

# corner offsets (x, y, z) of corner c = dz·4 + dy·2 + dx
_CORNER_OFF = np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1]
                        for c in range(8)], np.float32)


def _tet_signed_volume(tet) -> float:
    a, b, c, d = _CORNER_OFF[np.asarray(tet)]
    return float(np.dot(np.cross(b - a, c - a), d - a))


# the mirrored tets (negative signed volume) emit with reversed winding, so
# every triangle comes out wound outward
_CASE_TRIS_PER_TET = np.tile(_CASE_TRIS[None], (6, 1, 1, 1))
for _i, _tet in enumerate(_TETS):
    if _tet_signed_volume(_tet) < 0:
        _CASE_TRIS_PER_TET[_i] = _CASE_TRIS_PER_TET[_i][..., ::-1]


def _extract_slab_reference(grid: torch.Tensor, isovalue, z_offset: int):
    """Plain version, JAX's `_extract_slab` (isosurface.py:87-193) formula
    for formula: grid [sz, sy, sx] → (tris [N, 6, 2, 3, 3] float32 voxel
    coords, valid [N, 6, 2] bool, ids [N, 6, 2, 3, 4] int32), N the
    (sz−1)(sy−1)(sx−1) cells. `ids` holds each vertex's lattice edge as its
    two global corners, each split (z, y·sx + x) to stay int32."""
    dev = grid.device
    f32, i32 = torch.float32, torch.int32
    iso = torch.tensor(float(isovalue), dtype=f32, device=dev)
    sz, sy, sx = grid.shape
    nz, ny, nx = sz - 1, sy - 1, sx - 1
    n = nz * ny * nx
    corners = torch.stack([grid[dz:dz + nz, dy:dy + ny, dx:dx + nx]
                           for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)],
                          dim=-1)
    vals = corners.reshape(n, 8)
    zz, yy, xx = torch.meshgrid(torch.arange(nz, dtype=f32, device=dev),
                                torch.arange(ny, dtype=f32, device=dev),
                                torch.arange(nx, dtype=f32, device=dev),
                                indexing="ij")
    base = torch.stack([xx.reshape(-1), yy.reshape(-1),
                        zz.reshape(-1) + float(z_offset)], dim=-1)
    corner_off = torch.from_numpy(_CORNER_OFF).to(dev)
    tets = torch.from_numpy(_TETS).long().to(dev)
    tet_vals = vals[:, tets]  # [n, 6, 4]
    inside = (tet_vals > iso).to(i32)
    case = (inside[..., 0] + 2 * inside[..., 1] + 4 * inside[..., 2]
            + 8 * inside[..., 3])  # [n, 6]
    pairs = torch.from_numpy(_EDGE_PAIRS).long().to(dev)
    ca = tets[:, pairs[:, 0]]  # [6 tets, 6 edges] cube-corner ids
    cb = tets[:, pairs[:, 1]]
    va = tet_vals[:, :, pairs[:, 0]]  # [n, 6, 6]
    vb = tet_vals[:, :, pairs[:, 1]]
    denom = vb - va
    t = torch.where(torch.abs(denom) > 1e-12, (iso - va) / denom,
                    torch.full_like(denom, 0.5))
    t = torch.clamp(t, 0.0, 1.0)
    pa = corner_off[ca]  # [6, 6, 3]
    pb = corner_off[cb]
    edge_pos = (base[:, None, None, :] + pa[None]
                + t[..., None] * (pb - pa)[None])  # [n, 6, 6, 3]
    case_tris = torch.from_numpy(_CASE_TRIS_PER_TET).long().to(dev)
    tri_edges = case_tris[torch.arange(6, device=dev)[None, :], case.long()]
    valid = tri_edges[..., 0] >= 0  # [n, 6, 2]
    safe = torch.clamp(tri_edges, min=0)  # [n, 6, 2, 3]
    tris = torch.gather(
        edge_pos[:, :, None, None, :, :].expand(n, 6, 2, 3, 6, 3), 4,
        safe[..., None, None].expand(n, 6, 2, 3, 1, 3))[..., 0, :]
    # every crossing of one lattice edge is presented with the same (a, b)
    # orientation (ascending cube-corner index = ascending global id), so
    # its t and position are bit-identical wherever it occurs
    ibase = torch.stack([xx.reshape(-1).to(i32), yy.reshape(-1).to(i32),
                         zz.reshape(-1).to(i32) + int(z_offset)], dim=-1)
    ioff = corner_off.to(i32)

    def corner_id2(cids):  # [6, 6] cube corners → ([n,6,6] gz, [n,6,6] gyx)
        off = ioff[cids]
        gx = ibase[:, None, None, 0] + off[None, ..., 0]
        gy = ibase[:, None, None, 1] + off[None, ..., 1]
        gz = ibase[:, None, None, 2] + off[None, ..., 2]
        return gz, gy * sx + gx

    za, yxa = corner_id2(ca)
    zb, yxb = corner_id2(cb)
    ids4 = torch.stack([za, yxa, zb, yxb], dim=-1)  # [n, 6, 6, 4]
    ids = torch.gather(ids4[:, :, None, None, :, :].expand(n, 6, 2, 3, 6, 4),
                       4, safe[..., None, None].expand(n, 6, 2, 3, 1, 4)
                       )[..., 0, :]
    return tris, valid, ids


def extract_slab(grid: torch.Tensor, isovalue: float, z_offset: int):
    """The live triangles of a slab: grid [sz, sy, sx] float32 →
    (tris [k, 3, 3] float32 voxel coords (x, y, z), ids [k, 3, 4] int32),
    in the plain version's order. CUDA grids launch `mt_count` and
    `mt_emit` (one host read of the triangle count between them, from
    `mt_count`'s workspace: the count and each block's; `mt_count` also
    hands `mt_emit` each cell's packed cases); CPU grids take the plain
    version and its masked gather."""
    if grid.device.type == "cpu":
        tris, valid, ids = _extract_slab_reference(grid, isovalue, z_offset)
        return tris[valid], ids[valid]
    if grid.device.type != "cuda":
        raise ValueError(f"unsupported device {grid.device}")
    from instantvnr_torch.ops.cuda_lib import load_library

    if grid.dtype != torch.float32 or grid.dim() != 3:
        raise ValueError(f"grid must be [sz, sy, sx] float32, got "
                         f"{tuple(grid.shape)} {grid.dtype}")
    grid = grid.contiguous()
    sz, sy, sx = grid.shape
    dev = grid.device
    n = max(sz - 1, 0) * max(sy - 1, 0) * max(sx - 1, 0)
    if grid.numel() >= 1 << 31 or 12 * n >= 1 << 31:
        raise ValueError(f"the kernels count a slab's voxels and triangles "
                         f"(<= 12 a cell) in int32; {tuple(grid.shape)} is "
                         f"too large: extract it in thinner slabs")
    if n == 0:
        return (torch.zeros((0, 3, 3), dtype=torch.float32, device=dev),
                torch.zeros((0, 3, 4), dtype=torch.int32, device=dev))
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    iso = float(np.float32(isovalue))
    blocks = -(-n // _CELLS_A_BLOCK)
    # [the slab's triangles, each block's], zero on entry
    ws = torch.zeros((1 + blocks,), dtype=torch.int64, device=dev)
    # each cell's packed cases and count, from mt_count to mt_emit
    cases = torch.empty((n,), dtype=torch.int32, device=dev)
    lib.call("mt_count", grid.data_ptr(), iso, sz, sy, sx, ws.data_ptr(),
             cases.data_ptr(), stream)
    counter.launches += 1
    k = int(ws[0])  # the one host read: the output's size
    tris = torch.empty((k, 3, 3), dtype=torch.float32, device=dev)
    ids = torch.empty((k, 3, 4), dtype=torch.int32, device=dev)
    if k:
        lib.call("mt_emit", grid.data_ptr(), iso, int(z_offset), sz, sy, sx,
                 ws.data_ptr(), cases.data_ptr(), tris.data_ptr(),
                 ids.data_ptr(), stream)
        counter.launches += 1
    return tris, ids


def weld_triangles(soup: torch.Tensor, ids: torch.Tensor):
    """Weld a triangle soup into an indexed mesh on exact lattice-edge keys
    (JAX's weld_triangles, isosurface.py:195): soup [k, 3, 3] float32,
    ids [k, 3, 4] int32 (gz_a, gyx_a, gz_b, gyx_b) per vertex. Every
    crossing of one lattice edge is bit-identical, so a sorted unique over
    the edge keys welds exactly; a vertex takes the position of its key's
    first occurrence. → (verts [m, 3], faces [k, 3] int32), on the soup's
    device."""
    dev = soup.device
    if len(soup) == 0:
        return (torch.zeros((0, 3), dtype=torch.float32, device=dev),
                torch.zeros((0, 3), dtype=torch.int32, device=dev))
    ids = ids.to(torch.int64).reshape(-1, 4)
    span = int(ids[:, [1, 3]].max()) + 1  # max gyx + 1 ≤ sy·sx
    ga = ids[:, 0] * span + ids[:, 1]
    gb = ids[:, 2] * span + ids[:, 3]
    lo = torch.minimum(ga, gb)
    hi = torch.maximum(ga, gb)
    n_corners = int(hi.max()) + 1
    if n_corners < (1 << 31):  # scalar keys (grids up to ~1290³)
        _, inv = torch.unique(lo * n_corners + hi, sorted=True,
                              return_inverse=True)
    else:  # row-wise unique for larger grids
        _, inv = torch.unique(torch.stack([lo, hi], dim=1), dim=0,
                              sorted=True, return_inverse=True)
    m = int(inv.max()) + 1
    first = torch.full((m,), inv.numel(), dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, inv, torch.arange(inv.numel(), device=dev),
                          reduce="amin")
    verts = soup.reshape(-1, 3)[first]
    return verts, inv.to(torch.int32).reshape(-1, 3)


def _extract_loop(get_slab, dz: int, isovalue: float, slab: int,
                  weld: bool):
    """The slab loop, then the verts/faces epilogue on the host.
    get_slab(z, n) → grid rows z..z+n−1 ([n, sy, sx]); consecutive slabs
    overlap by one plane (stride `slab`, n = slab + 1). Its stages are
    spans that are also profiler ranges while a profiler records
    (isosurface.slab, .extract, .weld: the concatenation and the weld,
    .to_host; utils/profiling.py::span), so that one torch.profiler trace
    of a call splits its time."""
    out_v, out_i = [], []
    z = 0
    while z < dz - 1:
        n = min(slab + 1, dz - z)
        with span("isosurface.slab", annotate=True):
            grid = get_slab(z, n)
        with span("isosurface.extract", annotate=True):
            tris, ids = extract_slab(grid, isovalue, z)
        out_v.append(tris)
        out_i.append(ids)
        z += slab
    if not out_v:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    with span("isosurface.weld", annotate=True):
        v = torch.cat(out_v, dim=0)
        if weld:
            verts, faces = weld_triangles(v, torch.cat(out_i, dim=0))
    with span("isosurface.to_host", annotate=True):
        if weld:
            return verts.cpu().numpy(), faces.cpu().numpy()
        verts = v.reshape(-1, 3).cpu().numpy()
    return verts, np.arange(len(verts), dtype=np.int32).reshape(-1, 3)


def extract_isosurface(grid, isovalue: float, slab: int = 32,
                       weld: bool = True):
    """Marching tetrahedra over a [dz, dy, dx] grid (a tensor on its
    device, or numpy on the CPU) in z-slabs overlapping by one plane →
    (vertices [M, 3] float32 voxel coords, faces [T, 3] int32). By default
    shared edge crossings are welded into an indexed mesh (exact:
    marching_cube.cu:397-403); weld=False keeps the soup (M = 3T, faces =
    arange)."""
    if not isinstance(grid, torch.Tensor):
        grid = torch.tensor(np.asarray(grid), dtype=torch.float32)
    return _extract_loop(lambda z, n: grid[z:z + n], grid.shape[0],
                         isovalue, slab, weld)


def extract_isosurface_network(field, params, dims, isovalue: float,
                               slab: int = 16, weld: bool = True):
    """Marching tetrahedra on the neural representation itself (reference
    doMarchingCubeTemplate__Network, marching_cube.cu:424-450): each
    overlapping z-slab of slab + 1 planes is decoded from the inference
    params (models/network.py::render_params, as the port's decode) and
    extracted; the full grid never exists."""
    from instantvnr_torch.models.metrics import decode_slab
    from instantvnr_torch.models.network import render_params

    rp = render_params(params, field)

    def get_slab(z, n):
        return decode_slab(field, rp, z, dims, slab=slab + 1)[:n]

    return _extract_loop(get_slab, dims[2], isovalue, slab, weld)


def save_obj(verts: np.ndarray, faces: np.ndarray, path: str):
    """vnrSaveTriangles → OBJ (the reference's batch_isosurface output),
    byte for byte the JAX package's file of the same mesh."""
    verts = np.asarray(verts)
    faces = np.asarray(faces)
    with open(path, "w") as f:
        f.write(f"# instantvnr_tpu isosurface: {len(verts)} verts, "
                f"{len(faces)} tris\n")
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for a, b, c in faces + 1:
            f.write(f"f {a} {b} {c}\n")
