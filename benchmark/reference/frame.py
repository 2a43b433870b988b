"""One progressive pass of the wavefront ray marcher, plain: the camera's
rays, the box clip, the macrocells of the ground-truth volume under the
transfer function, the per-ray emission of sample intervals with empty
space skipped and adaptive steps, the jittered sample, the front-to-back
blend with opacity correction and early termination.

The semantics are the upstream's (method_raymarching.cu:263-306,
raytracing.h:146-207). Each superstep emits `n_iters` slots a ray, each
slot first probing up to `max_skips` cells; every probe body runs masked
over all rays, which gives the same intervals as a scan that stops early.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

CELL = 16  # macrocell edge in voxels
NEARLY_ONE = 0.9999  # early termination
EPS = 1e-6
PROBE_EPS = 1e-3
MAX_SUPERSTEPS = 192
TF_RESOLUTION = 1024


# -- the transfer function ----------------------------------------------------


def _interp(points, xs):
    points = np.asarray(points, np.float32)
    order = np.argsort(points[:, 0])
    pos, vals = points[order, 0], points[order, 1:]
    return np.stack([np.interp(xs, pos, vals[:, c])
                     for c in range(vals.shape[1])], -1)


@dataclass
class TF:
    ctrl_x: torch.Tensor  # [Kc] knots (padded by repeating the last)
    ctrl_rgba: torch.Tensor  # [Kc, 4]
    alphas: torch.Tensor  # [R] the alpha LUT
    rmq: torch.Tensor  # [levels, R] range maxima of the alpha envelope
    lo: float
    hi: float


def bake_tf(colors, alphas, value_range, device) -> TF:
    """Control points (position, r, g, b) and (position, alpha) over a
    value range → the knots of the piecewise-linear classification and the
    alpha LUT's range-max table (1024 entries: each bin's envelope is its
    two ends and every alpha knot inside it)."""
    xs = np.linspace(0.0, 1.0, TF_RESOLUTION).astype(np.float32)
    a_lut = _interp(alphas, xs)[:, 0]
    knots = np.unique(np.concatenate([np.asarray([c[0] for c in colors],
                                                 np.float32),
                                      np.asarray([a[0] for a in alphas],
                                                 np.float32), [0.0, 1.0]]))
    ctrl = np.concatenate([_interp(colors, knots),
                           _interp(alphas, knots)[:, :1]], -1)
    kc = 1 << max(2, int(np.ceil(np.log2(len(knots)))))
    if kc > len(knots):
        pad = kc - len(knots)
        knots = np.concatenate([knots, np.full(pad, knots[-1])])
        ctrl = np.concatenate([ctrl, np.repeat(ctrl[-1:], pad, 0)])
    env = a_lut.copy()
    env[:-1] = np.maximum(env[:-1], a_lut[1:])
    ak = np.asarray(alphas, np.float32)
    kidx = np.clip((ak[:, 0] * (TF_RESOLUTION - 1)).astype(np.int64), 0,
                   TF_RESOLUTION - 2)
    np.maximum.at(env, kidx, ak[:, 1])
    levels = max(1, int(np.ceil(np.log2(TF_RESOLUTION))) + 1)
    rmq = np.empty((levels, TF_RESOLUTION), np.float32)
    rmq[0] = env
    for k in range(1, levels):
        half = 1 << (k - 1)
        rmq[k] = np.maximum(rmq[k - 1], np.concatenate(
            [rmq[k - 1, half:], rmq[k - 1, -1:].repeat(half)]))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return TF(t(knots), t(ctrl), t(a_lut), t(rmq), float(value_range[0]),
              float(value_range[1]))


def classify(tf: TF, values):
    """value → (rgb, alpha) by the telescoping sum over the knots."""
    lo = torch.tensor(tf.lo, device=values.device)
    hi = torch.tensor(tf.hi, device=values.device)
    v = (torch.clamp(values, lo, hi) - lo) / torch.clamp(hi - lo, min=1e-20)
    x, y = tf.ctrl_x, tf.ctrl_rgba
    acc = y[0].expand(v.shape + (4,)).to(torch.float32)
    for i in range(x.shape[0] - 1):
        t = torch.clamp((v - x[i]) / torch.clamp(x[i + 1] - x[i], min=1e-12),
                        0.0, 1.0)
        acc = acc + t[..., None] * (y[i + 1] - y[i])
    return acc[..., :3], acc[..., 3]


def max_alpha(tf: TF, lo, hi):
    """The largest alpha over each value interval [lo, hi]: the nearest
    LUT entries widened by one each side, two range-max reads."""
    r = TF_RESOLUTION
    lo_t = torch.tensor(tf.lo, device=lo.device)
    hi_t = torch.tensor(tf.hi, device=lo.device)
    denom = torch.clamp(hi_t - lo_t, min=1e-20)
    nlo = torch.clamp((lo - lo_t) / denom, 0.0, 1.0)
    nhi = torch.clamp((hi - lo_t) / denom, 0.0, 1.0)
    i0 = torch.clamp(torch.floor(nlo * (r - 1) + 0.5).to(torch.int64) - 1,
                     0, r - 1)
    i1 = torch.clamp(torch.floor(nhi * (r - 1) + 0.5).to(torch.int64) + 1,
                     0, r - 1)
    length = torch.clamp(i1 - i0 + 1, min=1)
    k = torch.clamp(torch.floor(torch.log2(length.to(torch.float32))).to(
        torch.int64), 0, tf.rmq.shape[0] - 1)
    left = tf.rmq[k, i0]
    right = tf.rmq[k, torch.clamp(i1 + 1 - torch.pow(2, k), min=0)]
    return torch.where(i1 >= i0, torch.maximum(left, right),
                       tf.alphas[torch.clamp(i0, 0, r - 1)])


def macrocell_opacity(volume, tf: TF):
    """[mz, my, mx] max opacity: each cell's value range over its 16³
    voxels and a one-voxel ring (an 18³ window at stride 16)."""
    dz, dy, dx = volume.shape
    m = [-(-d // CELL) for d in (dx, dy, dz)]
    pad_hi = [max((mm - 1) * CELL - 1 + (CELL + 2) - d, 0)
              for mm, d in zip(m, (dx, dy, dz))]
    pads = (1, pad_hi[0], 1, pad_hi[1], 1, pad_hi[2])
    v = volume[None, None]
    hi = F.max_pool3d(F.pad(v, pads, value=-math.inf), CELL + 2,
                      stride=CELL)[0, 0]
    lo = -F.max_pool3d(F.pad(-v, pads, value=-math.inf), CELL + 2,
                       stride=CELL)[0, 0]
    op = max_alpha(tf, lo, hi)
    return torch.where(hi >= lo, op, torch.zeros_like(op))


# -- rays -------------------------------------------------------------------------


def _normalize(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-20)


def camera_rays(eye, center, up, fovy, width, height, device):
    """The upstream's pinhole (renderer.cpp:87-96), pixel centres, row
    major from the bottom left → (org [R, 3], dir [R, 3] normalized)."""
    f32 = torch.float32

    def t(v):
        return torch.as_tensor(v, dtype=f32, device=device)

    eye = t(eye)
    direction = _normalize(t(center) - eye)
    tan = 2.0 * torch.tan(t(fovy) * np.float32(np.pi) / 360.0)
    aspect = width / float(height)
    horizontal = tan * aspect * _normalize(torch.linalg.cross(direction,
                                                              t(up)))
    vertical = torch.linalg.cross(horizontal, direction) / aspect
    yy, xx = torch.meshgrid(torch.arange(height, dtype=f32, device=device),
                            torch.arange(width, dtype=f32, device=device),
                            indexing="ij")
    sx = (xx.reshape(-1) + 0.5) / width
    sy = (yy.reshape(-1) + 0.5) / height
    dirs = _normalize(direction[None] + (sx - 0.5)[:, None] * horizontal[None]
                      + (sy - 0.5)[:, None] * vertical[None])
    return eye[None].expand(dirs.shape), dirs


def box_clip(org, dirn, dims):
    """Slab test against [0, dims] in voxel space → (t0, t1) with t0 = 1,
    t1 = 0 on a miss (raytracing.h:60-103)."""
    dev = org.device
    d = torch.as_tensor([float(x) for x in dims], device=dev)

    def quotient(num):
        raw = num * (1.0 / dirn)
        ok = torch.isfinite(raw)
        return torch.where(ok, num * (1.0 / torch.where(ok, dirn, 1.0)), raw)

    lo = quotient(torch.zeros(3, device=dev) - org)
    hi = quotient(d - org)
    near, far = torch.minimum(lo, hi), torch.maximum(lo, hi)
    nan = torch.isnan(near) | torch.isnan(far)
    near = torch.where(nan, -np.inf, near)
    far = torch.where(nan, np.inf, far)
    t0 = torch.clamp(near.amax(-1), min=0.0)
    t1 = torch.clamp(far.amin(-1), max=np.inf)
    hit = t0 < t1
    return (torch.where(hit, torch.clamp(t0, min=0.0), 1.0),
            torch.where(hit, t1, 0.0))


# -- the march ----------------------------------------------------------------------


def _cell_exit(org, dirn, cell):
    step_pos = (dirn > 0).to(torch.float32)
    boundary = (cell.to(torch.float32) + step_pos) * float(CELL)
    raw = (boundary - org) / dirn
    ok = torch.isfinite(raw)
    t_ax = torch.where(ok, (boundary - org) / torch.where(ok, dirn, 1.0),
                       raw)
    return torch.where(ok, t_ax, torch.inf).amin(-1)


def _adaptive_rate(step, occ):
    scale = 15.0 * step
    r = torch.abs(torch.clamp(occ, 0.1, 1.0) - 1.0)
    return torch.clamp(step + scale * r * r, min=step)


def _quantized_step(ss, t0, t1):
    n = torch.floor((t1 - t0) / ss).to(torch.int32) + 1
    return (t1 - t0) / torch.clamp(n.to(torch.float32), min=1.0)


def emit(org, dirn, t_far, t, t_cell_end, ss, occ, base_step, n_iters,
         max_skips):
    """K slots a ray → ((t, t_cell_end, ss), t_x, t_y, valid [R, K])."""
    mz, my, mx = occ.shape
    flat = occ.reshape(-1)
    top = torch.tensor((mx - 1, my - 1, mz - 1), device=org.device)
    txs, tys, vs = [], [], []
    for _ in range(n_iters):
        entered = torch.zeros_like(t, dtype=torch.bool)
        for _ in range(max_skips):
            work = (t >= t_cell_end - EPS) & (t < t_far) & ~entered
            p = org + (t + PROBE_EPS)[:, None] * dirn
            cell = torch.floor(p / float(CELL)).to(torch.int64)
            c = torch.minimum(torch.clamp(cell, min=0), top)
            o = flat[(c[:, 2] * my + c[:, 1]) * mx + c[:, 0]]
            t_exit = torch.maximum(_cell_exit(org, dirn, cell),
                                   t + PROBE_EPS)
            empty = o <= EPS
            enter, skip = work & ~empty, work & empty
            entered = entered | enter
            t_exit_c = torch.minimum(t_exit, t_far)
            new_ss = _quantized_step(_adaptive_rate(base_step, o), t,
                                     t_exit_c)
            t = torch.where(skip, t_exit, t)
            ss = torch.where(enter, new_ss, ss)
            t_cell_end = torch.where(enter, t_exit_c, t_cell_end)
        t_y = torch.minimum(t + ss, t_cell_end)
        valid = (t_y > t + EPS) & (t < t_far) & (t_cell_end > t)
        txs.append(t)
        tys.append(t_y)
        vs.append(valid)
        t = torch.where(valid, t_y, t)
    return ((t, t_cell_end, ss), torch.stack(txs, 1), torch.stack(tys, 1),
            torch.stack(vs, 1))


def compose(values, t_x, t_y, valid, alpha, color, tf: TF, rate, density):
    rgb, a_s = classify(tf, values)
    dt = t_y - t_x
    a_s = 1.0 - torch.pow(torch.clamp(1.0 - a_s, 0.0, math.inf),
                          rate * dt * density)
    a_s = torch.where(valid, a_s, 0.0)
    for k in range(values.shape[1]):
        a_k = a_s[:, k]
        tr = torch.where(alpha < NEARLY_ONE, 1.0 - alpha, 0.0)
        color = color + tr[:, None] * rgb[:, k] * a_k[:, None]
        alpha = alpha + tr * a_k
    return alpha, color


@dataclass
class Scene:
    org: torch.Tensor
    dirn: torch.Tensor
    t0: torch.Tensor
    t1: torch.Tensor
    occ: torch.Tensor  # macrocell max opacity [mz, my, mx]
    tf: TF
    dims: tuple  # (x, y, z)
    n_iters: int
    max_skips: int
    sampling_rate: float = 1.0
    density_scale: float = 1.0


def make_scene(volume, dims, tf: TF, camera: dict, width, height, n_iters,
               max_skips) -> Scene:
    dev = volume.device
    org_w, dir_w = camera_rays(camera["eye"], camera["center"], camera["up"],
                               camera["fovy"], width, height, dev)
    d = torch.as_tensor([float(x) for x in dims], device=dev)
    org, dirn = org_w + 0.5 * d, dir_w
    t0, t1 = box_clip(org, dirn, dims)
    return Scene(org.contiguous(), dirn.contiguous(), t0, t1,
                 macrocell_opacity(volume, tf), tf, tuple(dims), n_iters,
                 max_skips)


@torch.no_grad()
def render_pass(scene: Scene, sample_fn, jitter):
    """One pass → (rgba [R, 4], samples taken, supersteps)."""
    org, dirn, t_far = scene.org, scene.dirn, scene.t1
    r = org.shape[0]
    dev = org.device
    dims = torch.as_tensor([float(x) for x in scene.dims], device=dev)
    t, tce = scene.t0, scene.t0.clone()
    ss = torch.full((r,), torch.inf, device=dev)
    alpha = torch.zeros(r, device=dev)
    color = torch.zeros((r, 3), device=dev)
    active = scene.t0 < t_far
    base = 1.0 / scene.sampling_rate
    samples = steps = 0
    while steps < MAX_SUPERSTEPS and bool(active.any()):
        (t, tce, ss), t_x, t_y, valid = emit(
            org, dirn, t_far, t, tce, ss, scene.occ, base, scene.n_iters,
            scene.max_skips)
        valid = valid & active[:, None]
        t_s = t_x + jitter[:, None] * (t_y - t_x)
        pos = (org[:, None, :] + t_s[..., None] * dirn[:, None, :]) / dims
        idx = torch.nonzero(valid.reshape(-1)).squeeze(1)
        values = torch.zeros(valid.numel(), device=dev)
        if idx.numel():
            values[idx] = sample_fn(pos.reshape(-1, 3)[idx])
        samples += int(idx.numel())
        alpha, color = compose(values.reshape(valid.shape), t_x, t_y, valid,
                               alpha, color, scene.tf, scene.sampling_rate,
                               scene.density_scale)
        active = active & (t < t_far) & (alpha < NEARLY_ONE)
        steps += 1
    return torch.cat([color, alpha[:, None]], -1), samples, steps


def chunked(fn, chunk: int = 1 << 18):
    """fn over `chunk` rows at a time."""
    def run(p):
        return torch.cat([fn(p[i:i + chunk]) for i in range(0, p.shape[0],
                                                            chunk)])
    return run
