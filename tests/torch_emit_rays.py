"""Rays and states for the emission's backward (render/raymarch.py::
_plain_emit_backward, and on the card raymarch_emit_backward), shared by
tests/test_torch_emit_backward.py (against JAX on the CPU) and
tests/test_torch_cuda.py (the kernel against the plain version). NumPy and
torch only: the card's tests import no JAX.

The scene is the 32³ sphere under the default TF, whose 2 × 2 × 2
macrocells are all occupied; two of them are emptied (`EMPTY_CELLS`) so
that the scans also skip cells.
"""
import numpy as np
import torch

DIMS = (32, 32, 32)
EMPTY_CELLS = ((0, 0, 0), (1, 0, 1))  # (z, y, x)
BASE_STEP = 0.5


def sphere_max_opacity(max_opacity):
    """The sphere's macrocell max opacity [2, 2, 2] (numpy) with
    EMPTY_CELLS set to 0."""
    m = np.asarray(max_opacity, dtype=np.float32).copy()
    for z, y, x in EMPTY_CELLS:
        m[z, y, x] = 0.0
    return m


def port_macrocell(device="cpu"):
    """The port's macrocell of the scene."""
    from instantvnr_torch.accel import macrocell as mcmod
    from instantvnr_torch.config import TransferFunctionConfig
    from instantvnr_torch.data.volume import synthetic_volume
    from instantvnr_torch.utils.tfn import bake_transfer_function

    vol = synthetic_volume(DIMS, kind="sphere", device=device)
    tf = bake_transfer_function(TransferFunctionConfig(), device=device)
    mc = mcmod.build(vol.data, vol.dims, tf)
    occ = torch.from_numpy(sphere_max_opacity(mc.max_opacity.cpu()))
    return mcmod.MacroCell(mc.value_lo, mc.value_hi, occ.to(device),
                           mc.volume_dims)


def box_range(org, dirn, inset=0.0):
    """float32 [t_near, t_far] of rays through the box [inset, DIMS −
    inset] (numpy, the slab method); a miss gets the empty range (1, 0)."""
    with np.errstate(invalid="ignore", divide="ignore"):
        inv = np.float32(1.0) / dirn
        lo = (np.full(3, inset, np.float32) - org) * inv
        hi = (np.array(DIMS, np.float32) - np.float32(inset) - org) * inv
    near = np.where(np.isnan(lo) | np.isnan(hi), -np.inf,
                    np.minimum(lo, hi))
    far = np.where(np.isnan(lo) | np.isnan(hi), np.inf, np.maximum(lo, hi))
    t0 = np.maximum(near.max(1), 0).astype(np.float32)
    t1 = far.min(1).astype(np.float32)
    hit = t0 < t1
    return np.where(hit, t0, 1).astype(np.float32), np.where(
        hit, t1, 0).astype(np.float32)


def random_rays(n, seed, zero_axes=0, inset=0.0):
    """n rays from around the box toward points inside it → float32 numpy
    (org [n, 3], dirn [n, 3], t_near, t_far over the box inset by `inset`).
    The directions are normalized; with `zero_axes`, that many components
    of each are exactly 0 (axis-parallel rays), the origin lies inside the
    box's slab on those axes, and the direction's length is drawn from
    [0.6, 0.9] (else a ray along an axis steps a cell's 16 voxels in
    exactly 32 half-voxel steps, at a jump of the quantized step)."""
    rng = np.random.default_rng(seed)
    org = rng.uniform(-20, 52, (n, 3)).astype(np.float32)
    d = rng.uniform(4, 28, (n, 3)).astype(np.float32) - org
    for i in range(n if zero_axes else 0):
        axes = rng.choice(3, zero_axes, replace=False)
        d[i, axes] = 0.0
        org[i, axes] = rng.uniform(3, 29, zero_axes)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    if zero_axes:
        d = d * rng.uniform(0.6, 0.9, (n, 1))
    dirn = d.astype(np.float32)
    t0, t1 = box_range(org, dirn, inset)
    return org, dirn, t0, t1


def _t_before(target, eps=np.float32(1e-3)):
    """A float32 t with t + 1e-3 == target exactly (float32)."""
    t = np.float32(target) - eps
    for k in range(-64, 65):
        c = t + np.float32(k) * np.spacing(np.float32(target))
        if np.float32(c + eps) == np.float32(target):
            return np.float32(c)
    raise ValueError(target)


def tie_cases():
    """One ray a case at which the emission's scan meets a tie, with the
    state before it, the scan's (n_iters, max_skips), a cotangent that
    reads the tied quantity and, where the split is simple, the gradient
    autograd's rules give (torch.minimum / maximum half and half, amin
    evenly among tied axes) as {(leaf, flat index): value}, every other
    entry 0 (leaves org, dirn [1, 3], t_far, t, tce, ss) → {name: dict}. Directions are exact in
    float32 (powers of two), so the tied values are equal bit for bit:
    - "t_y": t_y = min(t + ss, t_cell_end) with t + ss == t_cell_end (the
      quantized steps landing on the cell end), no probe;
    - "exit_far": the last cell's exit equals t_far (a volume whose sides
      are multiples of 16 voxels): t_cell_end = min(t_exit, t_far);
    - "axes": the x and y exits of an empty cell tie in the amin, and the
      ray skips to them (one probe);
    - "probe": the probe point t + 1e-3 lies on the exit face of a cell it
      leaves backwards, so max(t_exit, t + 1e-3) ties."""
    f = np.float32
    cases = {
        "t_y": dict(org=(-5.0, 15.5, 16.5), dirn=(1.0, 0.25, 0.125),
                    t_far=60.0, t=10.0, tce=10.5, ss=0.5, k=1, skips=8,
                    reads="t_y",
                    want={("t", 0): 0.5, ("tce", 0): 0.5, ("ss", 0): 0.5}),
        "exit_far": dict(org=(-5.0, 12.0, 20.0), dirn=(1.0, 0.25, 0.125),
                         t_far=37.0, t=22.0, tce=22.0, ss=np.inf, k=1,
                         skips=8, reads="tce",
                         want={("t_far", 0): 0.5, ("org", 0): -0.5,
                               ("dirn", 0): -0.5 * 37.0}),
        "axes": dict(org=(-5.0, -5.0, 2.0), dirn=(1.0, 1.0, 0.5),
                     t_far=37.0, t=6.0, tce=6.0, ss=np.inf, k=1, skips=1,
                     reads="t",
                     want={("org", 0): -0.5, ("org", 1): -0.5,
                           ("dirn", 0): -10.5, ("dirn", 1): -10.5}),
        "probe": dict(org=(40.0, 15.5, 16.5), dirn=(-1.0, 0.25, 0.125),
                      t_far=40.0, t=_t_before(8.0), tce=_t_before(8.0),
                      ss=np.inf, k=2, skips=8, reads="all", want=None),
    }
    for c in cases.values():
        c["org"] = np.array([c["org"]], f)
        c["dirn"] = np.array([c["dirn"]], f)
        for key in ("t_far", "t", "tce", "ss"):
            c[key] = np.array([c[key]], f)
    return cases


def tie_cotangents(case):
    """The cotangents (g_t, g_tce, g_ss [1], g_tx, g_ty [1, K]) of a tie
    case: 1 on the quantity it reads, or (\"all\") on every output."""
    k = case["k"]
    z1, zk = np.zeros(1, np.float32), np.zeros((1, k), np.float32)
    g = {"t": z1.copy(), "tce": z1.copy(), "ss": z1.copy(),
         "t_x": zk.copy(), "t_y": zk.copy()}
    if case["reads"] == "all":
        for key in g:
            g[key][:] = 1.0
    elif case["reads"] == "t_y":
        g["t_y"][0, 0] = 1.0
    else:
        g[case["reads"]][:] = 1.0
    return [g[key] for key in ("t", "tce", "ss", "t_x", "t_y")]

