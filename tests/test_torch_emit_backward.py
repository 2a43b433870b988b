"""The emission's backward (render/raymarch.py::_plain_emit_backward, the
plain version of the card's raymarch_emit_backward) against jax.vjp of the
JAX package's _emit_samples, on the same numpy rays and states, and the
axis-parallel rays where JAX's gradient is NaN and the port's is finite.

Tolerances:
- against jax.vjp: 1e-5 of each leaf's largest entry (float32 sums of the
  same derivatives in another order: torch's autograd against XLA's
  transpose of the scan);
- a tie's split: the gradient autograd's rules give (torch.minimum /
  maximum half and half, amin evenly among tied axes), within 1e-6 of its
  largest entry (the values are sums of exact halves);
- axis-parallel rays: the float32 gradient against a float64 central
  difference of the plain emission in float64 (step 1e-7 on each nonzero
  component of the origin and the direction), 1e-3 of the largest entry
  (float32 against float64 arithmetic), where the scan is smooth at that
  scale: the one-sided differences agree. The scan is only piecewise
  smooth (a quantized step's count, a skipped cell), and a tie that
  float32 meets exactly and float64 misses is split by autograd; so the
  rays' range is the box inset by a quarter voxel, whose faces no cell
  exit meets (at the box's own faces, multiples of 16 voxels, t_far ties
  with the last cell's exit). The zero axes exactly 0.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_emit_rays import (BASE_STEP, DIMS, port_macrocell, random_rays,
                             sphere_max_opacity, tie_cases, tie_cotangents)

from instantvnr_tpu.accel import macrocell as jmc
from instantvnr_tpu.config import TransferFunctionConfig as JTFConfig
from instantvnr_tpu.data import synthetic_volume as j_synthetic_volume
from instantvnr_tpu.utils.math import ray_box_intersect as j_box
from instantvnr_tpu.utils.tfn import bake_transfer_function as j_bake
from instantvnr_torch.render import raymarch as rm
from instantvnr_torch.utils.math import ray_box_intersect

jrm = importlib.import_module("instantvnr_tpu.render.raymarch")
LEAVES = ("org", "dirn", "t_far", "t", "tce", "ss")


@pytest.fixture(scope="module")
def mcs():
    """The scene's macrocell in both packages (the same emptied cells)."""
    jvol = j_synthetic_volume(DIMS, kind="sphere")
    jm = jmc.build(jvol.data, jvol.dims, j_bake(JTFConfig()))
    jm = jmc.MacroCell(jm.value_lo, jm.value_hi,
                       jnp.asarray(sphere_max_opacity(jm.max_opacity)),
                       jm.volume_dims)
    tm = port_macrocell()
    np.testing.assert_array_equal(np.asarray(jm.max_opacity),
                                  tm.max_opacity.numpy())
    return jm, tm


def _jax_vjp(jm, ins, grads, k, skips, s):
    """jax.vjp of JAX's _emit_samples in (org, dirn, t_far, t, t_cell_end,
    ss) with the cotangents of (t, t_cell_end, ss, t_x, t_y)."""
    base = jrm.init_ray_state(jnp.asarray(ins[3]), jnp.asarray(ins[2]))

    def emit(org, dirn, t_far, t, tce, ss):
        st = base._replace(t=t, t_cell_end=tce, ss=ss)
        (t2, tce2, ss2, *_), t_x, t_y, *_ = jrm._emit_samples(
            org, dirn, t_far, st, jm, BASE_STEP, k, skips,
            samples_per_slot=s)
        return t2, tce2, ss2, t_x, t_y

    _, vjp = jax.vjp(emit, *(jnp.asarray(x) for x in ins))
    return [np.asarray(g) for g in vjp(tuple(jnp.asarray(g)
                                             for g in grads))]


def _port_vjp(tm, ins, grads, k, skips, s):
    t = [torch.from_numpy(np.array(x)) for x in ins]
    g = [None if x is None else torch.from_numpy(np.array(x)) for x in grads]
    out = rm._plain_emit_backward(*t, g, (True,) * 6, tm, BASE_STEP, k,
                                  skips, s)
    return [np.zeros_like(x) if o is None else o.numpy()
            for x, o in zip(ins, out)]


def _close(got, want, rtol):
    for name, a, b in zip(LEAVES, got, want):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=rtol * max(np.abs(b).max(), 1e-30),
                                   err_msg=name)


def _cotangents(rng, r, kk):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((r,),) * 3 + ((r, kk),) * 2]


@pytest.mark.parametrize("k", [1, 4, 9])
@pytest.mark.parametrize("s", [1, 2])
def test_plain_emit_backward_matches_jax(mcs, k, s):
    """48 rays of the scene, three supersteps from the carried state (the
    first from a fresh state: ss = inf, t_cell_end = t), random cotangents
    on every output: each leaf's gradient within 1e-5 of its largest entry
    of jax.vjp's."""
    jm, tm = mcs
    org, dirn, t0, t1 = random_rays(48, 10 * k + s)
    rng = np.random.default_rng(k + 7 * s)
    t, tce, ss = t0, t0.copy(), np.full_like(t0, np.inf)
    nonzero = 0
    for _ in range(3):
        ins = [org, dirn, t1, t, tce, ss]
        grads = _cotangents(rng, 48, k * s)
        want = _jax_vjp(jm, ins, grads, k, 8, s)
        got = _port_vjp(tm, ins, grads, k, 8, s)
        _close(got, want, 1e-5)
        nonzero += int(np.abs(got[1]).max() > 0)
        (t, tce, ss), *_ = rm._emit_samples(
            *(torch.from_numpy(x) for x in (org, dirn, t1)),
            rm.init_ray_state(torch.from_numpy(t), torch.from_numpy(t1))
            ._replace(t_cell_end=torch.from_numpy(tce),
                      ss=torch.from_numpy(ss)), tm, BASE_STEP, k, 8, s)
        t, tce, ss = t.numpy(), tce.numpy(), ss.numpy()
    assert nonzero == 3  # the directions carry gradient every superstep


@pytest.mark.parametrize("name", ["t_y", "exit_far", "axes", "probe"])
def test_ties_split_as_autograd(mcs, name):
    """Each tie of the scan (torch_emit_rays.tie_cases): it occurs, the
    port's gradient is jax.vjp's (both split ties alike), and where the
    case states it, the split autograd's rules give."""
    jm, tm = mcs
    c = tie_cases()[name]
    ins = [c["org"], c["dirn"], c["t_far"], c["t"], c["tce"], c["ss"]]
    grads = tie_cotangents(c)
    tt = [torch.from_numpy(x) for x in ins]
    (t2, tce2, _), t_x, t_y, valid = rm._emit_samples(
        *tt[:3], rm.init_ray_state(tt[3], tt[2])._replace(
            t_cell_end=tt[4], ss=tt[5]), tm, BASE_STEP, c["k"], c["skips"])
    tied = {"t_y": bool(t_y[0, 0] == tt[4][0] == tt[3][0] + tt[5][0]),
            "exit_far": bool(tce2[0] == tt[2][0]),
            "axes": bool(t2[0] == 21.0),
            "probe": bool(tt[3][0] + np.float32(1e-3) == 8.0
                          and tce2[0] > 8.0 and valid.all())}
    assert tied[name]
    got = _port_vjp(tm, ins, grads, c["k"], c["skips"], 1)
    _close(got, _jax_vjp(jm, ins, grads, c["k"], c["skips"], 1), 1e-5)
    if c["want"] is not None:
        want = {leaf: np.zeros_like(x) for leaf, x in zip(LEAVES, ins)}
        for (leaf, i), v in c["want"].items():
            want[leaf].reshape(-1)[i] = v
        _close(got, [want[leaf] for leaf in LEAVES], 1e-6)


def _emit_loss_per_ray(tm, org, dirn, t_far, t, tce, ss, w, k, skips):
    """Each ray's Σ w·(t_x, t_y, t, t_cell_end, finite ss) → [R]."""
    st = rm.init_ray_state(t, t_far)._replace(t_cell_end=tce, ss=ss)
    (t2, tce2, ss2), t_x, t_y, _ = rm._emit_samples(org, dirn, t_far, st,
                                                    tm, BASE_STEP, k, skips)
    ss2 = torch.where(torch.isfinite(ss2), ss2, 0.0)
    return ((w[0] * t_x).sum(1) + (w[1] * t_y).sum(1) + w[2] * t2
            + w[3] * tce2 + w[4] * ss2)


@pytest.mark.parametrize("zero_axes", [1, 2])
def test_axis_parallel_rays_have_finite_gradients(mcs, zero_axes):
    """Rays with one or two zero direction components: the port's gradient
    is finite, exactly 0 on the zero axes, and a float64 central
    difference's on the others; JAX's is NaN there (ROADMAP Queue 3: its
    single where meets the division's derivative, 0·(b − o)/0²)."""
    jm, tm = mcs
    org, dirn, t0, t1 = random_rays(32, 40 + zero_axes, zero_axes,
                                   inset=0.25)
    zero = dirn == 0
    assert zero.sum(1).tolist() == [zero_axes] * 32
    k, skips = 4, 8
    rng = np.random.default_rng(zero_axes)
    w = [rng.standard_normal((32, k)).astype(np.float32),
         rng.standard_normal((32, k)).astype(np.float32),
         *rng.standard_normal((3, 32)).astype(np.float32)]
    leaves = [torch.from_numpy(x).requires_grad_() for x in (org, dirn)]
    t_near = torch.from_numpy(t0)
    loss = _emit_loss_per_ray(
        tm, *leaves, torch.from_numpy(t1), t_near, t_near.clone(),
        torch.full((32,), torch.inf), [torch.from_numpy(x) for x in w], k,
        skips)
    loss.sum().backward()
    got = [x.grad.numpy() for x in leaves]
    for g in got:
        assert np.isfinite(g).all() and np.abs(g).max() > 0
        assert (g[zero] == 0).all()
    # float64 central differences, each component of every ray at once
    # (each ray's loss is its own); held where the scan is smooth at the
    # step's scale (its one-sided differences agree), which most entries
    # are
    d64 = [torch.from_numpy(x).double() for x in (org, dirn, t1, t0)]
    w64 = [torch.from_numpy(x).double() for x in w]

    def loss64(x):
        return _emit_loss_per_ray(
            tm, x[0], x[1], d64[2], d64[3], d64[3].clone(),
            torch.full((32,), torch.inf, dtype=torch.float64), w64, k, skips)

    h = 1e-7  # under the distance to most quantized steps' jumps
    at = loss64(d64[:2])
    smooth = []
    for leaf, g in enumerate(got):
        for a in np.flatnonzero(~zero.all(0)):
            ends = []
            for sign in (1.0, -1.0):
                x = [v.clone() for v in d64[:2]]
                x[leaf][:, a] += sign * h * torch.from_numpy(~zero[:, a])
                ends.append(loss64(x))
            up, down = ((ends[0] - at) / h).numpy(), ((at - ends[1]) / h
                                                      ).numpy()
            fd = ((ends[0] - ends[1]) / (2 * h)).numpy()
            tol = 1e-3 * np.abs(g).max()
            ok = (np.abs(up - down) <= tol) & ~zero[:, a]
            np.testing.assert_allclose(g[ok, a], fd[ok], rtol=0, atol=tol)
            smooth.append(ok.sum() / (~zero[:, a]).sum())
    assert min(smooth) >= 0.9, smooth
    # JAX's gradient of the same loss: NaN on these rays
    base = jrm.init_ray_state(jnp.asarray(t0), jnp.asarray(t1))

    def jloss(o, d):
        (t2, tce2, ss2, *_), t_x, t_y, *_ = jrm._emit_samples(
            o, d, jnp.asarray(t1), base, jm, BASE_STEP, k, skips)
        ss2 = jnp.where(jnp.isfinite(ss2), ss2, 0.0)
        return jnp.sum(w[0] * t_x) + jnp.sum(w[1] * t_y) + jnp.sum(
            w[2] * t2 + w[3] * tce2 + w[4] * ss2)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(org), jnp.asarray(dirn))
    assert all(np.isnan(np.asarray(g)).any() for g in jg)


@pytest.mark.parametrize("zero_axes", [1, 2])
def test_ray_box_intersect_gradient_is_finite(zero_axes):
    """ray_box_intersect's t_near and t_far on the same axis-parallel rays:
    the values JAX's are, a finite gradient, exactly 0 on the zero axes
    (JAX's is NaN there: (box − org)·(1/0) differentiated)."""
    org, dirn, _, _ = random_rays(32, 40 + zero_axes, zero_axes)
    zero = dirn == 0
    leaves = [torch.from_numpy(x).requires_grad_() for x in (org, dirn)]
    hi = torch.tensor(DIMS, dtype=torch.float32)
    t0, t1, hit = ray_box_intersect(*leaves, torch.zeros(3), hi)
    jt0, jt1, jhit = j_box(jnp.asarray(org), jnp.asarray(dirn),
                           jnp.zeros(3), jnp.asarray(hi.numpy()))
    for a, b in ((t0, jt0), (t1, jt1), (hit, jhit)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    assert hit.all()
    (t0 + 2.0 * t1).sum().backward()
    for x in leaves:
        g = x.grad.numpy()
        assert np.isfinite(g).all() and np.abs(g).max() > 0
        assert (g[zero] == 0).all()

    def jloss(o, d):
        a, b, _ = j_box(o, d, jnp.zeros(3), jnp.asarray(hi.numpy()))
        return jnp.sum(a + 2.0 * b)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(org), jnp.asarray(dirn))
    assert all(np.isnan(np.asarray(g)).any() for g in jg)


def test_cell_exit_values_unchanged_on_axis_parallel_rays(mcs):
    """The double where keeps the forward: on axis-parallel and general
    rays the emission's outputs equal JAX's bit for bit."""
    jm, tm = mcs
    for zero_axes in (0, 1, 2):
        org, dirn, t0, t1 = random_rays(40, 60 + zero_axes, zero_axes)
        (jt, jce, jss, *_), *jout = jrm._emit_samples(
            org, dirn, t1, jrm.init_ray_state(t0, t1), jm, BASE_STEP, 4, 8)
        (tt, tce, tss), *tout = rm._emit_samples(
            *(torch.from_numpy(x) for x in (org, dirn, t1)),
            rm.init_ray_state(torch.from_numpy(t0), torch.from_numpy(t1)),
            tm, BASE_STEP, 4, 8)
        for a, b in zip([tt, tce, tss] + tout, [jt, jce, jss] + jout[:3]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_emit_backward_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches on CUDA tensors or raises; it never
    falls back to the plain recompute (the CPU's emission differentiates
    _emit_samples directly)."""
    tm = port_macrocell()
    org, dirn, t0, t1 = (torch.from_numpy(x) for x in random_rays(4, 1))
    before = rm.emit_backward_counter.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        rm._kernel_emit_backward(org, dirn, t1, t0, t0, t0,
                                 (None,) * 5, (True,) * 6, tm, BASE_STEP, 4,
                                 8, 1)
    assert rm.emit_backward_counter.launches == before
