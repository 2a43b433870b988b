"""The port's brick cache (render/brickcache.py, ops/brick_sample.py) and
the facade's streaming caches against the JAX package's on the CPU.

Both packages hold the same weights (params_from_numpy of one numpy draw)
on vorts 32³ and a 3-level 2^12 layout.

Tolerances:
- the LUT and a grid's pool: equal; the sampler on one pool: 1e-6 (the
  port sums the eight corners left to right, `jnp.sum` in its own order);
- a network's pool (decoded and exact lattices, ss 1 and 2, f32 and f16):
  the decode's tolerance, atol 2e-2 and mean 1e-3 (the fused MLP's bf16
  activations round at other points), as tests/test_torch_renderer.py
  holds the neural wavefront; an f16 pool adds its own rounding (2^-11 of
  a value);
- a pool against the decoded grid on occupied cells: 1e-5, JAX's own
  bound (tests/test_brickcache.py);
- lazy, refreshed and rebuilt pools of one package: equal;
- a NEURAL_WAVEFRONT frame under streaming_cache "auto" with JAX's
  jitter: the decode's tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantvnr_tpu import api as japi
from instantvnr_tpu.config import EncodingConfig as JEnc
from instantvnr_tpu.config import ModelConfig as JModelConfig
from instantvnr_tpu.config import NetworkConfig as JNet
from instantvnr_tpu.data import synthetic_volume as j_synthetic_volume
from instantvnr_tpu.render import brickcache as jbc
from instantvnr_tpu.render.camera import Camera as JCamera
from instantvnr_torch import api
from instantvnr_torch.config import EncodingConfig, ModelConfig, NetworkConfig
from instantvnr_torch.models.network import params_from_numpy, render_params
from instantvnr_torch.ops import brick_sample as bs
from instantvnr_torch.render import brickcache as bc
from instantvnr_torch.render.camera import Camera

DIMS = (32, 32, 32)
EYE = (5.0, 4.0, -50.0)
DECODE_ATOL, DECODE_MEAN = 2e-2, 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def volumes():
    jsv = japi.SimpleVolume(j_synthetic_volume(DIMS, kind="vorts"))
    tsv = api.SimpleVolume.synthetic(DIMS, "vorts", device="cpu")
    enc = dict(n_levels=3, n_features_per_level=4, log2_hashmap_size=12,
               base_resolution=4)
    net = dict(n_neurons=16, n_hidden_layers=2)
    jnv = japi.NeuralVolume(JModelConfig(encoding=JEnc(**enc),
                                         network=JNet(**net)), jsv)
    tnv = api.NeuralVolume(ModelConfig(encoding=EncodingConfig(**enc),
                                       network=NetworkConfig(**net)), tsv,
                           device="cpu")
    rng = np.random.default_rng(4)
    spec = tnv.field.spec
    params_np = {
        "table": rng.uniform(-1.0, 1.0, (spec.n_entries, spec.n_features)
                             ).astype(np.float32),
        "mlp": [(rng.standard_normal(s) * np.sqrt(2.0 / s[0])).astype(
            np.float32) for s in ((12, 16), (16, 16), (16, 1))]}
    jnv.state = jnv.state._replace(params={
        "table": jnp.asarray(params_np["table"]),
        "mlp": [jnp.asarray(w) for w in params_np["mlp"]]})
    tnv.params = params_from_numpy(params_np, "cpu")
    return jnv, tnv


def _points(mc_np, n, seed, dims=DIMS):
    """Object-space points: most in occupied macrocells (their faces
    included), some anywhere (misses where the pool holds no cell)."""
    rng = np.random.default_rng(seed)
    occ = np.flatnonzero(mc_np.reshape(-1) > 1e-6)
    mz, my, mx = mc_np.shape
    pick = occ[rng.integers(0, occ.size, n)]
    base = np.stack([pick % mx, (pick // mx) % my, pick // (mx * my)],
                    -1).astype(np.float32) * 16.0
    pos = base + rng.random((n, 3), np.float32) * 16.0
    pos[: n // 8] = np.floor(pos[: n // 8])  # on voxel and cell faces
    p = np.clip(pos / np.asarray(dims, np.float32), 0.0, 1.0)
    p[-n // 8:] = rng.random((n // 8, 3))
    return p.astype(np.float32)


def _jax_ctx_to_port(jctx):
    return {"lut": _t(jctx["lut"]),
            "packed": torch.from_numpy(np.array(
                jctx["packed"].astype(jnp.float32))).to(
                    torch.float16 if jctx["packed"].dtype == jnp.float16
                    else torch.float32),
            "dims": tuple(int(d) for d in np.asarray(jctx["dims"])),
            "mcdims": tuple(int(d) for d in np.asarray(jctx["mcdims"])),
            "ss": jbc.ctx_supersample(jctx),
            "convention": jbc.ctx_convention(jctx)}


def test_grid_pool_and_sampler_match_jax(volumes):
    """build_brick_cache_from_grid: the LUT and the pool equal JAX's; the
    sampler within 1e-6 of JAX's on JAX's pool, and within JAX's 1e-5 of
    the trilinear grid sample on occupied cells."""
    from instantvnr_torch.ops.trilinear import sample_volume

    jnv, tnv = volumes
    jsv, tsv = jnv.simple, tnv.simple
    jctx = jbc.build_brick_cache_from_grid(jsv.volume.data, jsv.macrocell)
    ctx = bc.build_brick_cache_from_grid(tsv.volume.data, tsv.macrocell)
    np.testing.assert_array_equal(ctx["lut"].numpy(), np.asarray(jctx["lut"]))
    np.testing.assert_array_equal(ctx["packed"].numpy(),
                                  np.asarray(jctx["packed"]))
    p = _points(tsv.macrocell.max_opacity.numpy(), 4000, 1)
    ref = np.asarray(jbc.brick_sample_fn(jctx, jnp.asarray(p)))
    got = bc.brick_sample_fn(_jax_ctx_to_port(jctx), _t(p)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    occupied = (tsv.macrocell.max_opacity.numpy().reshape(-1)[
        (np.minimum(np.floor(p[:3500] * 32 / 16), 1).astype(int)
         * [1, 2, 4]).sum(-1)] > 1e-6)
    np.testing.assert_allclose(
        bc.brick_sample_fn(ctx, _t(p[:3500]))[occupied].numpy(),
        sample_volume(tsv.volume.data, _t(p[:3500]))[occupied].numpy(),
        rtol=0, atol=1e-5)


@pytest.mark.parametrize("convention,ss,dtype", [
    ("decoded", 1, "float32"), ("exact", 1, "float16"),
    ("exact", 2, "float16"), ("decoded", 2, "float32")])
def test_network_pool_matches_jax(volumes, convention, ss, dtype):
    jnv, tnv = volumes
    jmc_, tmc = jnv.simple.macrocell, tnv.simple.macrocell
    jctx = jbc.build_brick_cache(jnv.field, jnv.state.params, jmc_,
                                 dtype=getattr(jnp, dtype), supersample=ss,
                                 convention=convention)
    ctx = bc.build_brick_cache(tnv.field,
                               render_params(tnv.params, tnv.field), tmc,
                               dtype=getattr(torch, dtype), supersample=ss,
                               convention=convention)
    assert ctx["packed"].dtype == getattr(torch, dtype)
    assert (bc.ctx_supersample(ctx), bc.ctx_convention(ctx)) == (
        jbc.ctx_supersample(jctx), jbc.ctx_convention(jctx))
    np.testing.assert_array_equal(ctx["lut"].numpy(), np.asarray(jctx["lut"]))
    ref = np.asarray(jctx["packed"].astype(jnp.float32))
    got = ctx["packed"].float().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=DECODE_ATOL)
    assert np.abs(got - ref).mean() <= DECODE_MEAN
    p = _points(tmc.max_opacity.numpy(), 3000, ss)
    np.testing.assert_allclose(
        bc.brick_sample_fn(_jax_ctx_to_port(jctx), _t(p)).numpy(),
        np.asarray(jbc.brick_sample_fn(jctx, jnp.asarray(p))), rtol=0,
        atol=1e-6)
    vals = bc.brick_sample_fn(ctx, _t(p)).numpy()
    assert np.abs(vals).max() > 0.05


def test_decoded_pool_equals_the_decoded_grid(volumes):
    """On occupied cells a "decoded"-lattice pool reproduces the port's
    own decoded grid's trilinear sample (JAX's bound, 1e-5)."""
    from instantvnr_torch.ops.trilinear import sample_volume

    _, tnv = volumes
    mc = tnv.simple.macrocell
    ctx = bc.build_brick_cache(tnv.field, render_params(tnv.params,
                                                        tnv.field), mc)
    p = _points(mc.max_opacity.numpy(), 3000, 5)[:-375]
    np.testing.assert_allclose(
        bc.brick_sample_fn(ctx, _t(p)).numpy(),
        sample_volume(tnv.decode_volume(), _t(p)).numpy(), rtol=0,
        atol=1e-5)


def test_brick_sample_plain_sums_left_to_right():
    """The plain sampler: a miss gives 0, a pool of ones gives 1 anywhere
    it holds the cell (the weights sum to 1), at ss 1 and 2."""
    for ss in (1, 2):
        lut = torch.tensor([0, -1, 1, -1], dtype=torch.int32)  # 2x2x1
        packed = torch.ones((2 * bs._brick_edge(ss) ** 3, 8))
        p = torch.rand((500, 3), generator=torch.Generator().manual_seed(ss))
        v = bs.brick_sample(lut, packed, p, (32, 32, 16), (2, 2, 1), ss)
        held = (p[:, 0] * 32 < 16)
        torch.testing.assert_close(v[held], torch.ones(int(held.sum())),
                                   rtol=0, atol=1e-6)
        assert (v[~held] == 0).all()


def test_view_and_light_cells_match_jax(volumes):
    jnv, tnv = volumes
    for eye, scale in ((EYE, None), ((40.0, 10.0, -20.0), (1.5, 1.0, 0.7)),
                       ((0.0, 0.0, 12.0), None)):
        jc = JCamera(eye=eye, center=(3.0, 0, 0), up=(0, 1, 0), fovy=40)
        tc = Camera(eye=eye, center=(3.0, 0, 0), up=(0, 1, 0), fovy=40)
        ref = jbc.view_cells(jnv.simple.macrocell, jc, 20, 14, scale=scale)
        got = bc.view_cells(tnv.simple.macrocell, tc, 20, 14, scale=scale)
        np.testing.assert_array_equal(got, ref)
        light = (0.7, -0.9, 0.4)
        np.testing.assert_array_equal(
            bc.light_swept_cells(tnv.simple.macrocell, got[:2], light),
            jbc.light_swept_cells(jnv.simple.macrocell, ref[:2], light))
    assert 0 < bc.occupied_cells(tnv.simple.macrocell, dilate=0).size
    assert bc.brick_cache_bytes(tnv.simple.macrocell) == \
        jbc.brick_cache_bytes(jnv.simple.macrocell)


def test_lazy_cache_matches_the_full_build(volumes):
    """LazyBrickCache decodes the bricks a view can touch, equal to a full
    build there; ensure_all completes the pool; set_params restales it;
    a TF-empty scene's dummy brick counts as decoded."""
    _, tnv = volumes
    mc = tnv.simple.macrocell
    params = render_params(tnv.params, tnv.field)
    full = bc.build_brick_cache(tnv.field, params, mc, dtype=torch.float16,
                                convention="exact")
    lazy = bc.LazyBrickCache(tnv.field, params, mc, dtype=torch.float16,
                             convention="exact")
    assert lazy.n_decoded == 0 and float(lazy.ctx["packed"].abs().max()) == 0
    # a narrow view of the cells of x, y ≥ 16 only
    cam = Camera(eye=(8.0, 8.0, -60.0), center=(8.0, 8.0, 0.0), up=(0, 1, 0),
                 fovy=5)
    n = lazy.ensure_view(cam, 8, 8)
    assert 0 < n < lazy.n_bricks and lazy.ensure_view(cam, 8, 8) == 0
    # column 0 holds a brick's texels (the other columns may differ in
    # brick-tail rows no sample addresses); samples equal the full build's
    b3 = bc._ss_geom(1)[1]
    for slot in range(lazy.n_bricks):
        rows = lazy.ctx["packed"][slot * b3:(slot + 1) * b3, 0]
        if lazy._decoded[slot]:
            assert torch.equal(rows, full["packed"][slot * b3:
                                                    (slot + 1) * b3, 0])
        else:
            assert float(rows.abs().max()) == 0
    p = _t(_points(mc.max_opacity.numpy(), 2000, 7)[:-250])
    assert np.isin(bc.view_cells(mc, cam, 8, 8),
                   lazy._cells[lazy._decoded]).all()
    cell = torch.clamp(torch.floor(p * 32 / 16).long(), 0, 1)
    in_view = torch.from_numpy(lazy._decoded)[
        lazy.ctx["lut"][(cell * torch.tensor([1, 2, 4])).sum(-1)].long()]
    assert in_view.any() and (~in_view).any()
    assert torch.equal(bc.brick_sample_fn(lazy.ctx, p)[in_view],
                       bc.brick_sample_fn(full, p)[in_view])
    assert lazy.ensure_all() == lazy.n_bricks - n
    assert torch.equal(lazy.ctx["packed"][:, 0], full["packed"][:, 0])
    assert torch.equal(bc.brick_sample_fn(lazy.ctx, p),
                       bc.brick_sample_fn(full, p))
    lazy.set_params(params)
    assert lazy.n_decoded == 0
    assert lazy.refresh(params, budget_bricks=2) == 0  # none decoded yet
    empty = dataclasses.replace(mc, max_opacity=torch.zeros_like(
        mc.max_opacity))
    dummy = bc.LazyBrickCache(tnv.field, params, empty, dilate=0)
    assert dummy.n_bricks == dummy.n_decoded == 1
    assert dummy.ensure_all() == 0


def test_refresh_with_budget_equals_a_rebuild(volumes):
    """refresh_brick_pool round-robin under a budget converges to a full
    build against the new params; it follows the ctx's own LUT, so a grown
    macrocell does not shift the layout (JAX's
    test_refresh_is_layout_stable_under_macrocell_drift)."""
    _, tnv = volumes
    mc = tnv.simple.macrocell
    old = render_params(tnv.params, tnv.field)
    new = {"table": old["table"] * 0.5, "mlp": old["mlp"]}
    occ = mc.max_opacity.clone()
    occ.view(-1)[torch.nonzero(occ.view(-1) > 1e-6)[:1]] = 0.0
    small = dataclasses.replace(mc, max_opacity=occ)
    for ss in (1, 2):
        ctx = bc.build_brick_cache(tnv.field, old, small, supersample=ss)
        want = bc.build_brick_cache(tnv.field, new, small, supersample=ss)
        cur, calls = 0, 0
        while True:
            ctx, cur = bc.refresh_brick_pool(tnv.field, new, ctx, cur, 3)
            calls += 1
            if cur == 0:
                break
        assert calls == -(-int((ctx["lut"] >= 0).sum()) // 3)
        # column 0 holds the texels themselves; the other columns may
        # differ only in brick-tail rows no sample addresses
        assert torch.equal(ctx["packed"][:, 0], want["packed"][:, 0])
        assert torch.equal(ctx["lut"], want["lut"])
        p = _t(_points(small.max_opacity.numpy(), 2000, ss))
        assert torch.equal(bc.brick_sample_fn(ctx, p),
                           bc.brick_sample_fn(want, p))
        assert bc.ctx_supersample(ctx) == ss


@pytest.mark.parametrize("scale", [2.0, 0.75, 0.6, 0.001])
def test_memory_gate_and_info_match_jax(volumes, monkeypatch, scale):
    """Under VNR_BRICK_MAX_MB at a multiple of the f32 pool's size, every
    policy resolves as in JAX (api.py:1068-1136) and streaming_cache_info
    equals JAX's dict."""
    jnv, tnv = volumes
    mb = bc.brick_cache_bytes(tnv.simple.macrocell) / 2**20
    monkeypatch.setenv("VNR_BRICK_MAX_MB", str(mb * scale))
    for policy in ("auto", "brick", "hq", "lazy", "none"):
        jr = japi.VNRenderer(jnv, 8, 8, japi.RenderMode.NEURAL_WAVEFRONT,
                             streaming_cache=policy)
        tr = api.VNRenderer(tnv, 8, 8, api.RenderMode.NEURAL_WAVEFRONT,
                            streaming_cache=policy)
        assert tr.streaming_cache_info == jr.streaming_cache_info, policy
    tr = api.VNRenderer(tnv, 8, 8)  # DECODED_SLAB
    assert tr.streaming_cache_info == {"policy": "auto", "resolved": "n/a",
                                       "quality": "n/a"}


def _jax_jitter(n):
    key = jax.random.PRNGKey(0)
    _, sub = jax.random.split(key)
    return _t(jax.random.uniform(sub, (n,), jnp.float32))


@pytest.mark.parametrize("mode", ["NEURAL_WAVEFRONT",
                                  "NEURAL_WAVEFRONT_GRADIENT"])
def test_auto_brick_wavefront_matches_jax(volumes, mode):
    """The default streaming_cache ("auto": the f16 pool on the exact
    lattice) renders the JAX package's frame, the port fed JAX's jitter."""
    jnv, tnv = volumes
    n = 20
    jr = japi.VNRenderer(jnv, n, n, japi.RenderMode[mode])
    jr.set_camera(JCamera(eye=EYE, center=(0, 0, 0), up=(0, 1, 0), fovy=45))
    jr.render()
    ref = jr.mapframe()
    tr = api.VNRenderer(tnv, n, n, api.RenderMode[mode])
    assert tr.streaming_cache_info["resolved"] == "brick"
    jit = _jax_jitter(n * n)
    tr._impl._next_jitter = lambda: jit
    tr.set_camera(Camera(eye=EYE, center=(0, 0, 0), up=(0, 1, 0), fovy=45))
    tr.render()
    got = tr.mapframe()
    assert ref[..., 3].max() > 0.05
    np.testing.assert_allclose(got, ref, atol=DECODE_ATOL, rtol=0)
    assert np.abs(got - ref).mean() <= DECODE_MEAN


def test_facade_lazy_hq_and_budgeted_refresh(volumes):
    """"lazy" renders the eager pool's frame, decoding only what the view
    (and under SSH its light sweep) touches; refresh_params(budget_bricks)
    round-robins the eager pool to a full refresh's frame."""
    _, tnv = volumes
    cam = Camera(eye=EYE, center=(0, 0, 0), up=(0, 1, 0), fovy=45)
    jit = torch.rand(16 * 16, generator=torch.Generator().manual_seed(2))
    frames = {}
    for policy in ("auto", "lazy"):
        r = api.VNRenderer(tnv, 16, 16, api.RenderMode.NEURAL_WAVEFRONT_SSH,
                           streaming_cache=policy)
        r._impl._next_jitter = lambda: jit
        r.set_camera(cam)
        r.render()
        frames[policy] = r.mapframe()
        if policy == "lazy":
            assert 0 < r._lazy.n_decoded <= r._lazy.n_bricks
    np.testing.assert_array_equal(frames["lazy"], frames["auto"])

    old = tnv.params
    try:
        out = {}
        for budget in (None, 2):
            tnv.params = old
            r = api.VNRenderer(tnv, 16, 16, api.RenderMode.NEURAL_WAVEFRONT)
            r._impl._next_jitter = lambda: jit
            r.set_camera(cam)
            tnv.params = {"table": old["table"] * 0.5, "mlp": old["mlp"]}
            r.refresh_params(budget_bricks=budget)
            while r._brick_cursor:
                r.refresh_params(budget_bricks=budget)
            r.render()
            out[budget] = r.mapframe()
        np.testing.assert_array_equal(out[2], out[None])
        r.set_streaming_cache("hq")
        assert r.streaming_cache_info["supersample"] == 2
        r.set_streaming_cache("lazy")
        r.refresh_params(budget_bricks=1)
        r.render()
        assert np.isfinite(r.mapframe()).all()
    finally:
        tnv.params = old
