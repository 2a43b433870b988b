"""The port's compaction (render/compaction.py's schedule, ops/compaction.py)
against the JAX package's (instantvnr_tpu/render/compaction.py), on the
CPU.

- The schedule functions (_bucket, _next_bucket, bucket_sizes,
  bump_schedule, strip_counts) equal JAX's, with the midpoint ladder on
  and off.
- The plain compact_rows equals JAX's _compact_body exactly (it moves
  values, computes none), and scatter_rows JAX's _unpermute, on seeded
  numpy state at m = 2^16; select_rows is the masked selection; the
  wrappers' device-side count forms on CPU tensors.
- The plain emission with S samples a slot equals JAX's; _Programs and
  the finisher's chunks.

The compacted frames are in tests/test_torch_compaction_frames.py, the
schedule replay and the fused frames in
tests/test_torch_compaction_replay.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_compaction_scene import (DIMS, _jax_rays, _t, jcomp, jrm,
                                    scene)

from instantvnr_torch.accel import macrocell as mcmod
from instantvnr_torch.config import TransferFunctionConfig
from instantvnr_torch.data.volume import synthetic_volume
from instantvnr_torch.ops import compaction as ops
from instantvnr_torch.render import compaction as comp
from instantvnr_torch.render import raymarch as rm
from instantvnr_torch.utils.tfn import bake_transfer_function


# -- the schedule functions --------------------------------------------------

COUNTS = (1, 8191, 8192, 8193, 12288, 12289, 20000, 24577, 65535, 65536,
          100000, 196608, 196609, 262143, 262144)


@pytest.mark.parametrize("midpoints", [False, True])
@pytest.mark.parametrize("r", [65536, 262144, 589824 // 3, 1 << 20])
def test_bucket_ladder_equals_jax(monkeypatch, midpoints, r):
    for mod in (comp, jcomp):
        monkeypatch.setattr(mod, "_MIDPOINT_BUCKETS", midpoints)
    for c in COUNTS:
        assert comp._bucket(c, r) == jcomp._bucket(c, r), c
        assert comp._next_bucket(c, r) == jcomp._next_bucket(c, r), c
    assert comp.bucket_sizes(r) == jcomp.bucket_sizes(r)


def test_ladder_at_512_squared():
    """The midpoint ladder at R = 512²: 11 sizes."""
    assert comp.bucket_sizes(512 * 512) == [
        262144, 196608, 131072, 98304, 65536, 49152, 32768, 24576, 16384,
        12288, 8192]
    assert comp._MIN_BUCKET == 8192 and comp._FINISH_BUCKET == 32768


@pytest.mark.parametrize("midpoints", [False, True])
def test_bump_and_strip_equal_jax(monkeypatch, midpoints):
    for mod in (comp, jcomp):
        monkeypatch.setattr(mod, "_MIDPOINT_BUCKETS", midpoints)
    r = 1 << 20
    recorded = [("S", r), ("C", 98304, 90000), ("S", 98304),
                ("C", 12288, 9000), ("S", 12288), ("F", 8192)]
    assert comp.strip_counts(recorded) == jcomp.strip_counts(recorded)
    for ops_ in (comp.strip_counts(recorded),
                 (("C", 98304), ("C", 131072), ("F", 131072)),
                 (("C", 8192), ("S", 8192), ("F", 8192))):
        got = comp.bump_schedule(ops_, r)
        assert got == jcomp.bump_schedule(ops_, r)
        assert comp.bump_schedule(got, r) == jcomp.bump_schedule(got, r)
    assert comp._fusable(recorded) and not comp._fusable(recorded[:-1])


def test_motion_bump_is_one_rung(monkeypatch):
    """Under motion a replayed compaction runs one rung above its recorded
    bucket, as bump_schedule (the fused path) does, also where the count
    sat within the headroom (JAX stacks the two bumps, two rungs: a
    reference fault the port does not copy, ROADMAP Queue 3)."""

    class Frame:
        finish_steps = 0

        def __init__(self):
            self.compactions = []

        def initial(self):
            pass

        def count_handle(self):
            return 10 ** 6

        def superstep(self, m):
            return 10 ** 6

        def finish(self, m, budget):
            pass

        def compact(self, m):
            self.compactions.append(m)

    monkeypatch.setattr(comp, "_MIDPOINT_BUCKETS", True)
    r = 1 << 20
    # the count 98000 sits within the headroom of its bucket 98304
    recorded = [("S", r), ("C", 98304, 98000), ("S", 98304), ("F", 98304)]
    for bump, want in ((False, 131072), (True, 131072)):
        cache = {"ops": list(recorded)}
        frame = Frame()
        comp._replay(r, frame, 192, 1, 1 << 17, 0, cache, defer=True,
                     bump=bump)
        assert cache["pending"][0][1] == want
    assert comp.bump_schedule(comp.strip_counts(recorded), r)[1] == (
        "C", 131072)
    # JAX's _replay of the same record under motion goes two rungs up
    assert jcomp._next_bucket(jcomp._next_bucket(98304, r), r) == 196608


def test_bucket_schedule(monkeypatch):
    """Twin of test_compaction.py::test_bucket_schedule."""
    monkeypatch.setattr(comp, "_MIDPOINT_BUCKETS", False)
    assert comp._bucket(1, 1 << 20) == 8192
    assert comp._bucket(8193, 1 << 20) == 16384
    assert comp._bucket(1 << 20, 1 << 18) == 1 << 18


# -- the kernels' plain versions ----------------------------------------------


def _state(m, seed):
    rng = np.random.default_rng(seed)
    return {"org": rng.uniform(0, 32, (m, 3)).astype(np.float32),
            "dirn": rng.standard_normal((m, 3)).astype(np.float32),
            "t_far": rng.uniform(0, 50, m).astype(np.float32),
            "jitter": rng.random(m).astype(np.float32),
            "t": rng.uniform(0, 9, m).astype(np.float32),
            "alpha": rng.random(m).astype(np.float32),
            "color": rng.random((m, 3)).astype(np.float32),
            "active": rng.random(m) < 0.37,
            "best_pos": rng.random((m, 3)).astype(np.float32),
            "si": rng.integers(0, 9, m).astype(np.int32)}


@pytest.mark.parametrize("prefix", [1 << 16, 40000])
def test_compact_rows_equals_jax_compact_body(prefix):
    """The plain compact_rows on the prefix [0:prefix] of m = 2^16 rows
    against JAX's _compact_body on the same numpy state: every leaf equal
    bit for bit, the rows past the prefix untouched, the count."""
    from collections import namedtuple

    m = 1 << 16
    st = _state(m, 5)
    names = sorted(st)
    perm = np.arange(m, dtype=np.int32)
    jst = namedtuple("State", names)(*(jnp.asarray(st[n]) for n in names))
    _, jout, jperm = jcomp._compact_body(prefix, (), jst, jnp.asarray(perm))
    jstate = jout._asdict()
    leaves = [_t(st[n]) for n in names] + [_t(perm)]
    views = [x[:prefix] for x in leaves]
    scratch = [torch.empty_like(x) for x in views]
    count = torch.zeros(1, dtype=torch.int32)
    order = torch.zeros(prefix, dtype=torch.int32)
    ops.compact_rows(_t(st["active"])[:prefix].contiguous(), views, scratch,
                     count=count, order=order, copy_back=True)
    for n, got in zip(names, leaves):
        np.testing.assert_array_equal(got.numpy(), np.asarray(jstate[n]),
                                      err_msg=n)
    np.testing.assert_array_equal(leaves[-1].numpy(), np.asarray(jperm))
    assert int(count) == int(st["active"][:prefix].sum())
    live = st["active"][:prefix]
    np.testing.assert_array_equal(
        order.numpy(), np.concatenate([np.nonzero(live)[0],
                                       np.nonzero(~live)[0]]))


@pytest.mark.parametrize("rows", [1, 999, 1001])
def test_compact_rows_refuses_a_short_scratch_leaf(rows):
    """A scratch leaf of other than m rows is refused before the device
    dispatch, as on the card: one row is not broadcast, and none of the
    leaves is written."""
    rng = np.random.default_rng(7)
    active = _t(rng.random(1000) < 0.4)
    leaves = [_t(rng.random((1000, 3)).astype(np.float32)),
              _t(rng.integers(0, 9, 1000).astype(np.int32))]
    before = [x.clone() for x in leaves]
    scratch = [torch.zeros((rows, 3)), torch.empty_like(leaves[1])]
    with pytest.raises(ValueError, match="1000 rows"):
        ops.compact_rows(active, leaves, scratch, copy_back=True)
    with pytest.raises(ValueError, match="1000 rows"):
        ops.compact_rows(active, leaves, scratch[:1])
    for got, want in zip(leaves, before):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not scratch[0].any()


def test_scatter_rows_equals_jax_unpermute():
    m = 1 << 16
    rng = np.random.default_rng(2)
    perm = rng.permutation(m).astype(np.int32)
    st = _state(m, 3)
    want = jcomp._unpermute(jnp.asarray(perm), st["color"], st["alpha"],
                            st["t"], st["best_pos"], st["org"])
    leaves = [_t(st[n]) for n in ("color", "alpha", "t", "best_pos", "org")]
    outs = [torch.empty_like(x) for x in leaves]
    ops.scatter_rows(_t(perm), leaves, outs)
    for got, ref in zip(outs, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_count_forms_on_the_cpu():
    """The wrappers' device-side row count on CPU tensors (their plain
    versions): the rows under the count equal the call without one, the
    rows past it are 0; a count is refused under autograd."""
    from instantvnr_torch.config import (EncodingConfig, ModelConfig,
                                         NetworkConfig)
    from instantvnr_torch.models.network import (NeuralField, init_params,
                                                 network_apply_chunked)
    from instantvnr_torch.ops.brick_sample import brick_sample
    from instantvnr_torch.render.brickcache import build_brick_cache_from_grid

    field = NeuralField.from_config(ModelConfig(
        encoding=EncodingConfig(n_levels=2, n_features_per_level=2,
                                log2_hashmap_size=8),
        network=NetworkConfig(n_neurons=16, n_hidden_layers=1),
        compute_dtype="bfloat16"))
    params = init_params(torch.Generator().manual_seed(0), field, "cpu")
    p = torch.rand((1000, 3), generator=torch.Generator().manual_seed(1))
    count = torch.tensor([613], dtype=torch.int32)
    whole = network_apply_chunked(params, p, field, chunk=300)
    part = network_apply_chunked(params, p, field, chunk=300, count=count)
    torch.testing.assert_close(part[:613], whole[:613], rtol=0, atol=0)
    assert not part[613:].any()
    vol = synthetic_volume(DIMS, kind="sphere", device="cpu")
    ttf = bake_transfer_function(TransferFunctionConfig(), device="cpu")
    ctx = build_brick_cache_from_grid(vol.data,
                                      mcmod.build(vol.data, vol.dims, ttf))
    args = (ctx["lut"], ctx["packed"], p, ctx["dims"], ctx["mcdims"])
    whole = brick_sample(*args)
    part = brick_sample(*args, count=count)
    torch.testing.assert_close(part[:613], whole[:613], rtol=0, atol=0)
    assert not part[613:].any()
    params["table"].requires_grad_(True)
    with pytest.raises(ValueError, match="inference only"):
        network_apply_chunked(params, p, field, count=count)


def test_select_rows_is_the_masked_selection():
    """select_rows (the compacted superstep's valid slots) is the masked
    march's nonzero selection, in its order, with the count."""
    rng = np.random.default_rng(4)
    mask = _t(rng.random(5000) < 0.2)
    rows = _t(rng.random((5000, 3)).astype(np.float32))
    out, order, count = ops.select_rows(mask, rows)
    n = int(count)
    idx = torch.nonzero(mask).squeeze(1)
    assert n == idx.numel()
    torch.testing.assert_close(order[:n].long(), idx, rtol=0, atol=0)
    torch.testing.assert_close(out[:n], rows[idx], rtol=0, atol=0)


@pytest.mark.parametrize("k,s", [(4, 2), (8, 3)])
def test_samples_per_slot_emission_equals_jax(scene, k, s):
    """The plain emission with S samples a slot equals JAX's bit for bit."""
    _, _, _, _, jm, tm, _ = scene
    org, dirn, t0, t1, _ = _jax_rays(24)
    jst = jrm.init_ray_state(t0, t1)
    (jt, jce, jss, *_), jtx, jty, jv, *_ = jrm._emit_samples(
        org, dirn, t1, jst, jm, 1.0, k, 8, samples_per_slot=s)
    (tt, tce, tss), ttx, tty, tv = rm._emit_samples(
        _t(org), _t(dirn), _t(t1), rm.init_ray_state(_t(t0), _t(t1)), tm,
        1.0, k, 8, samples_per_slot=s)
    for got, ref in ((tt, jt), (tce, jce), (tss, jss), (ttx, jtx),
                     (tty, jty), (tv, jv)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert ttx.shape == (24 * 24, k * s) and int(tv.sum()) > 100


def test_programs_capture_once_per_key():
    """_Programs runs a key eagerly at its first use (on the CPU always);
    on the card the second use is captured."""
    calls = []
    p = comp._Programs(torch.device("cpu"))
    for _ in range(3):
        p.run(("S", 8), lambda: calls.append(1))
    assert len(calls) == 3 and not p.graphs


def test_finisher_chunks_honor_the_budget():
    """A finisher chunk is cut to the budget left as powers of two."""
    assert comp._chunks(8) == [8]
    assert comp._chunks(7) == [4, 2, 1]
    assert comp._chunks(5) == [4, 1]
    assert sum(comp._chunks(3)) == 3
