"""Port's hash-grid encoding == the JAX package's, on the same numpy table
and coords.

- A small spec in float32 compute: atol 1e-6 (same f32 operations, only the
  order of the 8-corner sum may differ).
- The full reference spec (ModelConfig(): 8 levels x 8 features, 2^19 hash
  rows) after render_params — bf16 table plus packed dense levels, the
  layout the decode runs at that size — at B = 4096: atol 1e-2, since each
  side sums the 8 bf16-rounded corner products in bf16 in its own order.
  Levels with res ≥ 128 hash, so this case catches a uint32 wrap fault.
- Corner indices must be equal exactly.
- Table gradients: equal to `jax.grad(hash_encode)` (rtol 1e-6) on a layout
  under 32 MB, in f32 and bf16 compute; against a float64 `np.add.at`
  oracle at B = 2^16 (atol 5e-4, rtol 1e-4, as tests/test_ops.py:257), on
  the 2^19 schema's dense levels and, with the bf16 pre-cast forced on, on
  a small hashed layout, where the JAX reference (which then scatters into
  bf16) lies far from the oracle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantvnr_tpu.config import EncodingConfig as JEncodingConfig
from instantvnr_tpu.config import ModelConfig as JModelConfig
from instantvnr_tpu.models.network import NeuralField as JNeuralField
from instantvnr_tpu.models.network import render_params as j_render_params
from instantvnr_tpu.ops import hash_encoding as jhe
from instantvnr_torch.config import EncodingConfig, ModelConfig
from instantvnr_torch.models.network import NeuralField, render_params
from instantvnr_torch.ops import hash_encoding as he

SMALL = dict(n_levels=5, n_features_per_level=2, log2_hashmap_size=10,
             base_resolution=4, per_level_scale=1.7)


def _coords(rng, b):
    c = rng.random((b, 3)).astype(np.float32)
    c[:4] = [[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 1]]  # edge cells
    return c


def test_spec_layout_matches():
    for kw in (SMALL, {}):
        js = jhe.HashGridSpec.from_config(JEncodingConfig(**kw))
        ts = he.HashGridSpec.from_config(EncodingConfig(**kw))
        for name in ("scales", "resolutions", "level_sizes", "level_offsets",
                     "level_is_dense", "n_params"):
            assert getattr(js, name) == getattr(ts, name), name


@pytest.mark.parametrize("kw", [SMALL, {}], ids=["small", "reference"])
def test_corner_indices_equal(kw):
    rng = np.random.default_rng(0)
    coords = _coords(rng, 2048)
    js = jhe.HashGridSpec.from_config(JEncodingConfig(**kw))
    ts = he.HashGridSpec.from_config(EncodingConfig(**kw))
    ji, jw = jhe.corner_indices_and_weights(js, jnp.asarray(coords))
    ti, tw = he.corner_indices_and_weights(ts, torch.from_numpy(coords))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji).astype(np.int64))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_small_spec_f32():
    rng = np.random.default_rng(1)
    spec_kw = SMALL
    js = jhe.HashGridSpec.from_config(JEncodingConfig(**spec_kw))
    ts = he.HashGridSpec.from_config(EncodingConfig(**spec_kw))
    table = rng.uniform(-1, 1, (ts.n_entries, ts.n_features)).astype(np.float32)
    coords = _coords(rng, 4096)
    ref = np.asarray(jhe.hash_encode(jnp.asarray(table), jnp.asarray(coords),
                                     js, compute_dtype=jnp.float32))
    got = he.hash_encode(torch.from_numpy(table), torch.from_numpy(coords),
                         ts, compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    packed = he.packed_dense_tables(torch.from_numpy(table), ts)
    jpacked = jhe.packed_dense_tables(jnp.asarray(table), js)
    assert sorted(packed) == sorted(jpacked) and packed
    for k in packed:
        np.testing.assert_array_equal(packed[k].numpy(),
                                      np.asarray(jpacked[k]))
    got_p = he.hash_encode_packed(torch.from_numpy(table), packed,
                                  torch.from_numpy(coords), ts,
                                  compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got_p, ref, atol=1e-6, rtol=0)


def test_reference_spec_render_params_bf16_packed():
    rng = np.random.default_rng(2)
    jfield = JNeuralField.from_config(JModelConfig())
    field = NeuralField.from_config(ModelConfig())
    spec = field.spec
    assert spec.n_entries == 2_920_448 and spec.level_is_dense[:4] == (
        True, True, True, False)
    table = rng.uniform(-1, 1, (spec.n_entries, spec.n_features)).astype(
        np.float32)
    mlp = [np.zeros((64, 64), np.float32)] * 4 + [np.zeros((64, 1),
                                                           np.float32)]
    jp = j_render_params({"table": jnp.asarray(table),
                          "mlp": [jnp.asarray(w) for w in mlp]}, jfield)
    tp = render_params({"table": torch.from_numpy(table),
                        "mlp": [torch.from_numpy(w) for w in mlp]}, field)
    # the same big-schema branch: bf16 table + packed dense levels 0-2
    assert tp["table"].dtype == torch.bfloat16
    assert sorted(tp["packed"]) == sorted(jp["packed"]) == ["0", "1", "2"]
    coords = _coords(rng, 4096)
    ref = np.asarray(jhe.hash_encode_packed(
        jp["table"], jp["packed"], jnp.asarray(coords), jfield.spec,
        compute_dtype=jnp.bfloat16).astype(jnp.float32))
    got = he.hash_encode_packed(tp["table"], tp["packed"],
                                torch.from_numpy(coords), spec,
                                compute_dtype=torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=0)
    # and the plain (unpacked) encode of the same bf16 table agrees
    plain = he.hash_encode(tp["table"], torch.from_numpy(coords), spec,
                           compute_dtype=torch.bfloat16).float().numpy()
    np.testing.assert_allclose(plain, ref, atol=1e-2, rtol=0)


def _oracle(spec, coords, g, compute_dtype):
    """float64 np.add.at of each corner weight (rounded to the compute
    type) times the cotangent row, the product rounded to the compute type
    as the forward's product is."""
    b, nl, nf = coords.shape[0], spec.n_levels, spec.n_features
    idx, w = he.corner_indices_and_weights(spec, torch.from_numpy(coords))
    wc = w.to(compute_dtype).reshape(b, nl, 8, 1)
    gc = torch.from_numpy(g).to(compute_dtype).reshape(b, nl, 1, nf)
    contrib = (gc * wc).double().reshape(-1, nf).numpy()
    ref = np.zeros((spec.n_entries, nf))
    np.add.at(ref, idx.reshape(-1).numpy(), contrib)
    return ref


def _port_grad(spec, table, coords, g, compute_dtype):
    t = torch.from_numpy(table).requires_grad_()
    out = he.hash_encode(t, torch.from_numpy(coords), spec,
                         compute_dtype=compute_dtype)
    out.backward(torch.from_numpy(g).to(compute_dtype))
    assert t.grad.dtype == torch.float32
    return t.grad.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_table_grad_matches_jax(dtype):
    rng = np.random.default_rng(3)
    js = jhe.HashGridSpec.from_config(JEncodingConfig(**SMALL))
    ts = he.HashGridSpec.from_config(EncodingConfig(**SMALL))
    assert ts.n_entries * ts.n_features * 4 < he._PRECAST_MIN_BYTES
    table = rng.uniform(-1, 1, (ts.n_entries, ts.n_features)).astype(
        np.float32)
    coords = _coords(rng, 4096)
    g = rng.standard_normal((4096, ts.n_output_dims)).astype(np.float32)
    g = torch.from_numpy(g).to(getattr(torch, dtype)).float().numpy()
    jd = getattr(jnp, dtype)
    ref = jax.grad(lambda t: jnp.sum(jhe.hash_encode(
        t, jnp.asarray(coords), js, compute_dtype=jd).astype(jnp.float32)
        * g))(jnp.asarray(table))
    got = _port_grad(ts, table, coords, g, getattr(torch, dtype))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_dense_grads_match_f64_oracle_at_train_batch():
    """The reference schema's dense levels (res 16/32/64) at B = 2^16."""
    spec = he.HashGridSpec.from_config(EncodingConfig(
        n_levels=3, n_features_per_level=2, log2_hashmap_size=19,
        base_resolution=16, per_level_scale=2.0))
    assert spec.resolutions == (16, 32, 64) and all(spec.level_is_dense)
    rng = np.random.default_rng(4)
    b = 1 << 16
    coords = rng.random((b, 3)).astype(np.float32)
    g = rng.standard_normal((b, spec.n_output_dims)).astype(np.float32)
    table = np.zeros((spec.n_entries, 2), np.float32)
    got = _port_grad(spec, table, coords, g, torch.float32)
    np.testing.assert_allclose(got, _oracle(spec, coords, g, torch.float32),
                               atol=5e-4, rtol=1e-4)


def test_plain_backward_stays_f32_under_precast(monkeypatch):
    """With the bf16 pre-cast on (forced for a small table), the port still
    sums the table gradient in float32; the JAX reference's autodiff
    scatters into the pre-cast bf16 table and misses the oracle by ~9 on
    entries of up to ~57 (ROADMAP Queue 3)."""
    kw = dict(n_levels=2, n_features_per_level=2, log2_hashmap_size=8,
              base_resolution=4)
    js = jhe.HashGridSpec.from_config(JEncodingConfig(**kw))
    ts = he.HashGridSpec.from_config(EncodingConfig(**kw))
    monkeypatch.setattr(he, "_PRECAST_MIN_BYTES", 0)
    monkeypatch.setattr(jhe, "_PRECAST_MIN_BYTES", 0)
    rng = np.random.default_rng(5)
    b = 1 << 16
    table = rng.uniform(-1, 1, (ts.n_entries, 2)).astype(np.float32)
    coords = rng.random((b, 3)).astype(np.float32)
    g = torch.from_numpy(rng.standard_normal((b, ts.n_output_dims)).astype(
        np.float32)).to(torch.bfloat16).float().numpy()
    ref = _oracle(ts, coords, g, torch.bfloat16)
    got = _port_grad(ts, table, coords, g, torch.bfloat16)
    np.testing.assert_allclose(got, ref, atol=5e-4, rtol=1e-4)
    j_got = np.asarray(jax.grad(lambda t: jnp.sum(jhe.hash_encode(
        t, jnp.asarray(coords), js, compute_dtype=jnp.bfloat16).astype(
        jnp.float32) * g))(jnp.asarray(table)))
    j_err = np.abs(j_got - ref).max()
    assert j_err > 1.0 and j_err > 0.05 * np.abs(ref).max()


def test_coords_grad_is_refused():
    ts = he.HashGridSpec.from_config(EncodingConfig(**SMALL))
    table = torch.zeros((ts.n_entries, ts.n_features))
    coords = torch.rand((8, 3), requires_grad=True)
    with pytest.raises(NotImplementedError, match="coordinates"):
        he.hash_encode(table, coords, ts)
