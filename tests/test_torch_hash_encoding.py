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
"""
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
