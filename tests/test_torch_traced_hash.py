"""The traced hash encode (per-level parameters as data, the tensor-parallel
path's encode) == the JAX package's `hash_encode_traced` and
`hash_encode_traced_splitgrad`, on the same numpy table, coords and
cotangent, at a model shard's level params (offsets rebased into its
padded table).

Tolerances:
- the forward: atol 1e-6 in float32 compute; in bf16 compute equal up to
  one bf16 step of |v| ≤ 1 (atol 1e-2), each side summing the 8
  bf16-rounded corner products in its own order;
- table gradients against jax.grad: rtol 1e-6, atol 1e-6 (float32 sums in
  another order), for both backwards (the traced encode's own: products
  in the compute type; the split-grad's: float32 products), at caps under
  2^17, where JAX accumulates in float32 too;
- at the production batch (B = 2^16) on a shard of the reference 2^19
  schema, whose caps reach 2^19 (JAX accumulates those in float16, this
  port in float32): the split-grad backward against a float64 np.add.at
  oracle at atol 5e-4, rtol 1e-4, as tests/test_ops.py:257.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantvnr_tpu.config import EncodingConfig as JEncodingConfig
from instantvnr_tpu.config import ModelConfig as JModelConfig
from instantvnr_tpu.models.network import NeuralField as JNeuralField
from instantvnr_tpu.ops import hash_encoding as jhe
from instantvnr_tpu.parallel import tp as jtp
from instantvnr_torch.config import EncodingConfig, ModelConfig
from instantvnr_torch.models.network import NeuralField
from instantvnr_torch.ops import hash_encoding as he
from instantvnr_torch.parallel import tp

# 6 levels, dense and hashed, over two shards of 3
SMALL = dict(n_levels=6, n_features_per_level=2, log2_hashmap_size=12,
             base_resolution=4, per_level_scale=1.8)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _fields(**enc):
    return (NeuralField.from_config(ModelConfig(
                encoding=EncodingConfig(**enc))),
            JNeuralField.from_config(JModelConfig(
                encoding=JEncodingConfig(**enc))))


def _shard(field, jfield, shard, n_model=2, seed=0, b=777):
    """A shard's local table (uniform ±1, padded rows zero), its level
    params (port and JAX) and caps, coords and a cotangent."""
    rng = np.random.default_rng(seed + shard)
    spec = field.spec
    lps, e_max = tp.tp_layout(field, n_model)
    lo = spec.level_offsets[shard * lps]
    hi = spec.level_offsets[(shard + 1) * lps]
    table = np.zeros((e_max, spec.n_features), np.float32)
    table[:hi - lo] = rng.uniform(-1, 1, (hi - lo, spec.n_features))
    lp = tp.local_level_params(tp.shard_level_params(field, n_model), shard)
    jlp = jax.tree.map(lambda x: x[shard],
                       jtp.shard_level_params(jfield, n_model))
    coords = rng.random((b, 3), np.float32)
    coords[:4] = [[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 1]]
    g = rng.standard_normal((b, lps * spec.n_features)).astype(np.float32)
    return table, lp, jlp, tp.level_caps(field, n_model), coords, g


def test_level_param_arrays_match_jax():
    field, jfield = _fields(**SMALL)
    lp = he.level_param_arrays(field.spec)
    jlp = jhe.level_param_arrays(jfield.spec)
    assert set(lp) == set(jlp)
    for k in lp:
        np.testing.assert_array_equal(lp[k].numpy(),
                                      np.asarray(jlp[k]).astype(
                                          lp[k].numpy().dtype))


def test_paired_layout_is_refused():
    field, _ = _fields(**SMALL, hash_variant="paired")
    with pytest.raises(ValueError, match="paired"):
        he.level_param_arrays(field.spec)


@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(shard, dtype):
    field, jfield = _fields(**SMALL)
    table, lp, jlp, caps, coords, _ = _shard(field, jfield, shard)
    td, jd = DTYPES[dtype]
    lps, nf = len(caps), field.spec.n_features
    got = he.hash_encode_traced(torch.from_numpy(table),
                                torch.from_numpy(coords), lp, lps, nf, td)
    want = jhe.hash_encode_traced(jnp.asarray(table), jnp.asarray(coords),
                                  jlp, lps, nf, jd)
    split = he.hash_encode_traced_splitgrad(
        torch.from_numpy(table), torch.from_numpy(coords), lp, caps, nf, td)
    torch.testing.assert_close(split, got, rtol=0, atol=0)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=1e-6 if dtype == "float32" else 1e-2,
                               rtol=0)


def test_forward_equals_hash_encode_on_all_levels():
    """At the whole spec's level params the traced encode is hash_encode."""
    field, _ = _fields(**SMALL)
    spec = field.spec
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.uniform(-1, 1, (spec.n_entries,
                                                 spec.n_features)
                                         ).astype(np.float32))
    coords = torch.from_numpy(rng.random((300, 3), np.float32))
    got = he.hash_encode_traced(table, coords, he.level_param_arrays(spec),
                                spec.n_levels, spec.n_features)
    torch.testing.assert_close(got, he.hash_encode(table, coords, spec),
                               rtol=0, atol=0)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_table_grad_matches_jax(split, dtype):
    field, jfield = _fields(**SMALL)
    table, lp, jlp, caps, coords, g = _shard(field, jfield, 1)
    assert max(caps) < 1 << 17  # JAX's split-grad accumulates in f32 here
    td, jd = DTYPES[dtype]
    lps, nf = len(caps), field.spec.n_features
    t = torch.from_numpy(table).requires_grad_()
    if split:
        y = he.hash_encode_traced_splitgrad(t, torch.from_numpy(coords), lp,
                                            caps, nf, td)
    else:
        y = he.hash_encode_traced(t, torch.from_numpy(coords), lp, lps, nf,
                                  td)
    y.backward(torch.from_numpy(g).to(td))

    def loss(tab):
        c = jnp.asarray(coords)
        if split:
            f = jhe.hash_encode_traced_splitgrad(tab, c, jlp, caps, nf, jd)
        else:
            f = jhe.hash_encode_traced(tab, c, jlp, lps, nf, jd)
        return jnp.sum(f.astype(jnp.float32) * jnp.asarray(g).astype(jd)
                       .astype(jnp.float32))

    want = np.asarray(jax.grad(loss)(jnp.asarray(table)))
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-6, atol=1e-6)


def test_splitgrad_equals_traced_grad_in_f32():
    """In float32 compute the two backwards are one function (JAX's
    test_ops.py TestTracedSplitGrad)."""
    field, jfield = _fields(**SMALL)
    table, lp, _, caps, coords, g = _shard(field, jfield, 0)
    grads = []
    for split in (False, True):
        t = torch.from_numpy(table).requires_grad_()
        c = torch.from_numpy(coords)
        y = (he.hash_encode_traced_splitgrad(t, c, lp, caps, 2) if split
             else he.hash_encode_traced(t, c, lp, len(caps), 2))
        y.backward(torch.from_numpy(g))
        grads.append(t.grad.numpy())
    np.testing.assert_allclose(grads[1], grads[0], atol=1e-5, rtol=1e-4)


def test_splitgrad_matches_f64_oracle_at_train_batch():
    """B = 2^16 on shard 1 of the reference 2^19 schema (levels 4-7, caps
    of 2^19 rows): the split-grad backward against float64 np.add.at of
    each corner's weight times the cotangent."""
    field = NeuralField.from_config(ModelConfig())
    spec = field.spec
    lps, e_max = tp.tp_layout(field, 2)
    caps = tp.level_caps(field, 2)
    assert max(caps) >= 1 << 17
    lp = tp.local_level_params(tp.shard_level_params(field, 2), 1)
    b = 1 << 16
    rng = np.random.default_rng(7)
    coords = torch.from_numpy(rng.random((b, 3), np.float32))
    g = torch.from_numpy(rng.standard_normal((b, lps * spec.n_features)
                                             ).astype(np.float32))
    t = torch.zeros((e_max, spec.n_features), requires_grad=True)
    he.hash_encode_traced_splitgrad(t, coords, lp, caps, spec.n_features,
                                    torch.bfloat16).backward(
                                        g.to(torch.bfloat16))
    gb = g.to(torch.bfloat16).double().numpy().reshape(b, lps, -1)
    ref = np.zeros((e_max, spec.n_features))
    for l, row in enumerate(he._level_rows(lp, lps)):
        idx, w = he._traced_level_corners(coords, row)
        np.add.at(ref, (idx + row[2]).reshape(-1).numpy(),
                  (w.double().numpy()[..., None] * gb[:, l, None, :]
                   ).reshape(-1, spec.n_features))
    np.testing.assert_allclose(t.grad.numpy(), ref, atol=5e-4, rtol=1e-4)
