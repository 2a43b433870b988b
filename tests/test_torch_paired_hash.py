"""The paired hash layout (EncodingConfig.hash_variant="paired") against the
JAX package's, on the CPU (ROADMAP Queue 1 item 5; JAX
tests/test_paired_hash.py).

Tolerances:
- addressing (`_dense_level_corners`, `_paired_level_rows`,
  `paired_rows_and_weights`, `paired_corner_indices_and_weights`): equal
  bit for bit, indices and weights (the same float32 and uint32
  operations in the same order);
- the forward forms in float32 compute: atol 1e-6 (the order of the 8-
  corner sum); the narrow against the wide form: atol 1e-5, as JAX holds
  its two;
- the table's gradient: rtol 1e-6 of jax.grad of JAX's
  `hash_encode_paired`, and, at the training batch B = 2^16, atol 5e-4,
  rtol 1e-4 against a float64 np.add.at oracle (the ROADMAP rule, as
  tests/test_torch_hash_encoding.py holds the tcnn layout);
- training: JAX's PSNR band of its paired test (> 40 dB and within
  1.5 dB of the tcnn layout) at a cut of its config (`_train_psnr`);
- a native .npz crossing the packages: the decode's tolerance, atol
  2e-2 and mean 1e-3 (tests/test_torch_fused_mlp.py: the two packages'
  bf16 MLPs round activations in other places; the model document holds
  no compute type, so both load bf16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantvnr_tpu import serializer as jser
from instantvnr_tpu.config import EncodingConfig as JEnc
from instantvnr_tpu.config import ModelConfig as JModelConfig
from instantvnr_tpu.config import NetworkConfig as JNet
from instantvnr_tpu.models.metrics import decode_volume as j_decode
from instantvnr_tpu.models.network import NeuralField as JNeuralField
from instantvnr_tpu.models.trainer import create_train_state as j_create
from instantvnr_tpu.ops import hash_encoding as jhe
from instantvnr_torch import api, serializer
from instantvnr_torch.config import EncodingConfig, ModelConfig, NetworkConfig
from instantvnr_torch.models.metrics import decode_volume
from instantvnr_torch.models.network import render_params
from instantvnr_torch.ops import hash_encoding as he

# levels 0-1 dense, 2-3 hashed (JAX's fixture); the reference schema's
# levels of res ≥ 128 catch a uint32 wrap fault
SMALL = dict(n_levels=4, n_features=4, log2_hashmap_size=10,
             base_resolution=4, per_level_scale=2.0)
REFERENCE = dict(n_levels=8, n_features=8, log2_hashmap_size=19,
                 base_resolution=16, per_level_scale=2.0)


def _specs(kw):
    return (jhe.HashGridSpec(paired=True, **kw),
            he.HashGridSpec(paired=True, **kw))


def _coords(b, seed=1):
    c = np.random.default_rng(seed).random((b, 3)).astype(np.float32)
    c[:4] = [[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 1]]  # edge cells
    return c


def _table(spec, seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, (spec.n_entries, spec.n_features)).astype(np.float32)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("kw", [SMALL, REFERENCE], ids=["small", "reference"])
def test_addressing_matches_jax(kw):
    js, ts = _specs(kw)
    c = _coords(2048)
    jc, tc = jnp.asarray(c), torch.from_numpy(c)
    for lvl in range(ts.n_levels):
        jcell, jfrac = jhe._level_cell_frac(js, lvl, jc)
        tcell, tfrac = he._level_cell_frac(ts, lvl, tc)
        np.testing.assert_array_equal(_np(tcell), _np(jcell))
        np.testing.assert_array_equal(_np(tfrac), _np(jfrac))
        if ts.level_is_dense[lvl]:
            got, want = (he._dense_level_corners(ts, lvl, tc),
                         jhe._dense_level_corners(js, lvl, jc))
        else:
            got, want = (he._paired_level_rows(ts, lvl, tc),
                         jhe._paired_level_rows(js, lvl, jc))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), _np(w))
    rows, w2, counts = he.paired_rows_and_weights(ts, tc)
    jrows, jw2, jcounts = jhe.paired_rows_and_weights(js, jc)
    assert counts == jcounts
    np.testing.assert_array_equal(_np(rows), _np(jrows))
    np.testing.assert_array_equal(_np(w2), _np(jw2))
    idx, w = he.paired_corner_indices_and_weights(ts, tc)
    jidx, jw = jhe.paired_corner_indices_and_weights(js, jc)
    np.testing.assert_array_equal(_np(idx), _np(jidx))
    np.testing.assert_array_equal(_np(w), _np(jw))
    assert not he.HashGridSpec(**kw).paired
    with pytest.raises(ValueError, match="paired"):
        he.corner_indices_and_weights(ts, tc)


@pytest.mark.parametrize("form", ["narrow", "wide", "packed", "dispatch"])
def test_forward_forms_match_jax(form):
    js, ts = _specs(SMALL)
    table, c = _table(ts), _coords(4096)
    jt, jc = jnp.asarray(table), jnp.asarray(c)
    tt, tc = torch.from_numpy(table), torch.from_numpy(c)
    want = np.asarray(jhe.hash_encode_paired(jt, jc, js))
    if form == "narrow":
        got = he.hash_encode_paired(tt, tc, ts)
    elif form == "wide":
        got = he.hash_encode_paired_wide(tt, tc, ts)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jhe.hash_encode_paired_wide(jt, jc, js)),
            atol=1e-6, rtol=0)
    elif form == "packed":
        packed = he.packed_dense_tables(tt, ts)
        jpacked = jhe.packed_dense_tables(jt, js)
        assert sorted(packed) == sorted(jpacked) == ["0", "1"]
        got = he.hash_encode_packed(tt, packed, tc, ts)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jhe.hash_encode_packed(jt, jpacked, jc,
                                                           js)),
            atol=1e-6, rtol=0)
    else:  # hash_encode dispatches on spec.paired
        got = he.hash_encode(tt, tc, ts)
        np.testing.assert_array_equal(
            got.numpy(), he.hash_encode_paired(tt, tc, ts).numpy())
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 if form != "narrow" else 1e-6,
                               rtol=0)
    # the paired layout is another function of the table than tcnn's
    tcnn = he.hash_encode(tt, tc, he.HashGridSpec(**SMALL)).numpy()
    assert np.abs(tcnn - want).max() > 0.1


def test_narrow_equals_wide_and_row_budget():
    _, ts = _specs(SMALL)
    table, c = torch.from_numpy(_table(ts)), torch.from_numpy(_coords(512))
    np.testing.assert_allclose(he.hash_encode_paired(table, c, ts).numpy(),
                               he.hash_encode_paired_wide(table, c,
                                                          ts).numpy(),
                               atol=1e-5, rtol=0)
    rows, w2, counts = he.paired_rows_and_weights(ts, c)
    assert counts == (8, 8, 4, 4) and rows.shape == (512, 24)
    start = 0
    for n in counts:  # each level's weights are a partition of unity
        np.testing.assert_allclose(w2[:, start:start + n].sum(dim=(1, 2)),
                                   1.0, atol=1e-5)
        start += n


def test_dense_levels_match_tcnn_layout():
    kw = dict(SMALL, n_levels=2, log2_hashmap_size=14)
    tcnn, paired = he.HashGridSpec(**kw), he.HashGridSpec(paired=True, **kw)
    assert all(paired.level_is_dense)
    table, c = torch.from_numpy(_table(tcnn, 3)), torch.from_numpy(
        _coords(512))
    np.testing.assert_array_equal(he.hash_encode(table, c, tcnn).numpy(),
                                  he.hash_encode(table, c, paired).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_table_grad_matches_jax(dtype):
    js, ts = _specs(SMALL)
    table, c = _table(ts), _coords(2048)
    g = np.random.default_rng(4).standard_normal(
        (2048, ts.n_output_dims)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)

    def jloss(t):
        return jnp.sum(jhe.hash_encode_paired(t, jnp.asarray(c), js, jd)
                       .astype(jnp.float32) * g)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    he.hash_encode(t, torch.from_numpy(c), ts, td).backward(
        torch.from_numpy(g).to(td))
    np.testing.assert_allclose(t.grad.numpy(), want,
                               rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_backward_matches_f64_oracle_at_train_batch():
    """B = 2^16 on the reference schema's paired layout."""
    _, ts = _specs(REFERENCE)
    b = 1 << 16
    c = _coords(b, seed=7)
    g = np.random.default_rng(8).standard_normal(
        (b, ts.n_output_dims)).astype(np.float32)
    idx, w = he.paired_corner_indices_and_weights(ts, torch.from_numpy(c))
    contrib = (torch.from_numpy(g).reshape(b, ts.n_levels, 1, ts.n_features)
               * w.reshape(b, ts.n_levels, 8, 1)).double()
    ref = np.zeros((ts.n_entries, ts.n_features))
    np.add.at(ref, idx.reshape(-1).numpy(),
              contrib.reshape(-1, ts.n_features).numpy())
    t = torch.zeros((ts.n_entries, ts.n_features), requires_grad=True)
    he.hash_encode(t, torch.from_numpy(c), ts).backward(torch.from_numpy(g))
    np.testing.assert_allclose(t.grad.numpy(), ref, atol=5e-4, rtol=1e-4)
    assert np.abs(ref).max() > 1.0


def _train_psnr(variant, steps=150):
    """JAX's tests/test_paired_hash.py::TestPairedTraining config (vorts,
    6 levels × 4 features, cap 2^16, base 4) cut so that it takes seconds
    on the CPU: vorts 48³ of its 64³, MLP 32 × 2 of its 64 × 4, 150 of its
    300 steps, B = 4096 of its 16384 (44.6-45.2 dB in either layout)."""
    cfg = ModelConfig(
        encoding=EncodingConfig(n_levels=6, n_features_per_level=4,
                                log2_hashmap_size=16, base_resolution=4,
                                hash_variant=variant),
        network=NetworkConfig(n_neurons=32, n_hidden_layers=2))
    simple = api.SimpleVolume.synthetic((48,) * 3, "vorts", device="cpu")
    nv = api.NeuralVolume(cfg, simple, device="cpu", train_batch=4096)
    nv.train(steps, fast_mode=True)
    return nv.get_psnr()


def test_paired_training_in_jax_psnr_band():
    # a few threads: the suite runs one process a core
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        p_tcnn, p_paired = _train_psnr("tcnn"), _train_psnr("paired")
    finally:
        torch.set_num_threads(threads)
    assert p_paired > 40.0, p_paired
    assert p_paired > p_tcnn - 1.5, (p_paired, p_tcnn)


def _cfgs():
    enc = dict(n_levels=4, n_features_per_level=4, log2_hashmap_size=10,
               base_resolution=4, hash_variant="paired")
    net = dict(n_neurons=16, n_hidden_layers=2)
    return (JModelConfig(encoding=JEnc(**enc), network=JNet(**net)),
            ModelConfig(encoding=EncodingConfig(**enc),
                        network=NetworkConfig(**net)))


def _close_decodes(got, want):
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    assert np.abs(got - want).mean() <= 1e-3


def test_npz_crosses_the_packages(tmp_path):
    """A paired model's native .npz loads in both packages and decodes to
    the same grid; BSON is refused (no tcnn layout holds it)."""
    jcfg, tcfg = _cfgs()
    dims = (12, 10, 8)
    simple = api.SimpleVolume.synthetic((16,) * 3, "sphere", device="cpu")
    nv = api.NeuralVolume(tcfg, simple, device="cpu", train_batch=2048)
    nv.train(20, fast_mode=True)
    port_npz = str(tmp_path / "port.npz")
    nv.save_params(port_npz)
    with pytest.raises(ValueError, match="paired"):
        nv.save_params(str(tmp_path / "p.bson"))
    jfield, jstate, jdims = jser.load_native(port_npz)
    assert jfield.spec.paired and jdims == (16, 16, 16)
    want = decode_volume(nv.field, render_params(nv.params, nv.field),
                         dims).numpy()
    _close_decodes(np.asarray(j_decode(jfield, jstate.params, dims)), want)
    # and the JAX package's file in the port
    jfield = JNeuralField.from_config(jcfg)
    jstate = j_create(jax.random.PRNGKey(3), jfield)
    jstate = jstate._replace(params=dict(jstate.params, table=jstate.params[
        "table"] + 0.3 * jax.random.normal(jax.random.PRNGKey(4),
                                           jstate.params["table"].shape)))
    jax_npz = str(tmp_path / "jax.npz")
    jser.save_native(jax_npz, jfield, jstate, volume_dims=dims)
    loaded = api.NeuralVolume.from_checkpoint(jax_npz, device="cpu")
    assert loaded.field.spec.paired and loaded.dims == dims
    _close_decodes(loaded.decode_volume().numpy(),
                   np.asarray(j_decode(jfield, jstate.params, dims)))
    assert dataclasses.asdict(loaded.cfg)["encoding"]["hash_variant"] == \
        "paired"
    assert serializer.load_native(jax_npz, device="cpu")[0].spec.paired
