"""The hash encoding's gradient with respect to its coordinates (tcnn's
`kernel_grid_backward_input`) against the JAX package's, on the same numpy
table, coords and cotangent: `jax.grad` of `hash_encode` (tcnn and paired
layouts), of `hash_encode_traced`, and the split-grad form's zero.

The coords hold the grid's corners and faces (1.0 puts a dense level's
upper corners on its `% size` wrap) and samples exactly on a level's
lattice point (x = p·scale + 0.5 an integer, so frac = 0 and floor picks
the cell), where every implementation must take the same one-sided
derivative.

Tolerances, each of the largest entry of the reference:
- float32 compute: 1e-4 (float32 sums in another order);
- bf16 compute: 2e-2. Both sides round the table's rows and the cotangent
  to bf16; JAX's autodiff also rounds each product of a row and its
  cotangent, and their sum, to bf16, which the port keeps in float32
  (ops/hash_encoding.py::_plain_coords_backward);
- the plain backward against a float64 oracle at B = 2^16 on the
  reference schema (8 levels × 8 features, 2^19): 1e-5, the float32
  roundings of 64 corner terms a sample.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantvnr_tpu.config import EncodingConfig as JEncodingConfig
from instantvnr_tpu.ops import hash_encoding as jhe
from instantvnr_torch.config import EncodingConfig
from instantvnr_torch.ops import hash_encoding as he

# dense and hashed levels
SMALL = dict(n_levels=5, n_features_per_level=2, log2_hashmap_size=10,
             base_resolution=4, per_level_scale=1.7)
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-4),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _specs(variant="tcnn", **kw):
    kw = {**SMALL, **kw, "hash_variant": variant}
    return (he.HashGridSpec.from_config(EncodingConfig(**kw)),
            jhe.HashGridSpec.from_config(JEncodingConfig(**kw)))


def _lattice_coords(spec, n_per_level=8):
    """float32 coords with one axis exactly on a lattice point of each
    level: p·scale rounds to k + 0.5 in float32, so x = k + 1."""
    out = []
    rng = np.random.default_rng(11)
    for scale in spec.scales:
        s = np.float32(scale)
        found = 0
        while found < n_per_level:
            kk = np.float32(int(rng.integers(0, max(int(s), 1))) + 0.5)
            # the float32 values around (k + 0.5)/s: the product's step
            # can pass over k + 0.5, then another k is drawn
            p0 = np.float32(kk / s)
            cand = p0 + np.arange(-64, 65, dtype=np.float32) * np.spacing(p0)
            hit = cand[cand * s == kk]
            if not hit.size:
                continue
            assert hit[0] * s + np.float32(0.5) == kk + 0.5
            c = rng.random(3).astype(np.float32)
            c[found % 3] = hit[0]
            out.append(c)
            found += 1
    return np.stack(out)


def _coords(spec, b, seed):
    rng = np.random.default_rng(seed)
    c = rng.random((b, 3)).astype(np.float32)
    c[:4] = [[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 1]]
    lat = _lattice_coords(spec)
    c[4:4 + len(lat)] = lat
    return c


def _inputs(spec, b=2048, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (spec.n_entries, spec.n_features)).astype(
        np.float32)
    g = rng.standard_normal((b, spec.n_output_dims)).astype(np.float32)
    return table, _coords(spec, b, seed + 1), g


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _port_grads(encode, table, coords, g, table_grad=False):
    """(coords' gradient, table's or None) of sum(encode(t, c) · g)."""
    t = torch.from_numpy(table).requires_grad_(table_grad)
    c = torch.from_numpy(coords).requires_grad_(True)
    (encode(t, c).float() * torch.from_numpy(g)).sum().backward()
    return c.grad.numpy(), (t.grad.numpy() if table_grad else None)


@pytest.mark.parametrize("variant", ["tcnn", "paired"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("table_grad", [False, True])
def test_coords_grad_matches_jax(variant, dtype, table_grad):
    """hash_encode (paired: hash_encode_paired, as JAX's hash_encode routes
    it) differentiated in its coords, alone or with the table."""
    tdt, jdt, tol = DTYPES[dtype]
    ts, js = _specs(variant)
    table, coords, g = _inputs(ts, seed=3)
    jc, jt = jax.grad(lambda c, t: jnp.sum(jhe.hash_encode(
        t, c, js, compute_dtype=jdt).astype(jnp.float32) * g),
        argnums=(0, 1))(jnp.asarray(coords), jnp.asarray(table))
    got_c, got_t = _port_grads(lambda t, c: he.hash_encode(t, c, ts, tdt),
                               table, coords, g, table_grad)
    assert np.isfinite(got_c).all() and np.abs(got_c).max() > 1.0
    assert _rel(got_c, np.asarray(jc)) < tol
    if table_grad:  # the table's gradient is unchanged by the coords'
        assert _rel(got_t, np.asarray(jt)) < 1e-6


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_traced_coords_grad_matches_jax(dtype):
    """hash_encode_traced, its level parameters as data."""
    tdt, jdt, tol = DTYPES[dtype]
    ts, js = _specs()
    table, coords, g = _inputs(ts, seed=5)
    jlp = jhe.level_param_arrays(js)
    jc = jax.grad(lambda c: jnp.sum(jhe.hash_encode_traced(
        jnp.asarray(table), c, jlp, ts.n_levels, ts.n_features,
        compute_dtype=jdt).astype(jnp.float32) * g))(jnp.asarray(coords))
    lp = he.level_param_arrays(ts)
    got, _ = _port_grads(lambda t, c: he.hash_encode_traced(
        t, c, lp, ts.n_levels, ts.n_features, tdt), table, coords, g)
    assert _rel(got, np.asarray(jc)) < tol
    whole, _ = _port_grads(lambda t, c: he.hash_encode(t, c, ts, tdt),
                           table, coords, g)
    np.testing.assert_allclose(got, whole, rtol=0,
                               atol=1e-6 * np.abs(whole).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_splitgrad_coords_grad_is_true_where_jax_gives_zero(dtype):
    """JAX's split-grad custom_vjp returns None for the coords
    (instantvnr_tpu/ops/hash_encoding.py:325-326), so jax.grad gives an
    exact zero there: a reference fault (ROADMAP Queue 3). The port gives
    the true gradient, the plain traced encode's, which JAX's own plain
    traced encode agrees with."""
    tdt, jdt, tol = DTYPES[dtype]
    ts, js = _specs()
    table, coords, g = _inputs(ts, seed=7)
    caps = tuple(ts.level_sizes)
    jlp = jhe.level_param_arrays(js)
    jzero = jax.grad(lambda c: jnp.sum(jhe.hash_encode_traced_splitgrad(
        jnp.asarray(table), c, jlp, caps, ts.n_features,
        compute_dtype=jdt).astype(jnp.float32) * g))(jnp.asarray(coords))
    assert not np.asarray(jzero).any()
    jtrue = jax.grad(lambda c: jnp.sum(jhe.hash_encode_traced(
        jnp.asarray(table), c, jlp, ts.n_levels, ts.n_features,
        compute_dtype=jdt).astype(jnp.float32) * g))(jnp.asarray(coords))
    lp = he.level_param_arrays(ts)
    got, _ = _port_grads(lambda t, c: he.hash_encode_traced_splitgrad(
        t, c, lp, caps, ts.n_features, tdt), table, coords, g)
    assert np.abs(got).max() > 1.0
    assert _rel(got, np.asarray(jtrue)) < tol


def _oracle(spec, table, coords, g, compute):
    """float64 coordinate gradient from the corners' indices (held to
    JAX's in tests/test_torch_hash_encoding.py and
    tests/test_torch_paired_hash.py): the rows and the cotangent rounded to
    the compute type, the rest in float64."""
    b, nl, nf = coords.shape[0], spec.n_levels, spec.n_features

    def rnd(a):
        return torch.from_numpy(a).to(compute).double().numpy()

    idx = he._corners(spec, torch.from_numpy(coords))[0].numpy()
    idx = idx.reshape(b, nl, 8)
    gl = rnd(g).reshape(b, nl, nf)
    out = np.zeros((b, 3))
    for lvl in range(nl):
        s = np.float32(spec.scales[lvl])
        x = coords * s + np.float32(0.5)
        frac = (x - np.floor(x)).astype(np.float64)  # exact in float32
        dw = np.einsum("bcf,bf->bc", rnd(table[idx[:, lvl]]), gl[:, lvl])
        a = lvl % 3
        for c in range(8):
            if spec.paired and not spec.level_is_dense[lvl]:
                # corner 2·j + half: half along the pairing axis a, j's
                # bits along the axes after it
                side = {a: c & 1, (a + 1) % 3: (c >> 1) & 1,
                        (a + 2) % 3: c >> 2}
            else:
                side = {0: c & 1, 1: (c >> 1) & 1, 2: c >> 2}
            w = [frac[:, k] if side[k] else 1.0 - frac[:, k]
                 for k in range(3)]
            for k in range(3):
                o = [w[m] for m in range(3) if m != k]
                sign = 1.0 if side[k] else -1.0
                out[:, k] += float(s) * dw[:, c] * sign * o[0] * o[1]
    return out


@pytest.mark.parametrize("variant", ["tcnn", "paired"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_coords_backward_meets_f64_oracle_at_b65536(variant, dtype):
    """The plain backward (the kernel's reference) on the reference schema
    (ModelConfig(): 8 levels × 8 features, 2^19) at the training batch."""
    tdt = DTYPES[dtype][0]
    spec = he.HashGridSpec.from_config(EncodingConfig(hash_variant=variant))
    b = 1 << 16
    table, coords, g = _inputs(spec, b=b, seed=9)
    got = he._plain_coords_backward(torch.from_numpy(table),
                                    torch.from_numpy(coords), spec,
                                    torch.from_numpy(g), tdt).numpy()
    ref = _oracle(spec, table, coords, g, tdt)
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_count_form_refuses_coords_grad():
    """The device-side count form is for inference only: coords that
    require grad are refused, as a table that does."""
    ts, _ = _specs()
    table, coords, _ = _inputs(ts, b=64)
    c = torch.from_numpy(coords).requires_grad_(True)
    with pytest.raises(ValueError, match="inference only"):
        he.hash_encode(torch.from_numpy(table), c, ts,
                       count=torch.tensor([10], dtype=torch.int32))
