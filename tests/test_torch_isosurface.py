"""Isosurface extraction of the port (ops/isosurface.py) against the JAX
package's (instantvnr_tpu/ops/isosurface.py), on the same numpy grids.

Tolerances:
- the plain version's dense emission (tris, valid, ids) against JAX's
  `_extract_slab`: valid and ids exactly, tris within 1e-5 voxel (the
  same float32 operations; XLA may contract a product into its sum);
- extract_isosurface (welded and not) on the sphere and vorts grids: the
  triangle count and the faces exactly, the vertices within 1e-5 voxel;
- extract_isosurface_network: (a) exactly the port's own extraction of its
  own decode, slab for slab; (b) against JAX's network extraction, the mesh
  area and the vertex count within 1% (the bf16 decode of the two packages
  rounds near-iso values apart and moves their crossings);
- save_obj: JAX's file byte for byte.
The kernel (csrc/isosurface.cu) is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py); here its tables are held to
the plain version's.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantvnr_tpu.config import EncodingConfig as JEnc
from instantvnr_tpu.config import ModelConfig as JModelConfig
from instantvnr_tpu.config import NetworkConfig as JNet
from instantvnr_tpu.data.volume import synthetic_volume as j_synthetic
from instantvnr_tpu.models.network import NeuralField as JNeuralField
from instantvnr_tpu.ops import isosurface as jiso
from instantvnr_torch.config import EncodingConfig, ModelConfig, NetworkConfig
from instantvnr_torch.models.metrics import decode_volume
from instantvnr_torch.models.network import (NeuralField, params_from_numpy,
                                             render_params)
from instantvnr_torch.ops import isosurface as iso

VERT_ATOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grid(kind):
    if kind == "checkerboard":  # every cell emits 12 triangles
        z, y, x = np.meshgrid(*(np.arange(24),) * 3, indexing="ij")
        return ((x + y + z) % 2).astype(np.float32)
    return np.array(j_synthetic((24, 24, 24), kind=kind).data)


def test_tables_match_jax():
    np.testing.assert_array_equal(iso._TETS, jiso._TETS)
    np.testing.assert_array_equal(iso._EDGE_PAIRS, jiso._EDGE_PAIRS)
    np.testing.assert_array_equal(iso._CASE_TRIS_PER_TET,
                                  jiso._CASE_TRIS_PER_TET)


def test_kernel_tables_match_plain_version():
    """The kernel's tables (kTets, kEdgePairs, kCaseTris, from which it
    packs its shared-memory form) are the plain version's, and so is the
    compile-time copy of the tets that keeps a cell's corners in registers
    (kTetCorners)."""
    with open(os.path.join(ROOT, "instantvnr_torch", "csrc",
                           "isosurface.cu")) as f:
        src = f.read()

    def table(name):
        body = re.search(name + r"\[[^=]*=\s*(\{.*?\});", src, re.S).group(1)
        return np.array([int(v) for v in re.findall(r"-?\d+", body)])

    np.testing.assert_array_equal(table("kTets"), iso._TETS.ravel())
    np.testing.assert_array_equal(table("kTetCorners"), iso._TETS.ravel())
    np.testing.assert_array_equal(table("kEdgePairs"),
                                  iso._EDGE_PAIRS.ravel())
    np.testing.assert_array_equal(table("kCaseTris"),
                                  iso._CASE_TRIS_PER_TET.ravel())


@pytest.mark.parametrize("kind", ["sphere", "vorts", "checkerboard"])
def test_dense_slab_matches_jax(kind):
    grid = _grid(kind)[5:14]
    isov = float(np.median(grid))
    jt, jv, ji = jiso._extract_slab(jnp.asarray(grid), jnp.float32(isov),
                                    jnp.float32(5))
    tt, tv, ti = iso._extract_slab_reference(torch.from_numpy(grid), isov, 5)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if kind == "checkerboard":
        assert tv.numpy().all()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0,
                               atol=VERT_ATOL)
    # the wrapper on a CPU grid: the masked gather of the same slots
    kt, ki = iso.extract_slab(torch.from_numpy(grid), isov, 5)
    mask = tv.numpy()
    np.testing.assert_array_equal(kt.numpy(), tt.numpy()[mask])
    np.testing.assert_array_equal(ki.numpy(), ti.numpy()[mask])


@pytest.mark.parametrize("kind", ["sphere", "vorts"])
@pytest.mark.parametrize("which", ["low", "median", "outside"])
@pytest.mark.parametrize("weld", [True, False])
def test_extract_isosurface_matches_jax(kind, which, weld):
    grid = _grid(kind)
    isov = {"low": 0.2, "median": float(np.median(grid)),
            "outside": 1.5}[which]
    jv, jf = jiso.extract_isosurface(grid, isov, slab=8, weld=weld)
    tv, tf = iso.extract_isosurface(torch.from_numpy(grid), isov, slab=8,
                                    weld=weld)
    assert tv.dtype == np.float32 and tf.dtype == np.int32
    assert tf.shape == jf.shape and tv.shape == jv.shape
    if which == "outside":
        assert len(tf) == 0
    else:
        assert len(tf) > 100
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=VERT_ATOL)


def test_weld_is_exact_and_closed():
    """The welded sphere is a closed manifold: every edge is shared by two
    faces, and the weld keeps the soup's positions exactly."""
    grid = _grid("sphere")
    v, f = iso.extract_isosurface(torch.from_numpy(grid), 0.3, slab=8)
    sv, sf = iso.extract_isosurface(torch.from_numpy(grid), 0.3, slab=8,
                                    weld=False)
    np.testing.assert_array_equal(v[f], sv[sf])
    edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]],
                                    f[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()
    assert len(v) < len(sv) / 4  # ~T/2 vertices against the soup's 3T


def _mesh_area(v, f):
    t = v[f].astype(np.float64)
    return 0.5 * np.linalg.norm(np.cross(t[:, 1] - t[:, 0],
                                         t[:, 2] - t[:, 0]), axis=1).sum()


def test_network_extraction():
    enc = dict(n_levels=3, n_features_per_level=2, log2_hashmap_size=10,
               base_resolution=4)
    net = dict(n_neurons=16, n_hidden_layers=1)
    jfield = JNeuralField.from_config(JModelConfig(encoding=JEnc(**enc),
                                                   network=JNet(**net)))
    field = NeuralField.from_config(ModelConfig(
        encoding=EncodingConfig(**enc), network=NetworkConfig(**net)))
    rng = np.random.default_rng(7)
    spec = field.spec
    widths = [spec.n_output_dims, 16, 1]
    params_np = {"table": rng.uniform(-1, 1, (spec.n_entries,
                                              spec.n_features)
                                      ).astype(np.float32),
                 "mlp": [(rng.standard_normal((a, b)) * np.sqrt(2.0 / a)
                          ).astype(np.float32)
                         for a, b in zip(widths[:-1], widths[1:])]}
    params = params_from_numpy(params_np, "cpu")
    dims = (20, 18, 22)
    grid = decode_volume(field, render_params(params, field), dims)
    isov = float(grid.median())
    tv, tf = iso.extract_isosurface_network(field, params, dims, isov)
    # (a) the port's own extraction of its own decode
    gv, gf = iso.extract_isosurface(grid, isov, slab=16)
    np.testing.assert_array_equal(tf, gf)
    np.testing.assert_array_equal(tv, gv)
    # (b) JAX's network extraction of the same params
    jp = {"table": jnp.asarray(params_np["table"]),
          "mlp": [jnp.asarray(w) for w in params_np["mlp"]]}
    jv, jf = jiso.extract_isosurface_network(jfield, jp, dims, isov)
    assert len(tf) > 500
    assert abs(len(tv) - len(jv)) <= 0.01 * len(jv)
    assert _mesh_area(tv, tf) == pytest.approx(_mesh_area(jv, jf), rel=0.01)


def test_save_obj_matches_jax_bytes(tmp_path):
    grid = _grid("vorts")
    v, f = iso.extract_isosurface(torch.from_numpy(grid), 0.35, slab=8)
    jv, jf = jiso.extract_isosurface(grid, 0.35, slab=8)
    iso.save_obj(v, f, str(tmp_path / "port.obj"))
    jiso.save_obj(jv, jf, str(tmp_path / "jax.obj"))
    port = (tmp_path / "port.obj").read_bytes()
    assert port == (tmp_path / "jax.obj").read_bytes()
    assert port.count(b"\nf ") == len(f) and len(f) > 0
