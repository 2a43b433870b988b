"""Native `.npz` checkpoints cross between the packages (the port's
serializer.save_native/load_native against the JAX package's).

- The port's leaf order (serializer.native_leaves) is jax.tree_util's for
  the JAX TrainState, leaf for leaf (shapes, dtypes and values; mu and nu
  hold different values, so a swap would show).
- A JAX file loads in the port, and one host-batch step from it on the same
  numpy batch moves params and both Adam moments as JAX's step does. The
  steps differ only by the gradient: JAX's XLA MLP on the CPU and the
  port's fused MLP round bf16 activations in other places, and a table
  gradient here parts by up to 3.5e-3 of its largest entry (TOL = 1e-2;
  against the Pallas MLP it is 1e-3, tests/test_torch_training.py). So
  with G the largest gradient entry of
  an array: mu = β1·mu + 0.1·g within 0.1·TOL·G, nu = β2·nu + 0.001·g²
  within 0.001·2·TOL·G², and the params within TOL of the learning rate
  (the scale of an Adam step). A swapped mu and nu, or a step count off by
  one, moves them by far more.
- A port file loads in JAX leaf for leaf (exactly), and the port's own
  resume is exact: the same next losses and params bit for bit.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantvnr_tpu import serializer as jser
from instantvnr_tpu.config import EncodingConfig as JEnc
from instantvnr_tpu.config import ModelConfig as JModelConfig
from instantvnr_tpu.config import NetworkConfig as JNet
from instantvnr_tpu.models import trainer as jtrainer
from instantvnr_tpu.models.network import NeuralField as JNeuralField
from instantvnr_tpu.models.optimizer import AdamState as JAdamState
from instantvnr_torch import api
from instantvnr_torch import serializer as ser
from instantvnr_torch.config import EncodingConfig, ModelConfig, NetworkConfig
from instantvnr_torch.models import trainer
from instantvnr_torch.models.network import NeuralField
from instantvnr_torch.ops import trilinear as tri

SCHEMA = dict(encoding=dict(n_levels=2, n_features_per_level=4,
                            log2_hashmap_size=10),
              network=dict(n_neurons=16, n_hidden_layers=2))
DIMS = (16, 16, 16)
# one step from a loaded state: the gradients of the two packages part by
# up to TOL of their largest entry (3.5e-3 measured); see the docstring
TOL = 1e-2
LR = 5e-3  # OptimizerConfig().learning_rate


def _cfgs():
    enc, net = SCHEMA["encoding"], SCHEMA["network"]
    return (JModelConfig(encoding=JEnc(**enc), network=JNet(**net)),
            ModelConfig(encoding=EncodingConfig(**enc),
                        network=NetworkConfig(**net)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_state(step=7, seed=3):
    """A JAX TrainState with distinct random params, mu and nu (nu > 0)."""
    jcfg, _ = _cfgs()
    jfield = JNeuralField.from_config(jcfg)
    st = jtrainer.create_train_state(jax.random.PRNGKey(seed), jfield)
    rng = np.random.default_rng(seed)

    def like(tree, scale, positive=False):
        def one(x):
            a = rng.standard_normal(np.shape(x)).astype(np.float32) * scale
            return jnp.asarray(np.abs(a) if positive else a)
        return jax.tree_util.tree_map(one, tree)

    params = like(st.params, 0.3)
    opt = JAdamState(step=jnp.int32(step), mu=like(st.params, 1e-2),
                     nu=like(st.params, 1e-4, positive=True))
    return jfield, st._replace(params=params, opt=opt,
                               loss=jnp.float32(0.125))


def _batch(seed=9, b=3000):
    rng = np.random.default_rng(seed)
    coords = rng.random((b, 3)).astype(np.float32)
    vol = rng.random((16, 16, 16)).astype(np.float32)
    targets = tri.sample_volume_tex(_t(vol), _t(coords))[:, None].numpy()
    return coords, targets


def _port_state(jstate):
    """The port's TrainState holding the JAX state's arrays."""
    def tree(d):
        return {"table": _t(d["table"]), "mlp": [_t(w) for w in d["mlp"]]}

    from instantvnr_torch.models.optimizer import AdamState

    return trainer.TrainState(
        params=tree(jstate.params),
        opt=AdamState(step=int(jstate.opt.step), mu=tree(jstate.opt.mu),
                      nu=tree(jstate.opt.nu)),
        generator=torch.Generator().manual_seed(0),
        loss=torch.tensor(float(jstate.loss)),
        key=tuple(int(k) for k in np.asarray(jstate.key)))


def test_leaf_order_matches_jax_tree_util():
    _, jstate = _jax_state()
    ref = jax.tree_util.tree_leaves(jstate)
    got = ser.native_leaves(_port_state(jstate))
    # params, mu and nu (a table and 3 matrices each), step, key, loss
    assert len(got) == len(ref) == 3 * 4 + 3
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype, i
        np.testing.assert_array_equal(g, r, err_msg=f"leaf {i}")
    # mu and nu (same shapes) are told apart by their values
    assert not np.array_equal(got[4], got[8])


def test_jax_npz_loads_in_port_and_steps_like_jax(tmp_path):
    jfield, jstate = _jax_state()
    path = str(tmp_path / "jax.npz")
    jser.save_native(path, jfield, jstate, volume_dims=DIMS)
    field, state, dims = ser.load_native(path, device="cpu")
    assert dims == DIMS and state.opt.step == 7
    assert state.key == tuple(int(k) for k in np.asarray(jstate.key))
    for g, r in zip(ser.native_leaves(state),
                    jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(g, np.asarray(r))
    coords, targets = _batch()
    # numpy copies: JAX's step donates the state's buffers
    old = jax.tree_util.tree_map(np.array, (jstate.params, jstate.opt.mu,
                                            jstate.opt.nu))
    jnew = jtrainer.train_step_hostbatch(jfield, jstate, jnp.asarray(coords),
                                         jnp.asarray(targets))
    new = trainer.train_step_hostbatch(field, state, _t(coords),
                                       _t(targets))
    assert new.opt.step == int(jnew.opt.step) == 8
    assert float(new.loss) == pytest.approx(float(jnew.loss), rel=1e-5)
    for leaf in ("table", "mlp"):
        def arrays(tree):
            return tree[leaf] if leaf == "mlp" else [tree[leaf]]

        for i, (p, m, v, jp, jm, jv, op, om) in enumerate(zip(
                *(arrays(t) for t in (new.params, new.opt.mu, new.opt.nu,
                                      jnew.params, jnew.opt.mu, jnew.opt.nu,
                                      old[0], old[1])))):
            jm, jv, jp = np.asarray(jm), np.asarray(jv), np.asarray(jp)
            # the gradient JAX's step folded into mu (β1 = 0.9)
            g = np.abs((jm - 0.9 * om) / 0.1).max()
            assert g > 0 and np.abs(jp - op).max() > 0, (leaf, i)
            for name, got, ref, atol in (
                    ("params", p, jp, TOL * LR),
                    ("mu", m, jm, 0.1 * TOL * g),
                    ("nu", v, jv, 1e-3 * 2 * TOL * g * g)):
                # rtol: the float32 Adam formula rounds in other places
                np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                                           atol=atol,
                                           err_msg=f"{name}.{leaf}[{i}]")


def test_port_npz_loads_in_jax(tmp_path):
    _, cfg = _cfgs()
    sv = api.SimpleVolume.synthetic(DIMS, "vorts", device="cpu")
    nv = api.NeuralVolume(cfg, sv, seed=4, device="cpu", train_batch=2048)
    nv.train(3)
    path = str(tmp_path / "port.npz")
    nv.save_params(path)
    jfield, jstate, dims = jser.load_native(path)
    assert dims == DIMS and int(jstate.opt.step) == 3
    assert jfield.cfg.encoding.n_levels == SCHEMA["encoding"]["n_levels"]
    for g, r in zip(ser.native_leaves(nv.state),
                    jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(g, np.asarray(r))
    assert tuple(np.asarray(jstate.key)) == (0, 4)  # PRNGKey(4)'s words
    # and JAX trains on from it
    coords, targets = _batch()
    jnew = jtrainer.train_step_hostbatch(jfield, jstate, jnp.asarray(coords),
                                         jnp.asarray(targets))
    assert np.isfinite(float(jnew.loss)) and int(jnew.opt.step) == 4


def test_port_resume_is_exact(tmp_path):
    _, cfg = _cfgs()
    sv = api.SimpleVolume.synthetic(DIMS, "vorts", device="cpu")
    nv = api.NeuralVolume(cfg, sv, seed=1, device="cpu", train_batch=2048)
    nv.train(3)
    path = str(tmp_path / "resume.npz")
    nv.save_params(path)
    nv.train(2, fast_mode=True)
    resumed = api.NeuralVolume.from_checkpoint(path, simple=sv, device="cpu")
    resumed.train_batch = 2048
    assert resumed.step == 3
    resumed.train(2, fast_mode=True)
    assert resumed.step == nv.step == 5
    assert resumed.get_training_loss() == nv.get_training_loss()
    for a, b in zip(ser.native_leaves(resumed.state),
                    ser.native_leaves(nv.state)):
        np.testing.assert_array_equal(a, b)
    # set_params(.npz) restores the whole state into a live volume
    other = api.NeuralVolume(cfg, sv, seed=9, device="cpu", train_batch=2048)
    other.set_params(path)
    assert other.step == 3 and other.state.opt.step == 3
    other.train(2, fast_mode=True)
    assert other.get_training_loss() == nv.get_training_loss()


def test_jax_file_seeds_the_generator_from_its_key(tmp_path):
    """A JAX file has no generator state: the port seeds its stream from
    the two key words, so two loads train alike."""
    jfield, jstate = _jax_state()
    path = str(tmp_path / "jax.npz")
    jser.save_native(path, jfield, jstate)
    a = ser.load_native(path, device="cpu")[1]
    b = ser.load_native(path, device="cpu")[1]
    k = tuple(int(x) for x in np.asarray(jstate.key))
    assert a.generator.initial_seed() == (k[0] << 32) | k[1]
    assert torch.equal(torch.rand(4, generator=a.generator),
                       torch.rand(4, generator=b.generator))


def test_fvsrn_document_raises(tmp_path):
    """An fV-SRN document loads the fV-SRN family (tests/
    test_torch_fvsrn.py); one whose leaves are a hash grid's is refused by
    their shapes."""
    import dataclasses

    from instantvnr_tpu.models.fvsrn import FvsrnConfig as JFvsrnConfig

    jfield, jstate = _jax_state()
    path = str(tmp_path / "jax.npz")
    jser.save_native(path, jfield, jstate)
    data = dict(np.load(path))
    data["model_json"] = np.frombuffer(json.dumps(
        {"family": "fvsrn", **dataclasses.asdict(JFvsrnConfig())}).encode(),
        np.uint8)
    bad = str(tmp_path / "fvsrn.npz")
    np.savez(bad, **data)
    with pytest.raises(ValueError, match="leaf 0 shape"):
        ser.load_native(bad, device="cpu")
    assert NeuralField.from_config(_cfgs()[1]).n_params == jfield.n_params
