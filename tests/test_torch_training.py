"""The training slice of the port == the JAX package, on the same numpy
inputs (torch's generators cannot reproduce JAX's threefry bits, so no
test compares a seed).

Tolerances:
- trilinear sampling, grid coords, the macrocell update: exact or atol
  1e-6 (the same float32 operations);
- Adam: rtol 1e-6 (the same float32 formula; pow may differ in an ulp);
- losses and their gradients: rtol 1e-6;
- SSIM: atol 1e-5 against JAX (separable means in another order) and
  against a float64 brute-force oracle;
- one host-batch step's gradients against JAX's `hash_encode` composed
  with the Pallas fused MLP (interpret mode, `custom_vjp` backward): the
  loss at rtol 1e-5, every gradient within 1e-3 of its largest entry, since
  a bf16 activation on a rounding boundary may land on the other side.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantvnr_tpu.accel import macrocell as jmc
from instantvnr_tpu.config import EncodingConfig as JEnc
from instantvnr_tpu.config import ModelConfig as JModelConfig
from instantvnr_tpu.config import NetworkConfig as JNet
from instantvnr_tpu.config import OptimizerConfig as JOpt
from instantvnr_tpu.data import sampler as jsampler
from instantvnr_tpu.models import optimizer as jopt
from instantvnr_tpu.models import trainer as jtrainer
from instantvnr_tpu.models.metrics import ssim_arrays as j_ssim
from instantvnr_tpu.models.network import NeuralField as JNeuralField
from instantvnr_tpu.ops import hash_encoding as jhe
from instantvnr_tpu.ops import trilinear as jtri
from instantvnr_tpu.ops.pallas.fused_mlp import fused_mlp_apply as j_fused
from instantvnr_torch import api
from instantvnr_torch.accel import macrocell as mcmod
from instantvnr_torch.config import EncodingConfig, ModelConfig, NetworkConfig
from instantvnr_torch.config import OptimizerConfig
from instantvnr_torch.data import sampler
from instantvnr_torch.models import optimizer as opt
from instantvnr_torch.models import trainer
from instantvnr_torch.models.metrics import ssim_arrays
from instantvnr_torch.models.network import NeuralField, params_from_numpy
from instantvnr_torch.ops import fused_mlp as fm
from instantvnr_torch.ops import hash_encoding as he
from instantvnr_torch.ops import trilinear as tri

SCHEMA = dict(encoding=dict(n_levels=4, n_features_per_level=2,
                            log2_hashmap_size=10),
              network=dict(n_neurons=16, n_hidden_layers=2))


def _cfgs(**kw):
    enc, net = SCHEMA["encoding"], SCHEMA["network"]
    return (JModelConfig(encoding=JEnc(**enc), network=JNet(**net), **kw),
            ModelConfig(encoding=EncodingConfig(**enc),
                        network=NetworkConfig(**net), **kw))


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


# -- trilinear sampling and sampler -----------------------------------------


def test_trilinear_matches_jax():
    rng = np.random.default_rng(0)
    vol = rng.random((7, 9, 11)).astype(np.float32)  # [dz, dy, dx]
    p = rng.uniform(-0.1, 1.1, (500, 3)).astype(np.float32)
    p[:4] = [[0, 0, 0], [1, 1, 1], [0.5, 0, 1], [1, 0.5, 0]]
    vox = p * np.array([11, 9, 7], np.float32)
    jv, tv = jnp.asarray(vol), _t(vol)
    for jfn, fn, arg in ((jtri.sample_volume_voxel, tri.sample_volume_voxel,
                          vox), (jtri.sample_volume, tri.sample_volume, p),
                         (jtri.sample_volume_tex, tri.sample_volume_tex, p)):
        np.testing.assert_allclose(fn(tv, _t(arg)).numpy(),
                                   np.asarray(jfn(jv, jnp.asarray(arg))),
                                   atol=1e-6, rtol=0, err_msg=fn.__name__)
    pin = np.clip(p, 0.0, 1.0)
    v = np.asarray(jtri.sample_volume(jv, jnp.asarray(pin)))
    ref = np.asarray(jtri.sample_gradient(jv, jnp.asarray(pin),
                                          jnp.asarray(v), 0.05))
    got = tri.sample_gradient(tv, _t(pin), _t(v), 0.05).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


def test_grid_coords_and_static_sampler():
    got = sampler.grid_coords((1, 2, 0), (3, 4, 5), (0.1, 0.2, 0.05))
    ref = np.asarray(jsampler.grid_coords((1, 2, 0), (3, 4, 5),
                                          (0.1, 0.2, 0.05)))
    np.testing.assert_array_equal(got.numpy(), ref)
    vol = torch.rand((8, 8, 8), generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(sampler.DEFAULT_SEED)
    coords, values = sampler.sample_static(vol, gen, 1000, (0.25, 0.0, 0.5),
                                           (0.75, 1.0, 1.0))
    assert coords.shape == (1000, 3) and values.shape == (1000, 1)
    lo, hi = coords.min(0).values, coords.max(0).values
    assert (lo >= torch.tensor([0.25, 0.0, 0.5])).all()
    assert (hi <= torch.tensor([0.75, 1.0, 1.0])).all()
    np.testing.assert_array_equal(
        values[:, 0].numpy(), tri.sample_volume_tex(vol, coords).numpy())


# -- optimizer and losses ---------------------------------------------------


@pytest.mark.parametrize("otype,start", [("ExponentialDecay", 0),
                                         ("ExponentialDecay", 3499),
                                         ("Adam", 3499)])
def test_adam_matches_jax(otype, start):
    rng = np.random.default_rng(1)
    shapes = [(50, 2), (8, 16), (16, 16), (16, 1)]
    arrs = [[rng.standard_normal(s).astype(np.float32) * 0.1 for s in shapes]
            for _ in range(4)]
    arrs[3] = [np.abs(a) for a in arrs[3]]  # second moments are ≥ 0

    def tree(leaves, conv):
        return {"table": conv(leaves[0]), "mlp": [conv(a) for a in leaves[1:]]}

    jcfg, cfg = JOpt(otype=otype), OptimizerConfig(otype=otype)
    jp, jg, jm, jv = (tree(a, jnp.asarray) for a in arrs)
    p, g, m, v = (tree(a, _t) for a in arrs)
    jstate = jopt.AdamState(step=jnp.int32(start), mu=jm, nu=jv)
    state = opt.AdamState(step=start, mu=m, nu=v)
    jnew, jst = jopt.adam_update(jcfg, jp, jg, jstate,
                                 l2_mask=jopt.mlp_l2_mask(jp))
    new, st = opt.adam_update(cfg, p, g, state, l2_mask=opt.mlp_l2_mask(p))
    assert st.step == int(jst.step) == start + 1
    assert opt.lr_at_step(cfg, start + 1) == pytest.approx(
        float(jopt.lr_at_step(jcfg, jnp.int32(start + 1))), rel=1e-7)
    for got, ref in ((new, jnew), (st.mu, jst.mu), (st.nu, jst.nu)):
        for a, b in zip([got["table"], *got["mlp"]], [ref["table"],
                                                      *ref["mlp"]]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)
    # the step made new tensors and left the old ones as they were
    assert new["table"] is not p["table"]
    np.testing.assert_array_equal(p["table"].numpy(), arrs[0][0])


@pytest.mark.parametrize("kind", ["l1", "l2", "relativel2"])
def test_loss_terms_and_grads_match_jax(kind):
    rng = np.random.default_rng(2)
    pred = rng.standard_normal((300, 1)).astype(np.float32)
    tgt = rng.random((300, 1)).astype(np.float32)
    jt = jnp.asarray(tgt)
    jl = jnp.mean(jtrainer.loss_terms(kind, jnp.asarray(pred), jt))
    jgrad = jax.grad(lambda q: jnp.mean(jtrainer.loss_terms(kind, q, jt)))(
        jnp.asarray(pred))
    tp = _t(pred).requires_grad_()
    loss = torch.mean(trainer.loss_terms(kind, tp, _t(tgt)))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgrad), rtol=1e-6,
                               atol=1e-12)


# -- metrics and macrocell --------------------------------------------------


def _ssim_oracle(pred, gt, win=7, data_range=1.0):
    """Brute-force float64 SSIM with the reference kernel's semantics
    (network.cu:474-549), independent of any separable evaluation."""
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    n = win ** 3
    vals = []
    for z in range(gt.shape[0] - win + 1):
        for y in range(gt.shape[1] - win + 1):
            for x in range(gt.shape[2] - win + 1):
                a = gt[z:z + win, y:y + win, x:x + win].astype(np.float64)
                b = pred[z:z + win, y:y + win, x:x + win].astype(np.float64)
                ua, ub = a.mean(), b.mean()
                va = ((a - ua) ** 2).sum() / (n - 1)
                vb = ((b - ub) ** 2).sum() / (n - 1)
                vab = ((a - ua) * (b - ub)).sum() / (n - 1)
                vals.append(((2 * ua * ub + c1) * (2 * vab + c2))
                            / ((ua * ua + ub * ub + c1) * (va + vb + c2)))
    return float(np.mean(vals))


def test_ssim_matches_jax_and_oracle():
    rng = np.random.default_rng(3)
    gt = rng.random((12, 11, 10)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1).astype(np.float32)
    got = float(ssim_arrays(_t(pred), _t(gt)))
    assert got == pytest.approx(float(j_ssim(jnp.asarray(pred),
                                             jnp.asarray(gt))), abs=1e-5)
    assert got == pytest.approx(_ssim_oracle(pred, gt), abs=1e-5)
    assert float(ssim_arrays(_t(gt), _t(gt))) == pytest.approx(1.0, abs=1e-5)


def test_update_explicit_matches_jax():
    rng = np.random.default_rng(4)
    dims = (40, 33, 20)  # ragged last cells on every axis
    coords = rng.random((3000, 3)).astype(np.float32)
    # samples on cell boundaries (voxel % 16 in {0, 15}) and at the edges
    coords[:6] = [[0, 0, 0], [1, 1, 1], [16.5 / 40, 15.5 / 33, 0.99],
                  [15.2 / 40, 16.9 / 33, 0.0], [0.999, 0.0, 16.1 / 20],
                  [32.0 / 40, 31.9 / 33, 15.0 / 20]]
    values = rng.random(3000).astype(np.float32)
    jm = jmc.update_explicit(jmc.allocate(dims), jnp.asarray(coords),
                             jnp.asarray(values))
    tm = mcmod.update_explicit(mcmod.allocate(dims, "cpu"), _t(coords),
                               _t(values)[:, None])
    np.testing.assert_array_equal(tm.value_lo.numpy(), np.asarray(jm.value_lo))
    np.testing.assert_array_equal(tm.value_hi.numpy(), np.asarray(jm.value_hi))


# -- one training step ------------------------------------------------------


def test_host_batch_step_grads_match_jax():
    jcfg, cfg = _cfgs()
    jfield, field = JNeuralField.from_config(jcfg), NeuralField.from_config(cfg)
    rng = np.random.default_rng(5)
    spec = field.spec
    params_np = {
        "table": rng.uniform(-0.5, 0.5, (spec.n_entries, spec.n_features)
                             ).astype(np.float32),
        "mlp": [(rng.standard_normal(s) * np.sqrt(2.0 / s[0])).astype(
            np.float32) for s in ((8, 16), (16, 16), (16, 1))]}
    b = 4000  # ragged against the Pallas tile
    coords = rng.random((b, 3)).astype(np.float32)
    vol = rng.random((16, 16, 16)).astype(np.float32)
    targets = tri.sample_volume_tex(_t(vol), _t(coords))[:, None].numpy()
    jc, jt = jnp.asarray(coords), jnp.asarray(targets)

    def jloss(p):
        feats = jhe.hash_encode(p["table"], jc, jfield.spec,
                                compute_dtype=jnp.bfloat16)
        pred = j_fused(p["mlp"], feats, jcfg.network, interpret=True)
        return jnp.mean(jnp.abs(pred - jt))

    jp = {"table": jnp.asarray(params_np["table"]),
          "mlp": [jnp.asarray(w) for w in params_np["mlp"]]}
    jl, jg = jax.value_and_grad(jloss)(jp)
    params = params_from_numpy(params_np, "cpu")
    before = (fm.train_forward_counter.launches, he.counter.launches)
    loss, grads = trainer.value_and_grad(field, params, _t(coords),
                                         _t(targets))
    assert (fm.train_forward_counter.launches, he.counter.launches) == before
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    for got, ref in zip([grads["table"], *grads["mlp"]],
                        [jg["table"], *jg["mlp"]]):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-3 * np.abs(ref).max())
    # the step: Adam from the port's own gradients, into new tensors
    state = trainer.state_for_params(params)
    new = trainer.train_step_hostbatch(field, state, _t(coords), _t(targets))
    ref_p, _ = opt.adam_update(cfg.optimizer, params, grads, state.opt,
                               l2_mask=opt.mlp_l2_mask(params))
    assert new.opt.step == 1 and new.params is not params
    for a, r in zip([new.params["table"], *new.params["mlp"]],
                    [ref_p["table"], *ref_p["mlp"]]):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-6, atol=0)
    assert float(new.loss) == pytest.approx(float(loss), rel=1e-6)


def test_neural_volume_trains_and_redecodes_on_cpu(tmp_path):
    _, cfg = _cfgs()
    sv = api.SimpleVolume.synthetic((32, 32, 32), "vorts", device="cpu")
    nv = api.NeuralVolume(cfg, sv, device="cpu", train_batch=4096)
    r = api.VNRenderer(nv, 32, 32)
    decoder = nv.ensure_decoded()
    before = decoder.decoded.clone()
    first = nv.train(10)
    params_after_first = nv.params
    assert first.step == 10 == nv.get_training_step()
    last = nv.train(190, fast_mode=True)
    assert nv.params is not params_after_first  # a new dict every step
    assert last.step == 200 and last.loss < 0.7 * first.loss
    assert 0.0 < nv.get_testing_loss() < first.loss
    assert nv.get_psnr() > 25.0 and 0.5 < nv.get_mssim() <= 1.0
    assert nv.get_macrocell_psnr() > 10.0  # the first train() updated it
    nv.ensure_decoded()  # a new params object: the grid is decoded again
    assert not torch.equal(decoder.decoded, before)
    r.render()
    assert np.isfinite(r.mapframe()).all()
    # a BSON round trip keeps step and loss; the optimizer restarts
    path = str(tmp_path / "trained.bson")
    nv.save_params(path)
    nv2 = api.NeuralVolume(cfg, sv, device="cpu", train_batch=4096)
    nv2.set_params(path)
    assert nv2.get_training_step() == 200 and nv2.state.opt.step == 0
    np.testing.assert_allclose(nv2.get_psnr(), nv.get_psnr(), atol=0.5)
