"""The port's data sources against the JAX package's, on the same files and
numpy inputs: scene JSONs (config.py's scene half), raw volumes
(data/volume.py), analytic fields (data/procedural.py), the out-of-core
sampler on the shared native loader (data/outofcore.py), training from an
analytic source and from host batches (models/trainer.py), and time series
through the facade (api.SimpleVolume, VNRenderer.set_current_timestep).

Tolerances:
- scene configs: the dataclasses equal field for field (asdict);
- raw volumes, in each of the 8 dtypes, big-endian and with an offset:
  the normalized data bit for bit and the original range equal;
- the analytic fields' `evaluate` on 2^16 numpy coords and `lattice_grid`
  at 16³: max abs 1e-6 (their sin/cos/exp/sqrt are other libraries'
  roundings); the grid synthetics of the analytic kinds the same;
  `downsample_volume` bit for bit (the same numpy pooling);
- OutOfCoreSampler, native and numpy, same seed: coords and values bit
  for bit (one C library, one numpy code); `scan_value_range` equal;
- training chains (5 steps, a small schema) fed the same host batches as
  JAX's `train_step_hostbatch` chain, params copied over: each step's loss
  within rel 1e-3; the MLP within 1e-3 of its largest entry
  (tests/test_torch_training.py's band for one step's gradients); the
  table within lr/2 (Adam moves an entry by about lr a step whatever its
  gradient's size, so the bf16 roundings that part the packages' small
  gradients show at the scale of lr; a sign flip would show 2·lr);
- frames after a timestep switch: the isosurface renderers' FRAME_ATOL
  2e-5 (tests/test_torch_iso_sweep.py); the macrocells exactly.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantvnr_tpu import api as japi
from instantvnr_tpu import config as jconfig
from instantvnr_tpu.config import EncodingConfig as JEnc
from instantvnr_tpu.config import ModelConfig as JModelConfig
from instantvnr_tpu.config import NetworkConfig as JNet
from instantvnr_tpu.data import outofcore as joc
from instantvnr_tpu.data import procedural as jproc
from instantvnr_tpu.data import volume as jvolume
from instantvnr_tpu.models import trainer as jtrainer
from instantvnr_tpu.models.network import NeuralField as JNeuralField
from instantvnr_tpu.render.camera import Camera as JCamera
from instantvnr_torch import api
from instantvnr_torch import config
from instantvnr_torch.config import EncodingConfig, ModelConfig, NetworkConfig
from instantvnr_torch.data import outofcore as oc
from instantvnr_torch.data import procedural as proc
from instantvnr_torch.data import volume as tvolume
from instantvnr_torch.models import trainer
from instantvnr_torch.models.network import NeuralField, params_from_numpy
from instantvnr_torch.render.camera import Camera

FIELD_ATOL = 1e-6
FRAME_ATOL = 2e-5
DTYPES = ("BYTE", "UNSIGNED_BYTE", "SHORT", "UNSIGNED_SHORT", "INT",
          "UNSIGNED_INT", "FLOAT", "DOUBLE")


# -- scene files --------------------------------------------------------------


def _scenes(tmp_path):
    """Scene JSONs of both dialects as tests/test_config.py writes them,
    the range spellings and time series included; relaxed JSON (comments)
    on one."""
    vol = tmp_path / "vol.raw"
    np.zeros((8, 6, 4), np.uint8).tofile(vol)
    steps = []
    for t in range(3):
        f = tmp_path / f"vol_t{t}.raw"
        np.full((4, 4, 4), t, np.float32).tofile(f)
        steps.append(f.name)
    tfn = {"opacityControls": [{"position": 0.0, "value": 0.005},
                               {"position": 0.4, "value": 0.3},
                               {"position": 1.0, "value": 0.9}],
           "colorControls": [{"position": 0.0, "r": 0.0, "g": 0.0, "b": 1.0},
                             {"position": 1.0, "r": 1.0, "g": 0.0,
                              "b": 0.0}]}
    view = {"camera": {"eye": {"x": 0, "y": 0, "z": -2},
                       "center": {"x": 0, "y": 0, "z": 0},
                       "up": {"x": 0, "y": 1, "z": 0}, "fovy": 45},
            "volume": {"scalarMappingRange": {"minimum": 0.0,
                                              "maximum": 0.5},
                       "transferFunction": tfn}}
    src = {"vidi_u8": {"dataSource": [{
               "fileName": str(vol), "dimensions": {"x": 4, "y": 6, "z": 8},
               "type": "UNSIGNED_BYTE", "offset": 0,
               "endian": "LITTLE_ENDIAN"}], "view": view},
           "vidi_series_unnormalized": {"dataSource": [
               {"fileName": [f"missing_{s}", s], "dimensions": [4, 4, 4],
                "type": "FLOAT", "endian": "BIG_ENDIAN"} for s in steps],
               "view": {"volume": {"scalarMappingRangeUnnormalized": {
                   "minimum": -2.0, "maximum": 5.0},
                   "transferFunction": {"opacity": [[0.0, 0.0], [1.0, 1.0]]}}}},
           "diva": {"volume": {"filename": str(vol),
                               "dims": {"x": 4, "y": 6, "z": 8},
                               "type": "UNSIGNED_BYTE"}},
           "diva_range_obj": {"volume": {"filename": "vol.raw",
                                         "dims": [4, 6, 8], "type": "FLOAT",
                                         "range": {"x": -3e4, "y": 7e5},
                                         "offset": 16, "bigendian": True}},
           "diva_range_list": {"volume": {"filename": str(vol),
                                          "dims": {"x": 4, "y": 6, "z": 8},
                                          "type": "SHORT",
                                          "range": [-3e4, 7e5]}},
           "diva_series": {"volume": {"filename": steps,
                                      "dims": {"x": 4, "y": 4, "z": 4},
                                      "type": "FLOAT"}}}
    paths = {}
    for name, doc in src.items():
        p = tmp_path / f"{name}.json"
        p.write_text("// a scene\n" + json.dumps(doc, indent=1)
                     + "\n/* the end */\n")
        paths[name] = str(p)
    return paths


def test_scene_configs_match_jax(tmp_path):
    for name, path in _scenes(tmp_path).items():
        got = config.load_scene_config(path)
        ref = jconfig.load_scene_config(path)
        assert config.asdict(got) == jconfig.asdict(ref), name
        for t in range(got.volume.n_timesteps):
            assert (config.asdict(got.volume.at_timestep(t))
                    == jconfig.asdict(ref.volume.at_timestep(t)))
        assert got.volume.np_dtype == ref.volume.np_dtype
        assert got.volume.n_bytes == ref.volume.n_bytes
    series = config.load_scene_config(str(tmp_path / "diva_series.json"))
    assert series.volume.n_timesteps == 3
    with pytest.raises(IndexError):
        config.load_scene_config(str(tmp_path / "diva.json")
                                 ).volume.at_timestep(1)
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    with pytest.raises(ValueError, match="dialect"):
        config.load_scene_config(str(bad))


# -- raw volumes ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bigendian", [False, True])
def test_load_volume_matches_jax(tmp_path, dtype, bigendian):
    rng = np.random.default_rng(DTYPES.index(dtype))
    npd = config.VALUE_TYPES[dtype]
    if npd.kind == "f":
        raw = (rng.standard_normal((5, 6, 7)) * 1e3).astype(npd)
    else:
        info = np.iinfo(npd)
        raw = rng.integers(info.min, info.max, (5, 6, 7), dtype=npd,
                           endpoint=True)
    offset = 24
    path = tmp_path / "v.raw"
    with open(path, "wb") as f:
        f.write(b"\x7f" * offset)
        f.write(raw.astype(npd.newbyteorder(">" if bigendian else "<"))
                .tobytes())
    for vr in (None, (float(raw.min()) / 2, float(raw.max()) / 2)):
        kw = dict(filename=str(path), dims=(7, 6, 5), dtype=dtype,
                  offset=offset, bigendian=bigendian, value_range=vr)
        got = tvolume.load_volume(config.VolumeDesc(**kw), device="cpu")
        ref = jvolume.load_volume(jconfig.VolumeDesc(**kw))
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
        assert got.original_range == ref.original_range
        assert got.dims == ref.dims == (7, 6, 5)
    short = config.VolumeDesc(filename=str(path), dims=(70, 6, 5),
                              dtype=dtype, offset=offset)
    with pytest.raises(ValueError, match="voxels"):
        tvolume.load_volume(short, device="cpu")


def test_save_raw_round_trip_and_timesteps(tmp_path):
    data = np.random.default_rng(9).random((4, 5, 6)).astype(np.float32)
    files = []
    for t in range(2):
        f = tmp_path / f"t{t}.raw"
        tvolume.save_raw(torch.from_numpy(data + t), str(f))
        jvolume.save_raw(data + t, str(tmp_path / f"j{t}.raw"))
        assert f.read_bytes() == (tmp_path / f"j{t}.raw").read_bytes()
        files.append(str(f))
    desc = config.VolumeDesc(filename=files[0], dims=(6, 5, 4),
                             timestep_files=tuple(files))
    for t in range(2):
        got = tvolume.load_volume(desc.at_timestep(t), device="cpu")
        ref = jvolume.load_volume(jconfig.VolumeDesc(
            **dataclasses.asdict(desc)).at_timestep(t))
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
        assert got.original_range == ref.original_range


# -- analytic fields --------------------------------------------------------------


@pytest.fixture(scope="module")
def warm_torch_math():
    """One evaluation of every field at the compared size before any
    comparison. The first multi-threaded transcendental call of a process
    (MKL's vector math under torch's intra-op threads) can come back less
    accurate in one thread's chunk when the machine is loaded: seen as
    8192 consecutive values of a first torch.cos within 1.7e-3 of the
    truth; the same call repeated is exact."""
    coords = torch.rand((1 << 16, 3),
                        generator=torch.Generator().manual_seed(0))
    for kind in proc.FIELDS:
        proc.AnalyticSampler.create(kind, 5).evaluate(coords)


@pytest.mark.parametrize("kind", sorted(proc.FIELDS))
def test_fields_match_jax(kind, warm_torch_math):
    assert proc.field_names() == jproc.field_names()
    coords = np.random.default_rng(11).random((1 << 16, 3)).astype(
        np.float32)
    s, js = proc.AnalyticSampler.create(kind, 5), jproc.AnalyticSampler.create(
        kind, 5)
    assert s.params == js.params
    got = s.evaluate(torch.from_numpy(coords)).numpy()
    ref = np.asarray(js.evaluate(jnp.asarray(coords)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=FIELD_ATOL)
    assert got.min() >= 0.0 and got.max() <= 1.0
    grid = s.lattice_grid((16, 16, 16), device="cpu").numpy()
    np.testing.assert_allclose(grid, np.asarray(js.lattice_grid(
        (16, 16, 16))), rtol=0, atol=FIELD_ATOL)
    # the analytic kinds as grid synthetics (the repaired synthetic_array)
    vol = tvolume.synthetic_volume((12, 10, 14), kind=kind, seed=5,
                                   device="cpu")
    jvol = jvolume.synthetic_volume((12, 10, 14), kind=kind, seed=5)
    np.testing.assert_allclose(vol.data.numpy(), np.asarray(jvol.data),
                               rtol=0, atol=FIELD_ATOL)
    assert vol.original_range == jvol.original_range


def test_sampler_draws_on_its_generator():
    s = proc.AnalyticSampler.create("tubes", 0)
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    coords, values = s.sample(g1, 500, (0.25, 0.0, 0.5), (0.75, 1.0, 1.0))
    u = torch.rand((500, 3), generator=g2)
    lo, hi = torch.tensor([0.25, 0.0, 0.5]), torch.tensor([0.75, 1.0, 1.0])
    np.testing.assert_array_equal(coords.numpy(), (lo + u * (hi - lo)).numpy())
    np.testing.assert_array_equal(values[:, 0].numpy(),
                                  s.evaluate(coords).numpy())
    gc, gv = s.sample_grid((1, 2, 0), (3, 4, 5), (0.1, 0.2, 0.05),
                           device="cpu")
    assert gc.shape == (60, 3) and gv.shape == (60, 1)
    with pytest.raises(ValueError, match="unknown analytic field"):
        proc.AnalyticSampler.create("nope")


def test_downsample_matches_jax():
    vol = tvolume.synthetic_volume((17, 14, 20), "vorts", device="cpu")
    jvol = jvolume.synthetic_volume((17, 14, 20), "vorts")
    for f in (2, 3):
        got, ref = proc.downsample_volume(vol, f), jproc.downsample_volume(
            jvol, f)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
        assert got.dims == ref.dims and got.original_range == \
            ref.original_range


# -- the out-of-core sampler --------------------------------------------------------


@pytest.fixture(scope="module")
def ooc_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ooc")
    rng = np.random.default_rng(13)
    f32 = (rng.standard_normal((18, 20, 24)) * 40.0 + 7.0).astype(np.float32)
    u8 = rng.integers(0, 256, (18, 20, 24), dtype=np.uint8)
    out = {}
    for name, arr, dtype in (("float", f32, "FLOAT"),
                             ("uint8", u8, "UNSIGNED_BYTE")):
        p = tmp / f"{name}.raw"
        arr.tofile(p)
        out[name] = dict(filename=str(p), dims=(24, 20, 18), dtype=dtype)
    return out


@pytest.mark.parametrize("name", ["float", "uint8"])
@pytest.mark.parametrize("native", [True, False])
def test_out_of_core_sampler_matches_jax(ooc_files, name, native):
    kw = ooc_files[name]
    desc, jdesc = config.VolumeDesc(**kw), jconfig.VolumeDesc(**kw)
    assert oc.scan_value_range(desc) == joc.scan_value_range(jdesc)
    assert oc.default_n_resident(desc, 8, 8) == joc.default_n_resident(
        jdesc, 8, 8)
    # one reader thread and a resident set that covers the file: the
    # loaded blocks, so the batches, follow from the seed alone
    args = dict(block_y=8, block_z=8, n_resident=9, n_threads=1,
                use_native=native, seed=21)
    s, js = oc.OutOfCoreSampler(desc, **args), joc.OutOfCoreSampler(jdesc,
                                                                    **args)
    assert s.is_native == js.is_native == native
    assert s.value_range == js.value_range
    if native:
        s.wait_ready(9)
        js.wait_ready(9)
    for batch in (5000, 777):
        c, v = s.sample(batch)
        jc, jv = js.sample(batch)
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(v, jv)
    c = np.empty((300, 3), np.float32)
    v = np.empty((300, 1), np.float32)
    s.sample_into(c, v)
    jc, jv = js.sample(300)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(v, jv)
    for bad in (np.empty((300, 3), np.float64), np.empty((3, 300),
                                                        np.float32).T):
        with pytest.raises(ValueError, match="C-contiguous float32"):
            s.sample_into(bad, v)
    c, v = s.sample(64)  # a refused buffer draws nothing
    jc, jv = js.sample(64)
    np.testing.assert_array_equal(c, jc)
    assert s.measure_throughput(1024, 0.05) > 0
    s.close()
    js.close()


# -- training from an analytic source and from host batches -----------------------


def _small():
    enc = dict(n_levels=2, n_features_per_level=2, log2_hashmap_size=10)
    net = dict(n_neurons=16, n_hidden_layers=1)
    jcfg = JModelConfig(encoding=JEnc(**enc), network=JNet(**net))
    cfg = ModelConfig(encoding=EncodingConfig(**enc),
                      network=NetworkConfig(**net))
    jfield = JNeuralField.from_config(jcfg)
    jstate = jtrainer.create_train_state(jax.random.PRNGKey(0), jfield)
    field = NeuralField.from_config(cfg)
    params = params_from_numpy(
        {"table": np.asarray(jstate.params["table"]),
         "mlp": [np.asarray(w) for w in jstate.params["mlp"]]}, "cpu")
    return jfield, jstate, field, trainer.state_for_params(params)


def _assert_chain_close(state, jstate, losses, jlosses):
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    lr = ModelConfig().optimizer.learning_rate
    np.testing.assert_allclose(state.params["table"].numpy(),
                               np.asarray(jstate.params["table"]), rtol=0,
                               atol=0.5 * lr)
    for got, ref in zip(state.params["mlp"], jstate.params["mlp"]):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-3 * np.abs(ref).max())


def test_train_steps_source_matches_jax_chain():
    jfield, jstate, field, state = _small()
    kind, b, n = "tubes", 4096, 5
    s, js = proc.AnalyticSampler.create(kind, 2), jproc.AnalyticSampler.create(
        kind, 2)
    twin = torch.Generator().set_state(state.generator.get_state())
    losses, jlosses = [], []
    for _ in range(n):
        state = trainer.train_steps_source(field, s, state, 1, b)
        losses.append(float(state.loss))
        coords = torch.rand((b, 3), generator=twin).numpy()
        jc = jnp.asarray(coords)
        jstate = jtrainer.train_step_hostbatch(
            jfield, jstate, jc, js.evaluate(jc)[:, None])
        jlosses.append(float(jstate.loss))
    assert state.opt.step == n
    _assert_chain_close(state, jstate, losses, jlosses)


class _Batches:
    """A host sampler handing out fixed batches in turn."""

    def __init__(self, batches):
        self.batches, self.i = batches, 0

    def sample(self, batch):
        c, v = self.batches[self.i]
        self.i += 1
        assert len(c) == batch
        return c.copy(), v.copy()


def test_train_out_of_core_matches_jax_chain(ooc_files):
    jfield, jstate, field, state = _small()
    desc = config.VolumeDesc(**ooc_files["float"])
    s = oc.OutOfCoreSampler(desc, block_y=8, block_z=8, use_native=False,
                            seed=4)
    b, n = 4096, 5
    batches = [s.sample(b) for _ in range(n)]
    out = trainer.train_out_of_core(field, _Batches(batches), state, n, b)
    jout = jtrainer.train_out_of_core(jfield, _Batches(batches), jstate, n, b)
    # the last step's loss, and the chain's end (JAX's chain keeps no list)
    ref_losses, st = [], state
    for c, v in batches:
        st = trainer.train_step_hostbatch(field, st, torch.from_numpy(c),
                                          torch.from_numpy(v))
        ref_losses.append(float(st.loss))
    assert float(out.loss) == ref_losses[-1] and out.opt.step == n
    _assert_chain_close(out, jout, [float(out.loss)], [float(jout.loss)])


# -- time series through the facade ---------------------------------------------------


def test_timestep_switch_matches_jax(tmp_path):
    """A two-timestep 16³ diva scene: SimpleVolume(path) and a renderer in
    ISOSURFACE_REFERENCE, then set_current_timestep(1); the macrocell and
    the 32² frame after the switch against JAX's."""
    vols = [np.asarray(jvolume.synthetic_volume((16, 16, 16), k).data)
            for k in ("vorts", "sphere")]
    names = []
    for t, v in enumerate(vols):
        (tmp_path / f"t{t}.raw").write_bytes(
            (v * 1000.0).astype(">f4").tobytes())
        names.append(f"t{t}.raw")
    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps({"volume": {
        "filename": names, "dims": [16, 16, 16], "type": "FLOAT",
        "bigendian": True}}))
    sv = api.SimpleVolume(str(scene), device="cpu")
    jsv = japi.SimpleVolume(str(scene))
    assert sv.num_timesteps == jsv.num_timesteps == 2
    assert sv.value_range == jsv.value_range
    eye = (5.0, 4.0, -40.0)
    r = api.VNRenderer(sv, 32, 32, api.RenderMode.ISOSURFACE_REFERENCE)
    jr = japi.VNRenderer(jsv, 32, 32, japi.RenderMode.ISOSURFACE_REFERENCE)
    r.set_isovalue(0.3)
    jr.set_isovalue(0.3)
    r.set_camera(Camera(eye=eye, center=(0, 0, 0), up=(0, 1, 0), fovy=45))
    jr.set_camera(JCamera(eye=eye, center=(0, 0, 0), up=(0, 1, 0), fovy=45))
    r.render()
    before = r.mapframe()
    for renderer in (r, jr):
        renderer.set_current_timestep(1)
        renderer.render()
    assert sv.current_timestep == jsv.current_timestep == 1
    assert sv.value_range == jsv.value_range
    np.testing.assert_array_equal(sv.volume.data.numpy(),
                                  np.asarray(jsv.volume.data))
    for a, b in ((sv.macrocell.value_lo, jsv.macrocell.value_lo),
                 (sv.macrocell.value_hi, jsv.macrocell.value_hi),
                 (sv.macrocell.max_opacity, jsv.macrocell.max_opacity)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ref = jr.mapframe()
    assert ref[..., 3].max() > 0.5
    np.testing.assert_allclose(r.mapframe(), ref, atol=FRAME_ATOL)
    assert np.abs(r.mapframe() - before).max() > 0.1  # the data changed
    with pytest.raises(IndexError):
        sv.set_current_timestep(2)


def test_in_memory_time_series():
    vols = [tvolume.synthetic_volume((12, 12, 12), k, device="cpu")
            for k in ("vorts", "noise")]
    sv = api.SimpleVolume(vols, device="cpu")
    assert sv.num_timesteps == 2 and sv.current_timestep == 0
    mc0 = sv.macrocell
    sv.set_current_timestep(1)
    assert sv.volume is not vols[1] and torch.equal(sv.volume.data,
                                                    vols[1].data)
    assert sv.macrocell is not mc0
    other = tvolume.synthetic_volume((8, 8, 8), "vorts", device="cpu")
    with pytest.raises(ValueError, match="dims"):
        api.SimpleVolume([vols[0], other], device="cpu")
    with pytest.raises(TypeError):
        api.SimpleVolume(np.zeros((4, 4, 4)), device="cpu")
