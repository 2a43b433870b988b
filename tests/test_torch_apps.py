"""The port's CLI (instantvnr_torch/apps) and bench line, in-process on
--device cpu at a small size: train → .npz and .bson → resume → render in
each ported mode → view_model, and `instantvnr_torch.bench` printing one
JSON line with the named keys; the data apps on a two-timestep scene:
train in each --sampling-mode, vnr_cmd_isosurface of the grid and of a
checkpoint (the OBJ byte for byte the JAX app's), generate_shadow_map (the
raw file the JAX app's within 1e-5) and a render of the second timestep.
The PNG writer (zlib and struct only) is held to a decoder written here."""
import json
import struct
import zlib

import numpy as np
import pytest

from instantvnr_torch.api import SimpleVolume
from instantvnr_torch.data.volume import synthetic_array

from instantvnr_torch import bench
from instantvnr_torch.apps import common, generate_shadow_map, view_model
from instantvnr_torch.apps import vnr_cmd_isosurface, vnr_cmd_render
from instantvnr_torch.apps import vnr_cmd_train

MODEL = {"encoding": {"otype": "HashGrid", "n_levels": 2,
                      "n_features_per_level": 4, "log2_hashmap_size": 10,
                      "base_resolution": 16, "per_level_scale": 2.0},
         "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                     "output_activation": "None", "n_neurons": 16,
                     "n_hidden_layers": 2}}
VOLUME = ["--synthetic", "vorts", "--dims", "20", "--device", "cpu"]


def _decode_png(data: bytes) -> np.ndarray:
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = hdr[:4]
    assert depth == 8 and color == 6
    raw = zlib.decompress(idat)
    rows = [raw[y * (4 * w + 1):(y + 1) * (4 * w + 1)] for y in range(h)]
    assert all(r[0] == 0 for r in rows)
    return np.frombuffer(b"".join(r[1:] for r in rows), np.uint8).reshape(
        h, w, 4)


def test_png_writer_round_trips(tmp_path):
    rgba = np.random.default_rng(0).random((7, 5, 4)).astype(np.float32)
    rgba[0, 0] = [2.0, -1.0, 0.5, 1.0]  # clipped
    path = str(tmp_path / "f.png")
    common.save_png(rgba, path)
    with open(path, "rb") as f:
        img = _decode_png(f.read())
    np.testing.assert_array_equal(img, common.framebuffer_to_u8(rgba))
    assert tuple(img[-1, 0]) == (255, 0, 127, 255)  # row 0 is the bottom


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    model = str(tmp / "model.json")
    with open(model, "w") as f:
        json.dump(MODEL, f)
    npz, bson = str(tmp / "p.npz"), str(tmp / "p.bson")
    nv = vnr_cmd_train.main(VOLUME + ["--model", model, "--batch", "2048",
                                      "--max-num-steps", "20", "--save",
                                      npz, "--log", str(tmp / "log.csv")])
    assert nv.step == 20
    nv2 = vnr_cmd_train.main(VOLUME + ["--batch", "2048", "--max-num-steps",
                                       "30", "--resume", npz, "--save", bson,
                                       "--report-psnr"])
    assert nv2.step == 30 and nv2.field.spec.n_levels == 2
    with open(tmp / "log.csv") as f:
        assert f.readline().strip() == "step,loss,time_s"
        assert len(f.readlines()) == 2  # chunks of 10
    return tmp, npz, bson


@pytest.mark.parametrize("mode,extra", [
    ("decoded", ["--slab-shading", "gradient", "--shadows"]),
    ("neural", ["--streaming-cache", "none", "--denoise"]),
    ("ssh", ["--streaming-cache", "none"]),
    ("isosurface", ["--isovalue", "0.3", "--orbit"]),
    ("neural", ["--streaming-cache", "lazy"]),
    ("pathtrace", ["--denoise"]),
    ("pathtrace-neural", []),
])
def test_render_modes_from_checkpoint(trained, mode, extra):
    tmp, _, bson = trained
    out = str(tmp / f"{mode}{len(extra)}.png")
    frame = vnr_cmd_render.main(
        ["--device", "cpu", "--load", bson, "--mode", mode, "--size", "16",
         "--num-frames", "2", "--warmup", "1", "--output", out,
         "--fps-log", str(tmp / f"{mode}.csv")] + extra)
    assert frame.shape == (16, 16, 4) and np.isfinite(frame).all()
    with open(out, "rb") as f:
        np.testing.assert_array_equal(_decode_png(f.read()),
                                      common.framebuffer_to_u8(frame))


@pytest.mark.parametrize("mode", ["reference", "gradient",
                                  "isosurface-reference", "pathtrace",
                                  "pathtrace-reference"])
def test_render_ground_truth_modes(tmp_path, mode):
    frame = vnr_cmd_render.main(VOLUME + ["--mode", mode, "--size", "16",
                                          "--num-frames", "1", "--warmup",
                                          "0", "--output",
                                          str(tmp_path / "f.png")])
    assert frame[..., 3].max() > 0.05


def test_unported_options_raise(trained, tmp_path):
    # --volume reads .vdb files only; a raw volume needs a scene JSON
    with pytest.raises(SystemExit):
        vnr_cmd_train.main(["--device", "cpu", "--volume", "v.raw"])
    # --resume reads native .npz checkpoints only
    with pytest.raises(SystemExit):
        vnr_cmd_train.main(VOLUME + ["--resume", "p.bson"])
    # a .vdb that is not there is an error, in core and out of core (the
    # reader of .vdb files is tests/test_torch_vdb.py's)
    missing = str(tmp_path / "v.vdb")
    for extra in ([], ["--sampling-mode", "out-of-core"]):
        with pytest.raises(FileNotFoundError):
            vnr_cmd_train.main(["--device", "cpu", "--volume", missing]
                               + extra)


def test_profile_writes_trace(trained, tmp_path):
    """--profile DIR traces the timed frames into DIR/trace.json."""
    _, _, bson = trained
    logdir = tmp_path / "prof"
    vnr_cmd_render.main(["--device", "cpu", "--load", bson, "--size", "16",
                         "--num-frames", "2", "--warmup", "0", "--output",
                         "", "--profile", str(logdir)])
    with open(logdir / "trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    # the slab compositor's plain version ran inside the trace
    assert names and any(n.startswith("aten::") for n in names)


def test_view_model(trained):
    _, npz, bson = trained
    info = view_model.main([bson])
    assert info["step"] == 30 and info["dims"] == (20, 20, 20)
    info = view_model.main([npz] + VOLUME + ["--evaluate"])
    assert info["step"] == 20 and info["psnr"] > 10 and info["ssim"] > 0


def test_bench_prints_one_json_line(capsys):
    assert bench.main(["--device", "cpu", "--dims", "16", "--size", "16",
                       "--batch", "1024", "--train-warmup", "1",
                       "--train-steps", "2", "--protocol-steps", "4",
                       "--train-warmup-19", "1", "--steps-19", "1",
                       "--frames", "2", "--wavefront-frames", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["unit"] == "fps" and line["value"] > 0
    assert line["metric"].startswith("neural decode+slab-render fps")
    assert set(line["secondary"]) >= {
        "slab_fps_512_shaded", "isosurface_fps_512",
        "neural_wavefront_fps_512", "train_msamples_per_s_hash14",
        "train_msamples_per_s_hash19_ref_schema", "psnr_db", "ssim",
        "brick_wavefront_fps_512", "pathtrace_fps_512", "pathtrace_events"}
    assert line["device"] == {"platform": "cpu", "name": "cpu",
                              "power_limit": None}
    assert bench.METRIC == ("neural decode+slab-render fps @ 512x512 "
                            "(hash 2^14)")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A diva scene of two 16³ big-endian UNSIGNED_SHORT timesteps with a
    32-byte header, and the small model JSON."""
    tmp = tmp_path_factory.mktemp("scene")
    names = []
    for t, kind in enumerate(("vorts", "sphere")):
        a, _ = synthetic_array((16, 16, 16), kind)
        with open(tmp / f"t{t}.raw", "wb") as f:
            f.write(b"\0" * 32)
            f.write((a * 60000.0).astype(">u2").tobytes())
        names.append(f"t{t}.raw")
    path = tmp / "scene.json"
    path.write_text(json.dumps({"volume": {
        "filename": names, "dims": {"x": 16, "y": 16, "z": 16},
        "type": "UNSIGNED_SHORT", "bigendian": True, "offset": 32}}))
    model = tmp / "model.json"
    model.write_text(json.dumps(MODEL))
    return tmp, str(path), str(model)


@pytest.mark.parametrize("mode", ["gpu", "out-of-core", "analytic"])
def test_train_sampling_modes(scene, mode):
    tmp, path, model = scene
    src = (["--synthetic", "vorts", "--dims", "16"] if mode == "analytic"
           else ["--scene", path, "--timestep", "1"])
    out = str(tmp / f"{mode}.npz")
    nv = vnr_cmd_train.main(src + ["--device", "cpu", "--model", model,
                                   "--batch", "1024", "--max-num-steps",
                                   "20", "--sampling-mode", mode, "--save",
                                   out, "--report-psnr"])
    assert nv.step == 20 and np.isfinite(nv.get_training_loss())
    assert nv.dims == (16, 16, 16)
    if mode == "gpu":
        assert nv.simple.current_timestep == 1
    back = vnr_cmd_render.main(["--device", "cpu", "--load", out,
                                "--size", "16", "--num-frames", "1",
                                "--warmup", "0", "--output", ""])
    assert np.isfinite(back).all()


def test_isosurface_app_matches_jax_obj(scene):
    from instantvnr_tpu.ops import isosurface as jiso

    tmp, path, model = scene
    obj = str(tmp / "grid.obj")
    v, f = vnr_cmd_isosurface.main(["--device", "cpu", "--scene", path,
                                    "--isovalue", "0.3", "--output", obj])
    assert len(f) > 100 and np.isfinite(v).all()
    data = SimpleVolume(path, device="cpu").volume.data.numpy()
    jv, jf = jiso.extract_isosurface(data, 0.3)
    jiso.save_obj(jv, jf, str(tmp / "jax.obj"))
    with open(obj, "rb") as a, open(tmp / "jax.obj", "rb") as b:
        assert a.read() == b.read()
    soup = vnr_cmd_isosurface.main(["--device", "cpu", "--scene", path,
                                    "--isovalue", "0.3", "--no-weld",
                                    "--output", str(tmp / "soup.obj")])
    assert len(soup[0]) == 3 * len(f)
    vnr_cmd_train.main(["--device", "cpu", "--scene", path, "--model", model,
                        "--batch", "2048", "--max-num-steps", "30",
                        "--save", str(tmp / "iso.npz")])
    nv, nf = vnr_cmd_isosurface.main(["--device", "cpu", "--load",
                                      str(tmp / "iso.npz"), "--isovalue",
                                      "0.3", "--output",
                                      str(tmp / "net.obj")])
    assert len(nf) > 0 and np.isfinite(nv).all()


def test_shadow_map_and_scene_render(scene):
    from instantvnr_tpu.api import SimpleVolume as JSimpleVolume
    from instantvnr_tpu.render.shadow import shadow_volume_for as j_shadow

    tmp, path, _ = scene
    out = str(tmp / "shadow.raw")
    s = generate_shadow_map.main(["--device", "cpu", "--scene", path,
                                  "--output", out])
    assert s.shape == (16, 16, 16)
    jsv = JSimpleVolume(path)
    ref = np.asarray(j_shadow(jsv.volume.data, jsv.tf, (0.7, 0.9, 0.4), 1.0))
    np.testing.assert_allclose(np.fromfile(out, np.float32).reshape(s.shape),
                               ref, atol=1e-5)
    frames = [vnr_cmd_render.main(["--device", "cpu", "--scene", path,
                                   "--timestep", str(t), "--mode",
                                   "isosurface-reference", "--size", "16",
                                   "--num-frames", "1", "--warmup", "0",
                                   "--isovalue", "0.3", "--output",
                                   str(tmp / f"t{t}.png")])
              for t in (0, 1)]
    assert all(np.isfinite(f).all() and f[..., 3].max() > 0.05
               for f in frames)
    assert np.abs(frames[1] - frames[0]).max() > 0.1
