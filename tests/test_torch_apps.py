"""The port's CLI (instantvnr_torch/apps) and bench line, in-process on
--device cpu at a small size: train → .npz and .bson → resume → render in
each ported mode → view_model, and `instantvnr_torch.bench` printing one
JSON line with the named keys. The PNG writer (zlib and struct only) is
held to a decoder written here."""
import json
import struct
import zlib

import numpy as np
import pytest

from instantvnr_torch import bench
from instantvnr_torch.apps import common, view_model, vnr_cmd_render
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


def test_unported_options_raise(trained):
    _, _, bson = trained
    with pytest.raises(NotImplementedError, match="item 7"):
        vnr_cmd_render.main(["--device", "cpu", "--load", bson,
                             "--profile", "trace"])
    with pytest.raises(NotImplementedError, match="item 5"):
        vnr_cmd_train.main(["--device", "cpu", "--scene", "scene.json"])


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
