"""The port's interactive apps on the CPU, at a small size: the online
in-loop trainer (vnr_int_online: its CSV, steps, snapshots and
--pause-training), the web viewer end to end (vnr_int_viewer in a
subprocess on port 0, driven over HTTP as the browser drives it, as
tests/test_apps.py drives the JAX package's; its PNGs decoded with zlib)
and vnr_precompile, which builds nothing on the CPU."""
import csv
import json
import os
import struct
import subprocess
import sys
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from instantvnr_torch.apps import vnr_int_online, vnr_precompile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--synthetic", "vorts", "--dims", "24",
         "--size", "48", "--batch", "512"]


def _png_rgba(data: bytes) -> np.ndarray:
    """An 8-bit RGBA PNG with filter-0 scanlines → [H, W, 4] uint8."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        elif tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, depth, color = hdr[:4]
    assert (depth, color) == (8, 6)
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 4 * w + 1)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 4)


def test_online_app_logs_trains_and_snapshots(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    nv, dec = vnr_int_online.main(SMALL + [
        "--frames", "4", "--train-steps-per-frame", "5",
        "--infer-blobs-per-frame", "1", "--log", "online.csv",
        "--snapshot-every", "2"])
    with open("online.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["frame", "step", "loss", "train_ms", "render_ms",
                       "fps"]
    assert [int(r[0]) for r in rows[1:]] == [0, 1, 2, 3]
    assert [int(r[1]) for r in rows[1:]] == [5, 10, 15, 20]
    assert all(float(r[2]) > 0 and float(r[5]) > 0 for r in rows[1:])
    assert sorted(p for p in os.listdir(".") if p.endswith(".png")) == [
        "frame_0000.png", "frame_0002.png"]
    with open("frame_0002.png", "rb") as f:
        img = _png_rgba(f.read())
    assert img.shape == (48, 48, 4) and img[..., 3].max() > 0
    # the default model is the reference schema capped at 2^14, as in JAX
    assert nv.cfg.encoding.log2_hashmap_size == 14
    assert nv.step == 20 and dec._next_blob == 4
    frame = dec.mapframe()
    assert frame.shape == (48, 48, 4) and np.isfinite(frame).all()


def test_online_app_paused_and_model_flag(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    model = tmp_path / "m.json"
    model.write_text(json.dumps({"encoding": {"n_levels": 2,
                                              "log2_hashmap_size": 10},
                                 "network": {"n_neurons": 16}}))
    nv, dec = vnr_int_online.main(SMALL + [
        "--frames", "2", "--pause-training", "--model", str(model),
        "--log", "p.csv"])
    with open("p.csv") as f:
        rows = list(csv.reader(f))[1:]
    assert [r[1] for r in rows] == ["0", "0"] and nv.step == 0
    assert nv.cfg.encoding.log2_hashmap_size == 10  # --model: no cap
    assert dec._next_blob == 0


def test_online_app_needs_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vnr_int_online.main(SMALL[2:] + ["--frames", "1"])


def test_precompile_builds_nothing_on_cpu(capsys):
    assert vnr_precompile.main(["--device", "cpu", "--report"]) == {}
    assert "nothing to build" in capsys.readouterr().err


def test_viewer_end_to_end():
    proc = subprocess.Popen(
        [sys.executable, "-m", "instantvnr_torch.apps.vnr_int_viewer"]
        + SMALL + ["--train-steps-per-frame", "2", "--infer-blobs-per-frame",
                   "1", "--port", "0"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "serving on http://" in line, line + proc.stderr.read()
        base = line.split("serving on ")[1].strip().rstrip("/")

        def get(path, data=None, timeout=120):
            deadline = time.time() + timeout
            while True:
                try:
                    req = urllib.request.Request(
                        base + path, data=data,
                        method="POST" if data is not None else "GET")
                    with urllib.request.urlopen(req, timeout=30) as r:
                        return r.read()
                except urllib.error.HTTPError as e:
                    if e.code != 503:  # 503: no frame yet
                        return e.code
                except urllib.error.URLError:
                    pass
                assert time.time() < deadline, f"timed out on {path}"
                assert proc.poll() is None, proc.stderr.read()[-2000:]
                time.sleep(0.2)

        def state():
            return json.loads(get("/api/state"))

        def wait_for(pred, what, timeout=120):
            deadline = time.time() + timeout
            while True:
                s = state()
                if pred(s):
                    return s
                assert time.time() < deadline, f"{what}: {s}"
                time.sleep(0.2)

        assert b"instantvnr_torch viewer" in get("/")
        img = _png_rgba(get("/frame.png"))
        assert img.shape == (48, 48, 4) and img[..., 3].max() > 0
        s = state()
        assert s["mode"] == "DECODED_SLAB" and s["training"] is True
        assert len(s["modes"]) == 14 and s["errors"] == 0
        assert s["streaming_cache"]["quality"] == "n/a"
        wait_for(lambda s: s["step"] > 0, "training never advanced")
        cv = json.loads(get("/api/curve"))
        assert len(cv["step"]) >= 1 and cv["step"] == sorted(cv["step"])
        # a camera edit re-renders from the new orbit
        f0 = state()["frame"]
        assert get("/api/camera?yaw=2.5&dist=60") == b"ok"
        s = wait_for(lambda s: s["frame"] > f0 + 1, "no frame after a drag")
        assert abs(s["camera"]["yaw"] - 2.5) < 1e-9
        # mode switches, each rendering with training on
        for mode in ("NEURAL_WAVEFRONT", "PATHTRACE_NEURAL",
                     "ISOSURFACE_DECODED"):
            assert get(f"/api/mode?name={mode}") == b"ok"
            f0 = wait_for(lambda s: s["mode"] == mode, mode)["frame"]
            wait_for(lambda s: s["frame"] > f0, f"no frame in {mode}")
        assert get("/api/iso?value=0.35") == b"ok"
        wait_for(lambda s: abs(s["isovalue"] - 0.35) < 1e-9, "iso edit")
        assert get("/api/mode?name=DECODED_SLAB") == b"ok"
        # a TF edit, the density, shading and shadows, then a frame
        spec = json.dumps({"alphas": [[0.0, 0.1], [1.0, 0.9]]}).encode()
        assert get("/api/tf", data=spec) == b"ok"
        for q in ("density?value=1.5", "shading?on=1", "shadows?on=1"):
            assert get("/api/" + q) == b"ok"
        f0 = state()["frame"]
        s = wait_for(lambda s: s["frame"] > f0 + 1 and s["mode"] ==
                     "DECODED_SLAB", "no frame after the edits")
        assert s["errors"] == 0 and s["render_ms"] > 0
        # refused requests, and a bad edit counted, not fatal
        assert get("/api/mode?name=NOPE") == 400
        assert get("/api/tf", data=b"{not json") == 400
        assert get("/nowhere") == 404
        assert get("/api/tf", data=b'{"alphas": 3}') == b"ok"
        s = wait_for(lambda s: s["errors"] == 1, "the bad TF not counted")
        assert "TypeError" in s["last_error"]
        f0 = s["frame"]
        wait_for(lambda s: s["frame"] > f0, "the loop stopped after an error")
        assert get("/api/training?on=0") == b"ok"
        wait_for(lambda s: s["training"] is False, "training not paused")
        assert get("/api/quit") == b"bye"
        proc.wait(timeout=60)
        assert proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
