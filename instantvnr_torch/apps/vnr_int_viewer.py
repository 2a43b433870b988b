"""Interactive neural-volume viewer, a web page with no dependencies: the
port's `vnr_int_viewer` (counterpart of `apps/vnr_int_viewer.py`; the
reference's GUI apps).

It covers both `vnr_int_single` (view a trained model: drag to orbit,
switch render modes live; apps/int_volume.cpp:375-427) and `vnr_int_dual`
(online training inside the render loop, progressive decode so the view
sharpens as it learns; apps/int_dual_volume.cpp:498-699). The browser
stands in for ImGui, HTTP polling for the swapchain.

User edits land as pending values (vidi::TransactionalValue,
int_volume.cpp:389-427) that one render thread applies between frames;
training steps and progressive decode blobs run in the same loop
(int_dual_volume.cpp:662-674). While the server runs, the render thread is
the only one that touches the card: the HTTP handlers swap pending values
and read what the loop last published (the PNG, the step and loss, the
mode), under a lock.

    # online training (int_dual):
    python -m instantvnr_torch.apps.vnr_int_viewer --synthetic vorts \\
        --dims 64 --port 8642
    # view a trained model (int_single):
    python -m instantvnr_torch.apps.vnr_int_viewer --load params.npz

then open http://127.0.0.1:8642/ (drag orbits, the wheel zooms, the
toolbar switches render modes and pauses or resumes training). `--port 0`
takes a free port; the first line printed names it.
"""
from __future__ import annotations

import argparse
import json
import math
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from instantvnr_torch.apps.common import (
    add_device_arg,
    add_model_args,
    add_volume_args,
    framebuffer_to_u8,
    interactive_model_config,
    load_simple_volume,
    png_bytes,
)

_PAGE = """<!doctype html>
<html><head><title>instantvnr_torch viewer</title><style>
 body { background:#181818; color:#ddd; font:13px monospace; margin:12px }
 #view { border:1px solid #444; image-rendering:pixelated; cursor:grab }
 #bar { margin:6px 0 } select,button,label { font:inherit }
 #stats { color:#8c8 }
</style></head><body>
<div id="bar">
 mode <select id="mode"></select>
 <label><input type="checkbox" id="train"> train</label>
 <label><input type="checkbox" id="shade"> shading</label>
 <label><input type="checkbox" id="shadow"> shadows</label>
 iso <input type="range" id="iso" min="0" max="1" step="0.01" value="0.5"
   style="vertical-align:middle">
 density <input type="range" id="den" min="-1" max="1" step="0.05" value="0"
   style="vertical-align:middle">
 <span id="stats"></span>
</div>
<img id="view" draggable="false">
<div><canvas id="curve" width="512" height="90"
  style="border:1px solid #333; background:#111"></canvas></div>
<script>
const img = document.getElementById('view');
let cam = null, drag = null;
async function state() {
  const s = await (await fetch('/api/state')).json();
  if (cam === null) cam = s.camera;
  const sel = document.getElementById('mode');
  if (!sel.options.length) {
    for (const m of s.modes) {
      const o = document.createElement('option');
      o.value = o.textContent = m; sel.appendChild(o);
    }
    sel.onchange = () => fetch('/api/mode?name=' + sel.value);
    const tr = document.getElementById('train');
    tr.onchange = () => fetch('/api/training?on=' + (tr.checked ? 1 : 0));
    const iso = document.getElementById('iso');
    iso.oninput = () => fetch('/api/iso?value=' + iso.value);
    const den = document.getElementById('den');
    den.onchange = () =>
      fetch('/api/density?value=' + Math.pow(10, den.value));
    const sh = document.getElementById('shade');
    sh.onchange = () => fetch('/api/shading?on=' + (sh.checked ? 1 : 0));
    const sv = document.getElementById('shadow');
    sv.onchange = () => fetch('/api/shadows?on=' + (sv.checked ? 1 : 0));
  }
  sel.value = s.mode;
  document.getElementById('train').checked = s.training;
  let extra = '';
  if (s.streaming_cache && s.streaming_cache.quality !== 'n/a')
    extra = `  [cache ${s.streaming_cache.resolved}: `
          + `${s.streaming_cache.quality}]`;
  if (s.errors) extra += `  errors ${s.errors}: ${s.last_error}`;
  document.getElementById('stats').textContent =
    ` step ${s.step}  loss ${s.loss.toFixed(5)}  ${s.fps.toFixed(1)} fps`
    + ` (render ${s.render_ms.toFixed(1)} ms, png ${s.encode_ms.toFixed(1)}`
    + ' ms)' + extra;
}
// live training curve (int_dual_volume.cpp:426-431 implot panel)
async function curve() {
  const c = await (await fetch('/api/curve')).json();
  const cv = document.getElementById('curve'), g = cv.getContext('2d');
  g.clearRect(0, 0, cv.width, cv.height);
  if (c.step.length < 2) return;
  const ls = c.loss.map(v => Math.log10(Math.max(v, 1e-8)));
  const lmin = Math.min(...ls), lmax = Math.max(...ls, lmin + 1e-6);
  const smin = c.step[0], smax = c.step[c.step.length - 1];
  g.strokeStyle = '#8c8'; g.beginPath();
  for (let i = 0; i < ls.length; i++) {
    const x = (c.step[i] - smin) / Math.max(smax - smin, 1) * (cv.width - 8) + 4;
    const y = cv.height - 6 - (ls[i] - lmin) / (lmax - lmin) * (cv.height - 12);
    i ? g.lineTo(x, y) : g.moveTo(x, y);
  }
  g.stroke();
  g.fillStyle = '#888'; g.font = '10px monospace';
  g.fillText(`loss ${c.loss[c.loss.length-1].toExponential(2)} @ ${smax}`,
             6, 12);
}
function sendCam() {
  fetch(`/api/camera?yaw=${cam.yaw}&pitch=${cam.pitch}&dist=${cam.dist}`);
}
img.onmousedown = e => { drag = [e.clientX, e.clientY]; };
window.onmouseup = () => { drag = null; };
window.onmousemove = e => {
  if (!drag || !cam) return;
  cam.yaw += (e.clientX - drag[0]) * 0.01;
  cam.pitch = Math.max(-1.5, Math.min(1.5,
    cam.pitch + (e.clientY - drag[1]) * 0.01));
  drag = [e.clientX, e.clientY]; sendCam();
};
img.onwheel = e => {
  if (!cam) return;
  cam.dist *= Math.exp(e.deltaY * 0.001); sendCam(); e.preventDefault();
};
setInterval(() => { img.src = '/frame.png?t=' + Date.now(); }, 150);
setInterval(state, 500); state();
setInterval(curve, 1000); curve();
</script></body></html>"""


@dataclass
class Orbit:
    """Spherical orbit camera (the GUI apps' arcball)."""

    yaw: float
    pitch: float
    dist: float
    center: tuple = (0.0, 0.0, 0.0)

    def to_camera(self):
        from instantvnr_torch.render.camera import Camera

        cp, sp = math.cos(self.pitch), math.sin(self.pitch)
        cy, sy = math.cos(self.yaw), math.sin(self.yaw)
        eye = (self.center[0] + self.dist * cp * sy,
               self.center[1] + self.dist * sp,
               self.center[2] - self.dist * cp * cy)
        return Camera(eye=eye, center=self.center, up=(0, 1, 0), fovy=45)

    @classmethod
    def default_for_dims(cls, dims):
        d = max(dims)
        # the apps' default eye (0.15d, 0.1d, -2d), in spherical form
        dist = math.sqrt(0.15**2 + 0.1**2 + 4.0) * d
        return cls(yaw=math.atan2(0.15 * d, 2.0 * d),
                   pitch=math.asin(0.1 * d / dist), dist=dist)


class ViewerApp:
    """The render loop and the state it shares with the HTTP handlers.

    The handlers write pending edits and read `published` (plain Python
    values and the PNG bytes) under `lock`; only `loop` calls the
    renderer or the neural volume."""

    MAX_ACCUM = 32  # frames rendered after the last edit (accumulation)

    def __init__(self, renderer, nv=None, train_steps=10, blobs=2,
                 refresh_bricks=64, training=False):
        from instantvnr_torch.api import RenderMode

        self.renderer = renderer
        self.nv = nv
        self.device = (nv or renderer.simple).device
        if self.device.type == "cuda" and self.device.index is None:
            import torch

            # the card the volume was made on: the creating thread's
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.train_steps = train_steps
        # bricks of the streaming cache re-decoded a trained frame
        # (round-robin; bounds the frame's hitch, api.refresh_params)
        self.refresh_bricks = refresh_bricks
        self.blobs = blobs
        self.lock = threading.Lock()
        self.orbit = Orbit.default_for_dims(
            (renderer.neural or renderer.simple).dims)
        self.training = training and self._can_train()
        self.pending_mode = None
        self.pending_tf = None  # a TF spec dict (the GUI TF editor's edit)
        self.pending_density = None
        self.pending_shading = None  # "none" | "gradient"
        self.pending_shadows = None  # bool
        self.pending_isovalue = None  # float
        self.dirty = True
        self.stop_event = threading.Event()
        self.png = b""
        self.frame_id = 0
        self.fps = 0.0
        # a caught exception of the loop is counted and its message kept,
        # so that a failure shows in /api/state
        self.errors = 0
        self.last_error = ""
        # the training curve (step, loss, fps): the int_dual live plot
        # (int_dual_volume.cpp:426-431)
        self.curve = deque(maxlen=512)
        # each served frame's (train_ms, render_ms, encode_ms): the PNG
        # encode runs on the host, apart from the render
        self.timings = deque(maxlen=4096)
        self.modes = []
        for m in RenderMode:
            needs_simple = m.name.startswith("REFERENCE") or m.name in (
                "PATHTRACE_REFERENCE", "ISOSURFACE_REFERENCE",
                "FULL_SHADOW_REFERENCE")
            if (renderer.simple if needs_simple else nv) is not None:
                self.modes.append(m.name)
        self._accum_left = self.MAX_ACCUM
        self.published = {}
        self._publish()

    def _can_train(self) -> bool:
        # training needs a ground truth: a checkpoint alone cannot train
        return self.nv is not None and self.nv.simple is not None

    def _publish(self):
        """Copy the renderer's and the volume's state into plain values for
        the handlers (the render thread's own reads of the card)."""
        st = self.nv.statistics() if self.nv is not None else None
        pub = {"mode": self.renderer.mode.name,
               "isovalue": self.renderer.isovalue,
               "streaming_cache": self.renderer.streaming_cache_info,
               "step": st.step if st else 0,
               "loss": st.loss if st else 0.0}
        with self.lock:
            self.published = pub

    # ---- the render loop (the reference's background_work thread) -------

    def loop(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self.stop_event.is_set():
            try:
                self._loop_once()
            except Exception as e:  # noqa: BLE001 (a bad edit, e.g. a
                # malformed TF spec, must not end the render thread: the
                # edit is consumed, the error counted and shown)
                traceback.print_exc()
                with self.lock:
                    self.errors += 1
                    self.last_error = f"{type(e).__name__}: {e}"
                time.sleep(0.1)

    def _apply_edits(self) -> bool:
        """Apply the pending edits to the renderer; → whether any was."""
        from instantvnr_torch.api import RenderMode
        from instantvnr_torch.config import TransferFunctionConfig

        with self.lock:
            dirty, self.dirty = self.dirty, False
            mode, self.pending_mode = self.pending_mode, None
            tf_spec, self.pending_tf = self.pending_tf, None
            density, self.pending_density = self.pending_density, None
            iso, self.pending_isovalue = self.pending_isovalue, None
        r = self.renderer
        if mode is not None:
            r.set_mode(RenderMode[mode])
            dirty = True
        if tf_spec is not None:
            # the GUI TF editor's edit: the macrocell's max opacity follows
            # through set_transfer_function (int_volume.cpp:389-427)
            base = TransferFunctionConfig()
            r.set_transfer_function(TransferFunctionConfig(
                colors=tuple(tuple(c) for c in
                             tf_spec.get("colors", base.colors)),
                alphas=tuple(tuple(a) for a in
                             tf_spec.get("alphas", base.alphas)),
                range=tuple(tf_spec.get("range", base.range))))
            dirty = True
        if density is not None:
            r.set_volume_density_scale(density)
            dirty = True
        if iso is not None:
            r.set_isovalue(iso)
            dirty = True
        if r.mode == RenderMode.DECODED_SLAB:
            # shading and shadows apply to the decoded path alone; in other
            # modes they stay pending, so that checking the box and then
            # switching to DECODED_SLAB honours it
            with self.lock:
                shading, self.pending_shading = self.pending_shading, None
                shadows, self.pending_shadows = self.pending_shadows, None
            if shading is not None:
                r.set_slab_shading(shading)
                dirty = True
            if shadows is not None:
                if shadows:
                    r.enable_shadows()
                else:
                    r.disable_shadows()
                dirty = True
        return dirty

    def _loop_once(self):
        from instantvnr_torch.api import RenderMode
        from instantvnr_torch.utils.profiling import sync

        t0 = time.perf_counter()
        dirty = self._apply_edits()
        with self.lock:
            cam = self.orbit.to_camera()
            training = self.training
        r = self.renderer
        trained = False
        if training:
            # the training slice of int_dual_volume.cpp:662-674
            self.nv.train(self.train_steps, fast_mode=False)
            st = self.nv.statistics()
            with self.lock:
                self.curve.append((int(st.step), float(st.loss), self.fps))
            if r.mode == RenderMode.DECODED_SLAB:
                # the progressive decode feeds the decoded-slab grid alone;
                # refresh_params below rebinds the network-sampling modes
                self.nv.decode_progressive(self.blobs)
            trained = True
        if dirty:
            r.set_camera(cam)
            self._accum_left = self.MAX_ACCUM
        if trained:
            r.refresh_params(budget_bricks=self.refresh_bricks or None)
            r.reset_accumulation()
            self._accum_left = self.MAX_ACCUM
        if dirty or trained:
            self._publish()
        if self._accum_left <= 0:
            time.sleep(0.03)
            return
        self._accum_left -= 1
        if training:
            sync(self.nv.params)
        t1 = time.perf_counter()
        r.render()
        frame = r.mapframe()  # the host copy waits for the frame
        t2 = time.perf_counter()
        png = png_bytes(framebuffer_to_u8(frame))
        t3 = time.perf_counter()
        with self.lock:
            self.png = png
            self.frame_id += 1
            self.fps = 1.0 / max(t3 - t0, 1e-9)
            self.timings.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                                 (t3 - t2) * 1e3))

    # ---- /api/state ------------------------------------------------------

    def state(self) -> dict:
        with self.lock:
            last = self.timings[-1] if self.timings else (0.0, 0.0, 0.0)
            s = dict(self.published)
            s.update({
                "frame": self.frame_id, "modes": self.modes,
                "training": self.training, "fps": self.fps,
                "train_ms": last[0], "render_ms": last[1],
                "encode_ms": last[2],
                "camera": {"yaw": self.orbit.yaw, "pitch": self.orbit.pitch,
                           "dist": self.orbit.dist},
                "errors": self.errors, "last_error": self.last_error})
        # the schedule replay's counters of the compacted wavefront and
        # path tracer (render/compaction.py), as the JAX viewer reports them
        sc = getattr(self.renderer._impl, "_sched_cache", None)
        if sc:
            s["replay"] = {k: sc.get(k, 0)
                           for k in ("replays", "serialized", "invalidated")}
        return s


def make_handler(app: ViewerApp, server_holder):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="text/plain"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0) or 0)
            self._body = self.rfile.read(length) if length else b""
            self.do_GET()

        def _json(self, obj):
            return self._send(200, json.dumps(obj).encode(),
                              "application/json")

        def do_GET(self):
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            if url.path == "/":
                return self._send(200, _PAGE.encode(), "text/html")
            if url.path == "/frame.png":
                with app.lock:
                    png = app.png
                if not png:
                    return self._send(503, b"no frame yet")
                return self._send(200, png, "image/png")
            if url.path == "/api/state":
                return self._json(app.state())
            if url.path == "/api/curve":
                with app.lock:
                    pts = list(app.curve)
                return self._json({"step": [p[0] for p in pts],
                                   "loss": [p[1] for p in pts],
                                   "fps": [p[2] for p in pts]})
            if url.path == "/api/camera":
                with app.lock:
                    o = app.orbit
                    app.orbit = Orbit(yaw=float(q.get("yaw", o.yaw)),
                                      pitch=float(q.get("pitch", o.pitch)),
                                      dist=float(q.get("dist", o.dist)),
                                      center=o.center)
                    app.dirty = True
                return self._send(200, b"ok")
            if url.path == "/api/mode":
                name = q.get("name", "")
                if name not in app.modes:
                    return self._send(400, b"unknown mode")
                with app.lock:
                    app.pending_mode = name
                return self._send(200, b"ok")
            if url.path == "/api/iso":
                with app.lock:
                    app.pending_isovalue = float(q.get("value", 0.5))
                return self._send(200, b"ok")
            if url.path == "/api/tf":
                try:
                    spec = json.loads(getattr(self, "_body", b"")
                                      or q.get("spec", ""))
                except ValueError:
                    return self._send(400, b"bad tf json")
                with app.lock:
                    app.pending_tf = spec
                return self._send(200, b"ok")
            if url.path == "/api/density":
                with app.lock:
                    app.pending_density = float(q.get("value", 1.0))
                return self._send(200, b"ok")
            if url.path == "/api/shading":
                with app.lock:
                    app.pending_shading = ("gradient"
                                           if q.get("on", "0") == "1"
                                           else "none")
                return self._send(200, b"ok")
            if url.path == "/api/shadows":
                with app.lock:
                    app.pending_shadows = q.get("on", "0") == "1"
                return self._send(200, b"ok")
            if url.path == "/api/training":
                with app.lock:
                    app.training = (q.get("on", "0") == "1"
                                    and app._can_train())
                return self._send(200, b"ok")
            if url.path == "/api/quit":
                self._send(200, b"bye")
                app.stop_event.set()
                threading.Thread(target=server_holder[0].shutdown,
                                 daemon=True).start()
                return None
            return self._send(404, b"not found")

    return Handler


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_volume_args(p)
    add_model_args(p)
    add_device_arg(p)
    p.add_argument("--load", help="trained checkpoint (viewed as "
                   "vnr_int_single does)")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8642)
    p.add_argument("--mode", default=None,
                   help="initial render mode name (default: DECODED_SLAB "
                   "for a neural volume, REFERENCE_RAYMARCH otherwise)")
    p.add_argument("--train-steps-per-frame", type=int, default=10)
    p.add_argument("--infer-blobs-per-frame", type=int, default=2)
    p.add_argument("--refresh-bricks-per-frame", type=int, default=64,
                   help="streaming-cache bricks re-decoded a trained frame "
                   "(0: a full rebuild each refresh)")
    p.add_argument("--streaming-cache", default="auto",
                   choices=("auto", "brick", "hq", "lazy", "none"),
                   help="sample-streaming policy of the NEURAL_WAVEFRONT* "
                   "modes (hq: the 2x-supersampled pool; lazy: bricks "
                   "decoded at first visibility; none: exact network "
                   "sampling)")
    p.add_argument("--pause-training", action="store_true")
    p.add_argument("--view-only", action="store_true",
                   help="view the ground-truth volume without a network")
    args = p.parse_args(argv)
    if not (args.load or args.synthetic or args.scene):
        p.error("need --load, --synthetic or --scene")
    return args


def build_app(args) -> ViewerApp:
    """The volume, the renderer and the app the arguments name."""
    from instantvnr_torch.api import NeuralVolume, RenderMode, VNRenderer

    nv = None
    training = False
    if args.load:
        nv = NeuralVolume.from_checkpoint(args.load, device=args.device)
        volume = nv
    elif args.view_only:
        # ground truth alone (no network): the REFERENCE_* modes,
        # PATHTRACE_REFERENCE and ISOSURFACE_REFERENCE
        volume = load_simple_volume(args)
    else:
        nv = NeuralVolume(interactive_model_config(args),
                          simple=load_simple_volume(args), seed=args.seed,
                          train_batch=args.batch, device=args.device)
        volume = nv
        training = not args.pause_training
    mode = (RenderMode[args.mode] if args.mode
            else (RenderMode.DECODED_SLAB if nv is not None
                  else RenderMode.REFERENCE_RAYMARCH))
    renderer = VNRenderer(volume, args.size, args.size, mode=mode,
                          streaming_cache=args.streaming_cache)
    return ViewerApp(renderer, nv=nv,
                     train_steps=args.train_steps_per_frame,
                     refresh_bricks=args.refresh_bricks_per_frame,
                     blobs=args.infer_blobs_per_frame, training=training)


def serve(app: ViewerApp, host: str, port: int):
    """Bind the HTTP server and start the render thread; → (server,
    render thread). The caller runs server.serve_forever(); /api/quit
    ends both."""
    holder = [None]
    server = ThreadingHTTPServer((host, port), make_handler(app, holder))
    holder[0] = server
    server.daemon_threads = True
    thread = threading.Thread(target=app.loop, daemon=True)
    thread.start()
    return server, thread


def main(argv=None):
    args = parse_args(argv)
    app = build_app(args)
    server, thread = serve(app, args.host, args.port)
    print(f"[vnr] serving on http://{args.host}:{server.server_address[1]}/",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        app.stop_event.set()
        thread.join(timeout=30)
        server.server_close()
    print("[vnr] viewer stopped")
    return app


if __name__ == "__main__":
    main()
