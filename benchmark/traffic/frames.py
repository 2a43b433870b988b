"""Progressive frames of a view held still: one viewer calls `render()`
then `mapframe()`, frame after frame (a closed loop); each render adds one
jittered pass to the accumulation.

Parameters (benchmark/workloads/<traffic>.json): `width`, `height`, the
`camera`, the `transfer_function`, `volume_dims` of the vorts-like ground
truth (it sets the macrocells and the world box), `scene_seed` (the one
scene every run looks at: the volume and the base field),
`weight_jitter` (the share of the run's own seeded draw in the field, so
that each seed checks its own field while the work stays alike),
`streaming_cache` (the facade's policy; the reference follows "none",
the network at every sample), `march` (the facade's n_iters and
max_skips for that policy, which the reference marches with),
`warm_frames` (rendered in set-up, so that the compacted path's bucket
programs, its replays and the fused whole-frame graph are built before
the window) and `checked_frames`.

The weights are the hash grid's serving form, drawn by the benchmark on
the card (`serving_weights`): the table uniform in ±1, the MLP He-normal
(an untrained ±1e-4 table decodes to a transparent frame).

`correct`: frames drawn from the seed in the window, and the window's last
frame, are kept with the frame before each. A frame is the mean of its k
passes, so k·frame_k − (k − 1)·frame_(k−1) is pass k as the program made
it. The reference renders pass k itself (benchmark/reference/frame.py):
the same rays, the jitter of the renderer's k-th draw (its documented
stream: a generator on the card seeded 0, one uniform a pixel a frame),
the macrocells worked out again from the volume and the transfer
function, and the sample: the network in the configuration's compute
type.
"""
from __future__ import annotations

import statistics
import time

import numpy as np

from benchmark.harness import Check, data_file
from benchmark.reference import fields
from benchmark.reference import frame as rf
from benchmark.reference.volume import vorts
from benchmark.traffic.train import port_config

SERVING_STREAM = 0x73657276  # the weights' generator: seed + this
JITTER_SEED = 0  # the renderer's jitter stream (render/renderer.py)
PROBES = 1 << 16
SERVING_STD = 0.3
# pixels a pass may differ in beyond pass_tail_gap: rays whose value is a
# discontinuous function of the last bit of a sample
TAIL_PIXELS = 26


def serving_weights(model, seed: int, device, traffic: dict):
    """The field the frames show: the serving form's weights (the table
    uniform in ±1, the MLP He-normal) of the traffic's fixed
    `scene_seed`, plus `weight_jitter` times a draw of the same form from
    the run's seed, with the last layer then scaled (and its sign chosen)
    so that the field's values over PROBES uniform points have a positive
    mean and the standard deviation SERVING_STD. Every seed so shows its
    own field of like opacity over one scene, and so does like work."""
    import torch

    def draw(s):
        gen = torch.Generator(device=device).manual_seed(s + SERVING_STREAM)
        return model.init_serving(gen, device), gen

    base, _ = draw(int(traffic["scene_seed"]))
    noise, gen = draw(seed)
    eps = float(traffic["weight_jitter"])
    leaves = [b + eps * n for b, n in zip(base, noise)]
    probes = torch.rand((PROBES, 3), generator=gen, device=device)
    with torch.no_grad():
        v = model.apply(leaves, probes, fields.rounding("float32"))[:, 0]
    scale = SERVING_STD / float(v.std())
    if float(v.mean()) < 0:
        scale = -scale
    return leaves[:-1] + [leaves[-1] * scale]


class Session:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.w, self.h = int(t["width"]), int(t["height"])
        self.dims = tuple(int(d) for d in t["volume_dims"])
        self.cache = t["streaming_cache"]
        if self.cache != "none":
            raise ValueError("the reference follows streaming_cache "
                             f"'none' only, not {self.cache!r}")
        self.model = fields.model_for(ctx.config)
        self.limits = data_file(ctx.root, "limits", ctx.cell["name"])
        self.check_idx = None
        self.kept = {}
        self.last_pair = None
        self.supersteps = []

    def _tf_config(self):
        from instantvnr_torch.config import TransferFunctionConfig

        tf = self.ctx.traffic["transfer_function"]
        return TransferFunctionConfig(
            colors=tuple(tuple(c) for c in tf["colors"]),
            alphas=tuple(tuple(a) for a in tf["alphas"]),
            range=tuple(tf["range"]))

    def setup(self):
        from instantvnr_torch import api
        from instantvnr_torch.data.volume import Volume
        from instantvnr_torch.render.camera import Camera

        ctx, dev = self.ctx, self.ctx.device
        data = vorts(self.dims, int(ctx.traffic["scene_seed"]), dev)
        sv = api.SimpleVolume(Volume(data=data, dims=self.dims,
                                     original_range=(0.0, 1.0)),
                              tfn_cfg=self._tf_config(), device=dev)
        nv = api.NeuralVolume(port_config(ctx.config), sv, seed=ctx.seed,
                              device=dev)
        leaves = serving_weights(self.model, ctx.seed, dev, ctx.traffic)
        nv.params = {"table": leaves[0].clone(),
                     "mlp": [w.clone() for w in leaves[1:]]}
        r = api.VNRenderer(nv, self.w, self.h,
                           mode=api.RenderMode.NEURAL_WAVEFRONT,
                           streaming_cache=self.cache)
        cam = ctx.traffic["camera"]
        r.set_camera(Camera(eye=tuple(cam["eye"]),
                            center=tuple(cam["center"]),
                            up=tuple(cam["up"]), fovy=float(cam["fovy"])))
        # the compacted path's bucket programs (on the card their graphs)
        warmup = getattr(r._impl, "warmup", None)
        if warmup is not None:
            warmup()
        times = []
        prev = None
        for _ in range(int(self.ctx.traffic["warm_frames"])):
            t0 = time.perf_counter()
            r.render()
            prev = r.mapframe()
            times.append(time.perf_counter() - t0)
        self.frame_s = statistics.median(times[-4:])
        self.done = len(times)
        self.prev = prev
        self.sv, self.nv, self.r = sv, nv, r

    def _draw_checked(self, deadline: float):
        """Frames of the window to check, drawn from the seed among those
        the window should reach, as the count of passes each shows."""
        expect = max(int(0.8 * (deadline - time.perf_counter())
                         / self.frame_s), 2)
        rng = np.random.default_rng([self.ctx.seed & 0xFFFFFFFF,
                                     self.ctx.seed >> 32, 0x6672])
        n = int(self.ctx.traffic["checked_frames"])
        self.check_idx = set(self.done + int(j)
                             for j in rng.integers(1, expect, size=n))

    def run_until(self, deadline: float, spans) -> int:
        import torch

        first_window = self.check_idx is None
        if first_window:
            self._draw_checked(deadline)
        r, prev, n = self.r, self.prev, 0
        while True:
            t0 = time.perf_counter()
            r.render()
            t1 = time.perf_counter()
            steps = r.last_stats.get("supersteps")
            if steps is not None and first_window:
                self.supersteps.append(steps)
            img = r.mapframe()
            t2 = time.perf_counter()
            spans.add("render", t1 - t0)
            spans.add("frame", t2 - t0)
            self.done += 1
            k = self.done
            if first_window and k in self.check_idx:
                self.kept[k] = (prev, img)
            if first_window:
                self.last_pair = (k, prev, img)
            prev = img
            n += 1
            if t2 >= deadline:
                break
        self.prev = prev
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        return n

    def end_to_end(self, units: int, window_s: float, spans) -> dict:
        ms = np.asarray(spans.values("frame")) * 1e3
        return {"frame_fps": units / window_s,
                "frame_ms_p95": float(np.percentile(ms, 95))}

    def program_counters(self) -> dict:
        return {"supersteps_per_frame": (
            statistics.mean(self.supersteps) if self.supersteps else None)}

    def failed(self) -> int:
        return 0

    def release(self):
        k, prev, img = self.last_pair
        self.kept[k] = (prev, img)
        del self.r, self.nv, self.sv
        self.prev = None

    # -- the reference -------------------------------------------------------

    def scene(self):
        import torch

        dev = self.ctx.device
        data = vorts(self.dims, int(self.ctx.traffic["scene_seed"]), dev)
        tf = self.ctx.traffic["transfer_function"]
        march = self.ctx.traffic["march"]
        tfr = rf.bake_tf(tf["colors"], tf["alphas"], tf["range"], dev)
        sc = rf.make_scene(data, self.dims, tfr, self.ctx.traffic["camera"],
                           self.w, self.h, int(march["n_iters"]),
                           int(march["max_skips"]))
        return sc, torch.Generator(device=dev)

    def sample_fn(self, dtype_name: str):
        """The network's sample, from the weights the benchmark drew."""
        dev = self.ctx.device
        rnd = fields.rounding(dtype_name)
        leaves = serving_weights(self.model, self.ctx.seed, dev,
                                 self.ctx.traffic)

        def net(p):
            return self.model.apply(leaves, p, rnd)[:, 0]

        return rf.chunked(net)

    def passes(self, dtype_name: str, ks):
        """The reference's pass k for each k → {k: (rgba, samples)}."""
        import torch

        scene, gen = self.scene()
        gen.manual_seed(JITTER_SEED)
        fn = self.sample_fn(dtype_name)
        out = {}
        for j in range(1, max(ks) + 1):
            jitter = torch.rand((self.w * self.h,), generator=gen,
                                dtype=torch.float32, device=gen.device)
            if j in ks:
                rgba, samples, _ = rf.render_pass(scene, fn, jitter)
                out[j] = (rgba.double().cpu().numpy(), samples)
        return out

    def program_passes(self) -> dict:
        """{k: pass k as the program made it}: frame k is the mean of k
        passes, so pass k is k·frame_k − (k − 1)·frame_(k−1)."""
        out = {}
        for k, (prev, img) in self.kept.items():
            a = img.reshape(-1, 4).astype(np.float64)
            b = prev.reshape(-1, 4).astype(np.float64)
            out[k] = k * a - (k - 1) * b
        return out

    @staticmethod
    def numbers(prog: dict, ref: dict) -> dict:
        """Of the passes a checked frame added, against the reference's:
        pass_mean_gap, the mean channel gap; pass_tail_gap, the largest
        pixel gap (over the channels) once the TAIL_PIXELS widest of the
        frame are set aside; each the worst checked frame."""
        gaps = [np.abs(prog[k] - ref[k]) for k in prog]
        return {"pass_mean_gap": float(max(g.mean() for g in gaps)),
                "pass_tail_gap": float(max(
                    np.sort(g.max(axis=1))[-TAIL_PIXELS - 1] for g in gaps))}

    def check(self):
        prog = self.program_passes()
        ref = self.passes(self.ctx.config["compute_dtype"], set(prog) | {1})
        nums = self.numbers(prog, {k: ref[k][0] for k in prog})
        checks = [Check(k, v, float(self.limits[k])) for k, v in nums.items()]
        return checks, {"samples_per_frame": ref[1][1],
                        "flops_per_sample": 2 * self.model.mlp_macs()}

    def calibration(self) -> dict:
        """The program's readings, the control's (the reference in the
        configuration's control type in the program's place) and two
        faults': a pass that repeats the one before (a render that left
        its state where it was), and one whose second half of the rays is
        left out. `look`: the widest pixel gap of the checked passes,
        beside the reference in float32, which shows whether that pixel's
        value turns on the last bits of its samples."""
        cfg = self.ctx.config
        prog = self.program_passes()
        ref = self.passes(cfg["compute_dtype"],
                          set(prog) | {k - 1 for k in prog})
        ctl = self.passes(cfg["control_dtype"], set(prog))
        main = {k: ref[k][0] for k in prog}
        stale = {k: ref[k - 1][0] for k in prog}
        half = {}
        for k in prog:
            x = main[k].copy()
            x[x.shape[0] // 2:] = 0.0
            half[k] = x
        worst = max(prog, key=lambda j: np.abs(prog[j] - main[j]).max())
        px = int(np.argmax(np.abs(prog[worst] - main[worst]).max(axis=1)))
        f32 = self.passes("float32", {worst})[worst][0]
        look = {"frame": worst, "pixel": px,
                "program": prog[worst][px].tolist(),
                "reference": main[worst][px].tolist(),
                "reference_float32": f32[px].tolist(),
                "float32_against_reference": self.numbers(
                    {worst: f32}, {worst: main[worst]})}
        return {"program": self.numbers(prog, main),
                "control": self.numbers(
                    {k: ctl[k][0] for k in prog}, main),
                "faults": {"stale_pass": self.numbers(stale, main),
                           "half_rays": self.numbers(half, main)},
                "look": look}
