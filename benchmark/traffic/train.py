"""Training traffic: one client calls `NeuralVolume.train(steps_per_call,
fast_mode=True)` back to back, as a compression job does (a closed loop).

Parameters (benchmark/workloads/<traffic>.json): `batch` samples a step,
`steps_per_call`, `volume_dims` (x, y, z) of the vorts-like volume made
on the card from the seed.

Set-up makes the volume and the weights from the seed (the family's own
initialization, drawn by the benchmark on the card), hands both to the
program, and drives that same NeuralVolume through its first
`CHECK_STEPS` steps, one call each: the loss after each, Adam's first
moment after the first (the gradient as the optimizer took it is
m / (1 − β1)) and the parameters after the last are kept. A call of
`steps_per_call` steps then warms the window's call.

Once the window (and a traced run's profiled window) has closed, the
program's state is copied to the host (parameters, Adam's moments) and
the same NeuralVolume takes one more step, `train(1)`: the step at the
optimizer's count the window left, with its bias correction and decay.

After the program's state is freed, the reference
(benchmark/reference/training.py) runs the first steps from the same
weights on the same coordinates, and the late step from the copied state
on the coordinates of that step (its draw of the seed's stream, counted
by the harness). `correct` compares the losses, the gradients as Adam
took them and the change of the parameters of both.
"""
from __future__ import annotations

import math
import time

from benchmark.harness import Check, data_file
from benchmark.reference import compare, fields, training
from benchmark.reference.volume import vorts

CHECK_STEPS = 3
WEIGHT_STREAM = 0x77656967  # the weights' generator: seed + this


def optimizer_of(cfg: dict) -> dict:
    o = cfg["optimizer"]
    return {**o.get("nested", o), "otype": o["otype"],
            "decay_start": o.get("decay_start", 0),
            "decay_interval": o.get("decay_interval", 1),
            "decay_base": o.get("decay_base", 1.0)}


def port_config(cfg: dict):
    """The configuration as the program's own config objects."""
    from instantvnr_torch.config import load_model_config

    return load_model_config({k: cfg[k] for k in
                              ("optimizer", "loss", "encoding", "network")})


def leaves_of(tree: dict) -> list:
    return [tree["table"], *tree["mlp"]]


def to_host(tree: dict) -> list:
    return [x.detach().to("cpu", copy=True) for x in leaves_of(tree)]


def weights(model, seed: int, device):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed + WEIGHT_STREAM)
    return model.init(gen, device)


class Session:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.batch = int(t["batch"])
        self.chunk = int(t["steps_per_call"])
        self.dims = tuple(int(d) for d in t["volume_dims"])
        self.model = fields.model_for(ctx.config)
        self.limits = data_file(ctx.root, "limits", ctx.cell["name"])
        self.nonfinite = None
        self.steps = 0  # the steps the harness has had the program take
        self.late = None

    def setup(self):
        import torch

        from instantvnr_torch import api
        from instantvnr_torch.data.volume import Volume

        ctx, dev = self.ctx, self.ctx.device
        data = vorts(self.dims, ctx.seed, dev)
        sv = api.SimpleVolume(Volume(data=data, dims=self.dims,
                                     original_range=(0.0, 1.0)), device=dev)
        nv = api.NeuralVolume(port_config(ctx.config), sv, seed=ctx.seed,
                              device=dev, train_batch=self.batch)
        leaves = weights(self.model, ctx.seed, dev)
        nv.params = {"table": leaves[0].clone(),
                     "mlp": [w.clone() for w in leaves[1:]]}
        self.losses, self.first = [], None
        beta1 = float(optimizer_of(ctx.config)["beta1"])
        for i in range(CHECK_STEPS):
            nv.train(1, fast_mode=True)
            self.losses.append(float(nv.state.loss))
            if i == 0:
                self.first = [m.detach().clone() / (1.0 - beta1)
                              for m in leaves_of(nv.state.opt.mu)]
        self.after = [x.detach().clone() for x in leaves_of(nv.params)]
        nv.train(self.chunk, fast_mode=True)
        self.steps = CHECK_STEPS + self.chunk
        self.nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
        self.sv, self.nv = sv, nv

    def run_until(self, deadline: float, spans) -> int:
        import torch

        nv, steps = self.nv, 0
        while True:
            t = time.perf_counter()
            nv.train(self.chunk, fast_mode=True)
            spans.add("train_call", time.perf_counter() - t)
            self.nonfinite += ~torch.isfinite(nv.state.loss)
            steps += self.chunk
            if time.perf_counter() >= deadline:
                break
        self.steps += steps
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        return steps

    def end_to_end(self, units: int, window_s: float, spans) -> dict:
        return {"train_msamples_per_s": units * self.batch / window_s / 1e6}

    def program_counters(self) -> dict:
        return {}

    def failed(self) -> int:
        return int(self.nonfinite) * self.chunk

    def late_step(self):
        """The program's state on the host, then one more step of the same
        NeuralVolume: {step, params, m, v before; loss, params, m after}."""
        nv = self.nv
        before = {"step": self.steps, "params": to_host(nv.params),
                  "m": to_host(nv.state.opt.mu), "v": to_host(nv.state.opt.nu)}
        nv.train(1, fast_mode=True)
        self.steps += 1
        return {**before, "loss": float(nv.state.loss),
                "params_after": to_host(nv.params),
                "m_after": to_host(nv.state.opt.mu)}

    def release(self):
        self.late = self.late_step()
        self.nonfinite = self.nonfinite.cpu()
        del self.nv, self.sv

    def reference_run(self, dtype_name: str, half_batch: bool = False):
        """The reference's CHECK_STEPS from the same weights and coords in
        `dtype_name` → (losses, first gradients, leaves before, after)."""
        ctx, dev = self.ctx, self.ctx.device
        data = vorts(self.dims, ctx.seed, dev)
        leaves0 = weights(self.model, ctx.seed, dev)
        losses, first, after = training.train_steps(
            self.model, leaves0, data, ctx.seed, self.batch, CHECK_STEPS,
            fields.rounding(dtype_name), optimizer_of(ctx.config),
            half_batch=half_batch)
        return losses, first, leaves0, after

    def late_reference(self, dtype_name: str, half_batch: bool = False):
        """The reference's step from the program's state the window left,
        on that step's coordinates → (losses, gradients, leaves before,
        after). The state is the program's: the reference follows it from
        there, as the first steps check the start."""
        ctx, dev, late = self.ctx, self.ctx.device, self.late
        state = {"step": late["step"],
                 "m": [x.to(dev) for x in late["m"]],
                 "v": [x.to(dev) for x in late["v"]]}
        leaves0 = [x.to(dev) for x in late["params"]]
        losses, grads, after = training.train_steps(
            self.model, leaves0, vorts(self.dims, ctx.seed, dev), ctx.seed,
            self.batch, 1, fields.rounding(dtype_name),
            optimizer_of(ctx.config), half_batch=half_batch, state=state,
            skip=late["step"])
        return losses, grads, leaves0, after

    def late_outputs(self):
        """The program's late step: its loss, its gradient as Adam took
        it ((m_after − β1·m) / (1 − β1)) and its parameters around it."""
        late, dev = self.late, self.ctx.device
        b1 = float(optimizer_of(self.ctx.config)["beta1"])
        grads = [((a.double() - b1 * m.double()) / (1.0 - b1)).to(dev)
                 for a, m in zip(late["m_after"], late["m"])]
        return ([late["loss"]], grads,
                [x.to(dev) for x in late["params"]],
                [x.to(dev) for x in late["params_after"]])

    def numbers(self, prog, ref, late_prog, late_ref) -> dict:
        early = compare.training_numbers(*prog, *ref)
        late = compare.training_numbers(*late_prog, *late_ref)
        return {**early, "late_loss_gap": late["loss_gap"],
                "late_grad_gap": late["grad_gap"],
                "late_change_gap": late["change_gap"]}

    def program_outputs(self):
        leaves0 = weights(self.model, self.ctx.seed, self.ctx.device)
        return self.losses, self.first, leaves0, self.after

    def counts(self) -> dict:
        """What the per-layer metrics count from these inputs: the MLP's
        widths and FLOPs a sample (forward once, backward twice), the
        parameters Adam updates a step and, for the hash grid, the
        distinct table rows a step's coordinates touch."""
        import torch

        model = self.model
        out = {"mlp_widths": model.widths(),
               "flops_per_sample": 3 * 2 * model.mlp_macs(),
               "n_params": sum(math.prod(s) for s in model.leaf_shapes())}
        if isinstance(model, fields.HashGridModel):
            gen = training.coord_stream(self.ctx.seed, self.ctx.device)
            coords = torch.rand((self.batch, 3), generator=gen,
                                device=self.ctx.device)
            idx, _ = fields.grid_corners(model.spec, coords)
            out["distinct_rows"] = int(torch.unique(idx).numel())
            out["n_entries"] = model.spec.n_entries
        return out

    def check(self):
        dt = self.ctx.config["compute_dtype"]
        nums = self.numbers(self.program_outputs(), self.reference_run(dt),
                            self.late_outputs(), self.late_reference(dt))
        checks = [Check(k, v, float(self.limits[k])) for k, v in nums.items()]
        return checks, self.counts()

    def calibration(self) -> dict:
        """The readings the limits are set from: the program's, the
        control's (the reference in the configuration's control type, put
        in the program's place) and each fault's that this cell can have
        (the batch's second half left out, the mean taken over the rest).
        A step that returns its state unchanged reads 1 on the change
        numbers by their definition and needs no run."""
        dt, ct = self.ctx.config["compute_dtype"], self.ctx.config[
            "control_dtype"]
        ref, late = self.reference_run(dt), self.late_reference(dt)
        return {
            "program": self.numbers(self.program_outputs(), ref,
                                    self.late_outputs(), late),
            "control": self.numbers(self.reference_run(ct), ref,
                                    self.late_reference(ct), late),
            "faults": {"half_batch": self.numbers(
                self.reference_run(dt, half_batch=True), ref,
                self.late_reference(dt, half_batch=True), late)},
            "late_step": self.late["step"],
        }

