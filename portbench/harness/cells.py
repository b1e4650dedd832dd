"""The cell drivers, one per traffic kind: set-up, the measured window,
the profiled calls of a ``--trace 1`` run, and the output check.

Each driver is built from a configuration file and a traffic file
(``BENCHMARK.json`` names both) and ``--seed``; nothing in it names a
cell or an architecture: the configuration's reference module
(``self.arch``, :mod:`portbench.reference` gives its contract) supplies
the reference, the leaves and the work count.  ``device`` is the card;
the CPU is for the tests, which drive the same code at tiny sizes.
"""

import time

import numpy as np
import torch

from portbench.harness import compare, plugins, program, scenes, trace
from portbench.reference import tiles as ref_tiles
from portbench.reference import train as ref_train

# calls profiled in a --trace 1 run
PROFILED_CALLS = {"predict": 8, "train": 3, "plot": 1}
# set-up calls before the window (cuDNN plans, the kernels' first use)
WARMUP_CALLS = 3


def make(kind, conf, traffic, seed, root, device="cuda"):
    """The driver of a traffic ``kind``."""
    return {"predict": PredictCell, "train": TrainCell,
            "plot": PlotCell}[kind](conf, traffic, seed, root, device)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _record():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def percentile(values, q):
    return float(np.percentile(np.asarray(values, np.float64), q))


class Cell:
    kind = None

    def __init__(self, conf, traffic, seed, root, device):
        self.conf, self.traffic, self.seed = conf, traffic, int(seed)
        self.root, self.device = root, device
        self.model_cfg = conf["model"]
        self.arch = plugins.architecture(conf, root)
        self.spec = self.arch.Spec(self.model_cfg)
        self.flops = self.arch.forward_flops(self.model_cfg)
        self.stages = {}

    def setup(self):
        import sys

        marks = [("start", time.perf_counter())]
        self.weights = program.make_weights(self.arch, self.conf, self.seed,
                                            self.root, self.device)
        self.model = program.build_model(self.conf, self.weights,
                                         self.device)
        _sync(self.device)
        marks.append(("weights and model", time.perf_counter()))
        self.pool = scenes.make_pool(self.traffic, self.seed, self.root)
        marks.append(("pool", time.perf_counter()))
        self._prepare()
        _sync(self.device)
        marks.append(("warm-up", time.perf_counter()))
        print("set-up: " + ", ".join(
            f"{name} {t - marks[i][1]:.2f} s"
            for i, (name, t) in enumerate(marks[1:])), file=sys.stderr)

    def window(self, seconds, traced=False):
        """Calls in a closed loop until ``seconds`` have passed; returns
        (attempted, failed, {end-to-end metric: value})."""
        self.traced = traced
        lat = []
        failed = 0
        i = 0
        t0 = time.perf_counter()
        while True:
            ts = time.perf_counter()
            ok = self.call(i)
            te = time.perf_counter()
            lat.append(te - ts)
            failed += not ok
            i += 1
            if te - t0 >= seconds:
                break
        self.window_s = te - t0
        self.latencies = lat
        self.traced = False
        return i, failed, self._rates(i, self.window_s, lat)

    def profile(self):
        calls = PROFILED_CALLS[self.kind]
        start = getattr(self, "next_call", 0)
        tr, window_s = trace.profiled(lambda i: self.call(start + i), calls)
        work, encoder_bytes = self.work(range(start, start + calls))
        return trace.record(
            self.kind, self.model_cfg, work, encoder_bytes, tr, window_s,
            calls, self.clouds_per_call, self.stages, self.phases)

    def work(self, calls):
        """(forward FLOPs of one cloud by stage, the encoder's least bytes)
        of the calls ``calls``: the mean of ``arch.call_work`` over their
        clouds where the architecture counts a call's own active sites,
        else its static count of the configuration."""
        count = getattr(self.arch, "call_work", None)
        if count is None:
            return self.flops, self.arch.encoder_bytes(self.model_cfg)
        with torch.no_grad():
            works = [count(self.spec, c) for i in calls
                     for c in self.clouds(i)]
        mean = {k: sum(w[k] for w in works) / len(works) for k in works[0]}
        return mean, mean.pop("encoder_bytes")

    def clouds(self, i):
        """The clouds call ``i`` forwards, each an (N, C) tensor."""
        cloud, _ = self.pool[i % len(self.pool)]
        return [torch.as_tensor(cloud, device=self.device)]

    phases = ()
    clouds_per_call = 1

    def free(self):
        """Drop the program's state before the reference runs."""
        for name in ("model", "step", "tx", "tiler", "batches"):
            if hasattr(self, name):
                delattr(self, name)
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False


class PredictCell(Cell):
    """One client, B = 1 predicts of the pool's clouds in turn; each
    call's boxes, scores, labels and validity are read back to the
    host."""

    kind = "predict"

    def _prepare(self):
        tpu = self.model_cfg["tpu"]
        self.batches = [scenes.padded_batch(c, b, tpu["max_points_static"],
                                            tpu["max_gt_static"])
                        for c, b in self.pool]
        self.outputs = {}
        self.traced = False
        for i in range(WARMUP_CALLS):
            self.call(i)
        self.outputs = {}

    def _hooks(self):
        net = self.model.net
        marks = {}
        hooks = [net.pseudoimage_generator.register_forward_pre_hook(
            lambda m, a: marks.__setitem__("enc0", _record())),
            net.pseudoimage_generator.register_forward_hook(
            lambda m, a, o: marks.__setitem__("enc1", _record())),
            net.bbox_head.register_forward_hook(
            lambda m, a, o: marks.__setitem__("head1", _record()))]
        return marks, hooks

    def call(self, i):
        k = i % len(self.batches)
        traced = self.traced and torch.device(self.device).type == "cuda"
        if traced:
            marks, hooks = self._hooks()
            marks["start"] = _record()
        out = self.model.predict({"points": self.batches[k]["points"],
                                  "num_points":
                                  self.batches[k]["num_points"]})
        if traced:
            marks["end"] = _record()
            for h in hooks:
                h.remove()
        host = {key: v.cpu().numpy() for key, v in out.items()}
        self.outputs[k] = host
        if traced:
            for name, (a, b) in (("front", ("start", "enc0")),
                                 ("encoder", ("enc0", "enc1")),
                                 ("decode_nms", ("head1", "end"))):
                self.stages.setdefault(name, []).append(
                    marks[a].elapsed_time(marks[b]))
        return bool(np.isfinite(host["score"]).all())

    def _rates(self, n, window_s, lat):
        ms = np.asarray(lat) * 1e3
        import sys

        print(f"predict latency over {n} clouds: median "
              f"{np.median(ms):.3f} ms, p95 {percentile(ms, 95):.3f} ms",
              file=sys.stderr)
        return {"clouds_per_s": n / window_s,
                "predict_p95_ms": percentile(ms, 95)}

    def sample(self):
        """The pool indices the output check compares: ``check_sample`` of
        the clouds the window finished, drawn from the seed."""
        done = sorted(self.outputs)
        n = min(len(done), int(self.traffic.get("check_sample", len(done))))
        rng = np.random.default_rng(self.seed)
        return sorted(int(k) for k in rng.choice(done, n, replace=False))

    def reference_outputs(self, quant=None):
        anc = self.arch.anchors(self.spec, self.device)
        out = {}
        for k in self.sample():
            cloud, _ = self.pool[k]
            pts = torch.as_tensor(cloud, device=self.device)
            out[k] = self.arch.predict(pts, len(cloud), self.weights,
                                       self.spec, anc,
                                       quant or self.arch.identity)
        return out

    def check(self):
        self.free()
        ref = self.reference_outputs()
        return compare.predict_numbers(self.outputs, ref)


class TrainCell(Cell):
    """B = 1 train steps through the port's step, the optimizer's state
    carried over.  Set-up runs the first ``WARMUP_CALLS`` steps, which
    the output check follows with the reference; each later call first
    copies the parameters and the optimizer's moments aside, so that the
    check also holds the last step, taken from the state the window
    left, against one reference step from that copy."""

    kind = "train"
    phases = ("forward", "assignment", "loss+backward", "optimizer")

    def _prepare(self):
        tpu = self.model_cfg["tpu"]
        self.batches = [scenes.padded_batch(c, b, tpu["max_points_static"],
                                            tpu["max_gt_static"])
                        for c, b in self.pool]
        self.step, self.tx = program.train_step(self.model,
                                                self.traffic["optimizer"])
        self.losses = []
        self.names = [n for n, _ in self.model.net.named_parameters()]
        beta1 = float(self.traffic["optimizer"]["betas"][0])
        self.snapshot = None
        for i in range(WARMUP_CALLS):
            self.call(i)
            if i == 0:
                # the gradient the optimizer took, from its first moment
                self.first_grad = {
                    n: float((m / (1 - beta1)).norm()) for n, m in zip(
                        self.names, self._state()[len(self.names):])}
        self.change = {n: float((p.detach() - self.weights[n]).norm())
                       for n, p in self.model.net.named_parameters()}
        self.set_up_losses = list(self.losses)
        self.snapshot = [t.detach().clone() for t in self._state()]
        self.next_call = WARMUP_CALLS
        self.traced = False

    def _state(self):
        """The parameters, then their first and second moments (zeros
        where the optimizer holds none), in the order of ``self.names``."""
        params = list(self.model.net.parameters())
        state = self.tx.state
        return ([p.detach() for p in params] + [
            state[p][k] if k in state.get(p, {}) else torch.zeros_like(p)
            for k in ("exp_avg", "exp_avg_sq") for p in params])

    def call(self, i):
        if self.snapshot is not None:
            with torch.no_grad():
                torch._foreach_copy_(self.snapshot, self._state())
            self.snapshot_call = i
        losses = self.step(self.batches[i % len(self.batches)])
        vals = torch.stack([v.float() for v in losses.values()]).cpu()
        self.losses.append(dict(zip(losses, vals.tolist())))
        return bool(torch.isfinite(vals).all())

    def window(self, seconds, traced=False):
        start = self.next_call
        call = self.call
        self.call = lambda i: call(start + i)
        try:
            out = super().window(seconds, traced)
        finally:
            self.call = call
        self.next_call = start + out[0]
        return out

    def _rates(self, n, window_s, lat):
        return {"train_clouds_per_s": n / window_s}

    def free(self):
        """Takes the last step's readings (its losses, each leaf's change,
        the state it started from) before the program's state goes."""
        if hasattr(self, "model"):
            n = len(self.names)
            first = next(iter(self.model.net.parameters()))
            self.last = {
                "losses": self.losses[-1],
                "change": {k: float((p.detach() - s).norm()) for k, p, s in
                           zip(self.names, self.model.net.parameters(),
                               self.snapshot)},
                "params": dict(zip(self.names, self.snapshot[:n])),
                "exp_avg": dict(zip(self.names, self.snapshot[n:2 * n])),
                "exp_avg_sq": dict(zip(self.names, self.snapshot[2 * n:])),
                "t": max(int(self.tx.state.get(first, {}).get("step", 0))
                         - 1, 0),
                "index": self.snapshot_call % len(self.pool)}
        super().free()

    def _adamw(self, params):
        opt = self.traffic["optimizer"]
        return ref_train.AdamW(params, opt["lr"], tuple(opt["betas"]),
                               opt["weight_decay"], opt["grad_clip_value"])

    def _ref_step(self, params, adam, index, quant):
        cloud, boxes = self.pool[index]
        stats = {k: v for k, v in self.weights.items() if k not in params}
        return ref_train.train_step(
            self.arch, params, stats, adam,
            torch.as_tensor(cloud, device=self.device), len(cloud),
            torch.as_tensor(boxes, device=self.device),
            self.arch.anchors(self.spec, self.device), self.spec,
            quant or self.arch.identity)

    def reference_steps(self, quant=None, steps=WARMUP_CALLS):
        """The reference's first ``steps`` steps from the same weights on
        the same clouds: (losses per step, first clipped gradient's norm
        per leaf, parameter change's norm per leaf)."""
        params = {k: v.clone() for k, v in self.weights.items()
                  if not k.endswith(("running_mean", "running_var"))}
        adam = self._adamw(params)
        losses, first = [], None
        for i in range(steps):
            parts, num_pos, grads = self._ref_step(
                params, adam, i % len(self.pool), quant)
            parts["num_pos"] = num_pos
            losses.append(parts)
            if i == 0:
                first = {k: float(g.norm()) for k, g in grads.items()}
            del grads
        change = {k: float((v - self.weights[k]).norm())
                  for k, v in params.items()}
        return losses, first, change

    def reference_last_step(self, quant=None):
        """The reference's step from the state the program's last step
        started from, on its cloud: (losses, clipped gradient's norm per
        leaf, parameter change's norm per leaf)."""
        last = self.last
        params = {k: v.clone() for k, v in last["params"].items()}
        adam = self._adamw(params)
        adam.t = last["t"]
        adam.m = {k: v.clone() for k, v in last["exp_avg"].items()}
        adam.v = {k: v.clone() for k, v in last["exp_avg_sq"].items()}
        parts, _, grads = self._ref_step(params, adam, last["index"], quant)
        return (parts, {k: float(g.norm()) for k, g in grads.items()},
                {k: float((params[k] - last["params"][k]).norm())
                 for k in params})

    def check(self):
        self.free()
        return {**compare.train_numbers(
            (self.set_up_losses, self.first_grad, self.change),
            self.reference_steps()),
            **compare.last_step_numbers(self.last["change"],
                                        self.reference_last_step()[1:])}


class PlotCell(Cell):
    """Whole plots through the port's tiled inference, one at a time;
    each plot's merged detections come back to the host."""

    kind = "plot"

    def _prepare(self):
        self.tiler = program.tiled(self.model, self.traffic["tiled"],
                                   self._predict)
        self.outputs = {}
        self.traced = False
        # every tile is one predict of the same shapes: one plot warms all
        self.call(0)
        self.outputs = {}

    def _predict(self, batch):
        traced = self.traced and torch.device(self.device).type == "cuda"
        if traced:
            a = _record()
        out = self.model.predict(batch)
        if traced:
            self._tile_events.append((a, _record()))
        self._tiles += 1
        return out

    def call(self, i):
        k = i % len(self.pool)
        cloud, _ = self.pool[k]
        self._tile_events, self._tiles = [], 0
        t0 = time.perf_counter()
        dets = self.tiler(cloud)
        wall = time.perf_counter() - t0
        self.clouds_per_call = self._tiles
        self.outputs[k] = dets
        if self._tile_events:
            inside = sum(a.elapsed_time(b) for a, b in self._tile_events)
            self.stages.setdefault("outside_predict", []).append(
                wall * 1e3 - inside)
        self.points_done = getattr(self, "points_done", 0) + len(cloud)
        return all(np.isfinite(d["score"]) for d in dets)

    def window(self, seconds, traced=False):
        self.points_done = 0
        out = super().window(seconds, traced)
        out[2]["plot_mpts_per_s"] = self.points_done / 1e6 / self.window_s
        return out

    def _rates(self, n, window_s, lat):
        import sys

        s = np.asarray(lat)
        print(f"plot wall over {n} plots: median {np.median(s):.4f} s, "
              f"sd {s.std():.4f} s", file=sys.stderr)
        return {}

    def sample(self):
        """The pool indices the output check compares: one of the plots
        the window finished, drawn from the seed."""
        done = sorted(self.outputs)
        return [done[np.random.default_rng(self.seed).integers(len(done))]]

    def clouds(self, i):
        """The tiles call ``i`` forwards, as the tiled reference crops
        them."""
        return [t for _, t in ref_tiles.tiles(
            self.pool[i % len(self.pool)][0], self.spec,
            self.model_cfg["tpu"]["max_points_static"],
            float(self.traffic["tiled"]["overlap"]), self.device)]

    def reference_outputs(self, quant=None):
        out = {}
        for k in self.sample():
            out[k] = ref_tiles.plot_detections(
                self.arch, self.pool[k][0], self.weights, self.spec,
                self.model_cfg["tpu"]["max_points_static"],
                float(self.traffic["tiled"]["overlap"]), self.device,
                quant or self.arch.identity)
        return out

    def check(self):
        self.free()
        (k, ref), = self.reference_outputs().items()
        return compare.plot_numbers(self.outputs[k], ref)
