"""The joint model's train step on chunks of synthetic trajectories resident
on the card (events int8, depths uint8, as ``train.learner.Learner`` keeps
them): with ``chunks_per_step`` G, ``parallel.make_dp_chunked_train_step``
(G chunks through one forward, their mean loss, one Adam step: the
Learner's DP epoch on one card, ``dp_devices = 1``); without it the
per-chunk ``train.stepfn.make_train_step``.

Set-up builds the step once (the model from the seed's weights, Adam) and
drives it through its first ``first_steps`` steps on chunks that all
differ, through the window's own call and feed; the window continues the
same object.  A step ends when its loss is on the host, as the Learner's
log reads it.  The check replays those first steps with the reference and
compares each step's loss, each leaf's first gradient as Adam holds it
(exp_avg / (1 - beta1) after one step) and each leaf's change over the
first steps, the leaves by the gap of their norms.  It also compares one
step of the window, drawn from the seed among its first
``check_window_steps``: the program's state (every tensor of the model's
state_dict, Adam's moments and count) is cloned before that step, and the
reference takes the same step from the clone; compared are the step's
loss, its gradient as Adam got it ((exp_avg after - beta1 * exp_avg
before) / (1 - beta1)) and each leaf's change.  Each number (``loss``,
``grad``, ``update``) is the worse of the two.
"""

from __future__ import annotations

import statistics

import torch
import torch.nn.functional as F

from .. import generate
from ..counts import model_flops
from ..reference import train
from ._base import Driver as Base, tf32


class Driver(Base):
    program_attrs = ("model", "optimizer", "train_step")

    def setup(self):
        from evfly_tpu_torch.parallel.data_parallel import make_dp_chunked_train_step
        from evfly_tpu_torch.parallel.mesh import Mesh
        from evfly_tpu_torch.train import stepfn

        t, dev = self.traffic, self.dev
        if self.config["training"]["data_augmentation"] or self.config["training"]["dropout"]:
            raise ValueError("the reference replays a step without augmentation or dropout")
        self.H, self.W = self.config["input_hw"]
        self.B, self.first = t["chunk"], t["first_steps"]
        self.G = t.get("chunks_per_step")
        self.sd = self.make_weights()
        self.data = self.make_data()
        self.order = generate.rng(self.cell.seed, 4).permutation(t["chunks"])
        self.model = self.joint_program(self.sd)
        opt = t["adam"]
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=opt["lr"],
                                          betas=tuple(opt["betas"]), eps=opt["eps"])
        loss = dict(loss_weights=t["loss_weights"], optional_loss_param=t["optional_loss_param"],
                    data_augmentation=False)
        if self.G:
            self.train_step = make_dp_chunked_train_step(
                self.model, "joint_vitlstm", self.optimizer, Mesh(1, 0, dev), self.B, 2, 1,
                **loss)
        else:
            self.train_step = stepfn.make_train_step(
                self.model, "joint_vitlstm", self.optimizer, num_out_channels=1,
                batch_fn=stepfn.make_batch_slicer(self.B, 2, 1), **loss)
        self.losses = []
        params = {n: p for n, p in self.model.named_parameters() if p.requires_grad}
        for i in range(self.first):
            self.losses.append(self.run(i))
            if i == 0:
                state = self.optimizer.state
                self.grad0 = {n: state[p]["exp_avg"] / (1 - opt["betas"][0])
                              if "exp_avg" in state.get(p, {}) else torch.zeros_like(p)
                              for n, p in params.items()}
        self.change = {n: p.detach() - self.sd[n] for n, p in params.items()}
        self.probe_step = int(generate.rng(self.cell.seed, 6).integers(0, t["check_window_steps"]))
        self.probe = None

    def make_data(self):
        """Frames of ``chunks`` chunks (and one chunk of tail padding):
        smooth depths in [0, 1], sparse signed event frames in steps of
        1/127, forward commands with y commands that are 0 on some frames
        and a few z commands."""
        t, dev, gen = self.traffic, self.dev, generate.generator(self.cell.seed, 2, self.dev)
        n = (t["chunks"] + 1) * self.B
        f32 = dict(dtype=torch.float32, device=dev)
        coarse = torch.rand(n, 1, 14, 18, generator=gen, **f32)
        depth = F.interpolate(coarse, size=(self.H, self.W), mode="bilinear",
                              align_corners=False)[:, 0].clamp(0, 1)
        on = torch.rand(n, self.H, self.W, generator=gen, **f32) < t["event_density"]
        k = torch.randint(-3, 4, (n, self.H, self.W), generator=gen, device=dev)
        frame = torch.arange(n, **f32)
        vel = torch.stack([torch.full_like(frame, t["desvel"]),
                           torch.round(torch.sin(frame / 7.0) * 2.0) / 2.0,
                           (torch.rand(n, generator=gen, **f32) < 0.2) * 0.5], dim=1)
        return {"depths": torch.round(depth * 255).to(torch.uint8),
                "evs": (k * on * 42).to(torch.int8),
                "desvel": torch.full((n,), t["desvel"], **f32), "velcmd": vel}

    def starts(self, i: int):
        """The first frame of each chunk of step i."""
        g = self.G or 1
        return [int(self.order[(i * g + j) % len(self.order)]) * self.B for j in range(g)]

    def run(self, i: int) -> float:
        s = self.starts(i)
        if self.G:
            idx = {"start": s, "ev_start": s, "n_valid": [self.B] * self.G}
            loss_sum, _values, _gn, n_real = self.train_step(self.data, idx)
            return float(loss_sum / n_real)
        loss, _values, _gn = self.train_step(self.data, {"start": s[0], "ev_start": s[0],
                                                         "n_valid": self.B})
        return float(loss)

    def step(self, k, keep):
        if k != self.probe_step:
            self.run(self.first + k)
        else:
            before = self.program_state()
            loss = self.run(self.first + k)
            after = self.program_state()
            self.probe = {"i": self.first + k, "before": before, "loss": loss,
                          "m_after": after["m"], "params_after": after["params"]}
        self.steps_done = k + 1

    def program_state(self) -> dict:
        """Clones of the model's state_dict (parameters, spectral-norm u
        and v, BatchNorm statistics), of its trained parameters, and of
        Adam's moments and count, by name."""
        with torch.no_grad():
            sd = {n: v.detach().clone() for n, v in self.model.state_dict().items()}
            m, v, count = {}, {}, 0
            for n, p in self.model.named_parameters():
                state = self.optimizer.state.get(p, {})
                if "exp_avg" in state:
                    m[n], v[n] = state["exp_avg"].clone(), state["exp_avg_sq"].clone()
                    count = int(state["step"])
            params = {n: p.detach().clone() for n, p in self.model.named_parameters()
                      if p.requires_grad}
        return {"sd": sd, "m": m, "v": v, "count": count, "params": params}

    def adam(self, keys):
        opt = self.traffic["adam"]
        return train.Adam(keys, opt["lr"], tuple(opt["betas"]), opt["eps"])

    def chunk(self, i: int, half: bool):
        """Step i's chunks for the reference; ``half`` leaves out the second
        half of every chunk (the loss is the mean over the rest), a fault."""
        chunk = train.decode_chunks(self.data, self.starts(i), self.B)
        return tuple(c[:, : self.B // 2] for c in chunk) if half else chunk

    def reference(self, on_tf32: bool, half: bool = False):
        """The first steps replayed by the reference from the seed's weights
        (losses, first gradients, change), then the window's probed step
        taken by the reference from the program's state before it (loss,
        gradients, change), or None where the window never reached it."""
        sd = {k: v.clone() for k, v in self.sd.items()}
        adam = self.adam(train.trained_keys(sd))
        losses, grad0 = [], None
        with tf32(on_tf32):
            for i in range(self.first):
                loss, grads = train.train_step(sd, adam, self.chunk(i, half))
                losses.append(loss)
                grad0 = grads if i == 0 else grad0
            first = (losses, grad0, {k: sd[k] - self.sd[k] for k in adam.keys})
            if self.probe is None:
                return first, None
            before = self.probe["before"]
            sd = {k: v.clone() for k, v in before["sd"].items()}
            adam = self.adam(train.trained_keys(sd))
            adam.t = before["count"]
            adam.m = {k: v.clone() for k, v in before["m"].items()}
            adam.v = {k: v.clone() for k, v in before["v"].items()}
            loss, grads = train.train_step(sd, adam, self.chunk(self.probe["i"], half))
        return first, ([loss], grads, {k: sd[k] - before["sd"][k] for k in adam.keys})

    def got(self):
        """The program's readings, laid out as ``reference``'s."""
        first = (self.losses, self.grad0, self.change)
        if self.probe is None:
            return first, None
        p, b1 = self.probe, self.traffic["adam"]["betas"][0]
        before = p["before"]
        grads, change = {}, {}
        for n, after in p["params_after"].items():
            zero = torch.zeros_like(after)
            m_before = before["m"].get(n, zero)
            grads[n] = (p["m_after"].get(n, b1 * m_before) - b1 * m_before) / (1 - b1)
            change[n] = after - before["params"][n]
        return first, ([p["loss"]], grads, change)

    @staticmethod
    def gaps(got, ref):
        """(loss, grad, update): the worst step's relative loss gap, and the
        worst leaf's gap of norms over max(its norm, the median leaf's)."""
        (loss_p, g_p, d_p), (loss_r, g_r, d_r) = got, ref
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(loss_p, loss_r))
        g_norm = {k: float(v.norm()) for k, v in g_r.items()}
        g_med = statistics.median(g_norm.values())
        grad_gap = max(abs(float(g_p[k].norm()) - n) / max(n, g_med) for k, n in g_norm.items())
        # leaves whose gradient is nought to rounding move by round-off alone
        moved = [k for k, n in g_norm.items() if n >= 1e-3 * g_med]
        d_norm = {k: float(d_r[k].norm()) for k in moved}
        d_med = statistics.median(d_norm.values())
        update_gap = max(abs(float(d_p[k].norm()) - n) / max(n, d_med)
                         for k, n in d_norm.items())
        return loss_err, grad_gap, update_gap

    @classmethod
    def compare(cls, got, ref):
        """Each number the worse of the first steps' and the window step's."""
        (first_p, probe_p), (first_r, probe_r) = got, ref
        # a probed step that never came is no answer: it fails
        window = (cls.gaps(probe_p, probe_r) if probe_p is not None and probe_r is not None
                  else (float("inf"),) * 3)
        return dict(zip(("loss", "grad", "update"),
                        map(max, cls.gaps(first_p, first_r), window)))

    def check(self):
        return self.compare(self.got(), self.reference(False))

    def control(self):
        return self.compare(self.reference(True), self.reference(False))

    def fault_half_batch(self):
        return self.compare(self.reference(False, half=True), self.reference(False))

    def model_flops(self):
        sd = {k: v.clone() for k, v in self.sd.items()}
        keys = train.trained_keys(sd)
        chunk = train.decode_chunks(self.data, self.starts(0), self.B)

        def fwd_bwd():
            params = {k: sd[k].detach().requires_grad_(True) for k in keys}
            torch.autograd.grad(train.loss({**sd, **params}, *chunk), list(params.values()))

        return model_flops.count(fwd_bwd)
