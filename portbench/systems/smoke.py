"""2D smoke: the port's guided two-model DDIM and the joint model's training
step against the plain reference.

The program: ``diffphycon_tpu_torch.nets.unet3d.UNet3D`` in the
configuration's dtype, given the benchmark's seeded weights;
``benchmarks.smoke.build_diffusion`` / ``build_guidance``;
``GaussianDiffusion.ddim_step`` with the noise the benchmark draws
(sampling); ``training.trainer.Trainer.train_step`` (training). Inputs are
drawn from the seed on the device: the initial density (sampling), the
clean batches (training).

The checks: sampling as ``systems/burgers.py`` (the step, each net's eps);
training follows the trainer's first three steps with the plain reference
(its own Adam, the global-norm clip, ``p_losses`` in float32): each step's
loss, the first gradient as Adam holds it, and the parameters' change
after three steps, leaf by leaf.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from portbench import flops as pf
from portbench.reference import diffusion as rdiff
from portbench.reference import unet3d as ref
from portbench.reference.training import ReferenceTrainer
from portbench.systems.burgers import CONTROL_ROUNDING, _Probe, rel
from portbench.weights import build_module, make_params, sub_seed


def _factory(cfg, channels):
    from diffphycon_tpu_torch.nets.unet3d import UNet3D

    def make():
        return UNet3D(dim=cfg["dim"], dim_mults=tuple(cfg["dim_mults"]), channels=channels,
                      out_dim=channels, attn_heads=cfg["attn_heads"],
                      attn_dim_head=cfg["attn_dim_head"],
                      init_kernel_size=cfg["init_kernel_size"],
                      resnet_groups=cfg["resnet_groups"], remat_all=cfg["remat_all"],
                      dtype=getattr(torch, cfg["dtype"]))

    return make


def _smoke_config(cfg, is_w_model=False):
    from diffphycon_tpu_torch.benchmarks import smoke as sb

    return sb, sb.SmokeConfig(
        dim=cfg["dim"], dim_mults=tuple(cfg["dim_mults"]), frames=cfg["frames"],
        image_size=cfg["image_size"], timesteps=cfg["timesteps"], using_ddim=True,
        ddim_sampling_steps=cfg["ddim_sampling_steps"], ddim_eta=cfg["ddim_eta"],
        beta_schedule=cfg["beta_schedule"], is_w_model=is_w_model,
        w_prob_exp=cfg["w_prob_exp"], standard_fixed_ratio=cfg["standard_fixed_ratio"],
        design_guidance=cfg["design_guidance"], w_energy=cfg["w_energy"],
        bf16=cfg["dtype"] == "bfloat16", remat_all=cfg["remat_all"])


def _ref_net(P, cfg, rnd=None):
    return lambda x, t: ref.forward(P, x, t, cfg, rnd)


def _fp32_reference() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Guided:
    def __init__(self, run):
        self.run, self.cfg, self.dev = run, run.cfg, run.device
        cfg = self.cfg
        self.batch = run.traffic["batch"]
        self.spans = False
        self.records = []
        self.failed = 0
        s = cfg["image_size"]
        self.sample_shape = (self.batch, cfg["frames"], s, s, cfg["channels"])
        self.shapes = ref.param_shapes(cfg, cfg["channels"])
        self.shapes_w = ref.param_shapes(cfg, cfg["w_channels"])
        self.consts = rdiff.Constants(cfg["beta_schedule"], cfg["timesteps"])
        times = np.linspace(-1, cfg["timesteps"] - 1, cfg["ddim_sampling_steps"] + 1)
        times = list(reversed(times.astype(int).tolist()))
        self.schedule = list(zip(times[:-1], times[1:]))
        if run.mode == "control":
            rnd = CONTROL_ROUNDING[cfg["dtype"]]
            nets = [_ref_net(make_params(sh, run.seed, k, self.dev), cfg, rnd)
                    for k, sh in ((1, self.shapes), (2, self.shapes_w))]
        else:
            nets = [build_module(_factory(cfg, ch), sh, run.seed, k, self.dev).eval()
                    for k, ch, sh in ((1, cfg["channels"], self.shapes),
                                      (2, cfg["w_channels"], self.shapes_w))]
        self.joint = _Probe(nets[0], "nets.forward.joint", self)
        self.prior = _Probe(nets[1], "nets.forward.prior", self)
        if run.mode != "control":
            sb, scfg = _smoke_config(cfg)
            self.gd = sb.build_diffusion(scfg, self.joint, model_w=self.prior, device=self.dev)
            self.guidance = sb.build_guidance(scfg, device=self.dev)
            if [tuple(x) for x in self.gd.sample_ts()] != self.schedule:
                raise ValueError("the port's DDIM schedule differs from the configuration's")

    def start_job(self, job: int) -> None:
        cfg, dev = self.cfg, self.dev
        g = torch.Generator(device=dev).manual_seed(sub_seed(self.run.seed, 1, job + 1))
        s = cfg["image_size"]
        density = torch.rand(self.batch, s, s, generator=g, device=dev)
        self.x = torch.randn(self.sample_shape, generator=g, device=dev)
        self.noise_gen = g
        self.cond = {"init": density / cfg["rescaler"][0]}

    def step(self, pos: int, record: bool) -> None:
        t, tn = self.schedule[pos]
        noise = torch.randn(self.sample_shape, generator=self.noise_gen, device=self.dev)
        x_in = self.x
        if record:
            self.joint.keep, self.prior.keep = [], []
        if self.run.mode == "control":
            with torch.no_grad():
                self.x = rdiff.smoke_ddim_step(self.consts, x_in, t, tn, noise, self.cfg,
                                               self.cond, self.joint, self.prior)[0]
        else:
            self.x = self.gd.ddim_step(x_in, t, tn, self.cond, self.guidance, noise=noise)
        if record:
            self.records.append({"t": t, "tn": tn, "x": x_in.detach().clone(), "noise": noise,
                                 "out": self.x.detach().clone(), "cond": self.cond,
                                 "eps": (self.joint.keep or [None])[0],
                                 "eps_w": (self.prior.keep or [None])[0]})
            self.joint.keep = self.prior.keep = None

    def layers(self):
        c = self.cfg
        return [(f"joint.{n}", *r) for n, *r in pf.unet3d_layers(c, self.batch, c["channels"])] + \
               [(f"prior.{n}", *r) for n, *r in pf.unet3d_layers(c, self.batch, c["w_channels"])]

    def free(self) -> None:
        for name in ("gd", "joint", "prior", "x", "guidance"):
            self.__dict__.pop(name, None)
        if self.dev == "cuda":
            torch.cuda.empty_cache()

    def check(self, records) -> list:
        cfg, seed, dev = self.cfg, self.run.seed, self.dev
        _fp32_reference()
        joint = _ref_net(make_params(self.shapes, seed, 1, dev), cfg)
        prior = _ref_net(make_params(self.shapes_w, seed, 2, dev), cfg)
        step, eps, eps_w = 0.0, 0.0, 0.0
        with torch.no_grad():
            for r in records:
                x_ref, o, ow = rdiff.smoke_ddim_step(self.consts, r["x"], r["t"], r["tn"],
                                                     r["noise"], cfg, r["cond"], joint, prior)
                step = max(step, rel(r["out"], x_ref, x_ref - r["x"]))
                eps = max(eps, rel(r["eps"], o, o))  # a net not run reads inf
                eps_w = max(eps_w, rel(r["eps_w"], ow, ow))
                self.failed += int(not torch.isfinite(r["out"]).all())
        lim = self.run.cell.limits
        return [("step_rel_l2", step, lim["step_rel_l2"]),
                ("joint_eps_rel_l2", eps, lim["joint_eps_rel_l2"]),
                ("prior_eps_rel_l2", eps_w, lim["prior_eps_rel_l2"])]


def make_batches(cfg, traffic, seed, device) -> list:
    """``batch_pool`` clean batches (B, F, S, S, C) in model scale, U(-1, 1)
    from the seed, in one draw."""
    s, b = cfg["image_size"], traffic["batch"]
    shape = (traffic["batch_pool"], b, cfg["frames"], s, s, cfg["channels"])
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 3))
    return list(torch.rand(shape, generator=g, device=device).mul_(2.0).sub_(1.0).unbind(0))


def leaf_gap(prog: dict, refd: dict, names) -> float:
    """max over leaves of | |prog| - |ref| | / max(|ref|, median leaf |ref|)."""
    pn = {n: float(torch.linalg.vector_norm(prog[n].float())) for n in names}
    rn = {n: float(torch.linalg.vector_norm(refd[n].float())) for n in names}
    med = float(np.median(list(rn.values())))
    return max(abs(pn[n] - rn[n]) / max(rn[n], med) for n in names)


class Train:
    """Set-up builds one trainer and drives it through its first
    ``check_steps`` (3) steps, which the check follows; the window goes on
    with the same trainer."""

    def __init__(self, run):
        self.run, self.cfg, self.dev = run, run.cfg, run.device
        cfg, tr = self.cfg, run.traffic
        self.batch = tr["batch"]
        self.spans = False
        self.failed = 0
        self.batches = make_batches(cfg, tr, run.seed, self.dev)
        self.shapes = ref.param_shapes(cfg, cfg["channels"])
        if run.mode == "control":
            self.trainer = ReferenceTrainer(cfg, run.seed, self.dev,
                                            CONTROL_ROUNDING[cfg["dtype"]],
                                            chunks=tr["reference_chunks"])
            return
        from diffphycon_tpu_torch.diffusion import smoke_derive_cond
        from diffphycon_tpu_torch.training.trainer import Trainer, TrainerConfig

        tc = cfg["train"]
        net = build_module(_factory(cfg, cfg["channels"]), self.shapes, run.seed, 1, self.dev)
        sb, scfg = _smoke_config(cfg)
        gd = sb.build_diffusion(scfg, net, device=self.dev)
        folder = Path(__file__).resolve().parents[2] / "build" / "portbench_trainer"
        self.trainer = Trainer(gd, net, iter(()), smoke_derive_cond, TrainerConfig(
            train_batch_size=self.batch, train_lr=tc["lr"], adam_b1=tc["adam_b1"],
            adam_b2=tc["adam_b2"], max_grad_norm=tc["max_grad_norm"],
            lr_schedule=tc["lr_schedule"], seed=sub_seed(run.seed, 5),
            results_folder=str(folder)), device=self.dev)

    def step(self, i: int):
        batch = self.batches[i % len(self.batches)]
        if self.run.mode == "control":
            return self.trainer.step(batch)
        return self.trainer.train_step(batch)

    def _params(self) -> dict:
        if self.run.mode == "control":
            return {n: v.detach().clone() for n, v in self.trainer.P.items()}
        return {n: p.detach().clone() for n, p in self.trainer.model.named_parameters()}

    def _first_grad(self) -> dict:
        """The first step's gradient as Adam holds it: exp_avg / (1 - b1)."""
        if self.run.mode == "control":
            return self.trainer.grads
        opt, b1 = self.trainer.optimizer, self.cfg["train"]["adam_b1"]
        return {n: opt.state[p].get("exp_avg", torch.zeros_like(p)) / (1.0 - b1)
                for n, p in self.trainer.model.named_parameters()}

    def first_steps(self, n: int) -> None:
        """Steps 1..n of set-up, keeping what the check compares."""
        self.losses = []
        for i in range(n):
            self.losses.append(self.step(i))
            if i == 0:
                self.first_grad = self._first_grad()
        self.after = self._params()

    def check(self) -> list:
        cfg, tr = self.cfg, self.run.traffic
        _fp32_reference()
        rt = ReferenceTrainer(cfg, self.run.seed, self.dev, chunks=tr["reference_chunks"])
        start = {n: v.detach().clone() for n, v in rt.P.items()}
        losses, grad = [], None
        for i in range(len(self.losses)):
            losses.append(rt.step(self.batches[i]))
            if i == 0:
                grad = rt.grads
        names = sorted(start)
        prog_losses = [float(v) for v in self.losses]
        self.failed = sum(not math.isfinite(v) for v in prog_losses)
        loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog_losses, losses))
        grad_gap = leaf_gap(self.first_grad, grad, names)
        gn = {n: float(torch.linalg.vector_norm(grad[n])) for n in names}
        med = float(np.median(list(gn.values())))
        moving = [n for n in names if gn[n] >= 1e-3 * med]
        with torch.no_grad():
            d_prog = {n: self.after[n].float() - start[n] for n in moving}
            d_ref = {n: rt.P[n].detach() - start[n] for n in moving}
        update_gap = leaf_gap(d_prog, d_ref, moving)
        # the losses' gap is printed, not compared: neither the control nor a
        # fault reads three times its largest sound reading (PERF.md)
        self.uncompared = {"loss_rel_gap": loss_gap, "leaves_left_out": len(names) - len(moving)}
        lim = self.run.cell.limits
        return [("first_grad_leaf_gap", grad_gap, lim["first_grad_leaf_gap"]),
                ("update_leaf_gap", update_gap, lim["update_leaf_gap"])]

    def layers(self):
        c = self.cfg
        return pf.unet3d_layers(c, self.batch, c["channels"])

    def free(self) -> None:
        self.__dict__.pop("trainer", None)
        if self.dev == "cuda":
            torch.cuda.empty_cache()


class Rollout:
    """The evaluation's re-simulation: ``physics.fluids.smoke_env.smoke_solver``
    over ``frames`` frames (frames - 1 steps) of seeded controls and initial
    densities. The check takes kept frames k of the window's first job and
    steps the plain reference (``reference/smoke_solver.py``) from the
    program's state at k, against the program's state at k + 1."""

    def __init__(self, run):
        from portbench.reference import smoke_solver as rsolver

        self.run, self.cfg, self.dev = run, run.cfg, run.device
        self.rs = rsolver
        self.batch = run.traffic["batch"]
        self.solver = self.cfg["solver"]
        self.spans = False
        self.records = []
        self.failed = 0
        if run.mode == "control":
            self.dom = rsolver.Domain(self.dev, torch.bfloat16)
        else:
            from diffphycon_tpu_torch.physics.fluids.smoke_env import SmokeSim, smoke_solver

            self.solve = smoke_solver
            self.sim = SmokeSim.create(accuracy=self.solver["accuracy"],
                                       max_iterations=self.solver["max_iterations"],
                                       device=self.dev)

    def start_job(self, job: int) -> None:
        """Initial density (B, 64, 64) U(0, 1); controls c1, c2 (B, frames,
        64, 64) U(-1, 1) times their scale, zero in the interior [8, 56)^2
        (indirect control), as the evaluation hands sampled controls over."""
        cfg, dev, b = self.cfg, self.dev, self.batch
        s, f = cfg["image_size"], cfg["frames"]
        g = torch.Generator(device=dev).manual_seed(sub_seed(self.run.seed, 6, job + 1))
        self.density = torch.rand(b, s, s, generator=g, device=dev)
        c = torch.rand(2, b, f, s, s, generator=g, device=dev).mul_(2.0).sub_(1.0)
        c[:, :, :, 8:56, 8:56] = 0.0
        self.c1, self.c2 = c[0] * cfg["rescaler"][3], c[1] * cfg["rescaler"][4]
        self.init_v = torch.zeros(b, 128, 128, 2, device=dev)
        self.init_v[..., 1] = self.solver["initial_vy"]

    def _controls_at(self, c, k):
        """The (B, 128, 128) control of frame k: each control frame held for
        frames / F frames, each cell 2 x 2."""
        rep = self.solver["frames"] // c.shape[1]
        return c[:, k // rep].repeat_interleave(2, -2).repeat_interleave(2, -1)

    def rollout(self, keep=()):
        n = self.solver["frames"]
        if self.run.mode == "control":
            out = self._control_rollout(n)
        else:
            out = self.solve(self.sim, self.init_v, self.density, self.c1, self.c2, num_t=n)
        for k in keep:
            self.records.append({
                "k": k, "c1": self._controls_at(self.c1, k), "c2": self._controls_at(self.c2, k),
                **{f"{name}{j}": out[key][:, k + j].clone()
                   for j in (0, 1) for name, key in (("vel", "velocitys"), ("den", "densitys"),
                                                     ("zero", "zero_densitys"),
                                                     ("mass", "bucket_mass"))}})
        return n - 1

    def _control_rollout(self, n):
        """The plain reference in bfloat16 in the program's place."""
        rs, dom, bf = self.rs, self.dom, torch.bfloat16
        up = self.density.repeat_interleave(2, -2).repeat_interleave(2, -1)[:, :-1, :-1]
        vel, den = self.init_v.to(bf), up.to(bf)
        zd = F_pad(den) * dom.keep
        mass = torch.einsum("byx,kyx->bk", F_pad(den), dom.cal)
        zero = zd[:, :-1, :-1]
        rec = {"velocitys": [vel], "densitys": [F_pad(den)], "zero_densitys": [F_pad(zero)],
               "bucket_mass": [mass]}
        with torch.no_grad():
            for k in range(n - 1):
                vel, den, zero, mass = rs.frame(
                    dom, vel, den, zero, mass, self._controls_at(self.c1, k).to(bf),
                    self._controls_at(self.c2, k).to(bf), self.solver)
                for key, v in (("velocitys", vel), ("densitys", F_pad(den)),
                               ("zero_densitys", F_pad(zero)), ("bucket_mass", mass)):
                    rec[key].append(v)
        return {k: torch.stack(v, dim=1).float() for k, v in rec.items()}

    def free(self) -> None:
        for name in ("sim", "density", "c1", "c2", "init_v"):
            self.__dict__.pop(name, None)
        if self.dev == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        rs = self.rs
        _fp32_reference()
        dom = rs.Domain(self.dev)
        vel_gap, den_gap = 0.0, 0.0
        with torch.no_grad():
            for r in self.records:
                vel, den, _, _ = rs.frame(dom, r["vel0"], r["den0"][:, :-1, :-1],
                                          r["zero0"][:, :-1, :-1], r["mass0"], r["c1"], r["c2"],
                                          self.solver)
                vel_gap = max(vel_gap, rel(r["vel1"], vel, vel))
                den_gap = max(den_gap, rel(r["den1"][:, :-1, :-1], den, den))
                self.failed += int(not torch.isfinite(r["vel1"]).all())
        lim = self.run.cell.limits
        return [("velocity_rel_l2", vel_gap, lim["velocity_rel_l2"]),
                ("density_rel_l2", den_gap, lim["density_rel_l2"])]


def F_pad(a):
    """(B, 127, 127) -> (B, 128, 128), zero in the last row and column."""
    return torch.nn.functional.pad(a, (0, 1, 0, 1))
