"""1D Burgers: the port's guided two-model DDPM against the plain reference.

The program: two ``diffphycon_tpu_torch.nets.UNet2D`` (the joint p(u, w)
and the prior p(w)) in the configuration's dtype, given the benchmark's
seeded weights; ``benchmarks.burgers.build_diffusion`` /
``build_guidance`` with u0 / uT conditioning; ``GaussianDiffusion.ddpm_step``
with the noise the benchmark draws. Each job draws its target trajectories
u* (normal, as the JAX bench draws them), its x_T and its noises from the
seed.

The check: for each kept step, the reference step (``reference/
diffusion.py`` on ``reference/unet2d.py`` in float32) from the program's
input x_t and noise; three relative L2 gaps: the step's output against the
reference's (over the reference's increment x_{t-1} - x_t), and each net's
output against the reference net's.
"""

from __future__ import annotations

import contextlib

import torch

from portbench import flops as pf
from portbench.reference import diffusion as rdiff
from portbench.reference import unet2d as ref
from portbench.weights import build_module, make_params, sub_seed

RESCALER = 10.0  # the Burgers data scale (benchmarks/burgers.py)


def fp8(t):
    """Round to float8 e4m3 (saturating at its largest value)."""
    return t.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(torch.float32)


CONTROL_ROUNDING = {"bfloat16": fp8, "float32": lambda t: t.to(torch.bfloat16).float()}


def rel(a, b, base) -> float:
    """|a - b| / |base| (L2 over all elements); inf where ``a`` is None."""
    if a is None:
        return float("inf")
    return float(torch.linalg.vector_norm((a.float() - b.float()).flatten())
                 / torch.linalg.vector_norm(base.float().flatten()))


class _Probe:
    """fn(x, t) that keeps a copy of its output while ``keep`` is a list, and
    records a span while ``spans`` is on."""

    def __init__(self, fn, span: str, owner):
        self.fn, self.span, self.owner, self.keep = fn, span, owner, None

    def __call__(self, x, t):
        ctx = (torch.profiler.record_function(self.span) if self.owner.spans
               else contextlib.nullcontext())
        with ctx:
            out = self.fn(x, t)
        if self.keep is not None:
            self.keep.append(out.detach().clone())
        return out


class Guided:
    def __init__(self, run):
        self.run, self.cfg, self.dev = run, run.cfg, run.device
        cfg, tr = self.cfg, run.traffic
        self.batch = tr["batch"]
        self.spans = False
        self.records = []
        self.failed = 0
        self.shapes = ref.param_shapes(cfg)
        self.sample_shape = (self.batch, cfg["frames"], cfg["nx"], cfg["channels"])
        if run.mode == "control":
            rnd = CONTROL_ROUNDING[cfg["dtype"]]
            nets = [self._reference_net(k, rnd) for k in (1, 2)]
        else:
            nets = [self._program_net(k) for k in (1, 2)]
        self.joint = _Probe(nets[0], "nets.forward.joint", self)
        self.prior = _Probe(nets[1], "nets.forward.prior", self)
        self.consts = rdiff.Constants(cfg["beta_schedule"], cfg["timesteps"])
        self.schedule = list(range(cfg["timesteps"] - 1, -1, -1))
        if run.mode != "control":
            from diffphycon_tpu_torch.benchmarks import burgers as bb

            self.bb = bb
            self.bcfg = bb.BurgersConfig(
                dim=cfg["dim"], dim_mults=tuple(cfg["dim_mults"]),
                resnet_block_groups=cfg["resnet_block_groups"],
                timesteps=cfg["timesteps"], beta_schedule=cfg["beta_schedule"],
                is_condition_u0=cfg["is_condition_u0"], is_condition_uT=cfg["is_condition_uT"],
                condition_idx=cfg["condition_idx"], prior_beta=cfg["prior_beta"],
                bf16=cfg["dtype"] == "bfloat16", impl=cfg["impl"],
                nt_total=cfg["nt_total"], nx=cfg["nx"], pad_t=cfg["frames"])
            self.gd = bb.build_diffusion(self.bcfg, self.joint, model_w=self.prior,
                                         device=self.dev)

    # -- the program ------------------------------------------------------

    def _program_net(self, stream):
        from diffphycon_tpu_torch.nets.unet2d import UNet2D

        cfg = self.cfg
        dtype = getattr(torch, cfg["dtype"])

        def factory():
            return UNet2D(dim=cfg["dim"], out_dim=cfg["out_dim"],
                          dim_mults=tuple(cfg["dim_mults"]), channels=cfg["channels"],
                          resnet_block_groups=cfg["resnet_block_groups"],
                          attn_dim_head=cfg["attn_dim_head"], attn_heads=cfg["attn_heads"],
                          sinusoidal_pos_emb_theta=cfg["sinusoidal_pos_emb_theta"],
                          dtype=dtype)

        return build_module(factory, self.shapes, self.run.seed, stream, self.dev).eval()

    def _reference_net(self, stream, rnd):
        P = make_params(self.shapes, self.run.seed, stream, self.dev)
        return lambda x, t: ref.forward(P, x, t, self.cfg, rnd)

    def start_job(self, job: int) -> None:
        cfg, dev = self.cfg, self.dev
        g = torch.Generator(device=dev).manual_seed(sub_seed(self.run.seed, 1, job + 1))
        u_target = torch.randn(self.batch, cfg["nt_total"], cfg["nx"], generator=g, device=dev)
        self.x = torch.randn(self.sample_shape, generator=g, device=dev)
        self.noise_gen = g
        self.cond = {"u0": u_target[:, 0, :] / RESCALER,
                     "uT": u_target[:, cfg["condition_idx"], :] / RESCALER}
        self.ref_cond = dict(self.cond, u_target_scaled=u_target / RESCALER)
        if self.run.mode != "control":
            self.guidance = self.bb.build_guidance(self.bcfg, u_target,
                                                   wu=cfg["guidance"]["wu"])

    def step(self, pos: int, record: bool) -> None:
        t = self.schedule[pos]
        noise = torch.randn(self.sample_shape, generator=self.noise_gen, device=self.dev)
        x_in = self.x
        if record:
            self.joint.keep, self.prior.keep = [], []
        if self.run.mode == "control":
            with torch.no_grad():
                self.x = rdiff.burgers_ddpm_step(self.consts, x_in, t, noise, self.cfg,
                                                 self.ref_cond, self.joint, self.prior)[0]
        else:
            self.x = self.gd.ddpm_step(x_in, t, self.cond, self.guidance, noise=noise)
        if record:
            self.records.append({"t": t, "x": x_in.detach().clone(), "noise": noise,
                                 "out": self.x.detach().clone(), "cond": self.ref_cond,
                                 "eps": (self.joint.keep or [None])[0],
                                 "eps_w": (self.prior.keep or [None])[0]})
            self.joint.keep = self.prior.keep = None

    def layers(self):
        one = pf.unet2d_layers(self.cfg, self.batch, self.cfg["frames"], self.cfg["nx"])
        return [(f"joint.{n}", *rest) for n, *rest in one] + \
               [(f"prior.{n}", *rest) for n, *rest in one]

    def free(self) -> None:
        for name in ("gd", "joint", "prior", "x", "guidance"):
            self.__dict__.pop(name, None)
        if self.dev == "cuda":
            torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------

    def check(self, records) -> list:
        cfg, seed, dev = self.cfg, self.run.seed, self.dev
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        Pj = make_params(self.shapes, seed, 1, dev)
        Pw = make_params(self.shapes, seed, 2, dev)
        step, eps, eps_w = 0.0, 0.0, 0.0
        with torch.no_grad():
            for r in records:
                x_ref, o, ow = rdiff.burgers_ddpm_step(
                    self.consts, r["x"], r["t"], r["noise"], cfg, r["cond"],
                    lambda x, t: ref.forward(Pj, x, t, cfg),
                    lambda x, t: ref.forward(Pw, x, t, cfg))
                step = max(step, rel(r["out"], x_ref, x_ref - r["x"]))
                eps = max(eps, rel(r["eps"], o, o))  # a net not run reads inf
                eps_w = max(eps_w, rel(r["eps_w"], ow, ow))
                self.failed += int(not torch.isfinite(r["out"]).all())
        lim = self.run.cell.limits
        return [("step_rel_l2", step, lim["step_rel_l2"]),
                ("joint_eps_rel_l2", eps, lim["joint_eps_rel_l2"]),
                ("prior_eps_rel_l2", eps_w, lim["prior_eps_rel_l2"])]
