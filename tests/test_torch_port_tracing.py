"""The port's spans (``utils/profiling.py: span``) and work counters
(``kernels.count`` / ``counters``) on the CPU at a tiny size, over the four
kinds of work the benchmark runs: a guided two-model Burgers DDPM step, a
guided two-model smoke DDIM step, a smoke training step (remat_all, so the
ResnetBlocks are recomputed in the backward) and two ``smoke_solver`` frames.

(a) With no profiler no span site enters the profiler's record op
(torch's own ``Optimizer.step`` does; it is no span of the port) and no
counter is added to. (b) Under ``torch.profiler`` each kind emits its spans,
nested as ``profiling.SPANS`` lists them by layer; every name is in
``SPANS`` and under the benchmark's span prefixes. (c) ``solver.cg_iterations``
and ``solver.cg_solves`` are the iterations K4's plain route returns and the
elements it solved.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from diffphycon_tpu_torch import kernels
from diffphycon_tpu_torch.benchmarks import burgers as bb
from diffphycon_tpu_torch.benchmarks import smoke as sb
from diffphycon_tpu_torch.diffusion import smoke_derive_cond
from diffphycon_tpu_torch.kernels.cg_pressure import cg_pressure
from diffphycon_tpu_torch.physics.fluids.pressure import FluidDomain
from diffphycon_tpu_torch.physics.fluids.smoke_env import SmokeSim, smoke_solver
from diffphycon_tpu_torch.training.trainer import Trainer, TrainerConfig
from diffphycon_tpu_torch.utils import profiling
from portbench.yardstick import SPAN_PREFIXES

BURGERS = dict(dim=8, dim_mults=(1, 2), is_condition_u0=True, is_condition_uT=True)
SMOKE = dict(dim=8, dim_mults=(1, 2), frames=4, image_size=16)

# (span, the span it runs inside) for each kind of work
NESTING = {
    "burgers_ddpm": [("sampler.two_forwards", "sampler.ddpm_step"),
                     ("sampler.guidance", "sampler.ddpm_step"),
                     ("nets.unet2d.forward", "sampler.two_forwards")]
    + [(f"nets.block.{op}", "nets.unet2d.forward")
       for op in ("resblock", "downsample", "conv", "linear_attention", "attention")],
    "smoke_ddim": [("sampler.two_forwards", "sampler.ddim_step"),
                   ("sampler.guidance", "sampler.ddim_step"),
                   ("nets.unet3d.forward", "sampler.two_forwards"),
                   ("nets.unet3d.host_tables", "nets.unet3d.forward")]
    + [(f"nets.block.{kind}", "nets.unet3d.forward")
       for kind in ("resnet", "linear_attention", "attention", "temporal_attention")],
    "smoke_train": [("nets.unet3d.forward", "trainer.forward"),
                    ("nets.block.resnet", "trainer.forward"),
                    ("nets.block.resnet", "trainer.backward"),  # remat_all's recompute
                    ("trainer.optimizer", None)],
    "smoke_solver": [("solver.pressure", "solver.frame"), ("solver.advect", "solver.frame")],
}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """{kind: fn() running one unit of that work}."""
    torch.manual_seed(0)
    g = torch.Generator().manual_seed(1)

    bcfg = bb.BurgersConfig(**BURGERS)
    nets = [bb.build_unet(bcfg, "cpu").eval() for _ in range(2)]
    bgd = bb.build_diffusion(bcfg, nets[0], model_w=nets[1], device="cpu")
    u_target = torch.randn(2, bcfg.nt_total, bcfg.nx, generator=g)
    bguide = bb.build_guidance(bcfg, u_target, wu=1000.0)
    bcond = {"u0": u_target[:, 0] / 10.0, "uT": u_target[:, bcfg.condition_idx] / 10.0}
    bx = torch.randn(2, bcfg.pad_t, bcfg.nx, 2, generator=g)
    bnoise = torch.randn(bx.shape, generator=g)

    scfg = sb.SmokeConfig(**SMOKE)
    joint = sb.UNet3D(dim=8, dim_mults=(1, 2), channels=6, out_dim=6).eval()
    prior = sb.UNet3D(dim=8, dim_mults=(1, 2), channels=2, out_dim=2).eval()
    sgd = sb.build_diffusion(scfg, joint, model_w=prior, device="cpu")
    sguide = sb.build_guidance(scfg, device="cpu")
    scond = {"init": torch.rand(2, 16, 16, generator=g)}
    sx = torch.randn(2, 4, 16, 16, 6, generator=g)
    snoise = torch.randn(sx.shape, generator=g)
    t, tn = sgd.sample_ts()[0]

    net = sb.UNet3D(dim=8, dim_mults=(1, 2), channels=6, out_dim=6, remat_all=True)
    trainer = Trainer(sb.build_diffusion(scfg, net, device="cpu"), net, iter(()),
                      smoke_derive_cond,
                      TrainerConfig(results_folder=str(tmp_path_factory.mktemp("tr"))),
                      device="cpu")
    batch = torch.rand(2, 4, 16, 16, 6, generator=g) * 2.0 - 1.0

    sim = SmokeSim.create(accuracy=1e-6, max_iterations=20, device="cpu")
    vel0 = torch.zeros(1, 128, 128, 2)
    vel0[..., 1] = 0.5
    density = torch.rand(1, 64, 64, generator=g)
    c1, c2 = (torch.rand(1, 1, 64, 64, generator=g) - 0.5 for _ in range(2))

    return {
        "burgers_ddpm": lambda: bgd.ddpm_step(bx, 500, bcond, bguide, noise=bnoise),
        "smoke_ddim": lambda: sgd.ddim_step(sx, t, tn, scond, sguide, noise=snoise),
        "smoke_train": lambda: trainer.train_step(batch),
        "smoke_solver": lambda: smoke_solver(sim, vel0, density, c1, c2, num_t=3),
    }


@pytest.fixture(autouse=True)
def fresh_counters():
    kernels.reset_counters()
    yield
    kernels.reset_counters()


def _spans(prof):
    """[(name, start, end)] of the ranges under the benchmark's prefixes."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith(SPAN_PREFIXES)]


@pytest.mark.parametrize("kind", sorted(NESTING))
def test_port_spans_cost_no_record_op_without_a_profiler(work, kind, monkeypatch):
    entered = []
    enter = torch.ops.profiler._record_function_enter_new

    def counting(name, *args):
        entered.append(name)
        return enter(name, *args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", counting)
    work[kind]()
    assert not [n for n in entered if n in profiling.SPANS or n.startswith(SPAN_PREFIXES)]
    assert kernels.counters() == {}
    if kind == "smoke_train":  # the patched op does see torch's own ranges
        assert any(n.startswith("Optimizer.step") for n in entered)


@pytest.mark.parametrize("kind", sorted(NESTING))
def test_port_spans_nest_under_the_profiler(work, kind):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work[kind]()
    spans = _spans(prof)
    names = {n for n, _, _ in spans}
    assert names <= set(profiling.SPANS)
    assert all(n.startswith(SPAN_PREFIXES) for n in profiling.SPANS)
    for child, parent in NESTING[kind]:
        kids = [(s, e) for n, s, e in spans if n == child]
        assert kids, f"{kind}: no span {child}"
        if parent is not None:
            outer = [(s, e) for n, s, e in spans if n == parent]
            assert any(ps <= s and e <= pe for s, e in kids for ps, pe in outer), \
                f"{kind}: {child} is never inside {parent}"
    if kind == "smoke_solver":
        assert sum(n == "solver.frame" for n, _, _ in spans) == 2
        assert set(kernels.counters()) == set(kernels.COUNTERS)
    else:
        assert kernels.counters() == {}


def test_port_every_span_name_is_emitted(work):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for kind in sorted(work):
            work[kind]()
    assert {n for n, _, _ in _spans(prof)} == set(profiling.SPANS)


def test_port_cg_counters_sum_the_returned_iterations():
    dom = FluidDomain.from_obstacles((16, 16), [(4, 4, 2, 6)])
    coeffs = dom.laplacian_coeffs("cpu")
    div = torch.randn(3, 16, 16, generator=torch.Generator().manual_seed(2))
    with profile(activities=[ProfilerActivity.CPU]):
        _, it_a = cg_pressure(div, coeffs, 1e-5, 200)
        _, it_b = cg_pressure(div[:2] * 0.5, coeffs, 1e-5, 200)
    cg_pressure(div, coeffs, 1e-5, 200)  # no profiler: not counted
    total = int(it_a.sum()) + int(it_b.sum())
    assert 0 < total < 5 * 200
    assert kernels.counters() == {"solver.cg_iterations": total, "solver.cg_solves": 5}
    assert kernels.counters() == {"solver.cg_iterations": total, "solver.cg_solves": 5}
