"""A data-parallel dry run on CPU processes, the port's counterpart of
``__graft_entry__.py: dryrun_multichip``.

``dryrun_multichip(n)`` starts n processes that join one gloo group over
``tcp://localhost`` and each run, on tiny shapes:

- one Burgers training step at dim 8 (global batch 2n, one sample a rank
  after sharding, DDP gradient averaging);
- two-model guided sampling (DDPM, 10 steps) with the batch sharded over
  the ranks and gathered;
- one smoke UNet3D training step.

Each rank checks that its parameters equal every other rank's after each
step. It needs no GPU. Run it as

    python -m diffphycon_tpu_torch.parallel.dryrun 2
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _same_on_every_rank(mesh, module, what: str) -> None:
    import torch
    import torch.distributed as dist

    flat = torch.cat([p.detach().reshape(-1) for p in module.parameters()])
    parts = [torch.empty_like(flat) for _ in range(mesh.world_size)]
    dist.all_gather(parts, flat)
    for r, other in enumerate(parts):
        if not torch.equal(other, flat):
            raise AssertionError(f"rank {mesh.rank}: {what} differs from rank {r}'s")


def run_rank(rank: int, world: int, init_method: str, workdir: str) -> None:
    """One rank of the dry run (see the module docstring)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from diffphycon_tpu_torch.benchmarks import burgers as bench
    from diffphycon_tpu_torch.benchmarks import smoke as sbench
    from diffphycon_tpu_torch.diffusion import smoke_derive_cond
    from diffphycon_tpu_torch.parallel.mesh import make_mesh, replicate, sample_sharded
    from diffphycon_tpu_torch.training.data import ArrayDataset, stack_burgers_uf
    from diffphycon_tpu_torch.training.trainer import Trainer, TrainerConfig

    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu", rank=rank, world_size=world, init_method=init_method)
    try:
        rng = np.random.default_rng(0)
        n = 2 * world

        def tcfg(name):
            return TrainerConfig(train_batch_size=n, train_num_steps=1,
                                 save_and_sample_every=10**9, log_every=1,
                                 results_folder=os.path.join(workdir, name))

        cfg = bench.BurgersConfig(dim=8, dim_mults=(1, 2), is_condition_u0=True,
                                  is_condition_uT=True, timesteps=10)
        net = bench.init_params(cfg, seed=0, device="cpu")
        data = stack_burgers_uf(rng.normal(size=(n, 11, 128)).astype(np.float32),
                                rng.normal(size=(n, 10, 128)).astype(np.float32))
        trainer = Trainer(bench.build_diffusion(cfg, net, device="cpu"), net,
                          ArrayDataset(data).batches(n), bench.derive_cond, tcfg("burgers"),
                          mesh=mesh)
        if trainer.train(progress=False) != 1:
            raise AssertionError("the Burgers trainer did not take one step")
        _same_on_every_rank(mesh, net, "the Burgers UNet2D after a step")

        net_w = replicate(mesh, bench.init_params(cfg, seed=1, device="cpu"))
        gd2 = bench.build_diffusion(cfg, net.eval(), model_w=net_w, device="cpu")
        u_t = torch.from_numpy(rng.normal(size=(n, 11, 128)).astype(np.float32))
        guidance = bench.build_guidance(cfg, u_t, wu=10.0, j_scheduler="cosine",
                                        w_scheduler="sigmoid_flip")
        cond = {"u0": u_t[:, 0] / bench.RESCALER, "uT": u_t[:, 10] / bench.RESCALER}
        x = sample_sharded(mesh, gd2, n, cond, guidance, torch.Generator().manual_seed(3))
        if x.shape != (n, cfg.pad_t, cfg.nx, 2) or not torch.isfinite(x).all():
            raise AssertionError(f"sharded sampling gave {tuple(x.shape)}, finite "
                                 f"{bool(torch.isfinite(x).all())}")

        scfg = sbench.SmokeConfig(dim=8, dim_mults=(1, 2), frames=4, image_size=16,
                                  timesteps=5, using_ddim=False, beta_schedule="cosine")
        snet = sbench.init_params(scfg, 0, device="cpu")
        sdata = rng.normal(size=(n, 4, 16, 16, 6)).astype(np.float32)
        strainer = Trainer(sbench.build_diffusion(scfg, snet, device="cpu"), snet,
                           ArrayDataset(sdata).batches(n), smoke_derive_cond,
                           tcfg("smoke"), mesh=mesh)
        if strainer.train(progress=False) != 1:
            raise AssertionError("the smoke trainer did not take one step")
        _same_on_every_rank(mesh, snet, "the smoke UNet3D after a step")
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, timeout: float = 300.0) -> None:
    """Run the dry run on n CPU processes; raises if any rank fails."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [str(REPO),
                                                        os.environ.get("PYTHONPATH")])))
    with tempfile.TemporaryDirectory() as workdir:
        logs = [tempfile.TemporaryFile("w+") for _ in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "diffphycon_tpu_torch.parallel.dryrun", "--rank", str(r),
             "--world", str(n), "--init_method", f"tcp://localhost:{port}",
             "--workdir", workdir], cwd=REPO, env=env, stdout=log,
            stderr=subprocess.STDOUT, text=True)
            for r, log in enumerate(logs)]
        failed = []
        deadline = time.monotonic() + timeout
        try:
            # a rank that fails leaves the others waiting in a collective:
            # stop them all at the first failure or at the deadline
            while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for r, (p, log) in enumerate(zip(procs, logs)):
                log.seek(0)
                if p.returncode != 0:
                    failed.append(f"rank {r} exited {p.returncode}:\n{log.read()}")
                log.close()
    if failed:
        raise RuntimeError("dryrun_multichip failed\n" + "\n".join(failed))
    print(f"dryrun_multichip OK: {n} gloo ranks, a Burgers train step, two-model guided "
          "sampling with the batch sharded and gathered, a UNet3D train step")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", type=int, default=2, help="number of ranks")
    p.add_argument("--rank", type=int, default=None, help="(internal) run one rank")
    p.add_argument("--world", type=int, default=None)
    p.add_argument("--init_method", default=None)
    p.add_argument("--workdir", default=None)
    args = p.parse_args(argv)
    if args.rank is None:
        dryrun_multichip(args.n)
    else:
        run_rank(args.rank, args.world, args.init_method, args.workdir)


if __name__ == "__main__":
    main()
