"""Data parallelism (``diffphycon_tpu_torch/parallel``, the Trainer's
``mesh=``) on the CPU: two gloo ranks in two processes, each this file run
as a script (``python tests/test_torch_port_parallel.py RANK WORLD
INIT_METHOD OUT``: ``rank_main``).

- One optimizer step on two ranks, each on its shard of the global batch,
  equals the one-process full-batch step (gradient accumulation 1 and 2):
  the parameters and the EMA to 1e-6 of max(1, max |ref|). The ranks
  average their shard means, the reference takes the mean over the batch:
  the two differ by summation order only. The jellyfish EBM's averaged
  gradient (double backward) equals the full batch's to 1e-5 of its
  largest entry (its test says why).
- Sharded DDIM (eta 0) sampling, gathered, equals unsharded sampling to
  2e-3 of max(1, max |ref|) (the repo's DDIM limit: from t = T the steps
  amplify a forward's rounding ~1e4-fold; the shards run the same math on
  half the batch).
- ``dryrun_multichip(2)`` runs: a Burgers step, sharded two-model guided
  sampling and a UNet3D step on two ranks that agree on their weights.
- A SIGTERM that reaches one rank stops both after the same step, the one
  that follows it (the ranks agree on the flag on the host, one step
  late), and rank 0 saves a checkpoint there.
- A world of one needs no process group and is the plain path; an explicit
  CUDA index is kept unless it conflicts with torchrun's local rank.
"""

import os
import signal
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # run as a script

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from diffphycon_tpu_torch.apps.train_jellyfish import _GD  # noqa: E402
from diffphycon_tpu_torch.benchmarks import burgers as bench  # noqa: E402
from diffphycon_tpu_torch.benchmarks import jellyfish as jbench  # noqa: E402
from diffphycon_tpu_torch.nets.init import seeded_init_  # noqa: E402
from diffphycon_tpu_torch.nets.unet3d import UNet3D  # noqa: E402
from diffphycon_tpu_torch.parallel import (  # noqa: E402
    Mesh,
    make_mesh,
    replicate,
    sample_sharded,
    shard_batch,
)
from diffphycon_tpu_torch.parallel.dryrun import dryrun_multichip, free_port  # noqa: E402
from diffphycon_tpu_torch.training.trainer import Trainer, TrainerConfig  # noqa: E402
from torch_port_helpers import assert_close  # noqa: E402

GLOBAL_BATCH = 4


def parallel_case(accum: int, mesh=None):
    """(trainer, global batch) of the tiny Burgers case; the same on every
    rank and in the one-process reference."""
    cfg = bench.BurgersConfig(dim=8, dim_mults=(1, 2), is_condition_u0=True,
                              is_condition_uT=True)
    net = bench.init_params(cfg, seed=0, device="cpu")
    gd = bench.build_diffusion(cfg, net, device="cpu")
    rng = np.random.default_rng(0)
    batch = (0.3 * rng.normal(size=(GLOBAL_BATCH, 16, 128, 2))).astype(np.float32)
    tcfg = TrainerConfig(train_batch_size=GLOBAL_BATCH, gradient_accumulate_every=accum,
                         results_folder=tempfile.mkdtemp(), seed=5)
    return Trainer(gd, net, iter(()), bench.derive_cond, tcfg, device=None if mesh else "cpu",
                   mesh=mesh), batch


def ebm_case(mesh=None):
    """(trainer, global tuple batch) of the jellyfish EBM ("states") model
    through the train app's loss seam, UNet3D dim 8 at 4 frames of 16x16."""
    cfg = jbench.JellyfishConfig(dim=8, dim_mults=(1, 2), frames=4, image_size=16,
                                 timesteps=20, beta_schedule="cosine")
    net = seeded_init_(UNet3D(dim=8, dim_mults=(1, 2), channels=7, out_dim=4, remat_all=True),
                       torch.Generator().manual_seed(0))
    gd = _GD(jbench.JellyfishDiffusion(cfg, net, device="cpu"), "states")
    rng = np.random.default_rng(3)
    batch = (rng.uniform(-1, 1, size=(GLOBAL_BATCH, 4, 16, 16, 3)).astype(np.float32),
             rng.normal(size=(GLOBAL_BATCH, 4, 16, 16, 3)).astype(np.float32),
             rng.normal(size=(GLOBAL_BATCH, 4)).astype(np.float32))
    tcfg = TrainerConfig(train_batch_size=GLOBAL_BATCH, results_folder=tempfile.mkdtemp(),
                         lr_schedule="multistep", seed=5)
    return Trainer(gd, net, iter(()), lambda b: None, tcfg, device=None if mesh else "cpu",
                   mesh=mesh), batch


def sampling_case():
    """(diffusion, u_target, fn(u_target) -> guidance, fn(u_target) ->
    cond_vals) of the sharded DDIM check: two tiny models, 5 DDIM steps of
    20, the whole batch's targets."""
    cfg = bench.BurgersConfig(dim=8, dim_mults=(1, 2), is_condition_u0=True,
                              is_condition_uT=True, timesteps=20, using_ddim=True,
                              ddim_sampling_steps=5, prior_beta=0.5)
    nets = [bench.init_params(cfg, seed=s, device="cpu") for s in (0, 1)]
    gd = bench.build_diffusion(cfg, nets[0], model_w=nets[1], device="cpu")
    u = torch.from_numpy(np.random.default_rng(1).normal(
        size=(GLOBAL_BATCH, 11, 128)).astype(np.float32))

    def guidance(u_target):
        return bench.build_guidance(cfg, u_target, wu=100.0, w_scheduler="cosine",
                                    proj_guidance="ep_orthogonal_F")

    def cond(u_target):
        return {"u0": u_target[:, 0] / bench.RESCALER, "uT": u_target[:, 10] / bench.RESCALER}

    return gd, u, guidance, cond


def sigterm_batches(batch, raise_at=None):
    """The batch, step after step; SIGTERM to this process while the
    batch of step ``raise_at`` is fetched (that step is in flight)."""
    step = 0
    while True:
        step += 1
        if step == raise_at:
            os.kill(os.getpid(), signal.SIGTERM)
        yield batch


def rank_main(rank: int, world: int, init_method: str, out: str) -> None:
    """One rank of the two-rank run (``two_ranks``); rank 0 saves to out."""
    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu", rank=rank, world_size=world, init_method=init_method)
    result = {}
    for accum in (1, 2):
        trainer, batch = parallel_case(accum, mesh)
        result[f"loss_{accum}"] = float(trainer.train_step(batch))
        result[f"params_{accum}"] = [p.detach().clone() for p in trainer.params]
        result[f"ema_{accum}"] = [e.clone() for e in trainer.ema]
    trainer, batch = ebm_case(mesh)
    trainer.compute_grads(tuple(torch.as_tensor(b) for b in batch))
    result["grads_ebm"] = [p.grad.clone() for p in trainer.params]
    trainer, batch = parallel_case(1, mesh)
    trainer.cfg.train_num_steps = 6
    trainer.batch_iter = sigterm_batches(batch, raise_at=3 if rank == 1 else None)
    steps = [None] * world
    dist.all_gather_object(steps, trainer.train(progress=False))
    result["sigterm_steps"] = steps
    result["sigterm_saved"] = Trainer.latest_milestone(str(trainer.results_folder))
    gd, u, guidance, cond = sampling_case()
    result["ddim"] = sample_sharded(mesh, gd, GLOBAL_BATCH, cond(u), guidance(u),
                                    torch.Generator().manual_seed(2))
    if mesh.is_main:
        torch.save(result, out)
    dist.destroy_process_group()



@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ddp") / "rank0.pt"
    init = f"tcp://localhost:{free_port()}"
    procs = [subprocess.Popen([sys.executable, __file__, str(r), "2", init, str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return torch.load(out)


@pytest.mark.parametrize("accum", [1, 2])
def test_port_two_rank_step_equals_full_batch_step(two_ranks, accum):
    trainer, batch = parallel_case(accum=1)
    loss = trainer.train_step(batch)
    for out, ref in zip(two_ranks[f"params_{accum}"], trainer.params):
        assert_close(out, ref, 1e-6)
    for out, ref in zip(two_ranks[f"ema_{accum}"], trainer.ema):
        assert_close(out, ref, 1e-6)
    # rank 0's loss is its shard's half of the batch (t and noise sliced
    # from the same global draw)
    assert np.isfinite(two_ranks[f"loss_{accum}"]) and np.isfinite(float(loss))
    assert any(not torch.equal(p, q) for p, q in
               zip(two_ranks[f"params_{accum}"], parallel_case(1)[0].params))


def test_port_two_rank_ebm_gradient_equals_full_batch_gradient(two_ranks):
    """The jellyfish EBM under DDP: the loss is the gradient of an energy
    (double backward) through remat-ed UNet3D blocks, on a tuple batch. The
    averaged gradient against the full batch's, to 1e-5 of the largest
    entry: a second-order quantity with cancelling terms, whose rounding
    depends on the batch it is computed on (the two half-batch gradients
    averaged by hand, without DDP, differ from the full batch's by ~2e-6 of
    the largest entry on a CPU). Parameters after Adam are not compared:
    its first step lr * g / (|g| + eps) turns that rounding into ~4e-6 of a
    parameter where |g| is near eps."""
    trainer, batch = ebm_case()
    trainer.compute_grads(tuple(torch.as_tensor(b) for b in batch))
    scale = max(float(p.grad.abs().max()) for p in trainer.params)
    for out, p in zip(two_ranks["grads_ebm"], trainer.params):
        err = float((out - p.grad).abs().max())
        assert err <= 1e-5 * scale, (err, scale)


def test_port_sharded_ddim_equals_unsharded(two_ranks):
    gd, u, guidance, cond = sampling_case()
    ref = gd.sample(GLOBAL_BATCH, cond(u), guidance(u), torch.Generator().manual_seed(2))
    assert_close(two_ranks["ddim"], ref, 2e-3)


def test_port_two_rank_sigterm_stops_every_rank_at_one_step(two_ranks):
    """Rank 1 alone gets SIGTERM during step 3; both ranks stop after step 4
    (rank 1's flag, ORed on the host while step 4 ran) and rank 0 saves
    there, not at train_num_steps 6."""
    assert two_ranks["sigterm_steps"] == [4, 4]
    assert two_ranks["sigterm_saved"] == 4


def test_port_dryrun_multichip_two_ranks():
    dryrun_multichip(2)


def two_of(rank):
    return Mesh(rank=rank, world_size=2, local_rank=rank, device=torch.device("cpu"),
                grouped=False)


def test_port_world_of_one_is_the_plain_path(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.grouped, mesh.is_main) == (0, 1, False, True)
    x = torch.arange(6.0)
    assert shard_batch(mesh, {"a": x, "b": (x, x.numpy())})["b"][1].shape == (6,)
    assert torch.equal(shard_batch(two_of(1), x), torch.arange(3.0, 6.0))
    net = torch.nn.Linear(2, 2)
    assert replicate(mesh, net) is net
    with mesh.main_first():
        pass
    # the trainer under a world-of-one mesh takes the same step as without
    a, batch = parallel_case(accum=2)
    b, _ = parallel_case(accum=2, mesh=mesh)
    assert b.ddp is None
    a.train_step(batch)
    b.train_step(batch)
    for p, q in zip(a.params, b.params):
        assert torch.equal(p, q)


def test_port_make_mesh_rejects(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="model-parallel"):
        make_mesh(n_model=2, device="cpu")
    with pytest.raises(ValueError, match="n_data=2"):
        make_mesh(n_data=2, device="cpu")
    two = two_of(0)
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(two, torch.zeros(3))
    assert torch.equal(shard_batch(two, torch.arange(4))[1], torch.tensor(1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()


@pytest.mark.parametrize("device, local_rank, want", [
    ("cuda:1", None, "cuda:1"),   # a plain run keeps the index it was given
    ("cuda", "1", "cuda:1"),      # torchrun's LOCAL_RANK pins an unindexed request
    ("cuda:1", "1", "cuda:1"),
    ("cuda:0", "1", "conflicts"),
])
def test_port_make_mesh_cuda_index(monkeypatch, device, local_rank, want):
    """CUDA faked on the CPU: the device make_mesh pins, in a world of one."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    if local_rank is not None:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    pinned = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", pinned.append)
    if want == "conflicts":
        with pytest.raises(ValueError, match="conflicts with local rank 1"):
            make_mesh(device=device)
        assert pinned == []
        return
    mesh = make_mesh(device=device)
    assert (mesh.device, mesh.world_size, mesh.grouped) == (torch.device(want), 1, False)
    assert pinned == [torch.device(want)]


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
