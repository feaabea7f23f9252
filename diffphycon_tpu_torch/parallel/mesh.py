"""Data parallelism over processes: the port's counterpart of the JAX
package's ``make_mesh``, ``shard_batch`` and ``replicate``
(``diffphycon_tpu/parallel/mesh.py``).

JAX shards the batch over a ``data`` axis of one device mesh and lets XLA
all-reduce the gradients. Here each device is one process (``torchrun
--nproc_per_node N``, one GPU a rank): :func:`make_mesh` joins the process
group (NCCL on CUDA, gloo on the CPU) and pins the rank to
``cuda:LOCAL_RANK``; :func:`shard_batch` takes the rank's contiguous slice
of a batch's leading axis; :func:`replicate` broadcasts a module's
parameters and buffers from rank 0; the trainer wraps its model in
``DistributedDataParallel``. A world of one process is the plain
single-device path: no process group, no environment variable needed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from diffphycon_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel world.

    rank / world_size: this process and the number of processes;
    device: the rank's device; grouped: a process group is initialised
    (always when world_size > 1; with world_size 1 only when the caller
    asked for one, so that a one-rank run can exercise the collectives);
    host_group: a gloo group for collectives on host tensors when the
    default group is NCCL (None: the default group is gloo)."""

    rank: int
    world_size: int
    local_rank: int
    device: torch.device
    grouped: bool
    host_group: Optional[Any] = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        if self.grouped:
            dist.barrier()

    def any_async(self, flag: bool) -> Callable[[], bool]:
        """Start an OR of ``flag`` over the ranks on the host (gloo: no
        device sync, nothing queued on the card); the returned callable
        waits for it and gives the result."""
        if not (self.grouped and self.world_size > 1):
            return lambda: flag
        t = torch.tensor([float(flag)])
        work = dist.all_reduce(t, dist.ReduceOp.MAX, group=self.host_group, async_op=True)

        def result() -> bool:
            work.wait()
            return bool(t.item())

        return result

    @contextlib.contextmanager
    def main_first(self):
        """Rank 0 runs the block first (e.g. writes a data cache); the other
        ranks run it after rank 0 has finished."""
        if not self.is_main:
            self.barrier()
        yield
        if self.is_main:
            self.barrier()


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value is None else int(value)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None,
              rank: Optional[int] = None, world_size: Optional[int] = None,
              local_rank: Optional[int] = None,
              init_method: Optional[str] = None) -> Mesh:
    """This process's place in the data-parallel world.

    rank / world_size / local_rank default to an initialised process group's,
    else to torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``, else to a
    world of one. ``n_data``, when given, must equal the world size.
    ``n_model`` must be 1: the JAX mesh's ``model`` axis carries no sharding
    anywhere in the JAX package, so there is nothing to port behind it.
    ``device``: "cuda" (default), "cuda:<index>" or "cpu". "cuda" is
    pinned to ``cuda:local_rank``; an explicit index is kept, and raises if
    it differs from a local rank that torchrun set or the caller gave.
    The process group is joined when the world has more than one process or
    ``init_method`` is given (e.g. ``tcp://localhost:29500``; default
    ``env://``, torchrun's MASTER_ADDR / MASTER_PORT); the backend is NCCL
    on CUDA (raises without it) and gloo on the CPU."""
    if n_model != 1:
        raise ValueError(f"n_model={n_model}: the port has no model-parallel axis (the "
                         "JAX mesh's 'model' axis shards nothing in the JAX package)")
    if dist.is_available() and dist.is_initialized():
        rank = dist.get_rank() if rank is None else rank
        world_size = dist.get_world_size() if world_size is None else world_size
    rank = _env_int("RANK", 0) if rank is None else rank
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None else world_size
    local_rank_given = local_rank is not None or "LOCAL_RANK" in os.environ
    local_rank = _env_int("LOCAL_RANK", rank) if local_rank is None else local_rank
    if n_data is not None and n_data != world_size:
        raise ValueError(f"n_data={n_data} but the world has {world_size} processes")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        elif local_rank_given and dev.index != local_rank:
            raise ValueError(f"device {dev} conflicts with local rank {local_rank}: one "
                             "GPU a rank, cuda:LOCAL_RANK (pass device='cuda')")
        torch.cuda.set_device(dev)
    grouped = dist.is_available() and dist.is_initialized()
    if not grouped and (world_size > 1 or init_method is not None):
        if not dist.is_available():
            raise RuntimeError("torch.distributed is not available in this build")
        if dev.type == "cuda":
            if not dist.is_nccl_available():
                raise RuntimeError("data parallelism on CUDA needs NCCL, which this "
                                   "PyTorch build lacks")
            backend = "nccl"
        else:
            backend = "gloo"
        kwargs = {"device_id": dev} if dev.type == "cuda" else {}
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size, **kwargs)
        grouped = True
    host_group = None
    if grouped and world_size > 1 and dist.get_backend() != "gloo":
        host_group = dist.new_group(backend="gloo")
    return Mesh(rank=rank, world_size=world_size, local_rank=local_rank, device=dev,
                grouped=grouped, host_group=host_group)


def shard_slice(mesh: Mesh, n: int) -> slice:
    """The rank's contiguous slice of a leading axis of length n."""
    if n % mesh.world_size:
        raise ValueError(f"a batch of {n} does not split over {mesh.world_size} ranks")
    per = n // mesh.world_size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(mesh: Mesh, batch):
    """The rank's contiguous shard of the leading axis of a tensor or numpy
    array, or of each entry of a tuple, list or dict of them."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    return batch[shard_slice(mesh, batch.shape[0])]


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast the module's parameters and buffers from rank 0 (in place);
    returns the module."""
    if mesh.grouped and mesh.world_size > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, 0)
    return module


def gather_batch(mesh: Mesh, shard: torch.Tensor) -> torch.Tensor:
    """Every rank's shard concatenated along the leading axis, in rank order
    (the whole batch, on every rank)."""
    if not (mesh.grouped and mesh.world_size > 1):
        return shard
    parts = [torch.empty_like(shard) for _ in range(mesh.world_size)]
    dist.all_gather(parts, shard.contiguous())
    return torch.cat(parts, dim=0)


def _rank_seed(seed: int, rank: int) -> int:
    """A seed of the rank's own, from (seed, rank)."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0] >> 1)


def _global_guidance(mesh: Mesh, guidance, sl: slice):
    """The guidance of the whole batch seen from one shard: its gradient
    and its combiner run on the gathered batch and the rank keeps its rows
    (a Burgers objective is a mean over the batch, and the 'F' orthogonal
    projection sums over it, so neither splits into shard-local terms)."""
    def nabla_j(x):
        return guidance.nabla_j(gather_batch(mesh, x))[sl]

    def proj(eps, g):
        return guidance.proj(gather_batch(mesh, eps), gather_batch(mesh, g))[sl]

    return dataclasses.replace(
        guidance, nabla_j=None if guidance.nabla_j is None else nabla_j, proj=proj)


def sample_sharded(mesh: Mesh, gd, batch_size: int, cond_vals: dict, guidance,
                   generator: torch.Generator) -> torch.Tensor:
    """``gd.sample`` with the batch sharded over the ranks: every rank draws
    x_T for the whole batch from ``generator`` (seeded alike on every rank)
    and keeps its shard, runs the steps on it with its replicated weights
    and the shard of ``cond_vals``, and the shards are gathered. cond_vals
    and guidance are the whole batch's; the guidance is evaluated on the
    gathered batch each step, so the result is that of the unsharded
    sampler (as JAX's jit over a sharded batch computes the same function).
    The steps' noise comes from ``generator`` in a world of one; with more
    ranks from a generator seeded by (its initial seed, rank), so no two
    shards share noise. Returns the whole batch, unnormalized, on every
    rank."""
    sl = shard_slice(mesh, batch_size)
    x = gd.sample_init(batch_size, generator)[sl]
    if mesh.world_size > 1:
        generator = torch.Generator(device=generator.device).manual_seed(
            _rank_seed(generator.initial_seed(), mesh.rank))
        cond_vals = shard_batch(mesh, cond_vals)
        guidance = _global_guidance(mesh, guidance, sl)
    x = gd.sample_chunk(x, gd.sample_ts(), cond_vals, guidance, generator)
    return gather_batch(mesh, gd.unnormalize(x))
