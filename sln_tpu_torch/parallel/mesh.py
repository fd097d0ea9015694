"""Data parallelism over processes (counterpart of the data axis of
sln_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a mesh of devices, and XLA
inserts the collectives (the gradient sums, the masked-BatchNorm
statistics) because the sharded program is the whole-batch program. The
port runs one process per rank, the torch.distributed idiom:

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m sln_tpu_torch.train --num_data_shards N ...

and sums across ranks by hand wherever the whole-batch computation sums
over the batch: a step over a global batch of B rows sharded over N ranks
computes what the single-device step computes on those B rows.

Backend, fixed (and printed by rank 0), never retried on another:
  - NCCL when every rank on the host has a card of its own (rank r on
    cuda:LOCAL_RANK);
  - gloo on the CPU;
  - gloo with ranks sharing the cards when they outnumber the visible
    cards (NCCL refuses two ranks on one device): how one card runs a
    2-rank check. Gloo's collectives go through host copies of CUDA
    tensors here.

Without a launcher (no RANK / WORLD_SIZE in the environment) make_mesh
returns a world of 1 with no process group, and every caller takes its
plain single-process path.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from sln_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data-only mesh of this process: its rank, the world size, the
    rank's device and the process group's backend (None: no group)."""
    rank: int
    world_size: int
    device: torch.device
    backend: Optional[str] = None
    owns_group: bool = False

    @property
    def distributed(self) -> bool:
        """A process group exists: the collectives run (at a world of 1
        too, where they are identities)."""
        return self.backend is not None

    def rows(self, n: int) -> slice:
        """This rank's contiguous share of n rows."""
        if n % self.world_size:
            raise ValueError(f"{n} rows do not split over "
                             f"{self.world_size} ranks")
        per = n // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)

    def close(self) -> None:
        """Destroy the process group if make_mesh created it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def make_mesh(num_data: Optional[int] = None, device: str = "cuda",
              init_method: Optional[str] = None) -> Mesh:
    """The mesh of this process, from the launcher's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR / MASTER_PORT).

    num_data, when given, must equal the launcher's world size (1 without
    a launcher). init_method overrides env:// (a file:// store in the
    tests). A process group that already exists is joined, not owned."""
    env = os.environ
    launched = "WORLD_SIZE" in env and "RANK" in env
    world = int(env["WORLD_SIZE"]) if launched else 1
    if num_data is not None and num_data != world:
        started = (f"the launcher started {world}" if launched
                   else "no launcher started any")
        raise ValueError(
            f"--num_data_shards {num_data} needs {num_data} ranks, but "
            f"{started}: launch as `python -m torch.distributed.run "
            f"--standalone --nproc_per_node {num_data} -m sln_tpu_torch.train "
            f"--num_data_shards {num_data} ...`")
    dev = resolve_device(device)
    if not launched:
        return Mesh(0, 1, dev)
    rank = int(env["RANK"])
    local = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        backend = "nccl" if local_world <= cards else "gloo"
        dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
    else:
        backend = "gloo"
    owns = not dist.is_initialized()
    if owns:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world)
    elif dist.get_world_size() != world:
        raise ValueError(f"a process group of {dist.get_world_size()} "
                         f"ranks exists; the launcher says {world}")
    backend = dist.get_backend()
    if rank == 0:
        print(f"| data parallel: {world} ranks, backend {backend}"
              + (f" ({local_world} ranks sharing {torch.cuda.device_count()}"
                 " cards)" if backend == "gloo" and dev.type == "cuda"
                 else ""), flush=True)
    return Mesh(rank, world, dev, backend, owns)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def _staged(t: torch.Tensor, mesh: Mesh) -> bool:
    """Gloo reduces on the host: CUDA tensors go through a CPU copy."""
    return mesh.backend == "gloo" and t.is_cuda


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum `t` over the ranks, in place (no autograd); returns it. Every
    rank gets the same bits."""
    if not mesh.distributed:
        return t
    if _staged(t, mesh):
        host = t.cpu()
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks; the backward sums the incoming
    gradients over the ranks, since every rank's loss reads y."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce_sum(x.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), ctx.mesh), None


def all_reduce_sum_grad(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """all_reduce_sum through autograd (a new tensor)."""
    if not mesh.distributed:
        return t
    return _AllReduceSum.apply(t, mesh)


def all_reduce_flat(tensors, mesh: Mesh) -> list:
    """Sum a list of tensors over the ranks in one collective (flattened
    into one buffer); returns new tensors shaped as the inputs."""
    if not mesh.distributed:
        return list(tensors)
    flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in tensors]), mesh)
    return [v.view_as(t) for v, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's rows of `t`, concatenated along dim 0 in rank order."""
    if not mesh.distributed:
        return t
    src = t.cpu() if _staged(t, mesh) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.world_size)]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(t.device)


def broadcast_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank 0's value of `t` on every rank, in place."""
    if not mesh.distributed:
        return t
    if _staged(t, mesh):
        host = t.cpu()
        dist.broadcast(host, 0)
        t.copy_(host)
    else:
        dist.broadcast(t, 0)
    return t


# ---------------------------------------------------------------------------
# the counterparts of shard_batch, replicate, global_from_host_shards
# ---------------------------------------------------------------------------
def tree_map(fn: Callable[[torch.Tensor], Any], tree):
    """fn over the tensors of a tensor, a (named) tuple, a list or a dict;
    other leaves (None, numbers) pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def shard_batch(tree, mesh: Mesh):
    """This rank's rows of every tensor's leading (batch) axis."""
    if not mesh.distributed:
        return tree
    return tree_map(lambda t: t[mesh.rows(t.shape[0])], tree)


@torch.no_grad()
def replicate(tree, mesh: Mesh):
    """Rank 0's values on every rank, in place: the tensors of a tree, or
    the parameters and buffers of a module. Returns the tree."""
    if isinstance(tree, torch.nn.Module):
        for t in [*tree.parameters(), *tree.buffers()]:
            broadcast_(t.data, mesh)
    else:
        tree_map(lambda t: broadcast_(t, mesh), tree)
    return tree


def global_from_host_shards(local_tree, mesh: Mesh):
    """Each rank's rows assembled into the global batch on every rank (an
    all-gather in rank order), where a caller needs the whole array."""
    return tree_map(lambda t: all_gather_rows(t, mesh), local_tree)
