"""Data and tensor parallelism over processes (counterpart of
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

The mesh's axes are the JAX package's: slice (a node; make_multislice_mesh),
data and model. The batch shards over (slice, data), so every sum over the
batch runs over a rank's data group; the tensor-parallel MLPs
(parallel/sharding.py) sum over its model group. Each collective below takes
the axis it runs over.

Without a launcher (no RANK / WORLD_SIZE in the environment) make_mesh
returns a world of 1 with no process group, and every caller takes its
plain single-process path.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sln_tpu_torch import resolve_device


DATA_AXIS = "data"
MODEL_AXIS = "model"
SLICE_AXIS = "slice"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a (slice, data, model) mesh of ranks.

    rank, world_size: the process group's; device: the rank's device;
    backend: the group's (None: no group). shape is (slices, data ranks
    per slice, model ranks), coords this rank's (slice, data, model) place
    in it; both default to a data-only mesh, (1, world_size, 1) and
    (0, rank, 0). The batch shards jointly over (slice, data): its `data
    group` holds the ranks of this rank's model index, its `model group`
    the ranks of its (slice, data) place. groups maps DATA_AXIS and
    MODEL_AXIS to their process groups where they are not the whole world
    (absent: the default group), and axis_ranks each axis's ranks in
    coordinate order."""
    rank: int
    world_size: int
    device: torch.device
    backend: Optional[str] = None
    owns_group: bool = False
    shape: Optional[Tuple[int, int, int]] = None
    coords: Optional[Tuple[int, int, int]] = None
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict,
                                               compare=False)
    axis_ranks: Dict[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict, compare=False)

    def __post_init__(self):
        if self.shape is None:
            object.__setattr__(self, "shape", (1, self.world_size, 1))
        if self.coords is None:
            object.__setattr__(self, "coords", (0, self.rank, 0))

    @property
    def distributed(self) -> bool:
        """A process group exists: the collectives run (at a world of 1
        too, where they are identities)."""
        return self.backend is not None

    @property
    def num_model(self) -> int:
        return self.shape[2]

    @property
    def data_size(self) -> int:
        """The ranks a batch shards over: slices x data ranks per slice."""
        return self.shape[0] * self.shape[1]

    @property
    def data_index(self) -> int:
        """This rank's shard of a batch, of data_size."""
        return self.coords[0] * self.shape[1] + self.coords[1]

    @property
    def model_index(self) -> int:
        return self.coords[2]

    def ranks(self, axis: Optional[str]) -> Tuple[int, ...]:
        """The ranks of this rank's group on `axis` (None: every rank), in
        the order of their coordinate on it."""
        if axis in self.axis_ranks:
            return self.axis_ranks[axis]
        if axis == MODEL_AXIS and self.num_model == 1:
            return (self.rank,)
        return tuple(range(self.world_size))

    def rows(self, n: int) -> slice:
        """This rank's contiguous share of n rows (by its data index)."""
        if n % self.data_size:
            raise ValueError(f"{n} rows do not split over "
                             f"{self.data_size} ranks")
        per = n // self.data_size
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def close(self) -> None:
        """Destroy the process group if make_mesh created it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _launcher_world() -> Tuple[bool, int]:
    env = os.environ
    launched = "WORLD_SIZE" in env and "RANK" in env
    return launched, int(env["WORLD_SIZE"]) if launched else 1


def _join_group(device: str, init_method: Optional[str], what: str):
    """Initialise (or join) the launcher's process group: (rank, device,
    backend, owns)."""
    env = os.environ
    world = int(env["WORLD_SIZE"])
    rank = int(env["RANK"])
    dev = resolve_device(device)
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
        print(f"| {what}: {world} ranks, backend {backend}"
              + (f" ({local_world} ranks sharing {torch.cuda.device_count()}"
                 " cards)" if backend == "gloo" and dev.type == "cuda"
                 else ""), flush=True)
    return rank, dev, backend, owns


def _mesh_from_grid(grid: np.ndarray, rank: int, dev: torch.device,
                    backend: str, owns: bool) -> Mesh:
    """The Mesh of `rank` in a (slices, data, model) grid of every rank.
    Every rank creates every subgroup, in the same order (new_group's
    contract); with one model rank the data group is the whole world and
    no subgroup is made."""
    S, D, M = grid.shape
    coords = tuple(int(c) for c in np.argwhere(grid == rank)[0])
    groups, axis_ranks = {}, {}
    if M > 1:
        data = [grid[..., m].reshape(-1).tolist() for m in range(M)]
        model = [grid[s, d].tolist() for s in range(S) for d in range(D)]
        for m, ranks in enumerate(data):
            group = dist.new_group(ranks)
            if m == coords[2]:
                groups[DATA_AXIS], axis_ranks[DATA_AXIS] = group, tuple(ranks)
        for i, ranks in enumerate(model):
            group = dist.new_group(ranks)
            if i == coords[0] * D + coords[1]:
                groups[MODEL_AXIS] = group
                axis_ranks[MODEL_AXIS] = tuple(ranks)
    elif S * D > 1:
        axis_ranks[DATA_AXIS] = tuple(grid.reshape(-1).tolist())
    return Mesh(rank, int(grid.size), dev, backend, owns, (S, D, M), coords,
                groups, axis_ranks)


def make_mesh(num_data: Optional[int] = None, num_model: int = 1,
              device: str = "cuda", init_method: Optional[str] = None
              ) -> Mesh:
    """The (data, model) mesh of this process, from the launcher's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
    MASTER_ADDR / MASTER_PORT); model is innermost, so a model group is
    num_model contiguous ranks (the JAX package's mesh.py:36-44).

    num_data x num_model, when num_data is given, must equal the
    launcher's world size (1 without a launcher); without it num_data is
    the world over num_model. init_method overrides env:// (a file://
    store in the tests). A process group that already exists is joined,
    not owned."""
    launched, world = _launcher_world()
    if num_model < 1 or world % num_model:
        raise ValueError(f"{world} ranks do not split into model groups of "
                         f"{num_model}")
    need = None if num_data is None else num_data * num_model
    if need is not None and need != world:
        started = (f"the launcher started {world}" if launched
                   else "no launcher started any")
        what, how = ((f"--num_data_shards {num_data}",
                      f"-m sln_tpu_torch.train --num_data_shards {num_data}")
                     if num_model == 1 else
                     (f"a mesh of {num_data} data x {num_model} model ranks",
                      "<program>"))
        raise ValueError(
            f"{what} needs {need} ranks, but "
            f"{started}: launch as `python -m torch.distributed.run "
            f"--standalone --nproc_per_node {need} {how} ...`")
    if not launched:
        return Mesh(0, 1, resolve_device(device))
    what = ("data parallel" if num_model == 1
            else f"data x model mesh {world // num_model} x {num_model}")
    rank, dev, backend, owns = _join_group(device, init_method, what)
    grid = np.arange(world).reshape(1, world // num_model, num_model)
    return _mesh_from_grid(grid, rank, dev, backend, owns)


def multislice_layout(num_slices: int, data_per_slice: Optional[int],
                      num_model: int, nodes: Sequence[Optional[int]]
                      ) -> np.ndarray:
    """The (slices, data per slice, model) grid of global ranks for the
    multi-slice mesh, from the node of each rank (`nodes[r]`: its
    GROUP_RANK, None where the launcher gave none; the world is len(nodes)
    and a node's size the count of its ranks). A slice is a node: the
    rules of the JAX package's mesh.py:78-129, with ValueError for each
    topology that does not fit.

    - The mesh must fit the world, and every rank takes a place in it (a
      rank outside the mesh would have no work).
    - Ranks that name their node and ranks that do not may not mix.
    - Over several nodes the layout is strict: asking for more slices than
      there are nodes, nodes of unequal size, or a node with fewer ranks
      than a slice needs raise; each slice is one node's ranks (ascending),
      so a slice never straddles two nodes and a model group, innermost,
      never leaves its slice.
    - On a single node (or where no rank names one) contiguous groups of
      ranks simulate the slices: no node boundary exists to misalign."""
    world = len(nodes)
    if num_slices < 1 or num_model < 1:
        raise ValueError(f"mesh {num_slices} slices x {num_model} model "
                         "ranks: both must be positive")
    if data_per_slice is None:
        data_per_slice = world // (num_slices * num_model)
    per_slice = data_per_slice * num_model
    need = num_slices * per_slice
    shape = f"{num_slices}x{data_per_slice}x{num_model}"
    if not 0 < need <= world:
        raise ValueError(f"mesh {shape} > {world} ranks")
    by_node: Dict[Optional[int], list] = {}
    for rank, node in enumerate(nodes):
        by_node.setdefault(node, []).append(rank)
    if None in by_node and len(by_node) > 1:
        raise ValueError("the ranks mix node-indexed and nodeless ranks "
                         f"(nodes {sorted(by_node, key=repr)}); launch every "
                         "rank with its GROUP_RANK")
    if None not in by_node and len(by_node) > 1:
        if len(by_node) < num_slices:
            raise ValueError(f"requested {num_slices} slices but the ranks "
                             f"span only {len(by_node)} nodes (nodes "
                             f"{sorted(by_node)})")
        sizes = {node: len(r) for node, r in by_node.items()}
        if len(set(sizes.values())) > 1:
            raise ValueError(f"nodes of unequal size {sizes}: a slice is a "
                             "node")
        picked = sorted(by_node)[:num_slices]
        for node in picked:
            if sizes[node] < per_slice:
                raise ValueError(f"node {node} has {sizes[node]} ranks, "
                                 f"need {per_slice}: a slice may not "
                                 "straddle two nodes")
        ordered = [r for node in picked for r in by_node[node][:per_slice]]
    else:
        ordered = list(range(need))
    if need != world:
        raise ValueError(f"mesh {shape} places {need} of {world} ranks: "
                         "every rank needs a place")
    return np.asarray(ordered).reshape(num_slices, data_per_slice, num_model)


def make_multislice_mesh(num_slices: int,
                         data_per_slice: Optional[int] = None,
                         num_model: int = 1, device: str = "cuda",
                         init_method: Optional[str] = None) -> Mesh:
    """The hybrid (slice, data, model) mesh (the JAX package's
    mesh.py:47-131): slice outermost, model innermost. The slice of a GPU
    job is its node: each rank's GROUP_RANK (torchrun's node rank), shared
    over the world once, and multislice_layout places the ranks. The batch
    shards jointly over (slice, data) in one all-reduce over the data
    group (NCCL picks its own topology across nodes); the model group
    stays inside a slice."""
    launched, world = _launcher_world()
    # the sizes are checked before any group exists
    multislice_layout(num_slices, data_per_slice, num_model, [None] * world)
    if not launched:
        return Mesh(0, 1, resolve_device(device))
    node = os.environ.get("GROUP_RANK")
    rank, dev, backend, owns = _join_group(
        device, init_method, f"multi-slice mesh of {num_slices} slices")
    try:
        nodes = [None] * world
        dist.all_gather_object(nodes, None if node is None else int(node))
        grid = multislice_layout(num_slices, data_per_slice, num_model,
                                 nodes)
        return _mesh_from_grid(grid, rank, dev, backend, owns)
    except BaseException:
        if owns:
            dist.destroy_process_group()
        raise


def data_axes(mesh: Mesh) -> tuple:
    """The mesh axes the batch dimension shards over: (slice, data) on a
    multi-slice mesh, (data,) otherwise (the JAX package's
    mesh.py:134-137)."""
    return ((SLICE_AXIS, DATA_AXIS) if mesh.shape[0] > 1 else (DATA_AXIS,))


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def _staged(t: torch.Tensor, mesh: Mesh) -> bool:
    """Gloo reduces on the host: CUDA tensors go through a CPU copy."""
    return mesh.backend == "gloo" and t.is_cuda


def _runs(mesh: Mesh, axis: Optional[str]) -> bool:
    """The collective over `axis` has work: a process group exists and,
    on the model axis, more than one model rank."""
    return mesh.distributed and not (axis == MODEL_AXIS
                                     and mesh.num_model == 1)


def all_reduce_sum(t: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS
                   ) -> torch.Tensor:
    """Sum `t` over this rank's group on `axis`, in place (no autograd);
    returns it. Every rank of the group gets the same bits."""
    if not _runs(mesh, axis):
        return t
    group = mesh.groups.get(axis)
    if _staged(t, mesh):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the group; the backward sums the incoming
    gradients over the group, since every rank's loss reads y."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce_sum(x.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return (all_reduce_sum(g.contiguous().clone(), ctx.mesh, ctx.axis),
                None, None)


def all_reduce_sum_grad(t: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS
                        ) -> torch.Tensor:
    """all_reduce_sum through autograd (a new tensor)."""
    if not _runs(mesh, axis):
        return t
    return _AllReduceSum.apply(t, mesh, axis)


def all_reduce_flat(tensors, mesh: Mesh, axis: str = DATA_AXIS) -> list:
    """Sum a list of tensors over the group in one collective (flattened
    into one buffer); returns new tensors shaped as the inputs."""
    if not _runs(mesh, axis):
        return list(tensors)
    flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in tensors]), mesh,
                          axis)
    return [v.view_as(t) for v, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def all_gather_rows(t: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS,
                    dim: int = 0) -> torch.Tensor:
    """Every rank's `t` of the group, concatenated along `dim` in the
    order of their coordinate on `axis`."""
    if not _runs(mesh, axis):
        return t
    ranks = mesh.ranks(axis)
    src = t.cpu() if _staged(t, mesh) else t.contiguous()
    parts = [torch.empty_like(src) for _ in ranks]
    dist.all_gather(parts, src, group=mesh.groups.get(axis))
    # all_gather returns the group's ranks in ascending order
    ascending = sorted(ranks)
    parts = [parts[ascending.index(r)] for r in ranks]
    return torch.cat(parts, dim).to(t.device)


def broadcast_(t: torch.Tensor, mesh: Mesh, axis: Optional[str] = None
               ) -> torch.Tensor:
    """The value of the group's first rank on `axis` (None: rank 0 of the
    world) on every rank of the group, in place."""
    if not _runs(mesh, axis):
        return t
    src, group = mesh.ranks(axis)[0], mesh.groups.get(axis)
    if _staged(t, mesh):
        host = t.cpu()
        dist.broadcast(host, src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src, group=group)
    return t


# ---------------------------------------------------------------------------
# Megatron's mappings for the tensor-parallel MLPs (the model group)
# ---------------------------------------------------------------------------
class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity forward; the backward sums the input's
    gradient over the model group (each rank holds its shard's part)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), ctx.mesh,
                              MODEL_AXIS), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the forward sums the partial products over the model
    group; the backward is the identity (every rank's loss reads the
    sum)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_sum(x.clone(), mesh, MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The model group's shards of the last dimension, concatenated; the
    backward keeps this rank's columns of the gradient (the loss after the
    gather is computed alike on every rank of the group)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.index, ctx.width = mesh.model_index, x.shape[-1]
        return all_gather_rows(x, mesh, MODEL_AXIS, dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh) if _runs(mesh, MODEL_AXIS) else x


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh) if _runs(mesh, MODEL_AXIS) else x


def gather_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _GatherFromModel.apply(x, mesh) if _runs(mesh, MODEL_AXIS) else x


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
    """This rank's rows (by its data index) of every tensor's leading
    (batch) axis."""
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
    all-gather over the data group in data order), where a caller needs the
    whole array."""
    return tree_map(lambda t: all_gather_rows(t, mesh), local_tree)
