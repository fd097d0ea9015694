"""Megatron tensor parallelism for the MLPs (counterpart of
sln_tpu/parallel/sharding.py).

Every MLP of the model is one or two stages (models/layers.MLP): the first
Linear is column-parallel, the BatchNorm after it holds its shard of the
features, and the second Linear is row-parallel, so the hidden activations
are split over the mesh's model group. Embeddings and everything else are
replicated. The JAX package names these rules by flax path (dense_0's
kernel and bias and bn_0 over the model axis on their output dimension,
dense_1's kernel on its input dimension); here they are carried into the
reference layout the port's modules keep (Linear@0, BN@1, the second
Linear @3 with BatchNorm and @2 without), where a Linear's weight is
(out, in): dense_0's weight splits on dimension 0, dense_1's on 1.
"""

from __future__ import annotations

import itertools
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from sln_tpu_torch.models.layers import MLP, MaskedBatchNorm
from sln_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, all_gather_rows

_BN_SHARDED = ("weight", "bias", "running_mean", "running_var")


def _join(*parts: str) -> str:
    return ".".join(p for p in parts if p)


def partition_specs(model: nn.Module) -> Dict[str, Optional[int]]:
    """Every parameter and buffer name of `model` (its state_dict keys) ->
    the dimension split over the model axis, or None (replicated)."""
    specs: Dict[str, Optional[int]] = dict.fromkeys(model.state_dict())
    for prefix, mlp in model.named_modules():
        if not isinstance(mlp, MLP):
            continue
        linears = [str(i) for i, layer in enumerate(mlp)
                   if isinstance(layer, nn.Linear)]
        first = linears[0]
        specs[_join(prefix, first, "weight")] = 0
        specs[_join(prefix, first, "bias")] = 0
        after = int(first) + 1
        if after < len(mlp) and isinstance(mlp[after], MaskedBatchNorm):
            for leaf in _BN_SHARDED:
                specs[_join(prefix, str(after), leaf)] = 0
        if len(linears) > 1:
            specs[_join(prefix, linears[1], "weight")] = 1
    return specs


def _named_tensors(model: nn.Module):
    return itertools.chain(model.named_parameters(), model.named_buffers())


@torch.no_grad()
def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Keep this rank's shard (its model index of num_model equal chunks)
    of every split tensor of `model`, in place (the Parameter objects stay,
    so an optimizer built on them follows), and run its MLPs tensor-parallel
    over `mesh`. Returns the model. A dimension that does not split evenly
    raises. With one model rank the model is left as it is."""
    if mesh.num_model == 1:
        return model
    specs = partition_specs(model)
    for name, t in _named_tensors(model):
        dim = specs[name]
        if dim is None:
            continue
        if t.shape[dim] % mesh.num_model:
            raise ValueError(f"{name}: dimension {dim} of {tuple(t.shape)} "
                             f"does not split over {mesh.num_model} model "
                             "ranks")
        t.data = local_shard(t.data, dim, mesh)
    for module in model.modules():
        if isinstance(module, MLP):
            module.model_mesh = mesh
    return model


def local_shard(t: torch.Tensor, dim: Optional[int], mesh: Mesh
                ) -> torch.Tensor:
    """This rank's chunk of `t` along `dim` (a contiguous copy), or `t`
    when dim is None."""
    if dim is None:
        return t
    return t.chunk(mesh.num_model, dim)[mesh.model_index].contiguous()


@torch.no_grad()
def gather_params(model: nn.Module, mesh: Mesh,
                  tensors: Optional[Mapping[str, torch.Tensor]] = None
                  ) -> Dict[str, torch.Tensor]:
    """The full tensors back from their shards (an all-gather over the
    model group along each split dimension): `tensors` keyed by the
    model's names (its state_dict by default; Adam's moments by parameter
    name follow the same specs)."""
    specs = partition_specs(model)
    if tensors is None:
        tensors = model.state_dict()
    return {name: t.detach() if specs[name] is None
            else all_gather_rows(t.detach(), mesh, MODEL_AXIS,
                                 dim=specs[name])
            for name, t in tensors.items()}
