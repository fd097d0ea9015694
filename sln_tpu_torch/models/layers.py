"""Masked BatchNorm, the one-hot embedding and the reference-style MLP
(counterpart of sln_tpu/models/layers.py).

Batches are padded to static shapes, so BatchNorm takes its statistics
over the valid rows only — the reference's BatchNorm1d over the ragged
row axis on the same data. Module and parameter names follow the
reference state_dict (`make_mlp` Sequential indices, BatchNorm1d's
weight/bias/running_mean/running_var/num_batches_tracked), the layout
sln_tpu/utils/torch_port.py:109 reads.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sln_tpu_torch.parallel.mesh import (all_reduce_sum_grad, copy_to_model,
                                         gather_from_model,
                                         reduce_from_model)


@contextlib.contextmanager
def fp32_accumulation():
    """cuBLAS sums bfloat16 products in float32 throughout, as XLA does:
    PyTorch lets it keep split-K partial sums in bfloat16 unless
    allow_bf16_reduced_precision_reduction is off. Set around the forward
    and backward passes of a bfloat16 model (float32 products ignore it);
    the flag is put back after."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """F.linear computed in `dtype`, as flax's Dense(dtype=...): x, the
    weight and the bias cast to it; below float32 the bias is added after
    the product is rounded, as flax adds it. In float32 this is
    F.linear."""
    if dtype == torch.float32:
        return F.linear(x.to(dtype), weight.to(dtype), bias)
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the valid rows of a padded (N, F) activation.

    torch.nn.BatchNorm1d semantics: eps 1e-5, momentum 0.1, biased
    variance to normalize, unbiased variance for the running update.
    Eval mode normalizes with the running statistics. Statistics, running
    buffers and the normalisation are float32 whatever x's dtype; the
    output takes x's dtype (the JAX module's layers.py:70).

    `mesh` (set_mesh), when it has a process group: train mode takes the
    statistics over the valid rows of every rank of the data group, as the
    JAX module does over a sharded batch (the sums and the count
    all-reduced through autograd, so the backward sees the global
    statistics too), and the running buffers update from them, the same
    on every rank. Under tensor parallelism a BatchNorm after a
    column-parallel Linear holds its shard of the features, and its
    statistics still sum over the data group only."""

    mesh = None

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            # float32 statistics whatever x's dtype, as the JAX module
            m = mask.to(torch.float32)[:, None]
            xf = x.float()
            # one pass sum / sum of squares, as the JAX module
            s, ss, n = (xf * m).sum(0), (xf * xf * m).sum(0), m.sum()
            if self.mesh is not None and self.mesh.distributed:
                F_ = s.shape[0]
                sums = all_reduce_sum_grad(torch.cat([s, ss, n[None]]),
                                           self.mesh)
                s, ss, n = sums[:F_], sums[F_:2 * F_], sums[-1]
            n = n.clamp(min=1.0)
            mean = s / n
            var = (ss / n - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                unbiased = var * n / (n - 1.0).clamp(min=1.0)
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(unbiased, self.momentum)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        # normalised in float32 from the float32 statistics, returned in
        # x's dtype
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


def set_mesh(model: nn.Module, mesh) -> None:
    """Every MaskedBatchNorm of `model` takes its train-mode statistics
    over `mesh` (None: over this process's rows only)."""
    for module in model.modules():
        if isinstance(module, MaskedBatchNorm):
            module.mesh = mesh


class OneHotEmbedding(nn.Embedding):
    """nn.Embedding whose lookup is one_hot(idx) @ weight, as the JAX
    package's OneHotEmbed: the same values (one term of each sum is not
    zero), and a backward that is a matrix product, the same bits run to
    run. The gather's backward on the card (embedding_dense_backward) sums
    rows whose indices collide in an order that varies from run to run
    (measured at batch 256)."""

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        # a comparison, not F.one_hot, whose range check would make the
        # host wait for the card
        classes = torch.arange(self.num_embeddings, device=idx.device)
        return (idx[..., None] == classes).to(self.weight.dtype) @ self.weight


class MLP(nn.Sequential):
    """Reference `make_mlp` (models/graph.py:10-27): per stage
    Linear -> (BatchNorm) -> ReLU; `final_plain` (reference `norelu`)
    leaves the last stage a bare Linear. Sequential indices follow the
    reference: Linear@3i, BN@3i+1, ReLU@3i+2 with batch norm, else
    Linear@2i, ReLU@2i+1.

    `dtype` is the compute dtype, as flax's Dense(dtype=...): each Linear
    casts its input and its float32 weight and bias to it (`linear`), so
    the activations come out in `dtype` while the parameters stay
    float32.

    `model_mesh` (set by parallel.sharding.shard_params, which keeps this
    rank's shards of the weights): Megatron tensor parallelism over the
    mesh's model group. The first Linear is column-parallel (its input's
    gradient summed over the model group, Megatron's f), the BatchNorm
    after it runs on the local features, and the second Linear is
    row-parallel (its partial products summed over the model group,
    Megatron's g, and its bias added once after the sum). A one-stage MLP
    (a column-parallel Linear alone) all-gathers its output's features.
    Without it the MLP is the plain one."""

    model_mesh = None

    def __init__(self, dims: Sequence[int], batch_norm: str = "none",
                 final_plain: bool = False,
                 dtype: torch.dtype = torch.float32):
        layers = []
        stages = len(dims) - 1
        for i in range(stages):
            layers.append(nn.Linear(dims[i], dims[i + 1]))
            if i == stages - 1 and final_plain:
                break
            if batch_norm == "batch":
                layers.append(MaskedBatchNorm(dims[i + 1]))
            layers.append(nn.ReLU())
        super().__init__(*layers)
        self.dtype = dtype
        for layer in self:
            if isinstance(layer, nn.Linear):
                nn.init.kaiming_normal_(layer.weight)
                nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dt, tp = self.dtype, self.model_mesh
        if tp is not None:
            x = copy_to_model(x, tp)
        stage = 0
        for layer in self:
            if isinstance(layer, nn.Linear):
                if tp is not None and stage == 1:
                    x = reduce_from_model(linear(x, layer.weight, None, dt),
                                          tp)
                    x = x + layer.bias.to(dt)
                else:
                    x = linear(x, layer.weight, layer.bias, dt)
                stage += 1
            elif isinstance(layer, MaskedBatchNorm):
                x = layer(x, mask)
            else:
                x = layer(x)
        if tp is not None and stage == 1:
            x = gather_from_model(x, tp)
        return x
