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

from typing import Sequence

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the valid rows of a padded (N, F) activation.

    torch.nn.BatchNorm1d semantics: eps 1e-5, momentum 0.1, biased
    variance to normalize, unbiased variance for the running update.
    Eval mode normalizes with the running statistics."""

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
            m = mask.to(x.dtype)[:, None]
            n = m.sum().clamp(min=1.0)
            # one pass sum / sum of squares, as the JAX module
            mean = (x * m).sum(0) / n
            var = ((x * x * m).sum(0) / n - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                unbiased = var * n / (n - 1.0).clamp(min=1.0)
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(unbiased, self.momentum)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


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
    Linear@2i, ReLU@2i+1."""

    def __init__(self, dims: Sequence[int], batch_norm: str = "none",
                 final_plain: bool = False):
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
        for layer in self:
            if isinstance(layer, nn.Linear):
                nn.init.kaiming_normal_(layer.weight)
                nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        for layer in self:
            x = layer(x, mask) if isinstance(layer, MaskedBatchNorm) \
                else layer(x)
        return x
