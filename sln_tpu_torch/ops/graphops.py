"""Batched graph primitives as one-hot matmuls (counterpart of
sln_tpu/ops/graphops.py): every scene is a fixed-size padded graph, so
the edge gather and the node pooling are batched products

    gather:  (B, T, O) @ (B, O, D) -> (B, T, D)
    pool:    (B, O, T) @ (B, T, D) -> (B, O, D)
"""

from __future__ import annotations

from typing import Optional

import torch


def edge_one_hot(idx: torch.Tensor, num_nodes: int,
                 mask: Optional[torch.Tensor] = None,
                 dtype=torch.float32) -> torch.Tensor:
    """One-hot of (B, T) local node indices -> (B, T, O), zeroed where
    masked. A comparison, not F.one_hot, whose range check would make the
    host wait for the card."""
    nodes = torch.arange(num_nodes, device=idx.device)
    oh = (idx[..., None] == nodes).to(dtype)
    if mask is not None:
        oh = oh * mask[..., None].to(dtype)
    return oh


def gather_nodes(one_hot: torch.Tensor, node_vecs: torch.Tensor
                 ) -> torch.Tensor:
    """(B, T, O) x (B, O, D) -> (B, T, D): per-edge endpoint features."""
    return torch.bmm(one_hot, node_vecs)


def pool_messages(one_hot: torch.Tensor, messages: torch.Tensor
                  ) -> torch.Tensor:
    """(B, T, O) x (B, T, D) -> (B, O, D): sum edge messages into nodes."""
    return torch.bmm(one_hot.transpose(1, 2), messages)


def avg_pool_edges(one_hot_s, one_hot_o, new_s, new_o) -> torch.Tensor:
    """Average-pool subject/object messages into nodes; nodes touched by
    zero edges divide by 1 (reference graph.py:93-108 count clamp)."""
    pooled = pool_messages(one_hot_s, new_s) + pool_messages(one_hot_o,
                                                             new_o)
    counts = (one_hot_s.sum(1) + one_hot_o.sum(1)).clamp(min=1.0)
    return pooled / counts[..., None]
