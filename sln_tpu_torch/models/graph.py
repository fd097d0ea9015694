"""Graph triple-convolution message passing (counterpart of
sln_tpu/models/graph.py; reference models/graph.py:36-143).

Batches are (B, O, D) node / (B, T, D) edge tensors with validity masks;
the edge gather and the avg pooling are batched one-hot matmuls
(ops.graphops). MLPs run over the flattened (B*T) / (B*O) rows so the
masked BatchNorm statistics cover the whole batch.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sln_tpu_torch.models.layers import MLP
from sln_tpu_torch.ops import graphops


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))


class GraphTripleConv(nn.Module):
    """One round of (subject, predicate, object) message passing:
    concat (s, p, o) -> net1 -> (new_s, new_p, new_o); avg-pool new_s /
    new_o into nodes (counts clamped to >= 1); node MLP net2.

    The MLPs compute in `dtype`; the edge one-hots take the activations'
    dtype, so under bfloat16 the gather and pool products, the counts and
    the division run in bfloat16, as in the JAX module (the one-hots and
    the small counts are exact there)."""

    def __init__(self, input_dim: int, hidden_dim: int,
                 output_dim: Optional[int] = None,
                 mlp_normalization: str = "none",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.output_dim = output_dim or input_dim
        H, Dout = hidden_dim, self.output_dim
        self.net1 = MLP((3 * input_dim, H, 2 * H + Dout),
                        batch_norm=mlp_normalization, dtype=dtype)
        self.net2 = MLP((H, H, Dout), batch_norm=mlp_normalization,
                        dtype=dtype)

    def forward(self, obj_vecs, pred_vecs, edges, obj_mask, triple_mask):
        B, O, _ = obj_vecs.shape
        T = pred_vecs.shape[1]
        H, Dout = self.hidden_dim, self.output_dim
        s_oh = graphops.edge_one_hot(edges[..., 0], O, triple_mask,
                                     obj_vecs.dtype)
        o_oh = graphops.edge_one_hot(edges[..., 1], O, triple_mask,
                                     obj_vecs.dtype)
        cur_s = graphops.gather_nodes(s_oh, obj_vecs)
        cur_o = graphops.gather_nodes(o_oh, obj_vecs)
        t_in = torch.cat([cur_s, pred_vecs, cur_o], -1)
        t_out = self.net1(_flat(t_in), _flat(triple_mask))
        t_out = t_out.reshape(B, T, 2 * H + Dout)
        new_s, new_p = t_out[..., :H], t_out[..., H:H + Dout]
        new_o = t_out[..., H + Dout:]
        pooled = graphops.avg_pool_edges(s_oh, o_oh, new_s, new_o)
        new_obj = self.net2(_flat(pooled), _flat(obj_mask))
        return new_obj.reshape(B, O, Dout), new_p


class GraphTripleConvNet(nn.Module):
    """Stack of GraphTripleConv layers (reference models/graph.py:114-143);
    'recurrent' mode applies one shared layer num_layers times."""

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int = 5,
                 mode: str = "feedforward", mlp_normalization: str = "none",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if mode not in ("feedforward", "recurrent"):
            raise ValueError(f"Invalid mode {mode!r}")
        self.num_layers = num_layers
        n_modules = num_layers if mode == "feedforward" else 1
        self.gconvs = nn.ModuleList(
            GraphTripleConv(input_dim, hidden_dim,
                            mlp_normalization=mlp_normalization, dtype=dtype)
            for _ in range(n_modules))

    def forward(self, obj_vecs, pred_vecs, edges, obj_mask, triple_mask):
        for i in range(self.num_layers):
            gconv = self.gconvs[i % len(self.gconvs)]
            obj_vecs, pred_vecs = gconv(obj_vecs, pred_vecs, edges,
                                        obj_mask, triple_mask)
        return obj_vecs, pred_vecs
