"""Plain PyTorch Sg2ScVAE (3D-SLN, aluo-x/3D_SLN models/Sg2ScVAE_model.py
and models/graph.py), the reference the benchmark holds the measured
package's VAE against.

Float32, straightforward: embeddings are weight rows, the triple
convolution gathers and averages with index operations, BatchNorm takes
its train-mode statistics over the valid rows in two passes. Parameter
names follow the reference state_dict (make_mlp's Sequential indices), so
one state_dict loads into this module and into the measured package's.
Imports nothing of the measured package.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the valid rows: eps 1e-5, momentum 0.1."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x, mask):
        if self.training:
            rows = x[mask]
            mean = rows.mean(0)
            var = (rows - mean).square().mean(0)
            n = rows.shape[0]
            with torch.no_grad():
                self.running_mean.lerp_(mean, 0.1)
                self.running_var.lerp_(var * n / max(n - 1, 1), 0.1)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) / torch.sqrt(var + 1e-5) * self.weight + self.bias


class Embedding(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(n, dim))

    def forward(self, idx):
        return self.weight[idx]


class MLP(nn.Sequential):
    """Linear -> BatchNorm -> ReLU per stage; `plain_last` leaves the
    last stage a bare Linear."""

    def __init__(self, dims: Sequence[int], plain_last: bool = False):
        layers = []
        for i in range(len(dims) - 1):
            layers.append(nn.Linear(dims[i], dims[i + 1]))
            if i == len(dims) - 2 and plain_last:
                break
            layers += [MaskedBatchNorm(dims[i + 1]), nn.ReLU()]
        super().__init__(*layers)

    def forward(self, x, mask):
        for layer in self:
            x = layer(x, mask) if isinstance(layer, MaskedBatchNorm) \
                else layer(x)
        return x


class TripleConv(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.net1 = MLP((3 * dim, hidden, 2 * hidden + dim))
        self.net2 = MLP((hidden, hidden, dim))

    def forward(self, obj, pred, edges, obj_mask, triple_mask):
        B, O, D = obj.shape
        H = self.hidden
        s, o = edges[..., 0], edges[..., 1]
        bidx = torch.arange(B, device=obj.device)[:, None]
        t_in = torch.cat([obj[bidx, s], pred, obj[bidx, o]], -1)
        t_out = self.net1(t_in.reshape(-1, t_in.shape[-1]),
                          triple_mask.reshape(-1)).reshape(B, -1, 2 * H + D)
        new_s, new_p, new_o = (t_out[..., :H], t_out[..., H:H + D],
                               t_out[..., H + D:])
        keep = triple_mask[..., None].to(obj.dtype)
        pooled = torch.zeros(B, O, H, device=obj.device)
        counts = torch.zeros(B, O, device=obj.device)
        pooled = pooled.index_put((bidx.expand_as(s), s), new_s * keep,
                                  accumulate=True)
        pooled = pooled.index_put((bidx.expand_as(o), o), new_o * keep,
                                  accumulate=True)
        counts = counts.index_put((bidx.expand_as(s), s), keep[..., 0],
                                  accumulate=True)
        counts = counts.index_put((bidx.expand_as(o), o), keep[..., 0],
                                  accumulate=True)
        pooled = pooled / counts.clamp(min=1.0)[..., None]
        new_obj = self.net2(pooled.reshape(B * O, H), obj_mask.reshape(-1))
        return new_obj.reshape(B, O, D), new_p


class GraphNet(nn.Module):
    def __init__(self, dim: int, hidden: int, layers: int):
        super().__init__()
        self.gconvs = nn.ModuleList(TripleConv(dim, hidden)
                                    for _ in range(layers))

    def forward(self, obj, pred, edges, obj_mask, triple_mask):
        for g in self.gconvs:
            obj, pred = g(obj, pred, edges, obj_mask, triple_mask)
        return obj


class Sg2ScVAE(nn.Module):
    """The 3D-SLN layout VAE (decoder_cat, use_attr, 3-D boxes, 24 angle
    bins, batch-normalized MLPs, feed-forward graph convolutions)."""

    def __init__(self, embedding_dim: int = 64, gconv_layers: int = 5,
                 num_objs: int = 32, num_preds: int = 16,
                 num_attrs: int = 5, num_angles: int = 24):
        super().__init__()
        e = embedding_dim
        obj_e, attr_e = e * 3 // 4, e // 4
        box_e, ang_e = e * 3 // 4, e // 4
        hid = 4 * e
        self.obj_embeddings_ec = Embedding(num_objs + 1, obj_e)
        self.pred_embeddings_ec = Embedding(num_preds, 2 * e)
        self.obj_embeddings_dc = Embedding(num_objs + 1, obj_e)
        self.pred_embeddings_dc = Embedding(num_preds, 2 * e)
        self.attr_embedding_ec = Embedding(num_attrs, attr_e)
        self.attr_embedding_dc = Embedding(num_attrs, attr_e)
        self.box_embeddings = nn.Linear(6, box_e)
        self.angle_embeddings = Embedding(num_angles, ang_e)
        self.box_mean_var = MLP((2 * e, hid, 2 * e))
        self.box_mean = MLP((2 * e, box_e), True)
        self.box_var = MLP((2 * e, box_e), True)
        self.angle_mean_var = MLP((2 * e, hid, 2 * e))
        self.angle_mean = MLP((2 * e, ang_e), True)
        self.angle_var = MLP((2 * e, ang_e), True)
        self.gconv_net_ec = GraphNet(2 * e, hid, gconv_layers)
        self.gconv_net_dc = GraphNet(2 * e, hid, gconv_layers)
        self.box_net = MLP((2 * e + attr_e, hid, 6), True)
        self.angle_net = MLP((2 * e, hid, num_angles), True)

    def encode(self, b):
        obj = torch.cat([self.obj_embeddings_ec(b.objs),
                         self.attr_embedding_ec(b.attrs),
                         self.box_embeddings(b.boxes),
                         self.angle_embeddings(b.angles)], -1)
        obj = self.gconv_net_ec(obj, self.pred_embeddings_ec(b.preds),
                                b.edges, b.obj_mask, b.triple_mask)
        B, O, D = obj.shape
        flat, mask = obj.reshape(B * O, D), b.obj_mask.reshape(-1)
        vb, va = self.box_mean_var(flat, mask), self.angle_mean_var(flat,
                                                                    mask)
        mu = torch.cat([self.box_mean(vb, mask), self.angle_mean(va, mask)],
                       -1)
        logvar = torch.cat([self.box_var(vb, mask),
                            self.angle_var(va, mask)], -1)
        return mu.reshape(B, O, -1), logvar.reshape(B, O, -1)

    def decode(self, z, b):
        attr = self.attr_embedding_dc(b.attrs)
        obj = torch.cat([self.obj_embeddings_dc(b.objs), attr, z], -1)
        obj = self.gconv_net_dc(obj, self.pred_embeddings_dc(b.preds),
                                b.edges, b.obj_mask, b.triple_mask)
        B, O, D = obj.shape
        flat, mask = obj.reshape(B * O, D), b.obj_mask.reshape(-1)
        boxes = self.box_net(torch.cat([flat, attr.reshape(B * O, -1)], -1),
                             mask)
        angles = F.log_softmax(self.angle_net(flat, mask), -1)
        return boxes.reshape(B, O, 6), angles.reshape(B, O, -1)


def vae_losses(b, mu, logvar, boxes_pred, angle_lp, kl_weight: float,
               free_bits: float):
    """The masked VAE loss (3D-SLN utils.py): L1 on the boxes, NLL on the
    angle bins and the KL with a free-bits floor per latent dimension,
    each normalized by the valid objects. Returns the total."""
    m = b.obj_mask.to(torch.get_default_dtype())
    n = m.sum().clamp(min=1.0)
    l1 = ((boxes_pred - b.boxes).abs() * m[..., None]).sum() / (n * 6)
    nll = -(angle_lp.gather(-1, b.angles[..., None])[..., 0] * m).sum() / n
    kl = -0.5 * (1.0 + logvar - mu.square() - logvar.exp())
    kl_dim = (kl * m[..., None]).sum((0, 1)) / n
    return l1 + nll + kl_dim.clamp(min=free_bits).sum() * kl_weight
