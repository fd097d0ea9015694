"""Sg2ScVAE: conditional VAE over per-object (box, angle) given a scene
graph (counterpart of sln_tpu/models/vae.py:31; reference
models/Sg2ScVAE_model.py:6-188).

Module names follow the reference state_dict, so `params_from_jax` maps a
JAX checkpoint's flax tree onto it key by key, and `params_to_jax` maps a
state_dict back onto the JAX package's flax layout.
"""

from __future__ import annotations

import functools
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sln_tpu_torch.config import ModelConfig
from sln_tpu_torch.data.batch import SceneBatch
from sln_tpu_torch.models.graph import GraphTripleConvNet
from sln_tpu_torch.models.layers import MLP, MaskedBatchNorm, OneHotEmbedding


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))


class Sg2ScVAE(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = c = cfg
        e = c.embedding_dim
        self.obj_embeddings_ec = OneHotEmbedding(c.num_objs + 1,
                                                 c.obj_embedding_dim)
        self.pred_embeddings_ec = OneHotEmbedding(c.num_preds, 2 * e)
        self.obj_embeddings_dc = OneHotEmbedding(c.num_objs + 1,
                                                 c.obj_embedding_dim)
        self.pred_embeddings_dc = OneHotEmbedding(
            c.num_preds, 2 * e if c.decoder_cat else e)
        if c.use_attr:
            self.attr_embedding_ec = OneHotEmbedding(c.num_attrs,
                                                     c.attr_embedding_dim)
            self.attr_embedding_dc = OneHotEmbedding(c.num_attrs,
                                                     c.attr_embedding_dim)
        self.box_embeddings = nn.Linear(c.box_dim, c.box_embedding_dim)
        nn.init.kaiming_normal_(self.box_embeddings.weight)
        nn.init.zeros_(self.box_embeddings.bias)
        self.angle_embeddings = OneHotEmbedding(c.num_angles,
                                                c.angle_embedding_dim)

        bn = c.mlp_normalization
        hid = c.gconv_hidden_dim
        self.box_mean_var = MLP((2 * e, hid, 2 * e), bn)
        self.box_mean = MLP((2 * e, c.box_embedding_dim), bn, True)
        self.box_var = MLP((2 * e, c.box_embedding_dim), bn, True)
        self.angle_mean_var = MLP((2 * e, hid, 2 * e), bn)
        self.angle_mean = MLP((2 * e, c.angle_embedding_dim), bn, True)
        self.angle_var = MLP((2 * e, c.angle_embedding_dim), bn, True)

        self.gconv_net_ec = GraphTripleConvNet(
            2 * e, hid, c.gconv_num_layers, c.gconv_mode, bn)
        self.gconv_net_dc = GraphTripleConvNet(
            2 * e if c.decoder_cat else e, hid, c.gconv_num_layers,
            c.gconv_mode, bn)

        box_in = 2 * e + (c.attr_embedding_dim if c.use_attr else 0)
        self.box_net = MLP((box_in, hid, c.box_dim), bn, True)
        self.angle_net = MLP((2 * e, hid, c.num_angles), bn, True)

    def encode(self, batch: SceneBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Posterior q(z | graph, boxes, angles): (mu, logvar), each
        (B, O, latent_dim) with latent = [box | angle]."""
        c = self.cfg
        obj_vecs = self.obj_embeddings_ec(batch.objs)
        if c.use_attr:
            obj_vecs = torch.cat(
                [obj_vecs, self.attr_embedding_ec(batch.attrs)], -1)
        angle_vecs = self.angle_embeddings(batch.angles)
        pred_vecs = self.pred_embeddings_ec(batch.preds)
        box_vecs = self.box_embeddings(batch.boxes)
        obj_vecs = torch.cat([obj_vecs, box_vecs, angle_vecs], -1)
        obj_vecs, _ = self.gconv_net_ec(obj_vecs, pred_vecs, batch.edges,
                                        batch.obj_mask, batch.triple_mask)

        B, O = batch.objs.shape
        mask = _flat(batch.obj_mask)
        flat = _flat(obj_vecs)
        vec_box = self.box_mean_var(flat, mask)
        vec_angle = self.angle_mean_var(flat, mask)
        mu = torch.cat([self.box_mean(vec_box, mask),
                        self.angle_mean(vec_angle, mask)], -1)
        logvar = torch.cat([self.box_var(vec_box, mask),
                            self.angle_var(vec_angle, mask)], -1)
        return mu.reshape(B, O, -1), logvar.reshape(B, O, -1)

    def decode(self, z: torch.Tensor, batch: SceneBatch
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """p(box, angle | z, graph): (boxes_pred (B, O, 6),
        angle_logprobs (B, O, 24))."""
        c = self.cfg
        obj_vecs = self.obj_embeddings_dc(batch.objs)
        attr_vecs = None
        if c.use_attr:
            attr_vecs = self.attr_embedding_dc(batch.attrs)
            obj_vecs = torch.cat([obj_vecs, attr_vecs], -1)
        pred_vecs = self.pred_embeddings_dc(batch.preds)
        if c.decoder_cat:
            obj_vecs = torch.cat([obj_vecs, z], -1)
        obj_vecs, _ = self.gconv_net_dc(obj_vecs, pred_vecs, batch.edges,
                                        batch.obj_mask, batch.triple_mask)
        if not c.decoder_cat:
            obj_vecs = torch.cat([obj_vecs, z], -1)

        B, O = batch.objs.shape
        mask = _flat(batch.obj_mask)
        flat = _flat(obj_vecs)
        box_in = torch.cat([flat, _flat(attr_vecs)], -1) if c.use_attr \
            else flat
        boxes_pred = self.box_net(box_in, mask).reshape(B, O, -1)
        angle_logprobs = F.log_softmax(self.angle_net(flat, mask), -1)
        return boxes_pred, angle_logprobs.reshape(B, O, -1)

    def forward(self, batch: SceneBatch,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        """Full VAE pass: z = mu + eps * std, with eps = `noise` or drawn
        from `generator`; z = mu when neither is given, and always under
        use_ae (the JAX package's vae.py:178)."""
        mu, logvar = self.encode(batch)
        if self.cfg.use_ae or (generator is None and noise is None):
            z = mu
        else:
            z = reparameterize(mu, logvar, generator, noise)
        boxes_pred, angle_logprobs = self.decode(z, batch)
        return mu, logvar, boxes_pred, angle_logprobs


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mu + eps * exp(logvar / 2), eps standard normal: given, or drawn
    from `generator`."""
    std = torch.exp(0.5 * logvar)
    if eps is None:
        eps = torch.randn(std.shape, generator=generator, device=std.device,
                          dtype=std.dtype)
    return mu + eps * std


# ---------------------------------------------------------------------------
# JAX checkpoint -> state_dict
# ---------------------------------------------------------------------------
_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight",
         "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix=()) -> Dict[Tuple[str, ...], object]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def params_from_jax(model_state: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX checkpoint's `model_state` ({"params", "batch_stats"} flax
    trees of numpy arrays) -> a state_dict for Sg2ScVAE.

    Flax names map onto the reference layout: `dense_i` / `bn_i` of an MLP
    become Sequential indices (3i / 3i+1 with batch norm, 2i without),
    `gconv_i` becomes `gconvs.i` (`gconv_shared` -> `gconvs.0`), Dense
    kernels are transposed ((in, out) -> (out, in)). Every leaf is
    consumed; each BatchNorm also gets num_batches_tracked = 0."""
    stats = _flatten(model_state.get("batch_stats") or {})
    step = 3 if stats else 2
    leaves = dict(_flatten(model_state["params"]))
    leaves.update(stats)
    sd: Dict[str, torch.Tensor] = {}
    for path, value in leaves.items():
        names = []
        for part in path[:-1]:
            if m := re.fullmatch(r"dense_(\d+)", part):
                names.append(str(step * int(m[1])))
            elif m := re.fullmatch(r"bn_(\d+)", part):
                names.append(str(step * int(m[1]) + 1))
            elif m := re.fullmatch(r"gconv_(\d+)", part):
                names.append(f"gconvs.{m[1]}")
            elif part == "gconv_shared":
                names.append("gconvs.0")
            else:
                names.append(part)
        leaf = path[-1]
        if leaf not in _LEAF:
            raise KeyError(f"unexpected checkpoint leaf {'/'.join(path)}")
        arr = np.array(value, np.float32)
        if leaf == "kernel":
            arr = arr.T
        key = ".".join(names + [_LEAF[leaf]])
        if key in sd:
            raise KeyError(f"two checkpoint leaves map onto {key}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
        if leaf == "mean":
            sd[".".join(names + ["num_batches_tracked"])] = torch.tensor(
                0, dtype=torch.long)
    return sd


@functools.lru_cache(maxsize=8)
def _module_kinds(model_cfg: ModelConfig) -> Dict[str, type]:
    """Module path -> module class of Sg2ScVAE(model_cfg), built on the
    meta device (no memory, no random draws)."""
    with torch.device("meta"):
        skeleton = Sg2ScVAE(model_cfg)
    return {name: type(m) for name, m in skeleton.named_modules()}


def jax_path(name: str, model_cfg: ModelConfig
             ) -> Optional[Tuple[str, Tuple[str, ...], bool]]:
    """A state_dict key -> (flax collection, path in it, transpose), the
    inverse of params_from_jax's naming; None for num_batches_tracked,
    which the flax layout does not hold."""
    kinds = _module_kinds(model_cfg)
    parts = name.split(".")
    owner, leaf = ".".join(parts[:-1]), parts[-1]
    kind = kinds[owner]
    if leaf == "num_batches_tracked":
        return None
    per_stage = 3 if model_cfg.mlp_normalization == "batch" else 2
    path = []
    for i, part in enumerate(parts[:-1]):
        parent = ".".join(parts[:i])
        if part.isdigit() and kinds.get(parent) is MLP:
            sub = kinds[".".join(parts[:i + 1])]
            stage = int(part) // per_stage
            path.append(f"dense_{stage}" if sub is nn.Linear
                        else f"bn_{stage}")
        elif part.isdigit() and parts[i - 1] == "gconvs":
            # gconvs.i -> gconv_i
            path[-1] = ("gconv_shared" if model_cfg.gconv_mode == "recurrent"
                        else f"gconv_{part}")
        else:
            path.append(part)
    if kind is MaskedBatchNorm:
        collection, flax_leaf = {
            "weight": ("params", "scale"), "bias": ("params", "bias"),
            "running_mean": ("batch_stats", "mean"),
            "running_var": ("batch_stats", "var")}[leaf]
    elif issubclass(kind, nn.Embedding):
        collection, flax_leaf = "params", "embedding"
    elif kind is nn.Linear:
        collection, flax_leaf = "params", {"weight": "kernel",
                                           "bias": "bias"}[leaf]
    else:
        raise KeyError(f"no flax counterpart for {name}")
    return collection, tuple(path) + (flax_leaf,), flax_leaf == "kernel"


def params_to_jax(state_dict: Mapping[str, torch.Tensor],
                  model_cfg: ModelConfig) -> Dict[str, Dict]:
    """A Sg2ScVAE state_dict -> {"params", "batch_stats"} flax-layout trees
    of float32 numpy arrays, the exact inverse of params_from_jax: Dense
    kernels transposed back to (in, out), Sequential indices back to
    dense_i / bn_i, gconvs.i to gconv_i (gconv_shared in recurrent mode);
    num_batches_tracked is dropped. A state_dict with only parameters (an
    Adam moment, say) gives an empty batch_stats."""
    trees: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for name, value in state_dict.items():
        where = jax_path(name, model_cfg)
        if where is None:
            continue
        collection, path, transpose = where
        arr = value.detach().to("cpu", torch.float32).numpy()
        node = trees[collection]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        if path[-1] in node:
            raise KeyError(f"two state_dict keys map onto {'/'.join(path)}")
        node[path[-1]] = np.ascontiguousarray(arr.T if transpose else arr)
    return trees
