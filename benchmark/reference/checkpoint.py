"""Read a layout-VAE checkpoint (`artifacts/*.ckpt`: a pickle of numpy
flax trees) into a state_dict in the reference's names, without JAX: a
class of jax, jaxlib, flax or optax named in the pickle is rebuilt as a
plain stand-in. Imports nothing of the measured package."""

from __future__ import annotations

import pickle
import re
from typing import Dict

import numpy as np
import torch

_FOREIGN = ("jax", "jaxlib", "flax", "optax")
_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight",
         "bias": "bias", "mean": "running_mean", "var": "running_var"}


class _StandIn(tuple):
    def __new__(cls, *args):
        return tuple.__new__(cls, args)

    def __setstate__(self, state):
        self.state = state


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _FOREIGN:
            return type(name, (_StandIn,), {})
        return super().find_class(module, name)


def _plain(obj):
    if isinstance(obj, _StandIn) and type(obj).__name__ == "FrozenDict":
        return _plain(dict(obj[0]))
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def load_vae_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The checkpoint's model weights and BatchNorm statistics as a
    state_dict: dense_i / bn_i of an MLP -> Sequential indices 3i / 3i+1,
    gconv_i -> gconvs.i, Dense kernels transposed to (out, in)."""
    with open(path, "rb") as f:
        ckpt = _Unpickler(f).load()
    state = _plain(ckpt["model_state"])
    leaves = dict(_flatten(state["params"]))
    leaves.update(_flatten(state.get("batch_stats") or {}))
    sd: Dict[str, torch.Tensor] = {}
    for path_, value in leaves.items():
        names = []
        for part in path_[:-1]:
            if m := re.fullmatch(r"dense_(\d+)", part):
                names.append(str(3 * int(m[1])))
            elif m := re.fullmatch(r"bn_(\d+)", part):
                names.append(str(3 * int(m[1]) + 1))
            elif m := re.fullmatch(r"gconv_(\d+)", part):
                names.append(f"gconvs.{m[1]}")
            else:
                names.append(part)
        leaf = path_[-1]
        arr = np.array(value, np.float32)
        if leaf == "kernel":
            arr = arr.T
        sd[".".join(names + [_LEAF[leaf]])] = torch.from_numpy(
            np.ascontiguousarray(arr))
        if leaf == "mean":
            sd[".".join(names + ["num_batches_tracked"])] = torch.tensor(0)
    return sd
