"""Checkpointing with the reference's artifact semantics, in the JAX
package's schema (counterpart of sln_tpu/train/checkpoint.py; reference
train.py:34-55, 93-114).

One checkpoint dict holds the args, the vocab, the loss history, the
counters, the model state and the optimizer state; it is saved as three
pickles:

* ``latest_<name>_with_model.ckpt``  every checkpoint_every steps
* ``<name>snapshot_%06dK.ckpt``      every snapshot_every steps
* ``<name>_no_model.ckpt``           without model_state and optim_state

``model_state`` is the {"params", "batch_stats"} flax layout of numpy
arrays (models.vae.params_to_jax), so the JAX package reads the port's
checkpoints as its own. ``optim_state`` is a plain dict, {"count": int,
"mu": tree, "nu": tree}, with the Adam moments in the params layout: it
names no class of any package, so any machine can read it. The JAX
package's train.py expects optax objects there, so a port-written
checkpoint is for the JAX package to *evaluate*, not to resume.

``load_checkpoint`` also reads what the JAX trainer writes, whose
``optim_state`` pickles optax's namedtuples (ScaleByAdamState inside a
tuple), on a machine without JAX: classes of jax, jaxlib, flax and optax
become plain stand-ins, never imported, and the Adam state becomes the
same dict.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from sln_tpu_torch.config import ModelConfig
from sln_tpu_torch.models.vae import jax_path, params_to_jax

FOREIGN_PACKAGES = ("jax", "jaxlib", "flax", "optax")


def new_checkpoint(config_dict: Dict[str, Any],
                   vocab: Dict[str, Any]) -> Dict[str, Any]:
    """Fresh history dict (reference train.py:34-55)."""
    return {
        "args": config_dict,
        "vocab": vocab,
        "losses_ts": [],
        "losses": {},
        "checkpoint_ts": [],
        "counters": {"t": None, "epoch": None},
        "model_state": None,
        "optim_state": None,
    }


def record_losses(ckpt: Dict[str, Any], t: int,
                  losses: Dict[str, float]) -> None:
    for name, val in losses.items():
        ckpt["losses"].setdefault(name, []).append(float(val))
    ckpt["losses_ts"].append(int(t))


def save_checkpoint(ckpt: Dict[str, Any], output_dir: str, name: str,
                    t: int, epoch: int, model_state, optim_state,
                    snapshot: bool = False) -> str:
    """Write the trio; model_state and optim_state are numpy trees
    (model_state_of, adam_state_of). Returns the latest file's path."""
    os.makedirs(output_dir, exist_ok=True)
    ckpt["model_state"] = model_state
    ckpt["optim_state"] = optim_state
    ckpt["counters"]["t"] = int(t)
    ckpt["counters"]["epoch"] = int(epoch)

    latest = latest_path(output_dir, name)
    with open(latest, "wb") as f:
        pickle.dump(ckpt, f)

    if snapshot:
        snap = os.path.join(output_dir, name + "snapshot_%06dK.ckpt"
                            % (t // 1000))
        with open(snap, "wb") as f:
            pickle.dump(ckpt, f)

    small = {k: v for k, v in ckpt.items()
             if k not in ("model_state", "optim_state")}
    with open(os.path.join(output_dir, f"{name}_no_model.ckpt"), "wb") as f:
        pickle.dump(small, f)
    return latest


class _Foreign(tuple):
    """Stand-in for a class of jax / jaxlib / flax / optax named in a
    pickle: the positional fields the object was rebuilt from (a
    namedtuple's fields, in order)."""

    module = ""

    def __new__(cls, *args):
        return tuple.__new__(cls, args)

    def __setstate__(self, state):
        self.state = state


class _Unpickler(pickle.Unpickler):
    def __init__(self, f):
        super().__init__(f)
        self._standins: Dict[tuple, type] = {}

    def find_class(self, module, name):
        if module.split(".")[0] not in FOREIGN_PACKAGES:
            return super().find_class(module, name)
        key = (module, name)
        if key not in self._standins:
            self._standins[key] = type(name, (_Foreign,), {"module": module})
        return self._standins[key]


def _plain(obj):
    """A flax FrozenDict stand-in back to a dict, all the way down."""
    if isinstance(obj, _Foreign) and type(obj).__name__ == "FrozenDict":
        return _plain(dict(obj[0]))
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


def _adam_dict(optim_state) -> Optional[Dict[str, Any]]:
    """The port's Adam dict from either form a checkpoint holds it in."""
    if optim_state is None or isinstance(optim_state, dict):
        return optim_state
    # optax.adam: (ScaleByAdamState(count, mu, nu), EmptyState())
    for part in optim_state:
        if isinstance(part, _Foreign) and \
                type(part).__name__ == "ScaleByAdamState":
            count, mu, nu = part
            return {"count": int(np.asarray(count)), "mu": _plain(mu),
                    "nu": _plain(nu)}
    raise ValueError("optim_state holds no Adam state: "
                     f"{type(optim_state).__name__}")


def load_checkpoint(path: str) -> Optional[Dict[str, Any]]:
    """The checkpoint dict at `path` (None if there is none), with its
    optim_state as the port's Adam dict, whichever trainer wrote it."""
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        ckpt = _Unpickler(f).load()
    ckpt["model_state"] = _plain(ckpt.get("model_state"))
    ckpt["optim_state"] = _adam_dict(ckpt.get("optim_state"))
    return ckpt


def latest_path(output_dir: str, name: str) -> str:
    return os.path.join(output_dir, f"latest_{name}_with_model.ckpt")


def reference_pt_path(output_dir: str, name: str) -> str:
    """Where a reference-trained torch checkpoint would sit
    (reference train.py:99: latest_<name>_with_model.pt)."""
    return os.path.join(output_dir, f"latest_{name}_with_model.pt")


# ---------------------------------------------------------------------------
# torch state <-> checkpoint trees
# ---------------------------------------------------------------------------
def model_state_of(model: torch.nn.Module, model_cfg: ModelConfig):
    """The model's {"params", "batch_stats"} flax-layout numpy trees."""
    return params_to_jax(model.state_dict(), model_cfg)


def _leaf(tree: Mapping, path) -> np.ndarray:
    for part in path:
        tree = tree[part]
    return tree


def adam_state_of(model: torch.nn.Module, optimizer: torch.optim.Adam,
                  model_cfg: ModelConfig) -> Dict[str, Any]:
    """torch.optim.Adam's per-parameter state -> {"count", "mu", "nu"}.
    Every parameter takes every step, so the first one's count is the
    optimizer's."""
    named = dict(model.named_parameters())
    mu = {n: optimizer.state[p]["exp_avg"] for n, p in named.items()}
    nu = {n: optimizer.state[p]["exp_avg_sq"] for n, p in named.items()}
    first = optimizer.state[next(iter(named.values()))]
    return {"count": int(first["step"]),
            "mu": params_to_jax(mu, model_cfg)["params"],
            "nu": params_to_jax(nu, model_cfg)["params"]}


def load_adam_state(model: torch.nn.Module, optimizer: torch.optim.Adam,
                    adam: Optional[Dict[str, Any]],
                    model_cfg: ModelConfig) -> None:
    """Put an Adam dict ({"count", "mu", "nu"}; None = a fresh optimizer:
    count 0, zero moments) into torch.optim.Adam through its
    load_state_dict."""
    sd = optimizer.state_dict()
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    ids = [i for g in sd["param_groups"] for i in g["params"]]
    if len(ids) != len(params):
        raise ValueError("the optimizer does not hold exactly the model's "
                         "parameters")
    state = {}
    for i, name, p in zip(ids, names, params):
        if adam is None:
            step, m, v = 0, torch.zeros_like(p), torch.zeros_like(p)
        else:
            _, path, transpose = jax_path(name, model_cfg)
            # copies (Adam updates its moments in place), C-contiguous as
            # the parameter is: the fused Adam kernel walks a moment's
            # memory in the parameter's order
            m, v = (torch.from_numpy(np.array(
                _leaf(adam[k], path).T if transpose else _leaf(adam[k], path),
                np.float32, order="C")) for k in ("mu", "nu"))
            step = adam["count"]
        state[i] = {"step": torch.tensor(float(step), dtype=torch.float32),
                    "exp_avg": m, "exp_avg_sq": v}
    sd["state"] = state
    optimizer.load_state_dict(sd)
