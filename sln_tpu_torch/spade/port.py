"""Generator weights carried into the port's SPADEGenerator4 (counterpart
of sln_tpu/spade/port.py).

* `params_from_jax`: the JAX package's flax parameter tree (as numpy,
  e.g. the `g_params` of artifacts/spade_gan.ckpt) -> the port's
  state_dict. Convs go HWIO -> OIHW, Dense kernels are transposed, and
  float16-stored leaves become float32.
* `fold_reference_state_dict`: a reference latest_net_G_AB.pth ->
  the port's state_dict, spectral norm folded: torch's eval-mode kernel
  is W / sigma with sigma = u^T W_mat v from the stored power-iteration
  vectors (weight_orig / weight_u / weight_v).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# flax module names that differ from the reference's submodule names
_JAX_NAMES = {"conv": "1", "fc1": "fc.0", "fc2": "fc.2"}


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(g_params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax SPADEGenerator4 params (numpy or array leaves) -> state_dict
    of sln_tpu_torch.spade.generator.SPADEGenerator4."""
    sd = {}
    for path, leaf in _flatten(g_params):
        a = np.asarray(leaf, np.float32)
        *mods, name = path
        key = ".".join(_JAX_NAMES.get(m, m) for m in mods)
        if name == "kernel":
            # conv HWIO -> OIHW; Dense (in, out) -> Linear (out, in)
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            name = "weight"
        sd[f"{key}.{name}"] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def _np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def fold_spectral(weight_orig, weight_u, weight_v) -> torch.Tensor:
    """Effective kernel of a spectral_norm-wrapped conv, in float64."""
    W, u, v = _np64(weight_orig), _np64(weight_u), _np64(weight_v)
    sigma = float(u @ (W.reshape(W.shape[0], -1) @ v))
    return torch.from_numpy((W / sigma).astype(np.float32))


def fold_reference_state_dict(state_dict: Mapping[str, object]
                              ) -> Dict[str, torch.Tensor]:
    """Reference SPADEGenerator4 state_dict -> the port's, every
    spectral-normed conv (`<m>.weight_orig` with `<m>.weight_u` and
    `<m>.weight_v`) folded into `<m>.weight`."""
    out = {}
    for key, value in state_dict.items():
        if key.endswith((".weight_u", ".weight_v")):
            continue
        if key.endswith(".weight_orig"):
            m = key[:-len(".weight_orig")]
            out[m + ".weight"] = fold_spectral(
                value, state_dict[m + ".weight_u"],
                state_dict[m + ".weight_v"])
        else:
            out[key] = torch.as_tensor(_np64(value).astype(np.float32))
    return out


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """./checkpoints/latest_net_G_AB.pth -> the port's state_dict."""
    return fold_reference_state_dict(torch.load(path, map_location="cpu"))
