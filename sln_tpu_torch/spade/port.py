"""SPADE weights between the JAX package's trees and the port's modules
(counterpart of sln_tpu/spade/port.py), and the JAX package's init.

* `params_from_jax`: a flax parameter tree (as numpy, e.g. the `g_params`,
  `d_params` or `e_params` of a shading-trainer checkpoint) -> the port's
  state_dict. Convs go HWIO -> OIHW, Dense kernels are transposed, and
  float16-stored leaves become float32. `spectral_from_jax` carries the
  `d_spectral` / `e_spectral` trees (u, v: the same vectors in both).
* `params_to_jax`: the inverse, a module -> (params tree, spectral tree)
  of numpy float32, so the port writes the JAX package's pickle schema.
* `init_like_jax`: flax's default init (lecun_normal, a truncated normal;
  zero biases) and the spectral vectors' 8 power-iteration steps.
* `fold_reference_state_dict`: a reference latest_net_G_AB.pth ->
  the port's state_dict, spectral norm folded: torch's eval-mode kernel
  is W / sigma with sigma = u^T W_mat v from the stored power-iteration
  vectors (weight_orig / weight_u / weight_v).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from sln_tpu_torch.spade.spectral import SpectralConv

# flax module names that differ from the reference's submodule names
_JAX_NAMES = {"conv": "1", "fc1": "fc.0", "fc2": "fc.2"}
_SPECTRAL = ("u", "v")


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(g_params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params (numpy or array leaves) of a SPADE module -> the
    state_dict of its port: any module of spade/ (the generators, the
    discriminators and their MMD wrappers' `trunk` level, the encoders,
    SpectralConv). A PadConv's flax `conv` is the port's submodule `1`,
    SEBlock2's `fc1`/`fc2` its `fc.0`/`fc.2`; every other name is kept."""
    sd = {}
    for path, leaf in _flatten(g_params):
        a = np.array(leaf, np.float32)
        *mods, name = path
        if name == "kernel":
            # conv HWIO -> OIHW; Dense (in, out) -> Linear (out, in)
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            name = "weight"
        key = ".".join([_JAX_NAMES.get(m, m) for m in mods] + [name])
        sd[key] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def spectral_from_jax(spectral: Mapping) -> Dict[str, torch.Tensor]:
    """A flax 'spectral' collection (u, v per SpectralConv) -> the port's
    buffers of the same names."""
    return {".".join(_JAX_NAMES.get(m, m) for m in path):
            torch.from_numpy(np.array(leaf, np.float32))
            for path, leaf in _flatten(spectral)}


def _jax_path(key: str):
    """A port state_dict key -> its flax path (module names mapped back)."""
    parts, out, i = key.split("."), [], 0
    while i < len(parts):
        if parts[i] == "fc" and i + 1 < len(parts) and parts[i + 1] in (
                "0", "2"):
            out.append("fc1" if parts[i + 1] == "0" else "fc2")
            i += 2
            continue
        out.append("conv" if parts[i] == "1" else parts[i])
        i += 1
    return out


def params_to_jax(module: nn.Module) -> Tuple[dict, dict]:
    """Module -> (params tree, spectral tree), numpy float32 leaves in the
    JAX package's layout (HWIO convs, (in, out) Dense kernels)."""
    params, spectral = {}, {}
    for key, t in module.state_dict().items():
        a = t.detach().cpu().numpy().astype(np.float32)
        *mods, name = _jax_path(key)
        tree = spectral if name in _SPECTRAL else params
        if name == "weight":
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
            name = "kernel"
        for m in mods:
            tree = tree.setdefault(m, {})
        tree[name] = np.ascontiguousarray(a)
    return params, spectral


def load_from_jax(module: nn.Module, params: Mapping,
                  spectral: Optional[Mapping] = None) -> nn.Module:
    """Load a flax params tree (and spectral tree) over module's state: a
    key the module lacks raises; what the trees lack keeps its value (a
    serving artifact carries no spectral vectors)."""
    sd = module.state_dict()
    sd.update(params_from_jax(params))
    if spectral:
        sd.update(spectral_from_jax(spectral))
    module.load_state_dict(sd)
    return module


# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled by this factor (the std of the truncated unit normal) so the
# kernel's variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def _truncated_normal(shape, std: float, gen: torch.Generator
                      ) -> torch.Tensor:
    """Inverse-CDF draw of N(0, std^2) truncated to [-2 std, 2 std], as
    jax.random.truncated_normal draws it."""
    lo, hi = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-2, 2))
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
    return (x.clamp(-2.0, 2.0) * std).float()


@torch.no_grad()
def init_like_jax(module: nn.Module, seed: int) -> nn.Module:
    """flax's default init of every Conv2d, SpectralConv and Linear in
    module (lecun_normal kernels: fan_in = in x kh x kw, or in; zero
    biases), then each SpectralConv's u and v from 8 power-iteration
    steps. Draws from a CPU torch.Generator seeded with `seed`, so the
    values do not depend on the device; the same distribution as the JAX
    package's, not its values."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear, SpectralConv)):
            w = m.weight
            std = math.sqrt(1.0 / w[0].numel()) / _TRUNC_STD
            w.copy_(_truncated_normal(w.shape, std, gen))
            if m.bias is not None:
                m.bias.zero_()
    for m in module.modules():
        if isinstance(m, SpectralConv):
            m.reset_spectral(gen)
    return module


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
