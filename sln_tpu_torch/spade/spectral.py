"""Spectral normalization by power iteration, the training path
(counterpart of sln_tpu/spade/spectral.py).

The kernel is divided by an estimate of its leading singular value, made
with one power-iteration step per training forward; the singular-vector
estimates u and v are buffers. This is not torch.nn.utils.spectral_norm,
which starts from its own draw and iterates whenever the module is in
training mode: here u converges over 8 steps at init, as in the JAX
package, and `train` is an argument of each call, so the discriminator's
two forwards of a step each advance u and v, and the generator's step
reads them without advancing. (Inference checkpoints arrive with sigma
folded: spade/port.py.)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def power_iteration(w_mat: torch.Tensor, u: torch.Tensor, n: int,
                    eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """n steps from u, without gradient -> (u, v), unit vectors."""
    with torch.no_grad():
        for _ in range(n):
            v = w_mat.t() @ u
            v = v / torch.linalg.vector_norm(v).clamp(min=eps)
            u = w_mat @ v
            u = u / torch.linalg.vector_norm(u).clamp(min=eps)
    return u, v


class SpectralConv(nn.Module):
    """Conv2d (zero padding, stride) of the kernel W / sigma.

    The weight is OIHW, flattened to (out, in * kh * kw) for sigma: the JAX
    package flattens its HWIO kernel to that same matrix (transpose(3, 2,
    0, 1)), so u (out,) and v (in * kh * kw,) carry across unchanged.
    `forward(x, train=True)` takes one power-iteration step and stores the
    new u, v; gradient flows through sigma = u . (W v) with u and v held
    constant."""

    def __init__(self, fin: int, fout: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = True, eps: float = 1e-12):
        super().__init__()
        self.stride, self.padding, self.eps = stride, padding, eps
        self.weight = nn.Parameter(torch.empty(fout, fin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(fout)) if bias else None
        self.register_buffer("u", torch.zeros(fout))
        self.register_buffer("v", torch.zeros(fin * kernel * kernel))

    def w_mat(self) -> torch.Tensor:
        return self.weight.reshape(self.weight.shape[0], -1)

    def reset_spectral(self, generator: Optional[torch.Generator] = None
                       ) -> None:
        """u from a normal draw, normalised, then 8 power-iteration steps,
        so sigma is converged from the first training step (the JAX
        package's init)."""
        # drawn where the generator lives (a CPU generator for a module on
        # the card: init_like_jax), then moved to the module's device
        u = torch.randn(self.u.shape, generator=generator,
                        device=generator.device if generator is not None
                        else self.u.device).to(self.u.device)
        u, v = power_iteration(self.w_mat(), u / torch.linalg.vector_norm(u),
                               8, self.eps)
        self.u, self.v = u, v

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        w_mat = self.w_mat()
        if train:
            # new buffer tensors, not in-place copies: an earlier forward of
            # this step may have saved the old u, v for its backward
            self.u, self.v = power_iteration(w_mat, self.u, 1, self.eps)
        sigma = self.u @ (w_mat @ self.v)
        return F.conv2d(x, self.weight / sigma.clamp(min=self.eps),
                        self.bias, self.stride, self.padding)
