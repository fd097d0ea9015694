"""GauGAN's training step counted from the shapes (FMA = 2): every
convolution's forward, input-gradient and weight-gradient work in each
pass as the step performs it. Frozen with the benchmark, so a change to
the program cannot change what a step is counted as.

A step (g_update, then d_update) on B images:
* G forward with gradient, its weights' gradients, and the inputs'
  gradients of every conv but those that read the label map (fc and each
  SPADE's shared conv);
* D forward on the 2B fake and real images, and its inputs' gradients;
* VGG19 forward on the fake and on the real, and the fake's input
  gradients (its weights are frozen);
* G forward without gradient;
* D forward on 2B, its weights' gradients, and the inputs' gradients of
  every conv but conv0 (the detached fake and the real need none).
Power iteration, norms, pooling, activations and Adam are not counted.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference import gaugan as ref


def _conv_flops(net: torch.nn.Module, x: torch.Tensor, tag) -> Dict[str, int]:
    """Forward operations of net(x)'s convolutions on the meta device, by
    tag(name) ("all" holds the sum)."""
    names = {id(m): n for n, m in net.named_modules()}
    totals: Dict[str, int] = {"all": 0}

    def hook(mod, inp, out):
        kh, kw = mod.kernel_size
        n = 2 * out.numel() * (mod.in_channels // mod.groups) * kh * kw
        totals["all"] += n
        t = tag(names[id(mod)])
        if t:
            totals[t] = totals.get(t, 0) + n

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        net(x)
    finally:
        for h in handles:
            h.remove()
    return totals


def step_flops(cfg: dict, B: int) -> Dict[str, float]:
    """{"g_fwd", "d_fwd", "vgg_fwd", "step"}: the forwards' operations
    (G and VGG on B images, D on 2B) and one training step's."""
    nc, S = cfg["semantic_nc"], cfg["crop_size"]
    with torch.device("meta"):
        G = ref.Generator(nc, cfg["ngf"], S)
        D = ref.MultiscaleD(nc + 3, cfg["ndf"], cfg["n_layers_D"],
                            cfg["num_D"])
        vgg = ref.VGG19()
        g = _conv_flops(G, torch.zeros(B, nc, S, S), lambda n: "label" if (
            n == "fc" or n.endswith("mlp_shared")) else "")
        d = _conv_flops(D, torch.zeros(2 * B, nc + 3, S, S),
                        lambda n: "conv0" if n.endswith("conv0") else "")
        v = _conv_flops(vgg, torch.zeros(B, 3, S, S), lambda n: "")
    G_, D_, V_ = g["all"], d["all"], v["all"]
    g_update = (G_ + G_ + (G_ - g["label"]) + D_ + D_ + 3 * V_)
    d_update = G_ + D_ + D_ + (D_ - d["conv0"])
    return {"g_fwd": float(G_), "d_fwd": float(D_), "vgg_fwd": float(V_),
            "step": float(g_update + d_update)}
