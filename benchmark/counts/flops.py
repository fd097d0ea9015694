"""Model operations counted from the shapes (FMA = 2): the layout VAE's
dense layers, the PSP pyramid's resize products and the shading
generator's convolutions. Frozen with the benchmark, so a change to the
program cannot change what a step is counted as."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from benchmark.reference import spade as spade_ref


def _mlp(rows: int, dims) -> int:
    return sum(2 * rows * a * b for a, b in zip(dims[:-1], dims[1:]))


def vae_flops(B: int, O: int, T: int, e: int = 64, layers: int = 5,
              num_angles: int = 24) -> Dict[str, int]:
    """Forward operations of the VAE's dense layers on B scenes of O
    object and T triple slots (padding rows included: they are
    computed): {"encoder", "decoder", "box_embedding"}. Embedding lookups
    and the graph's gathers and pools are not counted (no arithmetic)."""
    D, H = 2 * e, 4 * e
    gconv = layers * (_mlp(B * T, (3 * D, H, 2 * H + D))
                      + _mlp(B * O, (H, H, D)))
    # the two mean-var MLPs feed box_mean / box_var (3e/4 wide) and
    # angle_mean / angle_var (e/4)
    heads_ec = (2 * _mlp(B * O, (D, H, D)) + 2 * _mlp(B * O, (D, 3 * e // 4))
                + 2 * _mlp(B * O, (D, e // 4)))
    heads_dc = (_mlp(B * O, (D + e // 4, H, 6))
                + _mlp(B * O, (D, H, num_angles)))
    return {"encoder": gconv + heads_ec, "decoder": gconv + heads_dc,
            "box_embedding": 2 * B * O * 6 * (3 * e // 4)}


def train_step_flops(B: int, O: int, T: int, e: int = 64,
                     layers: int = 5) -> int:
    """One training step: the forward, and a backward of twice the
    forward (the weights' and the inputs' gradients) for every dense
    layer but the box embedding, whose input (the boxes) takes none."""
    f = vae_flops(B, O, T, e, layers)
    fwd = f["encoder"] + f["decoder"] + f["box_embedding"]
    return 3 * fwd - f["box_embedding"]


def decoder_step_flops(B: int, O: int, T: int, e: int = 64,
                       layers: int = 5) -> int:
    """The refine step's decoder: forward and twice it backward (the
    parameters and z both take gradients)."""
    return 3 * vae_flops(B, O, T, e, layers)["decoder"]


def psp_flops(B: int, channels: int, S: int, sizes: Tuple[int, ...]) -> int:
    """The refine losses' pyramid on the render (B, channels, S, S): each
    scale resized S -> s -> sizes[-1] by two products per resize, forward
    and the input's gradient backward. (At s == S a resize is skipped.)"""
    m = sizes[-1]
    per = 0
    for s in sizes:
        if s != S:
            per += 2 * s * S * S + 2 * s * S * s
        if m != s:
            per += 2 * m * s * s + 2 * m * s * m
    return 2 * B * channels * per


def spade_room_flops(ngf: int = 64, nz: int = 256, crop: int = 256,
                     semantic_nc: int = 41, num_z: int = 50,
                     z_chunk: int = 10) -> Dict[str, float]:
    """One room's shading: the segmentation branches once (batch 1) and
    ceil(num_z / z_chunk) decodes of z_chunk z, counted from the
    generator's convolution and linear shapes on the meta device:
    {"seg_mods", "decode_chunk", "room"}."""
    with torch.device("meta"):
        g = spade_ref.Generator(semantic_nc, 3, nz, ngf, crop)
        seg = torch.zeros(1, semantic_nc, crop, crop)
        z = torch.zeros(1, nz)
    totals = {"seg": 0, "z": 0}
    spade_convs = {id(m) for s in g.modules() if isinstance(s, spade_ref.Spade)
                   for m in s.modules()}

    def hook(mod, inp, out):
        if isinstance(mod, torch.nn.Conv2d):
            kh, kw = mod.kernel_size
            n = 2 * out.numel() * mod.in_channels * kh * kw
        else:
            n = 2 * out.numel() * mod.in_features
        totals["seg" if id(mod) in spade_convs else "z"] += n

    handles = [m.register_forward_hook(hook) for m in g.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        g(seg, z)
    finally:
        for h in handles:
            h.remove()
    chunks = -(-num_z // z_chunk)
    decode_chunk = float(totals["z"] * z_chunk)
    return {"seg_mods": float(totals["seg"]), "decode_chunk": decode_chunk,
            "room": float(totals["seg"]) + chunks * decode_chunk}
