"""Masked VAE loss assembly (counterpart of sln_tpu/train/losses.py:18;
reference utils.py:12-33): L1 on boxes + NLL on angle bins + KL, where
every normalizer counts only valid (non-padding) object rows.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from sln_tpu_torch.data.batch import SceneBatch


def vae_losses(batch: SceneBatch, mu, logvar, boxes_pred, angle_logprobs,
               kl_weight: float, use_ae: bool = False,
               kl_free_bits: float = 0.0
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, {bbox_pred, angle_pred[, KLD_Gauss, KLD_raw], total_loss}).

    KLD_raw is the KL per valid object; KLD_Gauss is the penalty times
    `kl_weight`, where the penalty floors each latent dimension's KL at
    `kl_free_bits` (free bits, Kingma et al. 2016; 0 = the reference's
    loss). Under use_ae there is no KL term."""
    m = batch.obj_mask.to(torch.float32)                      # (B, O)
    n_valid = m.sum().clamp(min=1.0)

    l1 = (boxes_pred - batch.boxes).abs() * m[..., None]
    loss_bbox = l1.sum() / (n_valid * boxes_pred.shape[-1])

    picked = torch.gather(angle_logprobs, -1, batch.angles[..., None])[..., 0]
    loss_angle = -(picked * m).sum() / n_valid

    losses = {"bbox_pred": loss_bbox, "angle_pred": loss_angle}
    total = loss_bbox + loss_angle

    if not use_ae:
        kl_el = -0.5 * (1.0 + logvar - mu.square() - logvar.exp())
        kl_per_dim = (kl_el * m[..., None]).sum(
            tuple(range(kl_el.dim() - 1))) / n_valid          # (D,)
        loss_kl = kl_per_dim.sum()
        if kl_free_bits > 0.0:
            penalty = kl_per_dim.clamp(min=kl_free_bits).sum()
        else:
            penalty = loss_kl
        losses["KLD_Gauss"] = penalty * kl_weight
        losses["KLD_raw"] = loss_kl
        total = total + penalty * kl_weight

    losses["total_loss"] = total
    return total, losses
