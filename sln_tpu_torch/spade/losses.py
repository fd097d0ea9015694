"""GAN losses and the SPADE GAN training steps (counterpart of
sln_tpu/spade/losses.py; reference GANLoss_2, models/SPADE_related.py
:509-593, and feature matching).

A step alternates a discriminator update and a generator update in the JAX
package's order, and the MMD mode adds an encoder update. Adam is
optax.adam(lr, b1=0.0, b2=0.9): torch.optim.Adam with betas (0.0, 0.9),
eps 1e-8. Each step runs with conv_math (float32) in force through its
backward passes too, and leaves each network's gradients of this step in
`.grad` after its optimizer has stepped.

`GauganTrainer` is GauGAN's step (NVlabs/SPADE pix2pix_model.py,
pix2pix_trainer.py), the generator's update first; it has no counterpart
in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sln_tpu_torch import trace
from sln_tpu_torch.spade.generator import conv_math
from sln_tpu_torch.spade.vgg import vgg_loss


def gan_loss(logits: List[list], target_is_real: bool,
             for_discriminator: bool, mode: str = "hinge") -> torch.Tensor:
    """Multiscale GAN loss averaged over discriminators (reference
    :550-593); each entry's last element is its logit map."""
    total = 0.0
    for feats in logits:
        pred = feats[-1]
        if mode == "original":
            loss = F.binary_cross_entropy_with_logits(
                pred, torch.full_like(pred, 1.0 if target_is_real else 0.0))
        elif mode in ("ls", "lsgan"):
            loss = (pred - (1.0 if target_is_real else 0.0)).square().mean()
        elif mode == "hinge":
            if not for_discriminator:
                loss = -pred.mean()
            elif target_is_real:
                loss = -torch.clamp(pred - 1.0, max=0.0).mean()
            else:
                loss = -torch.clamp(-pred - 1.0, max=0.0).mean()
        else:                                                 # wgan
            loss = -pred.mean() if target_is_real else pred.mean()
        total = total + loss
    return total / len(logits)


def feature_matching_loss(fake_feats: List[list], real_feats: List[list]
                          ) -> torch.Tensor:
    """pix2pixHD feature matching: mean L1 over every intermediate
    discriminator layer, the real features held constant."""
    total, n = 0.0, 0
    for ff, rf in zip(fake_feats, real_feats):
        for f, r in zip(ff[:-1], rf[:-1]):
            total = total + (f - r.detach()).abs().mean()
            n += 1
    return total / max(n, 1)


def mmd_rbf(x: torch.Tensor, y: torch.Tensor,
            scales: Sequence[float] = (0.25, 0.5, 1.0, 2.0, 4.0)
            ) -> torch.Tensor:
    """Multi-scale RBF maximum mean discrepancy between two z batches: the
    MMD mode's pull of the encoder's z towards the N(0, I) prior."""
    d = x.shape[-1]

    def k(a, b):
        sq = (a[:, None] - b[None]).square().sum(-1)
        out = 0.0
        for s in scales:
            out = out + torch.exp(-sq / (2.0 * s * d))
        return out

    return k(x, x).mean() + k(y, y).mean() - 2.0 * k(x, y).mean()


def split_mmd_output(out: List[list]
                     ) -> Tuple[List[list], List[torch.Tensor]]:
    """Per scale [feats..., (logits, z)] -> ([feats..., logits] lists for
    the GAN and feature losses, the per-scale z predictions)."""
    plain, zs = [], []
    for feats in out:
        logits, z = feats[-1]
        plain.append(list(feats[:-1]) + [logits])
        zs.append(z)
    return plain, zs


def adam(params, lr: float) -> torch.optim.Adam:
    """optax.adam(lr, b1=0.0, b2=0.9)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.0, 0.9), eps=1e-8,
                            fused=True)


class GanState:
    """The networks, their Adams and the step count. `encoder` (and its
    Adam) only in the MMD mode."""

    def __init__(self, generator: nn.Module, discriminator: nn.Module,
                 lr_g: float, lr_d: float,
                 encoder: Optional[nn.Module] = None, lr_e: float = 1e-4):
        self.generator, self.discriminator = generator, discriminator
        self.encoder = encoder
        self.g_opt = adam(generator.parameters(), lr_g)
        self.d_opt = adam(discriminator.parameters(), lr_d)
        self.e_opt = None if encoder is None else adam(encoder.parameters(),
                                                       lr_e)
        self.step = 0

    def state_tensors(self) -> List[torch.Tensor]:
        """Every parameter, spectral buffer and Adam moment, in a fixed
        order."""
        out = []
        for net, opt in ((self.generator, self.g_opt),
                         (self.discriminator, self.d_opt),
                         (self.encoder, self.e_opt)):
            if net is None:
                continue
            out += list(net.parameters()) + list(net.buffers())
            for p in net.parameters():
                out += [t for t in opt.state[p].values()
                        if isinstance(t, torch.Tensor)]
        return out


def _set_grads(loss: torch.Tensor, net: nn.Module) -> None:
    """This loss's gradients to net's parameters only (no gradient is
    computed for any other network's weights), into .grad."""
    params = list(net.parameters())
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g


def _d_forward(discriminator, img, seg, train):
    return discriminator(torch.cat([seg, img], 1), train)


def make_gan_train_step(state: GanState, gan_mode: str = "hinge",
                        lambda_feat: float = 10.0, lambda_l1: float = 0.0):
    """(seg (B, 41, H, W), real (B, 3, H, W), z (B, nz)) -> {d_loss,
    g_loss}, updating state in place.

    D: the fake of the current G, without gradient; D in training mode on
    the fake, then on the real (the spectral vectors advance twice); hinge
    (or `gan_mode`); Adam. G: the updated D with the new spectral vectors
    read in eval mode; the fake again, with gradient; adversarial +
    lambda_feat x feature matching + lambda_l1 x |fake - real|; Adam."""
    G, D = state.generator, state.discriminator

    def step(seg, real, z):
        with conv_math():
            with torch.no_grad():
                fake = G(seg, z)
            fake_out = _d_forward(D, fake, seg, True)
            real_out = _d_forward(D, real, seg, True)
            d_loss = (gan_loss(fake_out, False, True, gan_mode)
                      + gan_loss(real_out, True, True, gan_mode))
            _set_grads(d_loss, D)
            state.d_opt.step()

            fake = G(seg, z)
            fake_out = _d_forward(D, fake, seg, False)
            with torch.no_grad():
                real_out = _d_forward(D, real, seg, False)
            g_loss = (gan_loss(fake_out, True, False, gan_mode)
                      + lambda_feat * feature_matching_loss(fake_out,
                                                            real_out))
            if lambda_l1:
                g_loss = g_loss + lambda_l1 * (fake - real).abs().mean()
            _set_grads(g_loss, G)
            state.g_opt.step()
        state.step += 1
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach()}

    return step


def make_mmd_gan_train_step(state: GanState, gan_mode: str = "hinge",
                            lambda_feat: float = 10.0, lambda_z: float = 1.0,
                            lambda_mmd: float = 10.0,
                            lambda_rec: float = 10.0,
                            lambda_l1: float = 0.0):
    """The MMD mode's step (the objective of the reference's unused MMD
    classes, SPADE_related.py:909-979, :1237-1398), in the JAX package's
    order:

    * D: multiscale GAN loss on the decide logits + lambda_z x the
      z-regression of its z heads on the fakes' z;
    * G: adversarial + feature matching + z-recovery through the updated D
      (+ lambda_l1 x L1);
    * E: lambda_rec x L1 of the updated G's reconstruction from E's z +
      lambda_mmd x MMD(E's z, the prior batch); E's spectral vectors
      advance once."""
    G, D, E = state.generator, state.discriminator, state.encoder

    def z_regression(zs, z):
        total = 0.0
        for zp in zs:
            total = total + (zp - z).square().mean()
        return total / max(len(zs), 1)

    def step(seg, real, z):
        with conv_math():
            with torch.no_grad():
                fake = G(seg, z)
            fake_out = _d_forward(D, fake, seg, True)
            real_out = _d_forward(D, real, seg, True)
            fake_plain, fake_z = split_mmd_output(fake_out)
            real_plain, _ = split_mmd_output(real_out)
            d_loss = (gan_loss(fake_plain, False, True, gan_mode)
                      + gan_loss(real_plain, True, True, gan_mode)
                      + lambda_z * z_regression(fake_z, z))
            _set_grads(d_loss, D)
            state.d_opt.step()

            fake = G(seg, z)
            fake_plain, fake_z = split_mmd_output(
                _d_forward(D, fake, seg, False))
            with torch.no_grad():
                real_plain, _ = split_mmd_output(
                    _d_forward(D, real, seg, False))
            g_loss = (gan_loss(fake_plain, True, False, gan_mode)
                      + lambda_feat * feature_matching_loss(fake_plain,
                                                            real_plain)
                      + lambda_z * z_regression(fake_z, z))
            if lambda_l1:
                g_loss = g_loss + lambda_l1 * (fake - real).abs().mean()
            _set_grads(g_loss, G)
            state.g_opt.step()

            z_enc = E(real, True)
            recon = G(seg, z_enc)
            e_loss = (lambda_rec * (recon - real).abs().mean()
                      + lambda_mmd * mmd_rbf(z_enc, z))
            _set_grads(e_loss, E)
            state.e_opt.step()
        state.step += 1
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                "e_loss": e_loss.detach()}

    return step


def gaugan_feature_matching(fake_feats: List[list], real_feats: List[list]
                            ) -> torch.Tensor:
    """GauGAN's feature matching: mean L1 of every intermediate layer
    against the real's (held constant), summed over the layers and
    averaged over the discriminators."""
    total = 0.0
    for ff, rf in zip(fake_feats, real_feats):
        for f, r in zip(ff[:-1], rf[:-1]):
            total = total + (f - r.detach()).abs().mean()
    return total / len(fake_feats)


class GauganTrainer:
    """GauGAN's training step on a (seg one-hot (B, C, H, W), real (B, 3,
    H, W) in [-1, 1]) batch: `g_update` then `d_update`, both networks in
    training mode throughout, under conv_math (float32) through the
    backward passes.

    * g_update: the fake with gradient; D once on the fake and the real
      concatenated along the batch; hinge -mean D(fake) + lambda_feat x
      feature matching (summed over layers, averaged over scales) +
      lambda_vgg x the VGG loss of `vgg` (none where lambda_vgg is 0);
      the gradients to G's parameters alone; Adam.
    * d_update: the fake again without gradient (G's spectral vectors and
      running statistics advance a second time); D once on the detached
      fake and the real; hinge; the gradients to D's parameters; Adam.

    Each update returns its losses as device tensors; nothing is read
    back to the host. Spans: sln.gan.step over sln.gan.g_update and
    sln.gan.d_update, and inside them sln.gan.generate,
    sln.gan.discriminate, sln.gan.vgg (forwards), sln.gan.backward and
    sln.gan.adam. While a profiler records, `gan.images` counts the
    images through G (with and without gradient)."""

    def __init__(self, state: GanState, vgg: nn.Module,
                 lambda_feat: float = 10.0, lambda_vgg: float = 10.0):
        self.state, self.vgg = state, vgg
        self.lambda_feat, self.lambda_vgg = lambda_feat, lambda_vgg
        state.generator.train()
        state.discriminator.train()

    def _generate(self, seg: torch.Tensor) -> torch.Tensor:
        with trace.span("sln.gan.generate"):
            if trace.recording():
                trace.count("gan.images", seg.shape[0])
            return self.state.generator(seg)

    def _discriminate(self, seg, fake, real):
        """D on cat(fake, real) along the batch -> (fake's, real's) outputs
        per scale."""
        with trace.span("sln.gan.discriminate"):
            x = torch.cat([torch.cat([seg, fake], 1),
                           torch.cat([seg, real], 1)], 0)
            out = self.state.discriminator(x, True)
        B = fake.shape[0]
        return ([[f[:B] for f in o] for o in out],
                [[f[B:] for f in o] for o in out])

    def _update(self, loss: torch.Tensor, net: nn.Module,
                opt: torch.optim.Optimizer) -> None:
        with trace.span("sln.gan.backward"):
            _set_grads(loss, net)
        with trace.span("sln.gan.adam"):
            opt.step()

    def g_update(self, batch) -> dict:
        seg, real = batch
        st = self.state
        with trace.span("sln.gan.g_update"), conv_math():
            fake = self._generate(seg)
            pred_fake, pred_real = self._discriminate(seg, fake, real)
            out = {"g_gan": gan_loss(pred_fake, True, False)}
            if self.lambda_feat:
                out["g_feat"] = self.lambda_feat * gaugan_feature_matching(
                    pred_fake, pred_real)
            if self.lambda_vgg:
                with trace.span("sln.gan.vgg"):
                    out["g_vgg"] = self.lambda_vgg * vgg_loss(self.vgg,
                                                              fake, real)
            g_loss = sum(out.values())
            self._update(g_loss, st.generator, st.g_opt)
        out["g_loss"] = g_loss
        return {k: v.detach() for k, v in out.items()}

    def d_update(self, batch) -> dict:
        seg, real = batch
        st = self.state
        with trace.span("sln.gan.d_update"), conv_math():
            with torch.no_grad():
                fake = self._generate(seg)
            pred_fake, pred_real = self._discriminate(seg, fake, real)
            out = {"d_fake": gan_loss(pred_fake, False, True),
                   "d_real": gan_loss(pred_real, True, True)}
            d_loss = out["d_fake"] + out["d_real"]
            self._update(d_loss, st.discriminator, st.d_opt)
        out["d_loss"] = d_loss
        return {k: v.detach() for k, v in out.items()}

    def step(self, batch) -> dict:
        """g_update then d_update on one batch -> every loss of both."""
        with trace.span("sln.gan.step"):
            out = self.g_update(batch)
            out.update(self.d_update(batch))
        self.state.step += 1
        return out
