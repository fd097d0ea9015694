"""Plain PyTorch GauGAN training (Park et al., CVPR 2019; NVlabs/SPADE
models/networks/generator.py, normalization.py, discriminator.py,
architecture.py, loss.py, models/pix2pix_model.py and
trainers/pix2pix_trainer.py), `use_vae` off, norm_G
spectralspadesyncbatch3x3, norm_D spectralinstance, hinge, TTUR: the
step the benchmark holds the measured package's against.

Written from the published equations in float32, to run with TF32 off
(`torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32
= False`, as the caller sets them). Imports nothing of the measured
package. Parameter and buffer names are the measured package's, so one
state_dict loads into both. Departures from NVlabs/SPADE, each also the
measured package's:

* spectral norm keeps u and v as buffers `u`, `v` beside `weight` (torch's
  spectral_norm: weight_orig, weight_u, weight_v) and starts from the u
  and v it is given, not from one random u;
* the synchronized BatchNorm runs on one card: its statistics are the
  card's batch, and nothing stands in for the cross-card reduction;
* the label map is one-hotted here from integer ids, as preprocess_input
  does; the discriminator's wasted weight gradients in the generator's
  backward and the fake's input gradient in the discriminator's are
  computed here as GauGAN computes them (they change no update).

`fault` plants a known defect in a copy of the step, for the controls:
"no_vgg" (the VGG term left out), "g_spectral_frozen" (G's spectral
vectors not advanced), "bn_running" (G's batch norm on its running
statistics in training); in D's update alone, "d_half_batch" (its hinge
over the first half of the batch's fakes and reals), "d_no_real" (the
real images' hinge term left out) and "d_flipped" (the hinge's targets
swapped: fakes scored as real, reals as fake).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BLOCKS = ("head_0", "G_middle_0", "G_middle_1", "up_0", "up_1", "up_2",
          "up_3")
VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
           512, 512, "M", 512)
VGG_SLICES = (2, 7, 12, 21, 30)
VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)
EPS_SN, EPS_BN, MOMENTUM = 1e-12, 1e-5, 0.1


def power_step(w_mat: torch.Tensor, u: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One power-iteration step of torch's spectral_norm: v = W^T u / |.|,
    u = W v / |.|."""
    with torch.no_grad():
        v = F.normalize(w_mat.t() @ u, dim=0, eps=EPS_SN)
        u = F.normalize(w_mat @ v, dim=0, eps=EPS_SN)
    return u, v


class SNConv2d(nn.Conv2d):
    """A conv of W / sigma, sigma = u . (W_mat v), W_mat the weight as
    (out, in x kh x kw); in training mode each forward first takes one
    power-iteration step (unless `advance` is off) and keeps the new u,
    v."""
    advance = True

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.register_buffer("u", torch.zeros(self.out_channels))
        self.register_buffer("v", torch.zeros(self.weight[0].numel()))

    def forward(self, x):
        w_mat = self.weight.reshape(self.out_channels, -1)
        if self.training and self.advance:
            self.u, self.v = power_step(w_mat, self.u)
        sigma = torch.dot(self.u, w_mat @ self.v)
        return self._conv_forward(x, self.weight / sigma, self.bias)


class Spade(nn.Module):
    """normalization.py SPADE: BN(x) (1 + gamma(seg)) + beta(seg), BN the
    param-free batch norm (biased variance over (B, H, W) in training,
    running statistics at momentum 0.1 from the unbiased variance), seg
    resized nearest to x, then conv3x3 -> 128, ReLU, and the gamma and
    beta convs."""
    use_running = False

    def __init__(self, norm_nc: int, label_nc: int, nhidden: int = 128):
        super().__init__()
        self.mlp_shared = nn.Conv2d(label_nc, nhidden, 3, padding=1)
        self.mlp_gamma = nn.Conv2d(nhidden, norm_nc, 3, padding=1)
        self.mlp_beta = nn.Conv2d(nhidden, norm_nc, 3, padding=1)
        self.register_buffer("running_mean", torch.zeros(norm_nc))
        self.register_buffer("running_var", torch.ones(norm_nc))

    def batch_norm(self, x):
        if self.training and not self.use_running:
            mean = x.mean((0, 2, 3))
            var = x.var((0, 2, 3), correction=0)
            with torch.no_grad():
                n = x.numel() // x.shape[1]
                self.running_mean.mul_(1 - MOMENTUM).add_(MOMENTUM * mean)
                self.running_var.mul_(1 - MOMENTUM).add_(
                    MOMENTUM * var * n / (n - 1))
        else:
            mean, var = self.running_mean, self.running_var
        return ((x - mean[None, :, None, None])
                / torch.sqrt(var[None, :, None, None] + EPS_BN))

    def forward(self, x, seg):
        normalized = self.batch_norm(x)
        seg = F.interpolate(seg, size=x.shape[2:], mode="nearest")
        actv = F.relu(self.mlp_shared(seg))
        return normalized * (1 + self.mlp_gamma(actv)) + self.mlp_beta(actv)


class Block(nn.Module):
    """architecture.py SPADEResnetBlock: x_s + conv_1(lrelu(norm_1(conv_0(
    lrelu(norm_0(x)))))), x_s = conv_s(norm_s(x)) where fin != fout."""

    def __init__(self, fin: int, fout: int, label_nc: int):
        super().__init__()
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        self.conv_0 = SNConv2d(fin, fmiddle, 3, padding=1)
        self.conv_1 = SNConv2d(fmiddle, fout, 3, padding=1)
        self.norm_0 = Spade(fin, label_nc)
        self.norm_1 = Spade(fmiddle, label_nc)
        if self.learned_shortcut:
            self.conv_s = SNConv2d(fin, fout, 1, bias=False)
            self.norm_s = Spade(fin, label_nc)

    def forward(self, x, seg):
        x_s = (self.conv_s(self.norm_s(x, seg)) if self.learned_shortcut
               else x)
        dx = self.conv_0(F.leaky_relu(self.norm_0(x, seg), 0.2))
        dx = self.conv_1(F.leaky_relu(self.norm_1(dx, seg), 0.2))
        return x_s + dx


class Generator(nn.Module):
    """generator.py SPADEGenerator, 'normal' upsampling, square crop:
    fc = conv3x3 of the label map resized nearest to crop / 32, head_0,
    up, G_middle_0, G_middle_1, then up and up_0..up_3, tanh(conv_img(
    lrelu(x, 0.2)))."""

    def __init__(self, semantic_nc: int = 151, ngf: int = 64,
                 crop_size: int = 256):
        super().__init__()
        nf, self.sw = ngf, crop_size // 32
        self.fc = nn.Conv2d(semantic_nc, 16 * nf, 3, padding=1)
        widths = (16, 16, 16, 16, 8, 4, 2, 1)
        for name, fin, fout in zip(BLOCKS, widths[:-1], widths[1:]):
            self.add_module(name, Block(fin * nf, fout * nf, semantic_nc))
        self.conv_img = nn.Conv2d(nf, 3, 3, padding=1)

    def forward(self, seg):
        def up(t):
            return F.interpolate(t, scale_factor=2, mode="nearest")

        x = self.fc(F.interpolate(seg, size=(self.sw, self.sw),
                                  mode="nearest"))
        x = self.head_0(x, seg)
        x = self.G_middle_0(up(x), seg)
        x = self.G_middle_1(x, seg)
        for name in BLOCKS[3:]:
            x = getattr(self, name)(up(x), seg)
        return torch.tanh(self.conv_img(F.leaky_relu(x, 0.2)))


def instance_norm(h, eps: float = EPS_BN):
    mean = h.mean((2, 3), keepdim=True)
    var = h.var((2, 3), keepdim=True, correction=0)
    return (h - mean) / torch.sqrt(var + eps)


class NLayerD(nn.Module):
    """discriminator.py NLayerDiscriminator, spectralinstance: conv0 4x4
    stride 2 pad 2 and lrelu 0.2; conv1.. (widths x2 up to 512, the last
    stride 1) spectral without bias, instance norm, lrelu 0.2; a plain
    4x4 stride-1 pad-2 head to one channel. Every output is returned (the
    intermediate ones for feature matching), the logits last."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 4):
        super().__init__()
        self.n_layers = n_layers
        nf = ndf
        self.conv0 = nn.Conv2d(input_nc, nf, 4, 2, padding=2)
        for n in range(1, n_layers):
            prev, nf = nf, min(nf * 2, 512)
            stride = 1 if n == n_layers - 1 else 2
            self.add_module(f"conv{n}", SNConv2d(prev, nf, 4, stride,
                                                 padding=2, bias=False))
        self.head = nn.Conv2d(nf, 1, 4, 1, padding=2)

    def forward(self, x):
        h = F.leaky_relu(self.conv0(x), 0.2)
        out = [h]
        for n in range(1, self.n_layers):
            h = F.leaky_relu(instance_norm(getattr(self, f"conv{n}")(h)),
                             0.2)
            out.append(h)
        out.append(self.head(h))
        return out


class MultiscaleD(nn.Module):
    """discriminator.py MultiscaleDiscriminator: num_D NLayerDs of the same
    depth, the input average-pooled (3, 2, 1, count_include_pad off)
    between them."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 4,
                 num_d: int = 2):
        super().__init__()
        self.num_d = num_d
        for i in range(num_d):
            self.add_module(f"discriminator_{i}",
                            NLayerD(input_nc, ndf, n_layers))

    def forward(self, x):
        out = []
        for i in range(self.num_d):
            out.append(getattr(self, f"discriminator_{i}")(x))
            x = F.avg_pool2d(x, 3, 2, 1, count_include_pad=False)
        return out


class VGG19(nn.Module):
    """architecture.py VGG19: torchvision's features[0:30] in five slices
    ending at relu1_1 .. relu5_1, frozen."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for c in VGG_CFG:
            if c == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, c, 3, padding=1), nn.ReLU()]
                cin = c
        self.features = nn.Sequential(*layers)
        self.requires_grad_(False)

    def forward(self, x):
        out, start = [], 0
        for end in VGG_SLICES:
            for i in range(start, end):
                x = self.features[i](x)
            out.append(x)
            start = end
        return out


def one_hot(label: torch.Tensor, nc: int) -> torch.Tensor:
    """preprocess_input: (B, 1, H, W) ids -> (B, nc, H, W) one-hot."""
    out = torch.zeros((label.shape[0], nc) + tuple(label.shape[2:]),
                      device=label.device)
    return out.scatter_(1, label.long(), 1.0)


def hinge_d(preds: List[list], real: bool) -> torch.Tensor:
    """loss.py GANLoss hinge for the discriminator, averaged over scales."""
    total = 0.0
    for p in preds:
        x = p[-1] - 1 if real else -p[-1] - 1
        total = total - torch.min(x, torch.zeros_like(x)).mean()
    return total / len(preds)


def hinge_g(preds: List[list]) -> torch.Tensor:
    total = 0.0
    for p in preds:
        total = total - p[-1].mean()
    return total / len(preds)


def feature_matching(fake: List[list], real: List[list],
                     lambda_feat: float) -> torch.Tensor:
    """pix2pix_model.py: sum over scales i and layers j of
    L1(fake_ij, real_ij.detach()) x lambda_feat / num_D."""
    total = 0.0
    for fi, ri in zip(fake, real):
        for f, r in zip(fi[:-1], ri[:-1]):
            total = total + F.l1_loss(f, r.detach()) * lambda_feat / len(fake)
    return total


def vgg_loss(vgg: VGG19, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """loss.py VGGLoss."""
    xf, yf = vgg(x), vgg(y)
    total = 0.0
    for w, a, b in zip(VGG_WEIGHTS, xf, yf):
        total = total + w * F.l1_loss(a, b.detach())
    return total


def discriminate(D, seg, fake, real):
    """D on cat(fake, real) along the batch, split back per output."""
    out = D(torch.cat([torch.cat([seg, fake], 1),
                       torch.cat([seg, real], 1)], 0))
    B = fake.shape[0]
    return ([[t[:B] for t in o] for o in out],
            [[t[B:] for t in o] for o in out])


class Nets:
    """G, D and VGG19 from state_dicts, in training mode (VGG frozen)."""

    def __init__(self, cfg: dict, sd_g: dict, sd_d: dict, sd_vgg: dict,
                 device, fault: Optional[str] = None):
        nc = cfg["semantic_nc"]
        self.G = Generator(nc, cfg["ngf"], cfg["crop_size"]).to(device)
        self.D = MultiscaleD(nc + 3, cfg["ndf"], cfg["n_layers_D"],
                             cfg["num_D"]).to(device)
        self.vgg = VGG19().to(device)
        for net, sd in ((self.G, sd_g), (self.D, sd_d), (self.vgg, sd_vgg)):
            net.load_state_dict(sd)
            net.train()
        self.fault = fault
        self.lambda_feat = cfg["lambda_feat"]
        self.lambda_vgg = 0.0 if fault == "no_vgg" else cfg["lambda_vgg"]
        for m in self.G.modules():
            if isinstance(m, SNConv2d) and fault == "g_spectral_frozen":
                m.advance = False
            if isinstance(m, Spade) and fault == "bn_running":
                m.use_running = True


def leaves(nets: Nets) -> Dict[str, torch.Tensor]:
    """Every parameter of G and D, as 'G.<name>' / 'D.<name>'."""
    out = {f"G.{k}": v for k, v in nets.G.named_parameters()}
    out.update({f"D.{k}": v for k, v in nets.D.named_parameters()})
    return out


def spectral(nets: Nets) -> Dict[str, torch.Tensor]:
    """Every u and v of G and D."""
    out = {}
    for tag, net in (("G", nets.G), ("D", nets.D)):
        out.update({f"{tag}.{k}": v.detach().clone()
                    for k, v in net.named_buffers()
                    if k.endswith((".u", ".v"))})
    return out


def steps(nets: Nets, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
          cfg: dict, semantic_nc: int, each: Optional[Callable] = None):
    """GauGAN's first len(batches) steps (label ids (B, 1, H, W), real (B,
    3, H, W)): per step run_generator_one_step, then
    run_discriminator_one_step; Adam with betas (0, 0.9), lr_g and lr_d.
    -> (losses [(g, d) per step], first gradients, leaves before, leaves
    after). each(k), where given, is called after step k (from 0)."""
    G, D, vgg = nets.G, nets.D, nets.vgg
    opt_g = torch.optim.Adam(G.parameters(), lr=cfg["lr_g"],
                             betas=(cfg["beta1"], cfg["beta2"]),
                             foreach=False)
    opt_d = torch.optim.Adam(D.parameters(), lr=cfg["lr_d"],
                             betas=(cfg["beta1"], cfg["beta2"]),
                             foreach=False)
    before = {k: v.detach().clone() for k, v in leaves(nets).items()}
    losses, grads = [], None
    for k, (label, real) in enumerate(batches):
        seg = one_hot(label, semantic_nc)
        opt_g.zero_grad(set_to_none=True)
        fake = G(seg)
        pred_fake, pred_real = discriminate(D, seg, fake, real)
        g_loss = (hinge_g(pred_fake)
                  + feature_matching(pred_fake, pred_real, nets.lambda_feat))
        if nets.lambda_vgg:
            g_loss = g_loss + vgg_loss(vgg, fake, real) * nets.lambda_vgg
        g_loss.backward()
        opt_g.step()

        opt_d.zero_grad(set_to_none=True)
        with torch.no_grad():
            fake = G(seg).detach()
        fake.requires_grad_()
        pred_fake, pred_real = discriminate(D, seg, fake, real)
        if nets.fault == "d_half_batch":
            h = fake.shape[0] // 2
            pred_fake, pred_real = ([[t[:h] for t in o] for o in p]
                                    for p in (pred_fake, pred_real))
        flip = nets.fault == "d_flipped"
        d_loss = hinge_d(pred_fake, flip)
        if nets.fault != "d_no_real":
            d_loss = d_loss + hinge_d(pred_real, not flip)
        d_loss.backward()
        opt_d.step()
        if k == 0:
            grads = {name: None if p.grad is None else p.grad.detach().clone()
                     for name, p in leaves(nets).items()}
        losses.append((float(g_loss.detach()), float(d_loss.detach())))
        if each is not None:
            each(k)
    after = {k: v.detach().clone() for k, v in leaves(nets).items()}
    return losses, grads, before, after
