"""GauGAN in the port (spade/classic.py `gaugan_generator`, the GauGAN
form of spade/discriminator.py, spade/vgg.py, spade/losses.py
`GauganTrainer`, `train_spade --arch gaugan`) against the benchmark's
plain reference (benchmark/reference/gaugan.py, written from NVlabs/SPADE's
equations) on the same seeded weights, at a small size: ngf and ndf 8, 6
classes and don't-care (7 channels), 64 px, batch 2; VGG19 at its real
widths.

Tolerances and why:
* one forward in float32: outputs within 1e-5 of their largest value
  (the two sides order their sums differently: conv algorithms, the batch
  norm's statistics, the spectral normalisation);
* the training steps in float64, where the two must agree to rounding
  (1e-9 relative): every loss, first gradient, parameter, u, v and running
  statistic after one and after three steps, but for the leaves whose
  gradient is rounding alone (held within Adam's steps). In float32 the
  steps part after the first: Adam with beta1 = 0 moves every weight by
  +-lr on its first step, so a gradient at the rounding level (the biases
  that batch norm cancels, a few weights) flips its sign at random, and
  at GauGAN's init (xavier gain 0.02) lr is about one standard deviation
  of a weight;
* the first step in float32: losses within 1e-5; the gradients by the
  benchmark's numbers (benchmark/reference/compare.py): the median leaf's
  norm within 1e-5, the worst leaf's within 2e-2. The worst is the
  second scale's conv0 (4.5e-3 here, and float64 agrees to 1e-9): its
  gradient on the label channels is the difference of the fake's and the
  real's nearly equal terms (they share the label map), so it carries
  float32's rounding many times over. All but 1e-3 of the weights after
  Adam within 1e-6 (the rest within 2 lr).
"""

import contextlib

import numpy as np
import pytest
import torch

from benchmark.reference import compare
from benchmark.reference import gaugan as ref
from benchmark.traffic import labels as traffic_labels
from sln_tpu_torch import trace
from sln_tpu_torch.spade import labels as label_maps
from sln_tpu_torch.spade.spectral import SpectralConv
from sln_tpu_torch.spade.vgg import vgg_loss
from sln_tpu_torch.tools import train_spade

torch.set_num_threads(2)

NGF, NDF, LNC, CROP, B = 8, 8, 6, 64, 2
NC = LNC + 1
CFG = dict(semantic_nc=NC, ngf=NGF, crop_size=CROP, ndf=NDF, n_layers_D=4,
           num_D=2, lambda_feat=10.0, lambda_vgg=10.0, lr_g=1e-4, lr_d=4e-4,
           beta1=0.0, beta2=0.9)
ARGV = ["--arch", "gaugan", "--label_nc", str(LNC), "--crop", str(CROP),
        "--ngf", str(NGF), "--ndf", str(NDF), "--batch_size", str(B),
        "--device", "cpu"]


@contextlib.contextmanager
def default_dtype(dtype):
    saved = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(saved)


def build(dtype=torch.float32):
    """The CLI's trainer and the reference's networks from its weights."""
    with default_dtype(dtype):
        args = train_spade.parse_args(ARGV)
        tr = train_spade.build_gaugan(args, "cpu", train_spade.init_gaugan(
            args, train_spade.gaugan_networks(args)))
        sds = [{k: v.clone() for k, v in net.state_dict().items()}
               for net in (tr.state.generator, tr.state.discriminator,
                           tr.vgg)]
        return tr, ref.Nets(CFG, *sds, "cpu")


def batches(n, dtype=torch.float32):
    gen = torch.Generator().manual_seed(3)
    labels, images = traffic_labels.label_pairs(2 * n, CROP, LNC, 0.05,
                                                (4, 40), 0.1, gen)
    return [(labels[2 * k:2 * k + 2], images[2 * k:2 * k + 2].to(dtype))
            for k in range(n)]


def close(got, want, rel, msg="", floor=1e-30):
    """max |got - want| <= rel x max(max |want|, floor)."""
    scale = float(want.detach().abs().max())
    err = float((got - want).detach().abs().max())
    assert err <= rel * max(scale, floor), (msg, err, scale)


def leaves(G, D, grad=False):
    out = {f"G.{k}": v for k, v in G.named_parameters()}
    out.update({f"D.{k}": v for k, v in D.named_parameters()})
    return {k: (v.grad if grad else v).detach().clone()
            for k, v in out.items()}


def buffers(G, D):
    out = {f"G.{k}": v for k, v in G.named_buffers()}
    out.update({f"D.{k}": v for k, v in D.named_buffers()})
    return {k: v.detach().clone() for k, v in out.items()}


# ---------------------------------------------------------------------------
# one forward, float32
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def nets32():
    return build()


def test_generator_matches_reference(nets32):
    """Training-mode output, the running statistics it leaves and the
    advanced u, v; then the eval-mode output on those statistics."""
    tr, nets = nets32
    G = tr.state.generator
    seg = ref.one_hot(batches(1)[0][0], NC)
    G.train()
    nets.G.train()
    close(G(seg), nets.G(seg), 1e-5, "train output")
    got, want = buffers(G, nets.D), buffers(nets.G, nets.D)
    for k in want:
        if k.startswith("G."):
            close(got[k], want[k], 1e-5, k)
    G.eval()
    nets.G.eval()
    try:
        close(G(seg), nets.G(seg), 1e-5, "eval output")
    finally:
        G.train()
        nets.G.train()
    assert sum(p.numel() for p in G.parameters()) == sum(
        p.numel() for p in nets.G.parameters())


def test_discriminator_matches_reference(nets32):
    """Every intermediate feature and the logits at both scales, in
    training mode (one power-iteration step)."""
    tr, nets = nets32
    label, image = batches(1)[0]
    x = torch.cat([ref.one_hot(label, NC), image], 1)
    got = tr.state.discriminator(x, True)
    want = nets.D(x)
    assert len(got) == len(want) == 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w) == 5                 # 4 features, logits
        for j, (a, b) in enumerate(zip(g, w)):
            assert a.shape == b.shape
            close(a, b, 1e-5, f"scale {i} output {j}")


def test_vgg_loss_and_input_gradient_match_reference(nets32):
    """The VGG loss at VGG19's own widths on 32 px, and its gradient with
    respect to the fake image."""
    tr, nets = nets32
    gen = torch.Generator().manual_seed(4)
    fake = (torch.rand(2, 3, 32, 32, generator=gen) * 2 - 1).requires_grad_()
    real = torch.rand(2, 3, 32, 32, generator=gen) * 2 - 1
    got = vgg_loss(tr.vgg, fake, real)
    (g_got,) = torch.autograd.grad(got, fake)
    fake2 = fake.detach().clone().requires_grad_()
    want = ref.vgg_loss(nets.vgg, fake2, real)
    (g_want,) = torch.autograd.grad(want, fake2)
    close(got, want, 1e-5, "loss")
    close(g_got, g_want, 1e-5, "input gradient")
    assert not any(p.requires_grad for p in tr.vgg.parameters())


# ---------------------------------------------------------------------------
# training steps
# ---------------------------------------------------------------------------
def run_steps(dtype, n):
    """n steps of the port's trainer and of the reference from the same
    state on the same batches -> per side (losses, first gradients, the
    leaves and buffers after step 1 and after step n)."""
    tr, nets = build(dtype)
    G, D = tr.state.generator, tr.state.discriminator
    bs = batches(n, dtype)
    with default_dtype(dtype):
        prog = {"losses": [], "after": {}}
        for k, (label, image) in enumerate(bs):
            out = tr.step((label_maps.one_hot(label, NC).to(dtype), image))
            prog["losses"].append((float(out["g_loss"]),
                                   float(out["d_loss"])))
            if k == 0:
                prog["grads"] = leaves(G, D, grad=True)
            prog["after"][k + 1] = (leaves(G, D), buffers(G, D))
        want = {"after": {}}

        def each(k):
            want["after"][k + 1] = ({k: v.detach().clone() for k, v in
                                     ref.leaves(nets).items()},
                                    buffers(nets.G, nets.D))

        want["losses"], want["grads"], _, _ = ref.steps(nets, bs, CFG, NC,
                                                        each)
    return prog, want


@pytest.fixture(scope="module")
def steps64():
    return run_steps(torch.float64, 3)


@pytest.mark.parametrize("n", [1, 3])
def test_steps_match_reference_in_float64(steps64, n):
    """After n steps: each step's losses, the first step's gradient of
    every leaf of G and D, every leaf, every u and v and G's running
    statistics."""
    prog, want = steps64
    for (pg, pd), (wg, wd) in zip(prog["losses"][:n], want["losses"][:n]):
        assert abs(pg - wg) <= 1e-9 * abs(wg)
        assert abs(pd - wd) <= 1e-9 * abs(wd)
    scale = max(float(g.abs().max()) for g in want["grads"].values())
    for k, g in want["grads"].items():
        assert float((prog["grads"][k] - g).abs().max()) <= 1e-9 * scale, k
    p_leaves, p_bufs = prog["after"][n]
    w_leaves, w_bufs = want["after"][n]
    assert set(p_leaves) == set(w_leaves) and set(p_bufs) == set(w_bufs)
    # a leaf whose gradient is rounding alone (the biases batch norm
    # cancels: below 1e-3 of the median leaf's gradient, the benchmark's
    # rule) moves by an arbitrary share of lr a step; the rest to rounding
    norms = {k: float(g.norm()) for k, g in want["grads"].items()}
    med = sorted(norms.values())[len(norms) // 2]
    for k in w_leaves:
        if norms[k] >= 1e-3 * med:
            close(p_leaves[k], w_leaves[k], 1e-9, k)
        else:
            assert float((p_leaves[k] - w_leaves[k]).abs().max()) <= \
                2 * n * CFG["lr_d"], k
    for k in w_bufs:
        # the running means take in those biases: 1e-10 at the least
        close(p_bufs[k], w_bufs[k], 1e-9, k, floor=0.1)


def test_first_step_matches_reference_in_float32():
    """The program's own precision: losses, gradients and the weights
    after Adam (see the module's docstring)."""
    prog, want = run_steps(torch.float32, 1)
    for p, w in zip(prog["losses"][0], want["losses"][0]):
        assert abs(p - w) <= 1e-5 * abs(w)
    leaves_ = compare.counted_leaves(want["grads"])
    worst, at = compare.leaf_gap(prog["grads"], want["grads"], leaves_)
    assert worst <= 2e-2, at
    assert compare.median_gap(prog["grads"], want["grads"], leaves_) <= 1e-5
    p_leaves, w_leaves = prog["after"][1][0], want["after"][1][0]
    far = total = 0
    for k, w in w_leaves.items():
        d = (p_leaves[k] - w).abs()
        lr = CFG["lr_g"] if k.startswith("G.") else CFG["lr_d"]
        assert float(d.max()) <= 2 * lr * 1.001, k
        far += int((d > 1e-6).sum())
        total += d.numel()
    assert far <= 1e-3 * total, (far, total)


def test_spans_and_counters_record_a_step():
    """Under a profiler a step opens each span once (generate and
    discriminate twice), counts 2B images through G, and advances every
    spectral conv of G and D twice."""
    tr, _ = build()
    n_spectral = sum(isinstance(m, SpectralConv) for net in (
        tr.state.generator, tr.state.discriminator) for m in net.modules())
    label, image = batches(1)[0]
    trace.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        tr.step((label_maps.one_hot(label, NC), image))
    c = trace.counters()
    assert c["spectral.power_iters"] == 2 * n_spectral
    assert c["gan.images"] == 2 * B
    for name, calls in (("step", 1), ("g_update", 1), ("d_update", 1),
                        ("generate", 2), ("discriminate", 2), ("vgg", 1),
                        ("backward", 2), ("adam", 2)):
        assert c[f"sln.gan.{name}.calls"] == calls, name
    trace.reset()
    tr.step((label_maps.one_hot(label, NC), image))
    assert "spectral.power_iters" not in trace.counters()


def test_one_hot_and_synthetic_labels():
    """preprocess_input's one-hot, and the CLI's synthetic maps: ids in
    range, don't-care present, images in [-1, 1], seeded."""
    label = torch.tensor([[[[0, 2], [6, 1]]]])
    oh = label_maps.one_hot(label, NC)
    assert oh.shape == (1, NC, 2, 2) and torch.equal(oh.argmax(1), label[:, 0])
    assert torch.equal(oh.sum(1), torch.ones(1, 2, 2))
    a = label_maps.synthetic_label_pairs(
        8, 32, LNC, True, torch.Generator().manual_seed(1))
    b = label_maps.synthetic_label_pairs(
        8, 32, LNC, True, torch.Generator().manual_seed(1))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    labels, images = a
    assert labels.shape == (8, 1, 32, 32) and images.shape == (8, 3, 32, 32)
    assert int(labels.max()) <= LNC and int(labels.min()) >= 0
    assert float(images.abs().max()) <= 1.0
    no_dc, _ = label_maps.synthetic_label_pairs(
        8, 32, LNC, False, torch.Generator().manual_seed(1))
    assert int(no_dc.max()) < LNC


@pytest.mark.parametrize("source", ["synthetic_labels", "pairs_dir"])
def test_train_spade_gaugan_cli(tmp_path, source):
    """Two steps of `train_spade --arch gaugan --device cpu` on synthetic
    label maps or on .npz files of them: finite losses, an eval, the
    checkpoint with G's spectral vectors and running statistics, and a
    warm start that reads them."""
    out = tmp_path / "ck"
    data = ["--synthetic_labels", "6"]
    if source == "pairs_dir":
        labels, images = label_maps.synthetic_label_pairs(
            6, CROP, LNC, True, torch.Generator().manual_seed(2))
        for i in range(6):
            np.savez(tmp_path / f"{i}.npz", label=labels[i, 0].numpy(),
                     rgb=images[i].permute(1, 2, 0).numpy())
        data = ["--pairs_dir", str(tmp_path)]
    argv = ARGV + data + ["--steps", "2", "--print_every", "1",
                          "--eval_every", "2", "--output_dir", str(out)]
    tr = train_spade.main(argv)
    hist = tr.loss_history()
    assert set(hist) >= {"g_loss", "d_loss", "g_gan", "g_feat", "g_vgg"}
    assert all(torch.isfinite(torch.as_tensor(v)).all()
               for v in hist.values())
    assert len(tr.evals) == 1
    ck = out / "spade_gan.ckpt"
    G = tr.state.generator
    warm = train_spade.SpadeTrainer(train_spade.parse_args(
        argv + ["--resume", str(ck), "--steps", "0"]))
    for k, v in G.state_dict().items():
        assert torch.equal(warm.state.generator.state_dict()[k], v), k
    assert warm.start_step == 2
    with pytest.raises(SystemExit):
        train_spade.parse_args(ARGV + ["--mmd"])


def test_train_spade_gaugan_vgg_flags(tmp_path):
    """--vgg_weights loads a torchvision-layout VGG19 state_dict (the
    whole network's: features up to 36 and the classifier) into the
    trainer's VGG19; --no_vgg_loss is --lambda_vgg 0."""
    from sln_tpu_torch.spade.vgg import SLICE_ENDS, VGG19Features
    gen = torch.Generator().manual_seed(6)
    sd = {k: torch.randn(v.shape, generator=gen)
          for k, v in VGG19Features().state_dict().items()}
    for i in (30, 32, 34):                  # conv5_2 .. conv5_4
        sd[f"features.{i}.weight"] = torch.randn(512, 512, 3, 3,
                                                 generator=gen)
        sd[f"features.{i}.bias"] = torch.randn(512, generator=gen)
    sd["classifier.0.weight"] = torch.randn(4096, 8, generator=gen)
    path = tmp_path / "vgg19.pth"
    torch.save(sd, path)
    tr = train_spade.SpadeTrainer(train_spade.parse_args(
        ARGV + ["--synthetic_labels", "4", "--steps", "0", "--vgg_weights",
                str(path)]))
    got = tr.trainer.vgg.state_dict()
    assert len(got) == 2 * 13 and all(
        int(k.split(".")[1]) < SLICE_ENDS[-1] for k in got)
    for k, v in got.items():
        assert torch.equal(v, sd[k]), k
    assert not any(p.requires_grad for p in tr.trainer.vgg.parameters())
    assert train_spade.parse_args(ARGV).lambda_vgg == 10.0
    assert train_spade.parse_args(ARGV + ["--no_vgg_loss"]).lambda_vgg == 0
