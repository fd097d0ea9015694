"""Train the SPADE shading generator (GAN): the port's counterpart of the
JAX package's tools/train_spade.py.

    python -m sln_tpu_torch.tools.train_spade --synthetic 96 --crop 256 \\
        --ngf 64 --ndf 64 --nz 256 --batch_size 8 --lr_g 1e-4 --lr_d 4e-4 \\
        --lambda_l1 50 --steps 750 --eval_every 250 --save_every 250 \\
        --output_dir ckpts --artifact ckpts/spade_serving.ckpt

SPADEGenerator4 against a MultiscaleDiscriminator (hinge loss + feature
matching + lambda_l1 x pixel L1), or with --mmd the MMD mode (MMD
discriminator heads and the ConvEncoderPSPSEMMD encoder). It takes the JAX
driver's flags and --device (default cuda: it raises when there is no card,
never falling back to the CPU).

Data: `--synthetic N` renders N rooms through the port's rasterizer (the
CUDA forward kernel on the card) into (seg, rgb) pairs with the
deterministic shading target (workloads/gan_shade.py); `--pairs_dir`
reads .npz files with `seg` (H, W, 41) and `rgb` (H, W, 3 in [-1, 1]).
The front `--val_frac` of the pairs is held out. The checkpoint
(`<output_dir>/spade_gan.ckpt`) and the serving artifact (`--artifact`:
g_params in float16 + config) are the JAX package's pickles: either
package resumes from or shades with the other's.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pickle
import time
from typing import Callable, Optional

import numpy as np
import torch

from sln_tpu_torch import resolve_device
from sln_tpu_torch.config import default_config
from sln_tpu_torch.spade import port
from sln_tpu_torch.spade.discriminator import MultiscaleDiscriminator
from sln_tpu_torch.spade.generator import SPADEGenerator4
from sln_tpu_torch.spade.losses import (GanState, make_gan_train_step,
                                        make_mmd_gan_train_step)
from sln_tpu_torch.workloads import gan_shade

# seeds of the draws: the networks' inits (the JAX driver's PRNGKeys 0, 1
# and 3), the batch indices, each step's z (seeded with Z_SEED + t), and
# each eval chunk's z (EVAL_Z_SEED + its first row)
G_SEED, D_SEED, E_SEED = 0, 1, 3
INDEX_SEED = 0
Z_SEED = 2 << 32
EVAL_Z_SEED = 7


def synthetic_pairs(num_rooms: int, crop: int, seed: int = 0,
                    device="cuda"):
    """(seg (N, 41, crop, crop), rgb (N, 3, crop, crop)) on `device`, from
    rasterized synthetic rooms: the render loop and shading target that
    the quality cell measures with (workloads/gan_shade.py)."""
    segs = gan_shade.render_spade_inputs(num_rooms, default_config(), crop,
                                         synthetic_seed=seed, device=device)
    return segs, gan_shade.shading_target(segs)


def load_pairs_dir(path: str):
    """Every .npz of `path`, sorted by name -> (seg (N, H, W, 41), rgb (N,
    H, W, 3)) numpy arrays, as the files store them."""
    segs, rgbs = [], []
    for f in sorted(os.listdir(path)):
        if f.endswith(".npz"):
            d = np.load(os.path.join(path, f))
            segs.append(d["seg"])
            rgbs.append(d["rgb"])
    return np.stack(segs), np.stack(rgbs)


def pairs_source(pairs_dir: str) -> str:
    """The identity of a pairs directory: each .npz's name and the sha1 of
    its bytes. Digests are memoised in `.split_digests.json`, keyed by
    (size, mtime_ns, ctime_ns): a rewrite in place changes ctime even
    where it restores size and mtime, so the memo never serves a stale
    digest, and metadata churn only costs a re-hash."""
    cache_path = os.path.join(pairs_dir, ".split_digests.json")
    try:
        with open(cache_path) as fh:
            memo = json.load(fh)
    except (OSError, ValueError):
        memo = {}

    def digest(name):
        path = os.path.join(pairs_dir, name)
        st = os.stat(path)
        key = f"{st.st_size}:{st.st_mtime_ns}:{st.st_ctime_ns}"
        hit = memo.get(name)
        if hit and hit.get("key") == key:
            return hit["sha"]
        h = hashlib.sha1()
        with open(path, "rb") as fh:
            for block in iter(lambda: fh.read(1 << 20), b""):
                h.update(block)
        memo[name] = {"key": key, "sha": h.hexdigest()[:12]}
        return memo[name]["sha"]

    names = sorted(f for f in os.listdir(pairs_dir) if f.endswith(".npz"))
    src = "pairs:" + ",".join(f"{f}:{digest(f)}" for f in names)
    try:
        with open(cache_path, "w") as fh:
            json.dump(memo, fh)
    except OSError:
        pass                              # a read-only pairs dir: no memo
    return src


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--pairs_dir", default="")
    p.add_argument("--crop", type=int, default=128)
    p.add_argument("--ngf", type=int, default=32)
    p.add_argument("--ndf", type=int, default=32)
    p.add_argument("--nz", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lr_g", type=float, default=1e-4)
    p.add_argument("--lr_d", type=float, default=4e-4)
    p.add_argument("--print_every", type=int, default=20)
    p.add_argument("--eval_every", type=int, default=200,
                   help="report held-out L1/PSNR every N steps")
    p.add_argument("--val_frac", type=float, default=0.125,
                   help="fraction of pairs held out for eval")
    p.add_argument("--lambda_l1", type=float, default=50.0,
                   help="direct pixel L1 weight on G (0 disables)")
    p.add_argument("--output_dir", default="./checkpoints_spade")
    p.add_argument("--artifact", default="",
                   help="also write a serving-only artifact here (g_params "
                        "in float16 + config)")
    p.add_argument("--save_every", type=int, default=0,
                   help="checkpoint every N steps (0: only at the end)")
    p.add_argument("--resume", default="",
                   help="warm-start G/D (+E) and the spectral vectors from "
                        "a spade_gan.ckpt (Adam restarts)")
    p.add_argument("--mmd", action="store_true",
                   help="MMD training mode: MMD discriminator heads + "
                        "ConvEncoderPSPSEMMD")
    p.add_argument("--nef", type=int, default=16, help="MMD encoder width")
    p.add_argument("--lr_e", type=float, default=1e-4)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def _to_nchw(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)), device=device)


class SpadeTrainer:
    """The driver's state: the pairs on the device, the held-out split, the
    networks and their step. `draws(t) -> (idx (B,), z (B, nz))` replaces
    the trainer's own batch indices and z (the tests feed the JAX
    package's)."""

    def __init__(self, args: argparse.Namespace,
                 draws: Optional[Callable] = None):
        self.args, self.draws = args, draws
        self.device = device = resolve_device(args.device)
        t0 = time.perf_counter()
        if args.pairs_dir:
            segs, rgbs = load_pairs_dir(args.pairs_dir)
            segs, rgbs = _to_nchw(segs, device), _to_nchw(rgbs, device)
        else:
            n = args.synthetic or 32
            print(f"| rendering {n} synthetic (seg, rgb) pairs at "
                  f"{args.crop}px", flush=True)
            segs, rgbs = synthetic_pairs(n, args.crop, device=device)
        self.data_s = time.perf_counter() - t0
        n_val = max(1, int(len(segs) * args.val_frac)) if args.eval_every \
            else 0
        # never let the held-out split take the whole dataset
        n_val = min(n_val, len(segs) - 1)
        if n_val <= 0:
            if args.eval_every:
                print("| dataset too small to hold out a val split; "
                      "disabling eval", flush=True)
            n_val = 0
        self.n_val = n_val
        n_total = int(len(segs))
        # the dataset stays on the device; batches are gathered there
        self.val_segs, self.val_rgbs = segs[:n_val], rgbs[:n_val]
        self.segs, self.rgbs = segs[n_val:], rgbs[n_val:]
        print(f"| dataset: {tuple(self.segs.shape)} -> "
              f"{tuple(self.rgbs.shape)} (+{n_val} held out)", flush=True)

        # the identity of the held-out split, stamped into every
        # checkpoint: the split is the front of the sorted, deterministic
        # dataset, so a resume under another split would grade "held-out"
        # quality on images the warm-started generator trained on
        src = (pairs_source(args.pairs_dir) if args.pairs_dir
               else f"synthetic:{args.synthetic or 32}:{args.crop}")
        self.val_split = {"source": hashlib.sha1(src.encode()).hexdigest()
                          [:12], "n_val": n_val, "n_total": n_total}
        self.val_heldout_clean = True

        # built and initialised on the CPU (the same values on any
        # device), then moved
        gen = port.init_like_jax(
            SPADEGenerator4(nz=args.nz, ngf=args.ngf, crop_size=args.crop),
            G_SEED)
        disc = port.init_like_jax(
            MultiscaleDiscriminator(segs.shape[1] + rgbs.shape[1],
                                    args.ndf, n_layers=3, num_d=2,
                                    mmd_nz=args.nz if args.mmd else 0),
            D_SEED)
        enc = None
        if args.mmd:
            from sln_tpu_torch.spade.encoders import ConvEncoderPSPSEMMD
            enc = port.init_like_jax(
                ConvEncoderPSPSEMMD(args.nef, args.nz, rgbs.shape[1]),
                E_SEED).to(device)
        self.state = GanState(gen.to(device), disc.to(device), args.lr_g,
                              args.lr_d, enc, args.lr_e)
        make = make_mmd_gan_train_step if args.mmd else make_gan_train_step
        self.step = make(self.state, lambda_l1=args.lambda_l1)

        self.start_step = 0
        if args.resume:
            self.resume(args.resume)
        self.metrics = gan_shade.make_shading_metrics(self.state.generator)
        self.index_gen = torch.Generator(device).manual_seed(INDEX_SEED)
        self.z_gen = torch.Generator(device)
        self.losses, self.evals = [], []

    def resume(self, path: str) -> None:
        """Warm-start the networks and spectral vectors (Adam restarts, as
        the checkpoint stores none) and carry the split's cleanliness
        across the resume chain."""
        with open(path, "rb") as f:
            prev = pickle.load(f)
        st, mmd = self.state, self.args.mmd
        port.load_from_jax(st.generator, prev["g_params"])
        if "d_params" in prev:
            port.load_from_jax(st.discriminator, prev["d_params"],
                               prev.get("d_spectral"))
        if mmd and "e_params" in prev:
            port.load_from_jax(st.encoder, prev["e_params"],
                               prev.get("e_spectral"))
        config = prev.get("config", {})
        self.start_step = int(config.get("trained_steps", 0))
        print(f"| warm-started params from {path} (previously trained "
              f"{self.start_step} steps)", flush=True)
        prev_split = config.get("val_split")
        # a checkpoint already stamped unclean stays so, even when this
        # resume's split matches: its params trained on rooms now held out
        self.val_heldout_clean = bool(config.get("val_heldout_clean", False))
        if prev_split != self.val_split:
            self.val_heldout_clean = False
            print("| WARNING: held-out split differs from the resumed "
                  f"run's ({prev_split} -> {self.val_split}); val metrics "
                  "from this run may grade on previously-trained images "
                  "and will be stamped val_heldout_clean=False", flush=True)

    def run_eval(self):
        """(L1 on [-1, 1], PSNR dB on [0, 1]) of the generator on the
        held-out pairs, in chunks of the batch size: the MSE averaged over
        the chunks, one log at the end (a mean of PSNRs is biased high)."""
        B, n_val = self.args.batch_size, self.n_val
        l1s, mses = 0.0, 0.0
        for s in range(0, n_val, B):
            seg = self.val_segs[s:s + B]
            z = torch.randn((seg.shape[0], self.args.nz), device=self.device,
                            generator=torch.Generator(
                                self.device).manual_seed(EVAL_Z_SEED + s))
            l1, _, mse = self.metrics(seg, self.val_rgbs[s:s + B], z)
            l1s += l1 * seg.shape[0]
            mses += mse * seg.shape[0]
        return l1s / n_val, gan_shade.psnr_from_mse(mses / n_val)

    def save(self, t: int, extra: dict) -> None:
        args, st = self.args, self.state
        os.makedirs(args.output_dir, exist_ok=True)
        out = os.path.join(args.output_dir, "spade_gan.ckpt")
        # trained_steps from the loop counter at every save, so resume
        # accounting is exact between evals too
        config = {**vars(args), **extra,
                  "trained_steps": self.start_step + t,
                  "val_split": self.val_split,
                  "val_heldout_clean": self.val_heldout_clean}
        g_params, _ = port.params_to_jax(st.generator)
        d_params, d_spectral = port.params_to_jax(st.discriminator)
        payload = {"g_params": g_params, "d_params": d_params,
                   "d_spectral": d_spectral, "config": config}
        if args.mmd:
            payload["e_params"], payload["e_spectral"] = \
                port.params_to_jax(st.encoder)
        with open(out, "wb") as f:
            pickle.dump(payload, f)
        print("saved", out, flush=True)
        if args.artifact:
            # serving only: g_params in float16 (the loaders cast back)
            slim = {"g_params": _tree_map(
                        lambda a: a.astype(np.float16), g_params),
                    "config": config}
            with open(args.artifact, "wb") as f:
                pickle.dump(slim, f)
            print("saved", args.artifact, flush=True)

    def batch(self, t: int):
        """Step t's (seg, rgb, z): indices from the trainer's index
        generator, z from a generator seeded with Z_SEED + t (or
        draws(t))."""
        if self.draws is not None:
            idx, z = self.draws(t)
            idx = torch.as_tensor(idx, device=self.device)
            z = torch.as_tensor(z, device=self.device)
        else:
            B = self.args.batch_size
            idx = torch.randint(0, len(self.segs), (B,), device=self.device,
                                generator=self.index_gen)
            self.z_gen.manual_seed(Z_SEED + t)
            z = torch.randn((B, self.args.nz), device=self.device,
                            generator=self.z_gen)
        return (self.segs.index_select(0, idx),
                self.rgbs.index_select(0, idx), z)

    def train(self, eval_before: bool = False) -> "SpadeTrainer":
        """args.steps steps with the prints, evals and saves of the JAX
        driver. eval_before: also evaluate before the first step (as
        t = 0)."""
        args = self.args
        last_eval = {}
        if eval_before and self.n_val:
            l1, psnr = self.run_eval()
            self.evals.append((0, l1, psnr))
            print(f"step 0: val_l1={l1:.4f} val_psnr={psnr:.2f}dB",
                  flush=True)
        t0 = time.perf_counter()
        for t in range(1, args.steps + 1):
            losses = self.step(*self.batch(t))
            self.losses.append(losses)
            if t % args.print_every == 0:
                rate = t * args.batch_size / (time.perf_counter() - t0)
                print(f"step {t} ({rate:.1f} img/s): " + " ".join(
                    f"{k[0]}={float(v):.4f}"
                    for k, v in sorted(losses.items())), flush=True)
            if args.eval_every and self.n_val and (
                    t % args.eval_every == 0 or t == args.steps):
                l1, psnr = self.run_eval()
                last_eval = {"val_l1": l1, "val_psnr": psnr}
                self.evals.append((t, l1, psnr))
                print(f"step {t}: val_l1={l1:.4f} val_psnr={psnr:.2f}dB",
                      flush=True)
            if args.save_every and t % args.save_every == 0:
                self.save(t, last_eval)
        # the periodic save already wrote this payload when steps is a
        # multiple of save_every
        if not (args.save_every and args.steps % args.save_every == 0):
            self.save(args.steps, last_eval)
        return self

    def loss_history(self) -> dict:
        """{name: (steps,) float numpy} of every step's losses."""
        if not self.losses:
            return {}
        return {k: torch.stack([d[k] for d in self.losses]).cpu().numpy()
                for k in self.losses[0]}


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def main(argv=None, draws: Optional[Callable] = None,
         eval_before: bool = False) -> SpadeTrainer:
    """The driver; returns the trainer after its last save. `draws` and
    `eval_before` as in SpadeTrainer and SpadeTrainer.train."""
    return SpadeTrainer(parse_args(argv), draws).train(eval_before)


if __name__ == "__main__":
    main()
