"""Shared workload setup: data arrays, size table, model restore
(counterpart of sln_tpu/workloads/common.py)."""

from __future__ import annotations

import os
from typing import Dict, Tuple, Union

import numpy as np
import torch

from sln_tpu_torch.config import Config
from sln_tpu_torch.data import synthetic, tensorize
from sln_tpu_torch.data.augment import SizeInfo
from sln_tpu_torch.models.vae import Sg2ScVAE, params_from_jax
from sln_tpu_torch.train.checkpoint import (latest_path, load_checkpoint,
                                            reference_pt_path)


def load_arrays(path_or_synthetic: Union[str, int], cfg: Config, device,
                synthetic_seed: int = 0
                ) -> Tuple[Dict[str, np.ndarray], SizeInfo]:
    """path (reference JSON schema) or int N synthetic rooms -> padded
    numpy arrays + the size table on `device`."""
    if isinstance(path_or_synthetic, int):
        rooms = synthetic.generate_rooms(path_or_synthetic,
                                         seed=synthetic_seed)
    else:
        rooms = tensorize.load_rooms(path_or_synthetic)
    arrays = tensorize.tensorize_rooms(rooms, cfg.data.max_objects)
    t, m, a = synthetic.default_size_table()
    size_info = SizeInfo(*(torch.as_tensor(x, device=device)
                           for x in (t, m, a)))
    return arrays, size_info


def load_jax_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A `.ckpt` of either trainer (a pickle of numpy trees in the JAX
    package's schema; train/checkpoint.py load_checkpoint reads it without
    JAX) -> Sg2ScVAE state_dict."""
    return params_from_jax(load_checkpoint(path)["model_state"])


def restore_model(cfg: Config, device, allow_random: bool = False
                  ) -> Sg2ScVAE:
    """Sg2ScVAE in eval mode with the latest checkpoint's weights: the
    trainer's `.ckpt`, else a reference-trained `.pt` in the same
    directory (its state_dict loads as it is, strictly), else seeded
    random weights when allow_random is set."""
    train = cfg.train
    path = latest_path(train.output_dir, train.checkpoint_name)
    pt_path = reference_pt_path(train.output_dir, train.checkpoint_name)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = Sg2ScVAE(cfg.model)
    if os.path.isfile(path):
        model.load_state_dict(load_jax_checkpoint(path))
        print(f"Restored checkpoint from {path}")
    elif os.path.isfile(pt_path):
        # the reference checkpoint pickles its args and vocab beside the
        # weights, so it needs the full unpickler
        ckpt = torch.load(pt_path, map_location="cpu", weights_only=False)
        model.load_state_dict(ckpt["model_state"], strict=True)
        print(f"Restored checkpoint from {pt_path}")
    elif allow_random:
        print(f"WARNING: no checkpoint at {path}; using random weights")
    else:
        raise FileNotFoundError(
            f"checkpoint not found: {path} (train first, or pass "
            f"--allow_random_weights)")
    return model.to(device).eval()
