"""Shared workload setup: data arrays, size table, model restore
(counterpart of sln_tpu/workloads/common.py)."""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from sln_tpu_torch.config import Config
from sln_tpu_torch.data import synthetic, tensorize
from sln_tpu_torch.data.augment import SizeInfo
from sln_tpu_torch.models.vae import Sg2ScVAE, params_from_jax
from sln_tpu_torch.train.checkpoint import (latest_path, load_checkpoint,
                                            reference_pt_path)


def _generator_code_token() -> str:
    """Short hash of the sources that make the synthetic arrays
    (synthetic.py, tensorize.py and vocab.py, which defines the class
    indices), so the disk cache invalidates itself when any of them
    changes."""
    import hashlib

    from sln_tpu_torch.data import vocab

    h = hashlib.sha1()
    for mod in (synthetic, tensorize, vocab):
        with open(mod.__file__, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:8]


def synthetic_cache_dir() -> Optional[str]:
    """The data cache's directory: $SLN_TPU_DATA_CACHE, else
    sln_tpu_torch_data_cache under the temporary directory (not the JAX
    package's); None when the variable is "0" (no cache)."""
    root = os.environ.get("SLN_TPU_DATA_CACHE", "")
    if root == "0":
        return None
    return root or os.path.join(tempfile.gettempdir(),
                                "sln_tpu_torch_data_cache")


def _synthetic_arrays_cached(n: int, seed: int, max_objects: int
                             ) -> Dict[str, np.ndarray]:
    """Tensorized synthetic rooms, cached on disk as .npz under the key
    (n, seed, max_objects, generator code hash): generating rooms is host
    Python (minutes for thousands of rooms), and the key makes the cache
    exact. SLN_TPU_DATA_CACHE=0 disables it, or names its directory."""
    cache_dir = synthetic_cache_dir()
    if cache_dir is None:
        return tensorize.tensorize_rooms(
            synthetic.generate_rooms(n, seed=seed), max_objects)
    path = os.path.join(
        cache_dir,
        f"syn_{n}_{seed}_{max_objects}_{_generator_code_token()}.npz")
    if os.path.isfile(path):
        # an entry that cannot be read (another user's file, a truncated
        # write) is regenerated
        try:
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        except Exception as e:
            print(f"| data cache unreadable ({path}: {e}); regenerating",
                  flush=True)
            try:
                os.unlink(path)
            except OSError:
                pass
    arrays = tensorize.tensorize_rooms(
        synthetic.generate_rooms(n, seed=seed), max_objects)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:     # a file object: np.savez would
            np.savez(f, **arrays)      # append .npz to a str path
        os.replace(tmp, path)          # atomic against concurrent writers
    except OSError:
        pass
    return arrays


def load_arrays(path_or_synthetic: Union[str, int], cfg: Config, device,
                synthetic_seed: int = 0
                ) -> Tuple[Dict[str, np.ndarray], SizeInfo]:
    """path (reference JSON schema, through the C++ packer) or int N
    synthetic rooms (disk-cached) -> padded numpy arrays + the size table
    on `device`."""
    if isinstance(path_or_synthetic, int):
        arrays = _synthetic_arrays_cached(path_or_synthetic, synthetic_seed,
                                          cfg.data.max_objects)
    else:
        arrays = tensorize.tensorize_file(path_or_synthetic,
                                          cfg.data.max_objects)
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
