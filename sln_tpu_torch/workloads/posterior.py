"""Posterior statistics: encoder sweep -> (mean, full covariance) cache
(counterpart of sln_tpu/workloads/posterior.py; reference
testing/test_VAE.py:33-57).

The sweep encodes padded batches of scenes in eval mode and gathers each
valid object's posterior mean on the host; the covariance is one centred
X^T X in float64. `mean_cov.pkl` holds [mean (d,), cov (d, d)] float64,
as the JAX package and the reference write it.

Randomness (the graph draws of build_graphs, the z noise) enters as
explicit tensors; the loops draw them from torch.Generators seeded with
the JAX package's integers, whose streams differ from JAX's threefry.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from sln_tpu_torch.config import Config
from sln_tpu_torch.data.augment import (GraphDraws, SizeInfo, build_graphs,
                                        draw_graph_randomness)
from sln_tpu_torch.data.batch import SceneBatch
from sln_tpu_torch.models.vae import Sg2ScVAE

POSTERIOR_SEED = 123    # the JAX package's PRNGKey(123)

# (start, B, O) -> the graph draws for the batch of rows start..start+B
GraphDrawFn = Callable[[int, int, int], GraphDraws]


def padded_rows(n: int, start: int, batch_size: int
                ) -> Tuple[np.ndarray, int]:
    """Row indices of the batch at `start`, wrapped to a full batch with
    row 0 (the JAX package's padding), and the number of real rows."""
    idx = np.arange(start, min(start + batch_size, n))
    take = len(idx)
    if take < batch_size:
        idx = np.concatenate([idx, np.zeros(batch_size - take, np.int64)])
    return idx, take


def scene_batch(arrays: Dict[str, np.ndarray], idx: np.ndarray,
                size_info: SizeInfo, cfg: Config, draws: GraphDraws,
                device, obj_mask: Optional[np.ndarray] = None
                ) -> SceneBatch:
    """Rows `idx` of the padded arrays on `device`, with triples and
    attributes from `draws` (build_graphs)."""
    def t(name):
        return torch.as_tensor(arrays[name][idx], device=device)

    mask = t("obj_mask") if obj_mask is None else torch.as_tensor(
        obj_mask, device=device)
    return build_graphs(t("objs"), t("boxes"), t("angles"), mask,
                        t("room_ids"), size_info,
                        max_on_rels=cfg.data.max_on_rels,
                        use_attr_30=cfg.data.use_attr_30, draws=draws)


def generator_graph_draws(seed: int, device) -> GraphDrawFn:
    """Graph draws for a workload loop from one generator seeded `seed`."""
    gen = torch.Generator(device).manual_seed(seed)
    return lambda start, B, O: draw_graph_randomness(B, O, gen, device)


def mean_cov(X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(n, d) posterior means -> (mean (d,), cov (d, d)), float64, with
    the unbiased (n - 1) normalisation."""
    X = np.asarray(X, np.float64)
    mean = X.mean(axis=0)
    Xc = X - mean
    return mean, Xc.T @ Xc / max(len(X) - 1.0, 1.0)


def collect_posterior_stats(model: Sg2ScVAE, arrays: Dict[str, np.ndarray],
                            size_info: SizeInfo, cfg: Config,
                            batch_size: int = 256, device="cuda",
                            graph_draws: Optional[GraphDrawFn] = None
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """(mean (d,), cov (d, d)) over every valid object's posterior mu."""
    draw = graph_draws or generator_graph_draws(POSTERIOR_SEED, device)
    n, O = arrays["objs"].shape
    mus = []
    model.eval()
    with torch.inference_mode():
        for start in range(0, n, batch_size):
            idx, take = padded_rows(n, start, batch_size)
            batch = scene_batch(arrays, idx, size_info, cfg,
                                draw(start, batch_size, O), device)
            mu, _ = model.encode(batch)
            mask = batch.obj_mask.clone()
            mask[take:] = False
            mus.append(mu[mask].double().cpu().numpy())
    return mean_cov(np.concatenate(mus, axis=0))


def get_or_compute_mean_cov(model: Sg2ScVAE, arrays, size_info: SizeInfo,
                            cfg: Config, test_dir: str, device="cuda"
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Cache to `<test_dir>/mean_cov.pkl` (reference test_VAE.py:32-62)."""
    os.makedirs(test_dir, exist_ok=True)
    path = os.path.join(test_dir, "mean_cov.pkl")
    if os.path.isfile(path):
        with open(path, "rb") as f:
            mean, cov = pickle.load(f)
        return np.asarray(mean), np.asarray(cov)
    mean, cov = collect_posterior_stats(model, arrays, size_info, cfg,
                                        device=device)
    with open(path, "wb") as f:
        pickle.dump([mean, cov], f)
    return mean, cov


def cholesky_factor(cov: np.ndarray, jitter: float = 1e-10) -> np.ndarray:
    """Lower Cholesky factor of cov + jitter * I, taken on the host in
    float64 and returned as float32."""
    d = cov.shape[0]
    return np.linalg.cholesky(np.asarray(cov, np.float64)
                              + jitter * np.eye(d)).astype(np.float32)


def sample_z(mean: np.ndarray, cov: np.ndarray, eps: torch.Tensor
             ) -> torch.Tensor:
    """z ~ N(mean, cov) from standard-normal eps (..., d): mean +
    eps @ L^T, with L the host-side float64 Cholesky factor applied on
    eps's device."""
    chol = torch.as_tensor(cholesky_factor(cov), device=eps.device)
    return torch.as_tensor(mean, dtype=torch.float32,
                           device=eps.device) + eps @ chol.T


def draw_eps(shape, d: int, generator: torch.Generator, device
             ) -> torch.Tensor:
    """Standard-normal z noise of shape (*shape, d)."""
    return torch.randn(tuple(shape) + (d,), generator=generator,
                       device=device)
