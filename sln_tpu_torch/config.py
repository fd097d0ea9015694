"""Typed configuration: the fields training, the render-and-refine path
and the sampling and evaluation workloads read.

Counterpart of sln_tpu/config.py (ModelConfig, DataConfig, CameraConfig,
RenderConfig, RefineConfig, SpadeConfig). `RenderConfig.backend` is gone: the
rasterizer launches the CUDA kernel for tensors on the card and runs its
plain PyTorch version for tensors on the CPU (render/rasterizer_cuda.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Sg2ScVAE hyperparameters (reference defaults: options/options.py)."""

    embedding_dim: int = 64
    gconv_num_layers: int = 5
    gconv_mode: str = "feedforward"          # 'feedforward' | 'recurrent'
    mlp_normalization: str = "batch"          # 'batch' | 'none'
    decoder_cat: bool = True
    use_attr: bool = True
    use_ae: bool = False                      # z = mu, no KL (--use_AE)
    train_3d: bool = True
    num_angles: int = 24
    num_objs: int = 32
    num_preds: int = 16
    num_attrs: int = 5

    @property
    def gconv_hidden_dim(self) -> int:
        return self.embedding_dim * 4

    @property
    def box_embedding_dim(self) -> int:
        return int(self.embedding_dim * 3 / 4)

    @property
    def angle_embedding_dim(self) -> int:
        return int(self.embedding_dim / 4)

    @property
    def obj_embedding_dim(self) -> int:
        return (int(self.embedding_dim * 3 / 4)
                if self.use_attr else self.embedding_dim)

    @property
    def attr_embedding_dim(self) -> int:
        return int(self.embedding_dim / 4) if self.use_attr else 0

    @property
    def box_dim(self) -> int:
        return 6 if self.train_3d else 4

    @property
    def latent_dim(self) -> int:
        return self.box_embedding_dim + self.angle_embedding_dim


@dataclass(frozen=True)
class DataConfig:
    """Static-shape padded scene-graph batching."""

    max_objects: int = 32      # per scene, includes the __room__ node
    max_triples: int = 96      # 3 x max_objects, as the root test.py sets
    max_on_rels: int = 32      # cap on 'on' relations packed per scene
    use_attr_30: bool = True
    train_path: str = "metadata/data_rot_train.json"
    val_path: str = "metadata/data_rot_val.json"


@dataclass(frozen=True)
class TrainConfig:
    """Reference defaults: options/options.py:34-59, train.py:73-76."""

    batch_size: int = 128
    num_iterations: int = 600_000
    learning_rate: float = 1e-4   # the refine loop steps the model at this
    kl_loss_weight: float = 0.1
    kl_linear_decay: bool = False   # staircase 10**(t//1e5 - 6) when True
    # free-bits floor per latent dimension (0 = off, the reference's loss)
    kl_free_bits: float = 0.0
    seed: int = 42
    # gradient accumulation over chunks of this many scenes (0 = off)
    microbatch: int = 0
    print_every: int = 100
    checkpoint_every: int = 1000
    snapshot_every: int = 10_000
    output_dir: str = "./checkpoints"
    checkpoint_name: str = "latest_checkpoint"


@dataclass(frozen=True)
class CameraConfig:
    """Projection camera (reference: models/diff_render.py:13-46)."""

    focal_pix: float = 400.0
    sensor_size: int = 1024
    image_size: int = 256
    pitch: float = -0.4
    height_offset_cap: float = 0.1
    near: float = 0.001
    depth_clip: float = 15.0
    cull_eps: float = 0.06


@dataclass(frozen=True)
class RenderConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    sigma_px: float = 0.5             # soft edge band width (pixels)
    gamma: float = 0.02               # visibility softmax temperature
    z_far: float = 100.0              # background depth
    mesh_subdiv: int = 2              # procedural bank subdivision
    shell_subdiv: int = 4             # room-shell subdivision


@dataclass(frozen=True)
class RefineConfig:
    """Latent-optimization refinement (reference test_render_refine.py)."""

    num_iters: int = 60
    lr_z: float = 2e-4
    lr_model_scale: float = 0.1
    momentum: float = 0.1
    nesterov: bool = True
    seed: int = 13
    softargmax_beta: float = 2.0
    angle_noise_scale: float = 0.1
    pyramid_sizes: Tuple[int, ...] = (32, 48, 64, 96)
    depth_loss_weight: float = 100.0 * 0.5
    semantic_loss_weight: float = 100.0 / 800.0
    size_loss_weight: float = 2.0
    render_size: int = 96


@dataclass(frozen=True)
class SpadeConfig:
    """SPADEGenerator4 as loaded at inference (reference
    testing/test_SPADE_shade.py:9)."""

    semantic_nc: int = 41
    target_nc: int = 3
    nz: int = 256
    ngf: int = 64
    crop_size: int = 256
    n_up: str = "normal"              # 'normal' | 'more' | 'most'
    num_z: int = 50                   # reference test.py:94
    # only "float32" is ported; bfloat16 convs are ROADMAP item 10
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    refine: RefineConfig = field(default_factory=RefineConfig)
    spade: SpadeConfig = field(default_factory=SpadeConfig)
    test_dir: str = "./layouts_out"

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


def default_config() -> Config:
    return Config()
