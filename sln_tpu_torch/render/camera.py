"""Projection camera for the differentiable renderer (counterpart of
sln_tpu/render/camera.py; reference models/diff_render.py:13-46): fixed
pitch, camera at the room's mid-x on the near wall, slightly above
mid-height; world -> OpenCV camera coordinates (x right, y down, z
forward) via the cam2cv flip diag(1, -1, -1). Batched over scenes."""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import torch

from sln_tpu_torch.config import CameraConfig


class Camera(NamedTuple):
    rot: torch.Tensor     # (3, 3) world -> cv rotation (shared)
    trans: torch.Tensor   # (B, 3) world -> cv translation
    focal: float          # focal length in pixels at `image_size`
    center: float         # principal point (image_size / 2)
    image_size: int


@functools.lru_cache(maxsize=None)
def _world_to_cv(pitch: float, device: torch.device) -> torch.Tensor:
    """flip @ pitch rotation, made once per device (a tensor built from
    host data is a copy the host waits for)."""
    c, s = math.cos(pitch), math.sin(pitch)
    rot_w2cam = torch.tensor([[1.0, 0.0, 0.0], [0.0, c, s], [0.0, -s, c]])
    flip = torch.diag(torch.tensor([1.0, -1.0, -1.0]))
    return (flip @ rot_w2cam).to(device)


def camera_from_room(room_dims: torch.Tensor,
                     cfg: CameraConfig = CameraConfig()) -> Camera:
    """room_dims: (B, 3) [X, Y, Z] extents of each room box."""
    rot = _world_to_cv(cfg.pitch, room_dims.device)
    X, Y, Z = room_dims.unbind(-1)
    cam_pos = torch.stack(
        [X / 2.0, Y / 2.0 + (Y / 2.0).abs().clamp(max=cfg.height_offset_cap),
         Z], -1)                                                 # (B, 3)
    return Camera(rot=rot, trans=-cam_pos @ rot.T,
                  focal=cfg.focal_pix * cfg.image_size / cfg.sensor_size,
                  center=cfg.image_size / 2.0, image_size=cfg.image_size)


def to_camera(verts: torch.Tensor, cam: Camera) -> torch.Tensor:
    """(B, V, 3) world -> cv camera coordinates (z is viewing depth)."""
    return verts @ cam.rot.T + cam.trans[:, None, :]


def project(verts_cam: torch.Tensor, cam: Camera, eps: float = 1e-6
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, V, 3) camera coords -> ((B, V, 2) pixel coords [col, row],
    (B, V) depth)."""
    z = verts_cam[..., 2]
    zc = z.clamp(min=eps)
    u = cam.focal * verts_cam[..., 0] / zc + cam.center
    v = cam.focal * verts_cam[..., 1] / zc + cam.center
    return torch.stack([u, v], -1), z
