"""Blender subprocess bridge (photoreal renders + semantic/depth maps; own
copy of sln_tpu/render/blender_bridge.py).

The reference shells out to Blender 2.79 (testing/test_plot3d.py:4-8,
render/*.py). The port ships its own copies of the modern-Blender scripts
(sln_tpu_torch/render/blender/render_color.py and
render_semantic_depth.py), invoked with the exact reference contract:

    blender -b -P <script> -- <test_dir>

The differentiable rasterizer remains the primary mask/depth source
(sln_tpu_torch.workloads.gan_shade — no process boundary); Blender is the
photoreal / external-validation path. The bridge spawns the subprocess
when a blender binary is on PATH; otherwise it raises with a pointer to
the rasterizer path.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

_BLENDER_SCRIPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "blender")
DEFAULT_COLOR_SCRIPT = os.path.join(_BLENDER_SCRIPTS, "render_color.py")
DEFAULT_MASK_DEPTH_SCRIPT = os.path.join(_BLENDER_SCRIPTS,
                                         "render_semantic_depth.py")


class BlenderNotAvailable(RuntimeError):
    pass


def find_blender(blender_path: Optional[str] = None) -> str:
    if blender_path:
        cand = os.path.join(blender_path, "blender")
        if os.path.isfile(cand):
            return cand
    found = shutil.which("blender")
    if found:
        return found
    raise BlenderNotAvailable(
        "No blender binary found. Photoreal rendering is optional; the "
        "differentiable rasterizer provides semantic masks + depth for the "
        "gan_shade pipeline (sln_tpu_torch.workloads.gan_shade) without "
        "Blender.")


def run_blender_script(script_path: str, test_dir: str,
                       blender_path: Optional[str] = None,
                       timeout: int = 3600) -> subprocess.CompletedProcess:
    """`blender -b -P script -- test_dir` (reference test_plot3d.py:4-8)."""
    binary = find_blender(blender_path)
    return subprocess.run(
        [binary, "-b", "-P", script_path, "--", test_dir],
        check=True, timeout=timeout, capture_output=True)


def run_color_render(test_dir: str, blender_path: Optional[str] = None,
                     script: Optional[str] = None):
    """Photoreal Cycles render of generated layouts (reference
    render/render_caller.py -> render_room_color.py). Defaults to the
    bundled modern-Blender script; pass `script` to override."""
    return run_blender_script(script or DEFAULT_COLOR_SCRIPT, test_dir,
                              blender_path)


def run_mask_depth_render(test_dir: str,
                          blender_path: Optional[str] = None,
                          script: Optional[str] = None):
    """Semantic masks + EXR depth via Blender (reference
    render/semantic_depth_caller.py), defaulting to the bundled script.
    The rasterizer path (gan_shade.layout_channels_to_spade_input)
    supersedes this for speed; outputs here are consumed by
    gan_shade.spade_input_from_files."""
    return run_blender_script(script or DEFAULT_MASK_DEPTH_SCRIPT,
                              test_dir, blender_path)
