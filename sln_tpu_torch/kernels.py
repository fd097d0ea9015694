"""Build and load the port's CUDA kernels.

The sources in csrc/ have a plain `extern "C"` interface: no PyTorch
headers, no torch.utils.cpp_extension. They are compiled by `nvcc` into
one shared library under sln_tpu_torch/_build/ (git-ignored) at first use
and loaded with ctypes; a library whose sources and flags have not
changed is reused. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("soft_raster.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_lib: Optional[ctypes.CDLL] = None
last_build_log = ""


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin):"
                           " the CUDA kernels are built on the card's "
                           "machine only")
    return path


def _fingerprint() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:12]


def library_path() -> Path:
    return BUILD_DIR / f"libsln_kernels_{_fingerprint()}.so"


def build(timeout: float = BUILD_TIMEOUT_S) -> Path:
    """Compile csrc/ into the shared library unless an up-to-date one
    exists. Returns its path; raises on a failed or timed-out build."""
    global last_build_log
    out = library_path()
    if out.is_file():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout)
    last_build_log = (f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                      f"[{time.perf_counter() - t0:.1f} s]")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{last_build_log}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every argtype declared
    (without them ctypes would cut 64-bit pointers to 32 bits)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sln_raster_fwd.argtypes = [p] * 7 + [i] * 6 + [f] * 3 + [p]
    lib.sln_raster_fwd.restype = i
    lib.sln_raster_bwd.argtypes = [p] * 9 + [i] * 6 + [f] * 3 + [p]
    lib.sln_raster_bwd.restype = i
    lib.sln_raster_bwd_info.argtypes = [p]
    lib.sln_raster_bwd_info.restype = i
    lib.sln_error_string.argtypes = [i]
    lib.sln_error_string.restype = ctypes.c_char_p
    lib.sln_tile_pixels.argtypes = []
    lib.sln_tile_pixels.restype = i
    lib.sln_chunk_faces.argtypes = []
    lib.sln_chunk_faces.restype = i
    lib.sln_max_classes.argtypes = []
    lib.sln_max_classes.restype = i
    from sln_tpu_torch.render import rasterizer_cuda as rc
    built = (lib.sln_tile_pixels(), lib.sln_chunk_faces(),
             lib.sln_max_classes())
    if built != (rc.PT, rc.FC, rc.MAX_CLASSES):
        raise RuntimeError(f"kernel library tiles {built} disagree with "
                           f"rasterizer_cuda {(rc.PT, rc.FC, rc.MAX_CLASSES)}")
    _lib = lib
    return lib


def error_string(err: int) -> str:
    return load().sln_error_string(err).decode()


def bwd_launch_info() -> dict:
    """The backward kernel's resources and resident blocks per SM on the
    current card, as the CUDA runtime reports them."""
    info = (ctypes.c_int * 6)()
    err = load().sln_raster_bwd_info(info)
    if err:
        raise RuntimeError(f"sln_raster_bwd_info: {error_string(err)}")
    keys = ("sms", "blocks_per_sm", "registers", "spill_bytes",
            "shared_bytes", "threads")
    return dict(zip(keys, info))
