"""The port stands alone: sln_tpu_torch and chip_smoke.py import nothing
of JAX, flax, optax or the JAX package, and the port's entry point runs on
the card unless asked for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "sln_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sln_tpu")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path):
    """Every module a source file imports: import statements, and
    importlib.import_module / __import__ calls with a literal name."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif isinstance(node, ast.Call):
            fn = node.func
            name = getattr(fn, "attr", getattr(fn, "id", ""))
            if (name in ("import_module", "__import__") and node.args
                    and isinstance(node.args[0], ast.Constant)):
                yield node.args[0].value


def test_source_scan_finds_no_forbidden_import():
    bad = []
    for path in _port_sources():
        for mod in _imported_modules(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(REPO)}: {mod}")
    assert not bad, bad


def test_every_module_imports_with_jax_blocked():
    """Import every port module and chip_smoke with jax, flax, optax and
    sln_tpu made unimportable."""
    code = (
        "import sys, importlib, pkgutil\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        "import sln_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "sln_tpu_torch.__path__, 'sln_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "print(' '.join(names))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 20
    for module in ("losses", "loop", "checkpoint", "metrics", "cli",
                   "__main__"):
        assert f"sln_tpu_torch.train.{module}" in names


def test_entry_point_defaults_to_the_card(monkeypatch, tmp_path):
    from sln_tpu_torch import resolve_device, test as entry

    assert entry.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        entry.main(["--fine_tune", "--synthetic", "8",
                    "--allow_random_weights", "--test_dir", str(tmp_path)])
    assert resolve_device("cpu").type == "cpu"


def test_train_entry_point_defaults_to_the_card(monkeypatch, tmp_path):
    from sln_tpu_torch.train import cli

    assert cli.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--synthetic", "8", "--num_iterations", "1",
                  "--output_dir", str(tmp_path)])


def test_kernel_build_needs_nvcc(monkeypatch):
    """Building the kernels is the card machine's job: without nvcc the
    build raises instead of leaving a stub."""
    from sln_tpu_torch import kernels

    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernels.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(kernels, "library_path",
                        lambda: pathlib.Path("/nonexistent/lib.so"))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()
