"""The port stands alone: sln_tpu_torch and chip_smoke.py import nothing
of JAX, flax, optax, the JAX package or the root `tools` package, its
Blender-side scripts nothing beyond the standard library, numpy, Blender's
modules and the port, its native library builds from its own csrc/, and
the port's entry points run on the card unless asked for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "sln_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sln_tpu", "tools")


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


def _module_name(path):
    rel = path.relative_to(REPO).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


def blender_side_modules():
    """Port modules that run only inside Blender: those whose source
    imports bpy, directly or through another port module (`from pkg
    import mod` counts as importing pkg.mod)."""
    deps = {}
    for path in PORT.rglob("*.py"):
        names = set(_imported_modules(path))
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module:
                names |= {f"{node.module}.{a.name}" for a in node.names}
        deps[_module_name(path)] = names
    blender = {m for m, names in deps.items() if "bpy" in names}
    while True:
        more = {m for m, names in deps.items() if names & blender} - blender
        if not more:
            return blender
        blender |= more


def test_source_scan_finds_no_forbidden_import():
    bad = []
    for path in _port_sources():
        for mod in _imported_modules(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(REPO)}: {mod}")
    assert not bad, bad


def test_every_module_imports_with_jax_blocked():
    """Import every port module and chip_smoke with jax, flax, optax and
    sln_tpu made unimportable; the Blender-side modules, which need bpy,
    are skipped (test_blender_side_modules_import_only_what_blender_has,
    and tests/test_torch_blender.py imports them with a stub bpy)."""
    blender = sorted(blender_side_modules())
    code = (
        "import sys, importlib, pkgutil\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        "import sln_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "sln_tpu_torch.__path__, 'sln_tpu_torch.')\n"
        f"         if m.name not in {blender!r}]\n"
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
    assert "sln_tpu_torch.render.blender.scene_spec" in names
    assert "sln_tpu_torch.render.preview" in names
    assert "sln_tpu_torch.parallel.mesh" in names
    assert "sln_tpu_torch.parallel.sharding" in names
    assert "sln_tpu_torch.dryrun" in names
    for module in ("native", "data.objio", "ops.iou",
                   "tools.build_asset_bank", "tools.eval_refinement_quality",
                   "tools.sweep_refinement"):
        assert f"sln_tpu_torch.{module}" in names


def test_parallel_modules_and_rank_worker_import_no_jax():
    """The data- and tensor-parallel modules and the dry run build on
    torch.distributed and import nothing of JAX; the rank worker the
    parallel tests spawn (tests/torch_dist_worker.py) imports only the
    standard library, numpy, torch and the port, and makes JAX and the JAX
    package unimportable in each rank before it imports the port."""
    mesh_mods = set(_imported_modules(PORT / "parallel" / "mesh.py"))
    assert "torch.distributed" in mesh_mods
    for rel in ("parallel/__init__.py", "parallel/mesh.py",
                "parallel/sharding.py", "dryrun.py", "train/loop.py"):
        mods = _imported_modules(PORT / rel)
        assert not [m for m in mods if m.split(".")[0] in FORBIDDEN], rel
    worker = REPO / "tests" / "torch_dist_worker.py"
    allowed = set(sys.stdlib_module_names) | {"numpy", "torch",
                                              "sln_tpu_torch"}
    bad = [m for m in _imported_modules(worker)
           if m.split(".")[0] not in allowed]
    assert not bad, bad
    import torch_dist_worker

    assert set(torch_dist_worker.BLOCKED) >= set(FORBIDDEN)


def test_host_runtime_slice_imports_nothing_of_the_jax_package():
    """The native binding, the .obj reader, the IoU, every port tool and
    chip_smoke.py import nothing of JAX, the JAX package or the root
    `tools` package (which holds the JAX package's tools)."""
    paths = [PORT / "native.py", PORT / "data" / "objio.py",
             PORT / "ops" / "iou.py", REPO / "chip_smoke.py",
             *sorted((PORT / "tools").glob("*.py"))]
    assert len(paths) >= 8
    for path in paths:
        bad = [m for m in _imported_modules(path)
               if m.split(".")[0] in FORBIDDEN]
        assert not bad, (path.name, bad)


def _code_strings(path):
    """String constants of a source file other than docstrings."""
    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_native_library_builds_from_the_ports_own_source():
    """csrc/native.cpp is the port's own file (not a link) and includes
    only standard headers; the build names no path under sln_tpu/: its
    source, output and command lie in the port."""
    from sln_tpu_torch import native

    src = PORT / "csrc" / "native.cpp"
    assert src.is_file() and not src.is_symlink()
    includes = [ln for ln in src.read_text().splitlines()
                if ln.startswith("#include")]
    assert includes and all("<" in ln for ln in includes), includes
    assert native.CSRC == PORT / "csrc"
    assert native.BUILD_DIR == PORT / "_build"
    cmd = native.build_command(native.library_path())
    assert not [a for a in cmd if "sln_tpu/" in a or "sln_tpu" + os.sep
                in a], cmd
    assert not [c for c in _code_strings(PORT / "native.py")
                if "sln_tpu/" in c or "cpp" in c.split("/")], \
        _code_strings(PORT / "native.py")


def test_blender_side_modules_import_only_what_blender_has():
    """The bpy scripts import nothing outside the standard library, numpy,
    bpy, mathutils and the port; the port modules they reach import no
    torch (Blender's bundled Python has none)."""
    blender = blender_side_modules()
    assert blender == {f"sln_tpu_torch.render.blender.{m}" for m in (
        "bpy_scene", "driver", "render_color", "render_semantic_depth")}
    allowed = set(sys.stdlib_module_names) | {"numpy", "bpy", "mathutils",
                                              "sln_tpu_torch"}
    bad = []
    for path in PORT.rglob("*.py"):
        if _module_name(path) in blender:
            bad += [f"{path.name}: {m}" for m in _imported_modules(path)
                    if m.split(".")[0] not in allowed]
    assert not bad, bad
    # what they reach imports no torch when imported (a function may
    # import it when called: resolve_device does)
    reached = ["__init__.py", "render/__init__.py", "data/__init__.py",
               "workloads/__init__.py", "data/vocab.py", "render/assets.py",
               "render/blender/__init__.py", "render/blender/scene_spec.py",
               "workloads/plot2d.py", "render/image_io.py"]
    for rel in reached:
        tree = ast.parse((PORT / rel).read_text())
        top = {a.name.split(".")[0] for n in tree.body
               if isinstance(n, ast.Import) for a in n.names}
        top |= {n.module.split(".")[0] for n in tree.body
                if isinstance(n, ast.ImportFrom) and n.module}
        assert top <= allowed - {"bpy", "mathutils"}, (rel, top)


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


@pytest.mark.parametrize("tool", ["eval_refinement_quality",
                                  "sweep_refinement"])
def test_refinement_tools_default_to_the_card(monkeypatch, tmp_path, tool):
    import importlib

    module = importlib.import_module(f"sln_tpu_torch.tools.{tool}")
    assert module.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        module.main(["--output_dir", str(REPO / "artifacts"),
                     "--checkpoint_name", "bench", "--rooms", "2"]
                    + (["--out", str(tmp_path / "s.json"), "--rows", "0"]
                       if tool == "sweep_refinement" else []))
    assert not (tmp_path / "s.json").exists()


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
