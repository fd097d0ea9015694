"""One rank of a data-parallel check of the port, and the launcher that
starts the ranks. Not collected by pytest (no test_ prefix): the tests
import `launch` from here, and each rank runs this file as a script

    RANK=r WORLD_SIZE=n ... python tests/torch_dist_worker.py JOB INIT OUT

with JAX, flax, optax and sln_tpu made unimportable: a rank imports only
torch, numpy and the port. JOB is a torch.save'd dict of tasks by name, each
naming its kind (TASKS) and holding its inputs (made by the test from the JAX package's data); INIT is the
process group's store (file://, so ranks of concurrent test workers never
share a TCP port); each rank saves its results to OUT/rank<r>.pt.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
from typing import Callable

REPO = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "sln_tpu", "tools")


def launch(world: int, job: dict, workdir, nodes: int = 1
           ) -> Callable[..., list]:
    """Start `job` on `world` ranks (one process each, gloo through a
    FileStore in `workdir`); returns wait(timeout), which waits for them
    and returns each rank's results in rank order (or raises with the log
    of a rank that failed). The caller works on while the ranks run.
    nodes > 1 gives the ranks the environment torchrun gives ranks on that
    many nodes of equal size (GROUP_RANK, LOCAL_RANK, LOCAL_WORLD_SIZE),
    contiguous ranks to a node."""
    import torch

    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    job_path = workdir / "job.pt"
    torch.save(job, job_path)
    init = f"file://{workdir / 'store'}"
    procs, per_node = [], world // nodes
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank % per_node),
                   LOCAL_WORLD_SIZE=str(per_node),
                   PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        if nodes > 1:
            env["GROUP_RANK"] = str(rank // per_node)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(job_path), init, str(workdir)],
            env=env, cwd=str(workdir), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))

    def wait(timeout: float = 300.0) -> list:
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"rank {rank} exited {p.returncode}:\n"
                                   f"{log}")
        return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
                for r in range(world)]

    return wait


# ---------------------------------------------------------------------------
# the tasks (each rank runs them in the job's order)
# ---------------------------------------------------------------------------
def _train(mesh, job):
    """`steps` DP train steps from `restored` (or the seeded init) on the
    global batch `raw`, with the global `draws` per step (or the step's
    own); with `plain_too`, the same steps without a mesh on all rows.
    Returns per run: losses per step, the first step's gradients, the
    final state tensors and the model and Adam states in JAX layout."""
    import torch

    from sln_tpu_torch.data.augment import GraphDraws, SizeInfo
    from sln_tpu_torch.train import loop
    from sln_tpu_torch.train.checkpoint import adam_state_of, model_state_of

    cfg, device = job["cfg"], mesh.device
    size_info = SizeInfo(*(torch.as_tensor(x, device=device)
                           for x in job["size_table"]))
    raw = loop.RawBatch(*(torch.as_tensor(job["raw"][k], device=device)
                          for k in loop.RawBatch._fields))
    B = raw.objs.shape[0]

    def draws_at(s):
        if job.get("draws") is None:
            return None
        return [(GraphDraws(*(torch.as_tensor(x) for x in graph)),
                 torch.as_tensor(noise)) for graph, noise in job["draws"][s]]

    def run(m):
        world, rank = (m.world_size, m.rank) if m else (1, 0)
        rows = torch.as_tensor(loop.shard_rows(B, cfg.train.microbatch,
                                               rank, world), device=device)
        local = loop.RawBatch(*(a[rows] for a in raw))
        state = loop.create_state(cfg, device, job.get("restored"))
        step = loop.make_train_step(state, cfg, size_info, mesh=m)
        losses, grads = [], None
        for s in range(job["steps"]):
            losses.append({k: v.cpu() for k, v in
                           step(local, draws_at(s)).items()})
            if grads is None:
                grads = [p.grad.detach().cpu().clone()
                         for p in state.model.parameters()]
        if device.type == "cuda":
            torch.cuda.synchronize()
        return {"losses": losses, "grads": grads,
                "state": [t.detach().cpu().clone()
                          for t in state.state_tensors()],
                "model_state": model_state_of(state.model, cfg.model),
                "adam": adam_state_of(state.model, state.optimizer,
                                      cfg.model),
                "names": [n for n, _ in state.model.named_parameters()]}

    out = {"mesh": run(mesh)}
    if job.get("plain_too"):
        out["plain"] = run(None)
    return out


def _model(job, device):
    from sln_tpu_torch.models.vae import Sg2ScVAE

    model = Sg2ScVAE(job["model_cfg"])
    model.load_state_dict(job["state_dict"])
    return model.to(device).eval()


def _sampler(mesh, job):
    import torch

    from sln_tpu_torch.workloads import heatmap

    device = mesh.device
    B, O, T = job["batch"]
    sample = heatmap.make_sampler(
        _model(job, device),
        heatmap.heatmap_scene_batch(B, O, T, device=device),
        job["mean"], job["cov"], mesh=mesh)
    boxes, angles = sample(torch.as_tensor(job["eps"], device=device))
    return {"boxes": boxes.cpu(), "angles": angles.cpu()}


def _refine(mesh, job):
    import torch

    from sln_tpu_torch.data.batch import SceneBatch
    from sln_tpu_torch.parallel.mesh import all_gather_rows
    from sln_tpu_torch.render import assets, scene as scene_lib
    from sln_tpu_torch.workloads import refine
    from sln_tpu_torch.render import rasterizer_cuda as rc

    device, cfg = mesh.device, job["cfg"]
    bank_host = assets.build_procedural_bank(cfg.render.mesh_subdiv)
    bank = scene_lib.device_bank(bank_host, cfg.render.shell_subdiv,
                                 device=device)
    batch = SceneBatch(*(torch.as_tensor(x, device=device)
                         for x in job["batch"]))
    inputs = refine.prepare_refine_inputs(batch, bank_host, bank,
                                          refine.refine_render_config(cfg))
    z0 = torch.as_tensor(job["z0"], device=device)
    *local, model = refine.shard_refine_inputs(mesh, batch, *inputs, z0,
                                               _model(job, device))
    rc.reset_launch_counts()
    refiner = refine.make_refine_step(model, local[0], local[1], bank,
                                      *local[2:5], cfg, local[5], mesh=mesh)
    hist = refiner.run(job["steps"])
    launches = (rc.FWD_LAUNCHES, rc.BWD_LAUNCHES)
    return {"hist": {k: v.cpu() for k, v in hist.items()},
            "z": all_gather_rows(refiner.z.detach(), mesh).cpu(),
            "params": [p.detach().cpu().clone() for p in model.parameters()],
            "launches": launches}


def _colorize(mesh, job):
    import torch

    from sln_tpu_torch.config import default_config
    from sln_tpu_torch.workloads import gan_shade

    device = mesh.device
    model = gan_shade.make_spade_model(default_config(), job["checkpoint"],
                                       device=device)
    seg = torch.as_tensor(job["seg"], device=device)
    zs = torch.as_tensor(job["zs"], device=device)
    return {dtype: gan_shade.colorize(model, seg, zs, job["num_z"],
                                      out_dtype=dtype, mesh=mesh)
            for dtype in ("float32", "uint8")}


def _task_mesh(mesh, job):
    """The mesh a tensor-parallel task names: ("mesh", data, model) or
    ("multislice", slices, data per slice, model), on the world's group."""
    from sln_tpu_torch.parallel import mesh as meshlib

    kind, *shape = job["mesh"]
    make = {"mesh": meshlib.make_mesh,
            "multislice": meshlib.make_multislice_mesh}[kind]
    return make(*shape, device=job["device"])


def _tp_mlp(mesh, job):
    """Each of job["mlps"] (dims, batch_norm, final_plain, state_dict) run
    tensor-parallel on this rank's data rows of x in train mode, then
    backpropagated from sum(y * w) (its own of job["w"]): this rank's rows
    of y and of x's
    gradient, and the parameters' gradients summed over the data group and
    gathered over the model group."""
    import torch

    from sln_tpu_torch.models.layers import MLP, set_mesh
    from sln_tpu_torch.parallel.mesh import all_reduce_flat
    from sln_tpu_torch.parallel.sharding import gather_params, shard_params

    tp = _task_mesh(mesh, job)
    out = []
    for (dims, bn, final_plain, sd), w in zip(job["mlps"], job["w"]):
        mlp = MLP(dims, bn, final_plain)
        mlp.load_state_dict(sd)
        shard_params(mlp, tp)
        set_mesh(mlp, tp)
        rows = tp.rows(job["x"].shape[0])
        x = torch.as_tensor(job["x"][rows]).requires_grad_(True)
        y = mlp(x, torch.as_tensor(job["mask"][rows]))
        (y * torch.as_tensor(w[rows])).sum().backward()
        names = [n for n, _ in mlp.named_parameters()]
        grads = all_reduce_flat([p.grad for p in mlp.parameters()], tp)
        out.append({"y": y.detach(), "x_grad": x.grad,
                    "grads": gather_params(mlp, tp, dict(zip(names, grads))),
                    "state": gather_params(mlp, tp)})
    return out


def _tp_train(mesh, job):
    """`steps` train steps under the task's mesh from `restored`, with the
    state sharded over its model axis (shard_state) and the global `draws`
    per step: the losses, the full model state after the steps (gathered,
    JAX layout), this rank's state tensors (its shards) with their names
    and specs, whether gather_params gave back the restored weights bit
    for bit, and the rank's mesh coordinates."""
    import torch

    from sln_tpu_torch.data.augment import GraphDraws, SizeInfo
    from sln_tpu_torch.models.vae import params_to_jax
    from sln_tpu_torch.parallel.sharding import gather_params, partition_specs
    from sln_tpu_torch.train import loop

    tp = _task_mesh(mesh, job)
    cfg, device = job["cfg"], tp.device
    size_info = SizeInfo(*(torch.as_tensor(x, device=device)
                           for x in job["size_table"]))
    raw = loop.RawBatch(*(torch.as_tensor(job["raw"][k], device=device)
                          for k in loop.RawBatch._fields))
    rows = torch.as_tensor(loop.shard_rows(
        raw.objs.shape[0], cfg.train.microbatch, tp.data_index,
        tp.data_size))
    local = loop.RawBatch(*(a[rows] for a in raw))
    state = loop.create_state(cfg, device, job["restored"])
    full = {k: v.clone() for k, v in state.model.state_dict().items()}
    specs = partition_specs(state.model)
    loop.shard_state(state, tp)
    roundtrip = all(torch.equal(full[k], v) for k, v in
                    gather_params(state.model, tp).items())
    step = loop.make_train_step(state, cfg, size_info, mesh=tp)
    losses = []
    for s in range(job["steps"]):
        draws = [(GraphDraws(*(torch.as_tensor(x) for x in graph)),
                  torch.as_tensor(noise)) for graph, noise in job["draws"][s]]
        losses.append({k: v.cpu() for k, v in step(local, draws).items()})
    names = [n for n, _ in state.model.named_parameters()]
    return {"losses": losses, "roundtrip": roundtrip,
            "model_state": params_to_jax(gather_params(state.model, tp),
                                         cfg.model),
            "local": {n: t.detach().clone() for n, t in
                      state.model.state_dict().items()},
            "adam": {n: [v.clone() for v in state.optimizer.state[p].values()]
                     for n, p in zip(names, state.model.parameters())},
            "specs": specs, "coords": tp.coords,
            "data_index": tp.data_index}


TASKS = {"train": _train, "sampler": _sampler, "refine": _refine,
         "colorize": _colorize, "tp_mlp": _tp_mlp, "tp_train": _tp_train}


def main(job_path: str, init: str, out_dir: str) -> None:
    for name in BLOCKED:
        sys.modules[name] = None
    import torch

    from sln_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    mesh = make_mesh(int(os.environ["WORLD_SIZE"]), device=job["device"],
                     init_method=init)
    try:
        results = {name: TASKS[task["kind"]](mesh, task)
                   for name, task in job["tasks"].items()}
        results["rank"] = mesh.rank
        results["backend"] = mesh.backend
        torch.save(results, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    finally:
        mesh.close()


if __name__ == "__main__":
    main(*sys.argv[1:4])
