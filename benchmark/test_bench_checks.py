"""What decides `correct`: the program against the plain reference at
small sizes on the CPU, and whole runs with the timed path broken
underneath (the look for a card skipped), each of which has to read
`correct` false. The controls (the reference a precision lower) need the
card: TF32 exists only there."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness, run

CELLS = ("refine_small", "shade_small_fp32", "shade_small_bf16",
         "train_small")


@pytest.mark.parametrize("cell", CELLS)
def test_port_agrees_with_the_reference(small_catalog, cell):
    out = run.run_cell(small_catalog, cell, 2**31 + 3, 0.3, False, "cpu")
    assert out["correct"], out["checks"]


def _state_unchanged_refine(mp):
    from sln_tpu_torch.workloads import refine

    make = refine.refine_optimizer

    def frozen(*a, **kw):
        opt = make(*a, **kw)
        opt.step = lambda *a, **kw: None
        return opt
    mp.setattr(refine, "refine_optimizer", frozen)


def _z_frozen_refine(mp):
    """A fault in the refine loop's own variable alone: z's step dropped,
    the decoder's kept."""
    from sln_tpu_torch.workloads import refine

    make = refine.refine_optimizer

    def z_frozen(*a, **kw):
        opt = make(*a, **kw)
        opt.param_groups[0]["lr"] = 0.0
        return opt
    mp.setattr(refine, "refine_optimizer", z_frozen)


def _state_unchanged_train(mp):
    from sln_tpu_torch.train import loop

    create = loop.create_state

    def frozen(*a, **kw):
        state = create(*a, **kw)
        state.optimizer.step = lambda *a, **kw: None
        return state
    mp.setattr(loop, "create_state", frozen)


def _half_batch_train(mp):
    from sln_tpu_torch.train import loop

    losses = loop.vae_losses

    def half(batch, mu, logvar, boxes, angles, *a, **kw):
        n = batch.objs.shape[0] // 2
        return losses(batch.select(slice(0, n)), mu[:n], logvar[:n],
                      boxes[:n], angles[:n], *a, **kw)
    mp.setattr(loop, "vae_losses", half)


def _answer_altered_shade(mp):
    from sln_tpu_torch.workloads import gan_shade

    colorize = gan_shade.colorize

    def altered(*a, **kw):
        imgs = colorize(*a, **kw).copy()
        imgs[0] = 255 - imgs[0]
        return imgs
    mp.setattr(gan_shade, "colorize", altered)


FAULTS = {
    ("refine_small", "state_unchanged"): _state_unchanged_refine,
    ("refine_small", "z_frozen"): _z_frozen_refine,
    ("train_small", "state_unchanged"): _state_unchanged_train,
    ("train_small", "half_batch"): _half_batch_train,
    ("shade_small_fp32", "answer_altered"): _answer_altered_shade,
    ("shade_small_bf16", "answer_altered"): _answer_altered_shade,
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_a_broken_program_is_not_correct(small_catalog, monkeypatch, cell,
                                         fault):
    FAULTS[cell, fault](monkeypatch)
    out = run.run_cell(small_catalog, cell, 2**32 + 9, 0.3, False, "cpu")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell,kind", [
    ("refine_small", "float64"), ("train_small", "float64"),
    ("train_small", "half_batch")])
def test_control_numbers_are_the_compared_ones(small_catalog, cell, kind):
    """A control yields the cell's compared numbers alone, judged by its
    limits, on the CPU (float64 and half a batch exist there)."""
    from benchmark import control

    ctx = harness.Context(small_catalog, cell, 2**31 + 5, 0.0, False, "cpu",
                          0.0)
    numbers, logged = control.control_numbers(ctx, kind)
    assert set(numbers) == set(ctx.workload["limits"])
    assert not set(numbers) & set(logged)
    if kind == "half_batch":
        assert not harness.judge(numbers, ctx.workload["limits"])


def test_a_control_the_cell_cannot_have_is_none(small_catalog):
    from benchmark import control

    ctx = harness.Context(small_catalog, "refine_small", 3, 0.0, False,
                          "cpu", 0.0)
    assert control.control_numbers(ctx, "half_batch") is None


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [
    w["name"] for w in harness.Catalog().spec["workloads"]])
def test_control_fails_a_limit(cell):
    """The reference one precision lower in the program's place, on the
    cell's own inputs at its own size, reads above a limit, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: TF32 exists only there")
    from benchmark import control

    fails = []
    for seed in (11, 12, 13):
        ctx = harness.Context(harness.Catalog(), cell, seed, 0.0, False,
                              "cuda", 0.0)
        numbers, _ = control.control_numbers(ctx, "lower")
        assert set(numbers) == set(ctx.workload["limits"])
        fails.append(not harness.judge(numbers, ctx.workload["limits"]))
    assert all(fails)
