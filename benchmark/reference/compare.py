"""The numbers that decide `correct` for a stepped optimisation (training,
refinement): each step's loss, the first gradient and the change of the
parameters over the first steps, taken by the worst leaf."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

# a leaf whose reference gradient is below this share of the median
# leaf's moves by round-off alone (a key's bias under softmax, say)
NEGLIGIBLE = 1e-3


def loss_gap(prog: List[float], ref: List[float]) -> float:
    """The largest relative gap of a step's loss."""
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def counted_leaves(ref_grads: Dict[str, Optional[torch.Tensor]]
                   ) -> List[str]:
    """The leaves the reference moves: a gradient, and not negligible
    against the median leaf's."""
    norms = {k: float(g.norm()) for k, g in ref_grads.items()
             if g is not None}
    med = float(torch.tensor(list(norms.values())).median())
    return [k for k, n in norms.items() if n >= NEGLIGIBLE * med]


def leaf_gap(prog: Dict[str, Optional[torch.Tensor]],
             ref: Dict[str, Optional[torch.Tensor]],
             leaves: List[str]) -> Tuple[float, str]:
    """max over `leaves` of | |prog| - |ref| | / max(|ref|, the median
    leaf's |ref|), and the leaf that gives it. A leaf the program leaves
    without a value counts as norm 0."""
    def norm(t):
        return 0.0 if t is None else float(t.double().norm())

    ref_n = {k: norm(ref[k]) for k in leaves}
    med = float(torch.tensor(list(ref_n.values())).median())
    worst, at = -1.0, ""
    for k in leaves:
        gap = abs(norm(prog.get(k)) - ref_n[k]) / max(ref_n[k], med, 1e-30)
        if gap > worst:
            worst, at = gap, k
    return worst, at


def median_gap(prog: Dict[str, Optional[torch.Tensor]],
               ref: Dict[str, Optional[torch.Tensor]],
               leaves: List[str]) -> float:
    """The median over `leaves` of leaf_gap's per-leaf gap: steady where
    a few leaves swing (a loss with thresholds in it)."""
    def norm(t):
        return 0.0 if t is None else float(t.double().norm())

    ref_n = {k: norm(ref[k]) for k in leaves}
    med = float(torch.tensor(list(ref_n.values())).median())
    gaps = [abs(norm(prog.get(k)) - ref_n[k]) / max(ref_n[k], med, 1e-30)
            for k in leaves]
    return float(torch.tensor(gaps).median())


def deltas(after: Dict[str, torch.Tensor], before: Dict[str, torch.Tensor]
           ) -> Dict[str, torch.Tensor]:
    return {k: after[k].double() - before[k].double() for k in after}


def compare_steps(prog, ref, alone=()):
    """Every number of (losses, first gradients, leaves before, leaves
    after[, leaves after the first step]) against the reference's: each
    step's loss and the worst leaf's gaps, the first step's loss and the
    median leaf's gaps, and the gaps of each leaf named in `alone` against
    its own norm (its change over the first step too, where given)."""
    leaves = counted_leaves(ref[1])
    g_gap, g_at = leaf_gap(prog[1], ref[1], leaves)
    dp, dr = deltas(prog[3], prog[2]), deltas(ref[3], ref[2])
    d_gap, d_at = leaf_gap(dp, dr, leaves)
    numbers = {"loss_gap": loss_gap(prog[0], ref[0]), "grad1_gap": g_gap,
               "delta_gap": d_gap,
               "loss1_gap": loss_gap(prog[0][:1], ref[0][:1]),
               "grad1_median_gap": median_gap(prog[1], ref[1], leaves),
               "delta_median_gap": median_gap(dp, dr, leaves)}
    for k in alone:
        numbers[f"{k}_grad1_gap"] = leaf_gap(prog[1], ref[1], [k])[0]
        numbers[f"{k}_delta_gap"] = leaf_gap(dp, dr, [k])[0]
        if len(prog) > 4:
            numbers[f"{k}_delta1_gap"] = leaf_gap(
                deltas(prog[4], prog[2]), deltas(ref[4], ref[2]), [k])[0]
    log = {"losses program": prog[0], "losses reference": ref[0],
           "worst leaf (grad1, delta)": (g_at, d_at),
           "leaves counted": f"{len(leaves)} of {len(ref[1])}"}
    return numbers, log


def split(numbers: Dict[str, float], compared) -> Tuple[Dict[str, float],
                                                        Dict[str, float]]:
    """(the numbers a cell compares, the rest, which it only logs)."""
    return ({k: numbers[k] for k in compared},
            {k: v for k, v in numbers.items() if k not in compared})
