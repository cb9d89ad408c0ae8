"""The numbers that a training cell's output check compares.

Per leaf of the parameter tree, a norm of the program's and the same norm
of the reference's; the gap of the two norms (not the norm of their
difference), over the reference's norm of that leaf or of the median leaf,
whichever is larger (some leaves' gradients are all but zero); the worst
leaf (or, for the update, the median leaf) is the number.  ``keep`` leaves out leaves by a rule on the
reference (say, a gradient below a thousandth of the median leaf's).
"""

from __future__ import annotations

import torch

from harness.core import Check


def leaf_norms(leaves: list) -> torch.Tensor:
    """The L2 norm of every leaf, as one fp64 tensor on the host."""
    return torch.stack(torch._foreach_norm([x.detach().double() for x in leaves])).cpu()


def norm_gaps(program: torch.Tensor, reference: torch.Tensor, keep=None) -> torch.Tensor:
    """Each kept leaf's gap of norms over the larger of its reference norm
    and the median leaf's."""
    program, reference = program.double(), reference.double()
    if keep is not None:
        program, reference = program[keep], reference[keep]
    floor = torch.maximum(reference, reference.median())
    return (program - reference).abs() / floor.clamp_min(1e-30)


def worst_norm_gap(program: torch.Tensor, reference: torch.Tensor, keep=None) -> float:
    gaps = norm_gaps(program, reference, keep)
    return float(gaps.max()) if gaps.numel() else 0.0


def rel_gap(program: float, reference: float) -> float:
    return abs(program - reference) / max(abs(reference), 1e-30)


def _cycle_numbers(prog: dict, ref: dict) -> dict:
    moved = ref["mean_grad"] >= 1e-3 * ref["mean_grad"].median()
    return {"loss_rel": max(rel_gap(a, b) for a, b in zip(prog["losses"], ref["losses"])),
            "grad_norm_gap": worst_norm_gap(prog["grad1"], ref["grad1"]),
            "update_norm_gap": float(norm_gaps(prog["delta"], ref["delta"], moved).median()),
            "update_norm_gap_worst": worst_norm_gap(prog["delta"], ref["delta"], moved)}


def cycle_numbers(prog: list, ref: list) -> list:
    """Each cycle's numbers (``training_checks``'s, and the worst leaf's
    update gap), from the program's and the reference's readings of the
    same cycles."""
    return [_cycle_numbers(p, r) for p, r in zip(prog, ref)]


def training_checks(prog: list, ref: list, limits: dict) -> list:
    """A training cell's three numbers, each the worst over the cycles read
    (``harness/training.py``: the first, from the seed's weights, and the
    window's last): the worst relative gap of a cycle's losses, the worst
    leaf's gap of first-gradient norms, and the median leaf's gap of the
    norms of the change at the cycle's update, over the leaves whose
    reference gradient (the cycle's mean) is at least a thousandth of the
    median leaf's.  The change is the median leaf's, not the worst's: Adam
    divides each element by its own gradient's size, so elements whose
    gradient is near its epsilon move by round-off, and the worst leaf
    swings from seed to seed (``update_norm_gap_worst`` in the notes)."""
    nums = cycle_numbers(prog, ref)
    return [Check(k, max(n[k] for n in nums), limits[k])
            for k in ("loss_rel", "grad_norm_gap", "update_norm_gap")]


def reference_readings(losses: list, grads: list, params, new) -> dict:
    """The reference's readings in ``training_checks``'s terms, from its
    losses, gradient trees (one a step), weights and updated weights."""
    from reference.layers import tree_leaves

    mean = [torch.stack(gs).mean(0) for gs in zip(*(tree_leaves(g) for g in grads))]
    return {"losses": losses, "grad1": leaf_norms(tree_leaves(grads[0])),
            "delta": leaf_norms(torch._foreach_sub(tree_leaves(new), tree_leaves(params))),
            "mean_grad": leaf_norms(mean)}
