"""The measured loop of a training cell, shared by the training drivers.

Set-up builds one training state and drives it through its first
``accum`` steps with the window's own call, on batches that all differ:
those are the steps the reference follows.  It keeps, from the program's
own state, the norm of each leaf of the first gradient as the optimizer
got it (its accumulator after step 1, or Adam's first moment over 1 - b1
when every step emits) and of each leaf's change over the first emitting
step (the first ``accum`` steps), and each step's loss.

Set-up then runs every other batch once (every shape of the window met),
to a whole accumulation cycle.  The window cycles on through the batches,
one step a batch, and ends on a whole number of accumulation cycles once
``seconds`` have passed, so
that every window holds emitting steps in the same share.  Of the window's
last cycle it keeps the same readings, and the state the cycle started
from: the step does not modify its arguments, so holding the references
costs no copy and no sync.  With ``trace`` one more cycle runs after the
window under the profiler.
"""

from __future__ import annotations

import time

import torch

from harness import trace as tracing
from harness.compare import leaf_norms
from reference.layers import tree_leaves as _leaves


def first_gradient(opt_state: dict, b1: float, before: dict) -> list:
    """The gradient of a cycle's first step as the optimizer got it, from
    its state after that step (and ``before`` it)."""
    if "acc_grads" in opt_state:
        return _leaves(opt_state["acc_grads"])
    return [(m - b1 * m0) / (1.0 - b1)
            for m, m0 in zip(_leaves(opt_state["mu"]), _leaves(before["mu"]))]


def moments(opt_state: dict) -> tuple:
    """(mu leaves, nu leaves, count): the Adam state that an update of the
    reference (``reference/train.py::adam_update``) starts from."""
    return _leaves(opt_state["mu"]), _leaves(opt_state["nu"]), int(opt_state["count"])


def _cycle(state, step, batches, b1: float) -> tuple:
    """Run one accumulation cycle from ``state`` over ``batches``: (the new
    state, the cycle's readings as device tensors and references)."""
    start, losses, grad1 = state, [], None
    for k, i in enumerate(batches):
        state, m = step(state, i)
        losses.append(m["loss"])
        if k == 0:
            grad1 = first_gradient(state.opt_state, b1, start.opt_state)
    return state, {"start": start, "losses": losses, "grad1": grad1, "batches": list(batches)}


def _readings(cyc: dict, end) -> dict:
    """A cycle's readings on the host: each step's loss, the norm of each
    leaf of its first gradient and of each leaf's change over the cycle."""
    return {"losses": [float(x) for x in cyc["losses"]], "grad1": leaf_norms(cyc["grad1"]),
            "delta": leaf_norms(torch._foreach_sub(_leaves(end.params),
                                                   _leaves(cyc["start"].params))),
            "batches": cyc["batches"]}


def drive(state, step, n_batches: int, units, accum: int, b1: float, seconds: float,
          trace: bool, t_start: float, sync, timer=None, window_end=None) -> dict:
    """``step(state, i) -> (state, metrics)`` runs batch ``i``; ``units(i)``
    is its work (tokens or frames); ``timer``, the step's ``StageTimer`` if
    it has one, is read over the window alone; ``window_end()``, if given,
    is called once the window has closed, before any step after it.  Returns the readings of the
    run: ``first`` and ``last`` are the readings of the first cycle and of
    the window's last (``last["start"]``: the state it started from)."""
    state, cyc = _cycle(state, step, range(accum), b1)
    first_cycle = _readings(cyc, state)
    del cyc
    i = accum
    while i < n_batches or i % accum:  # every batch's shapes once, whole cycles
        state, _ = step(state, i % n_batches)
        i += 1
    sync()

    if timer is not None:
        timer.reset()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    steps, work, first = 0, 0, i
    while time.perf_counter() - t0 < seconds:
        cyc = None  # the cycle before is not held through this one
        batches = [(i + k) % n_batches for k in range(accum)]
        state, cyc = _cycle(state, step, batches, b1)
        work += sum(units(j) for j in batches)
        steps, i = steps + accum, i + accum
    sync()
    window_s = time.perf_counter() - t0
    stages = timer.summary() if timer is not None else {}
    last = dict(_readings(cyc, state), start=cyc["start"])
    del cyc
    if window_end is not None:
        window_end()
    tr = None
    if trace:
        with tracing.DeviceTrace() as traced:
            for _ in range(accum):
                state, _ = step(state, i % n_batches)
                i += 1
        tr = traced.summary
    return {"setup_s": setup_s, "window_s": window_s, "steps": steps, "work": work,
            "stages": stages, "first": first_cycle, "last": last, "trace": tr,
            "window_batches": [(first + k) % n_batches for k in range(steps)]}
