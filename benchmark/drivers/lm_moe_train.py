"""Speech-LM training on a DeepSeek-V3 MoE backbone through
``train/train.py::make_lm_step_fn`` (teams adapting CosyVoice2 on a large
MoE backbone with expert parallelism), in the configuration's precision
with its ``TrainConfig`` (adamw, ``accum_grad`` micro-steps to an update).

As ``drivers/lm_train.py``, whose loop (``harness/training.py``), readings
and compared numbers it shares, with what the MoE adds:

* the weights and the routers' frozen biases come from
  ``reference/moe_lm.py``; the biases enter the backbone's tree under the
  port's ``e_score_correction_bias``, which the step keeps out of the
  trained tree;
* each step reports the experts it chose (``routes``, left on the card);
  the reference routes each token of the two followed cycles to them and
  gives each MoE layer's ``s + b``, and ``route_flips`` counts the valid
  tokens (of every MoE layer and step) whose chosen set is not a top K of
  the reference's ``s + b`` by more than the mix's ``route_margin``, a
  step whose routes do not cover its batch counting every valid token
  (notes: the count within the margin and the largest gap);
* ``model_flops`` counts what this chip computes (``harness/moe.py``), with
  the (token, slot) pairs its held experts got in the window, which every
  step reports (``held_pairs``, from the sizes its dispatch already reads);
* the notes give the held experts' share of the routed pairs
  (``held_share``) over the first cycle and the window's first and last,
  against the even spread (held / routed experts): the router drifts
  towards the held experts, since only they give it a gradient through
  their outputs;
* the timer's MoE counters over the window go in ``ctx["counters"]`` and
  the notes.

The reference keeps a running sum of a cycle's gradients (not the list),
which its update takes as the one mean gradient.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

# a port without the backbone fails here, before anything is built
from cosyvoice2_eu_torch.models import deepseek_v3

from harness import moe
from harness import traffic as gen_traffic
from harness import training
from harness.compare import cycle_numbers, leaf_norms, training_checks
from harness.core import Check, Outcome
from harness.flops import PEAK
from reference import moe_lm
from reference import train as ref_train
from reference.config import model_config
from reference.layers import exact, lowered, tree_leaves
from reference.masks import make_non_pad_mask


def run(cell, seed: int, seconds: float, trace: bool, t_start: float, device: str = "cuda",
        control: bool = False) -> Outcome:
    from cosyvoice2_eu_torch.config import TrainConfig, TTSConfig, config_from_dict
    from cosyvoice2_eu_torch.parallel.train_step import init_train_state
    from cosyvoice2_eu_torch.train.optim import Optimizer, make_optimizer
    from cosyvoice2_eu_torch.train.sequences import build_lm_batch
    from cosyvoice2_eu_torch.train.train import make_lm_step_fn
    from cosyvoice2_eu_torch.utils.device import resolve_device
    from cosyvoice2_eu_torch.utils.profiling import StageTimer

    c = model_config(cell.config["model"])
    cfg = config_from_dict(TTSConfig, cell.config["model"]).llm
    tc = config_from_dict(TrainConfig, cell.config["train"])
    t = cell.traffic
    dev = resolve_device(device)  # the port's precision policy: TF32 off
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    layout = np.random.default_rng([seed % 2**64, 7])
    host = [build_lm_batch(texts, speeches, cfg, layout, bistream_prob=t["bistream_prob"])
            for texts, speeches in gen_traffic.generate(t, c, seed)]
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in b.items()} for b in host]
    tokens = [int(b["lengths"].sum()) for b in host]

    timer = StageTimer(sync=sync) if trace else None
    tx = make_optimizer(tc)
    trained = moe_lm.make(c.llm, seed, dev)
    biases = moe_lm.router_biases(c.llm, seed, dev)
    params = dict(trained, backbone=dict(trained["backbone"], **{deepseek_v3.FROZEN: biases}))
    trained, step_fn, _ = make_lm_step_fn(cfg, tc, tx, params, timer=timer)
    start = [init_train_state(trained, tx)]  # handed on, never held here (``_first_cycle``)
    del params, trained, biases

    first_routes, recent, seen = [], collections.deque(maxlen=tc.accum_grad), {}
    held = []  # (batch, held pairs) of every step, host ints

    def step(s, i):
        s, m = step_fn(s, batches[i])
        if len(first_routes) < tc.accum_grad:
            first_routes.append(m["routes"])
        recent.append(m["routes"])
        held.append((i, m["held_pairs"]))
        return s, m

    def window_end():
        seen["routes"] = list(recent)
        seen["counters"] = timer.counters() if timer is not None else {}
        seen["steps"] = len(held)

    first = _first_cycle(start, step, tc.accum_grad, lambda: moe_lm.make(c.llm, seed, dev))
    # its first cycle, from the state the first one left, is one more cycle of set-up
    r = training.drive(start.pop(), step, len(batches), lambda i: tokens[i], tc.accum_grad,
                       Optimizer.B1, seconds, trace, t_start, sync, timer, window_end)
    del step_fn
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    counters = seen["counters"]
    lengths = [int(n) for i in r["window_batches"] for n in host[i]["lengths"]]
    window = held[seen["steps"] - r["steps"]:seen["steps"]]
    assert [i for i, _ in window] == r["window_batches"]
    ctx = {"timer": r["stages"], "window_s": r["window_s"], "steps": r["steps"],
           "trace": r["trace"], "counters": counters,
           "model_flops": 3 * moe.forward_flops(
               c.llm, (k for n in lengths for k in range(1, n + 1)),
               sum(n for _, n in window)),
           "peak_flops": PEAK[cell.config["precision"]["train"]]}
    b = c.llm.backbone
    routed = lambda i: tokens[i] * (b.num_layers - b.first_k_dense_replace) * b.num_experts_per_tok  # noqa: E731
    share = lambda part: sum(n for _, n in part) / sum(routed(i) for i, _ in part)  # noqa: E731
    held_share = {"first_cycle": share(held[:tc.accum_grad]),
                  "window_first_cycle": share(window[:tc.accum_grad]),
                  "window_last_cycle": share(window[-tc.accum_grad:]),
                  "even": b.held_experts / b.n_routed_experts,
                  "window_pairs": sum(n for _, n in window)}
    del held
    if cuda:
        torch.cuda.empty_cache()

    cycles = [(None, batches[:tc.accum_grad], first_routes),
              (r["last"].pop("start"), [batches[i] for i in r["last"]["batches"]],
               seen["routes"])]
    prog = [first, r["last"]]
    ref, routing = _reference(c, tc, seed, dev, cycles, None, t["route_margin"])
    checks = training_checks(prog, ref, t["limits"])
    checks.append(Check("route_flips", routing["route_flips"], t["limits"]["route_flips"]))
    notes = {"cycles": cycle_numbers(prog, ref), "losses": [x["losses"] for x in prog],
             "reference_losses": [x["losses"] for x in ref], "routing": routing,
             "held_share": held_share, "counters": counters}
    if control:
        for mode, key in (("tf32", "control"), ("reordered", "reordered")):
            low, low_routing = _reference(c, tc, seed, dev, cycles, mode, t["route_margin"])
            notes[key] = {ch.name: ch.value for ch in training_checks(low, ref, t["limits"])}
            notes[key].update(low_routing, cycles=cycle_numbers(low, ref))
    del cycles
    failed = sum(1 for x in prog for y in x["losses"] if not np.isfinite(y))
    return Outcome({"lm_train_tokens_per_s": r["work"] / r["window_s"], "setup_s": r["setup_s"]},
                   ctx, checks, attempted=r["steps"] + tc.accum_grad, failed=failed,
                   memory_peak_bytes=peak, trace=r["trace"], notes=notes)


def _first_cycle(start: list, step, accum: int, seed_params) -> dict:
    """The first accumulation cycle, from the seed's weights and zero
    moments, with ``training.drive``'s readings of it.  ``start``: a list
    that holds the state alone, which the state after the cycle replaces,
    so that no caller holds a state that the step has left behind (the
    model's trees, several times over).  ``drive`` holds the state that a
    cycle starts from, which for the first is the seed's trees beside the
    optimizer's first copy of them: four trees of the model's size more at
    the first update than the card holds.  This loop holds none of it; the
    change is read against the seed's weights drawn again
    (``seed_params()``).  ``accum`` > 1: the first gradient is the
    optimizer's accumulator after the first step."""
    state, losses = start.pop(), []
    for k in range(accum):
        state, m = step(state, k)
        losses.append(m["loss"])
        if k == 0:
            grad1 = training.first_gradient(state.opt_state, 0.0, None)
    delta = torch._foreach_sub(tree_leaves(state.params), tree_leaves(seed_params()))
    start.append(state)
    return {"losses": [float(x) for x in losses], "grad1": leaf_norms(grad1),
            "delta": leaf_norms(delta), "batches": list(range(accum))}


def _reference(c, tc, seed, dev, cycles, mode, margin: float) -> tuple:
    """The reference's readings of each cycle (its losses, first-gradient
    norms, update norms and the norms of its mean gradient), and the check
    of the program's routes: ``cycles`` is [(the program's state at the
    cycle's start, or None for the seed's weights and zero moments, its
    batches, the routes the program chose for each)]."""
    biases = moe_lm.router_biases(c.llm, seed, dev)
    n_moe = c.llm.backbone.num_layers - c.llm.backbone.first_k_dense_replace
    out, gaps, unreported = [], [], 0
    for start, batches, routes in cycles:
        params = moe_lm.make(c.llm, seed, dev) if start is None else start.params
        moments = None if start is None else training.moments(start.opt_state)
        losses, grad1, total = [], None, None
        with (exact() if mode is None else lowered(mode)):
            for b, rt in zip(batches, routes):
                valid = make_non_pad_mask(b["lengths"], b["ids"].shape[1])
                use = rt if tuple(rt.shape[1:3]) == tuple(valid.shape) else None
                choices: list = []
                loss, g = ref_train.loss_and_grads(
                    lambda p: moe_lm.lm_loss(p, biases, c.llm, b, use, choices), params)
                if use is None:
                    unreported += n_moe * int(valid.sum())
                else:
                    gaps += [moe.route_gaps(ch, use[k], valid) for k, ch in enumerate(choices)]
                losses.append(float(loss))
                g = tree_leaves(g)
                if grad1 is None:
                    grad1 = leaf_norms(g)
                total = g if total is None else torch._foreach_add(total, g)
                del g
            torch._foreach_div_(total, len(batches))
            new = ref_train.adam_update(params, [total], tc, moments)
        out.append({"losses": losses, "grad1": grad1, "mean_grad": leaf_norms(total),
                    "delta": leaf_norms(torch._foreach_sub(tree_leaves(new),
                                                           tree_leaves(params)))})
        del params, total, new
    g = torch.cat(gaps) if gaps else torch.zeros(0)
    routing = {"route_flips": int((g > margin).sum()) + unreported,
               "route_near_ties": int(((g > 0) & (g <= margin)).sum()),
               "route_gap_max": float(g.max()) if g.numel() else 0.0,
               "route_unreported": unreported}
    return out, routing
