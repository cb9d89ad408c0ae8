"""Speech-LM training through ``train/train.py::make_lm_step_fn`` (teams
training a backbone variant), in the configuration's precision with its
``TrainConfig`` (adamw, ``accum_grad`` micro-steps to an update).

Set-up draws the text and speech sequences from the seed
(``lm_sequences``), has the port's ``train/sequences.py::build_lm_batch``
lay each dynamic batch out (unistream, or the bistream FILL layout with
``bistream_prob``), as a data loader's workers would off the step's path,
moves them to the card, makes the weights from the seed and runs the first
``accum_grad`` steps (``harness/training.py``).  The window cycles through
the batches; ``lm_train_tokens_per_s`` is the unpadded tokens of every
micro-step of the window over its wall time.  With ``--trace 1`` the step
carries a ``StageTimer`` (forward, backward, optimizer) for the whole run.

The reference (fp32, TF32 off, ``reference/train.py``) follows two
accumulation cycles on the same batches: the first, from the seed's
weights, and the window's last, from the weights and Adam moments that the
program's own state held when the cycle began (the stages between are
not followed).  For each it gives every step's loss and gradient and the
cycle's update; the check compares, each the worst over the two cycles,

* ``loss_rel``: the worst relative gap of the steps' losses;
* ``grad_norm_gap``: the worst leaf's gap of the norms of the cycle's first
  gradient;
* ``update_norm_gap``: the median leaf's gap of the norms of the change at
  the cycle's update, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (``harness/compare.py``).

``control=True`` also reads the reference computed in TF32 in the
program's place (the control), and the reference with its dense layers
summed in another order in fp32 (``reordered``: a sound program's
rounding, for the lower reading).
"""

from __future__ import annotations

import numpy as np
import torch

from harness import flops
from harness import traffic as gen_traffic
from harness import training
from harness.compare import cycle_numbers, reference_readings, training_checks
from harness.core import Outcome
from reference import train as ref_train
from reference import weights
from reference.config import model_config
from reference.layers import exact, lowered


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
    trained, step_fn, _ = make_lm_step_fn(cfg, tc, tx, weights.make(weights.lm(c.llm), seed, dev),
                                          timer=timer)
    state = init_train_state(trained, tx)
    del trained
    r = training.drive(state, lambda s, i: step_fn(s, batches[i]), len(batches),
                       lambda i: tokens[i], tc.accum_grad, Optimizer.B1, seconds, trace,
                       t_start, sync, timer)
    del state, step_fn
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = {"timer": r["stages"], "window_s": r["window_s"],
           "steps": r["steps"], "trace": r["trace"],
           "model_flops": sum(3 * flops.lm_sequence_flops(c.llm, int(n))
                              for i in r["window_batches"] for n in host[i]["lengths"]),
           "peak_flops": flops.PEAK[cell.config["precision"]["train"]]}
    if cuda:
        torch.cuda.empty_cache()

    cycles = [(None, batches[:tc.accum_grad]),
              (r["last"].pop("start"), [batches[i] for i in r["last"]["batches"]])]
    prog = [r["first"], r["last"]]
    ref = _reference(c, tc, seed, dev, cycles, None)
    checks = training_checks(prog, ref, t["limits"])
    notes = {"cycles": cycle_numbers(prog, ref), "losses": [x["losses"] for x in prog],
             "reference_losses": [x["losses"] for x in ref]}
    if control:
        for mode, key in (("tf32", "control"), ("reordered", "reordered")):
            low = _reference(c, tc, seed, dev, cycles, mode)
            notes[key] = {ch.name: ch.value for ch in training_checks(low, ref, t["limits"])}
            notes[key]["cycles"] = cycle_numbers(low, ref)
    del cycles
    failed = sum(1 for x in prog for y in x["losses"] if not np.isfinite(y))
    return Outcome({"lm_train_tokens_per_s": r["work"] / r["window_s"], "setup_s": r["setup_s"]},
                   ctx, checks, attempted=r["steps"] + tc.accum_grad, failed=failed,
                   memory_peak_bytes=peak, trace=r["trace"], notes=notes)


def _reference(c, tc, seed, dev, cycles, mode) -> list:
    """The reference's readings of each cycle (its losses, first-gradient
    norms, update norms and the norms of its mean gradient): ``cycles`` is
    [(the program's state at the cycle's start, or None for the seed's
    weights and zero moments, its batches)]."""
    out = []
    for start, batches in cycles:
        params = weights.make(weights.lm(c.llm), seed, dev) if start is None else start.params
        moments = None if start is None else training.moments(start.opt_state)
        losses, grads = [], []
        with (exact() if mode is None else lowered(mode)):
            for b in batches:
                loss, g = ref_train.loss_and_grads(lambda p: ref_train.lm_loss(p, c.llm, b),
                                                   params)
                losses.append(float(loss))
                grads.append(g)
            new = ref_train.adam_update(params, grads, tc, moments)
        out.append(reference_readings(losses, grads, params, new))
        del params, grads, new
    return out

