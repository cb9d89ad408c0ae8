"""Flow-decoder training through ``parallel/train_step.py::make_flow_train_step``
(teams adapting the flow), in the configuration's precision with its
``TrainConfig``: the estimator's attention runs K1 (fp32, with LSE), K3 and
K4 on the card.

Set-up draws the batches from the seed (``flow_utterances``: dynamic
batches to a cap of padded mel frames), makes the weights from the seed
and runs the first ``accum_grad`` steps (``harness/training.py``).  Each
step takes the draws of the trainer's ``make_flow_step_fn`` (prompt
conditioning, time, noise, CFG dropout), made here from a generator of the
seed, and its streaming coin (unified training: streaming with probability
0.5).  ``flow_train_frames_per_s`` is the unpadded mel frames of every
micro-step of the window over its wall time.

The reference (fp32, TF32 off, ``reference/train.py``) follows the first
accumulation cycle and the window's last, as the LM cell's does
(``drivers/lm_train.py``), with the same batches, draws and coins, in
blocks of rows (the loss is a sum over rows over one count, so the rows'
gradients add), and the check compares ``loss_rel``, ``grad_norm_gap`` and
``update_norm_gap`` as the LM cell does.
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
from reference.layers import exact, lowered, tree_map

FLOW_STREAM = 1  # the flow's weight stream, as in weights.make_tts
ROWS_X_FRAMES2 = 4.5e6  # a reference block's rows x frames^2 (its attention's memory)


def make_draws(gen: torch.Generator, batch: dict, n_mels: int) -> dict:
    """One step's draws, as the trainer's ``make_flow_draws`` shapes them."""
    b, t_mel = batch["speech_feat"].shape[:2]
    dev = gen.device
    return {"u_cond": torch.rand((b,), generator=gen, device=dev),
            "u_frac": torch.rand((b,), generator=gen, device=dev),
            "u_t": torch.rand((b, 1, 1), generator=gen, device=dev),
            "z": torch.randn((b, n_mels, t_mel), generator=gen, device=dev),
            "u_cfg": torch.rand((b,), generator=gen, device=dev)}


def run(cell, seed: int, seconds: float, trace: bool, t_start: float, device: str = "cuda",
        control: bool = False) -> Outcome:
    from cosyvoice2_eu_torch.config import TrainConfig, TTSConfig, config_from_dict
    from cosyvoice2_eu_torch.parallel.train_step import init_train_state, make_flow_train_step
    from cosyvoice2_eu_torch.train.optim import Optimizer, make_optimizer
    from cosyvoice2_eu_torch.utils.device import resolve_device
    from cosyvoice2_eu_torch.utils.profiling import StageTimer

    c = model_config(cell.config["model"])
    fcfg = config_from_dict(TTSConfig, cell.config["model"]).flow
    tc = config_from_dict(TrainConfig, cell.config["train"])
    t = cell.traffic
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    host = gen_traffic.generate(t, c, seed)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in b.items()} for b in host]
    frames = [int(b["speech_feat_len"].sum()) for b in host]

    gen = torch.Generator(device=dev)
    gen.manual_seed((seed * 1_000_003 + 11) % 2**63)
    coin = np.random.default_rng([seed % 2**64, 8])
    first, recent, last, traced = [], [], [], []
    timer = StageTimer(sync=sync) if trace else None
    tx = make_optimizer(tc)
    raw = make_flow_train_step(fcfg, tc, tx, timer)
    est = c.flow.estimator

    def step(state, i):
        d = make_draws(gen, batches[i], c.flow.output_size)
        streaming = bool(coin.random() < t["streaming_prob"])
        if len(first) < tc.accum_grad:
            first.append((i, d, streaming))
        recent.append((i, d, streaming))
        del recent[:-tc.accum_grad]
        traced.append((host[i]["speech_feat_len"].tolist(),
                       est.static_chunk_size if streaming else 0))
        return raw(state, batches[i], d, streaming=streaming)

    state = init_train_state(weights.make(weights.flow(c.flow), seed, dev, FLOW_STREAM), tx)
    r = training.drive(state, step, len(batches), lambda i: frames[i], tc.accum_grad,
                       Optimizer.B1, seconds, trace, t_start, sync, timer,
                       window_end=lambda: last.extend(recent))
    del state, raw
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = {"timer": r["stages"], "window_s": r["window_s"],
           "steps": r["steps"], "trace": r["trace"],
           "peak_flops": flops.PEAK[cell.config["precision"]["train"]]}
    if trace:
        count = flops.FlowFlops(c)
        ratio = c.flow.token_mel_ratio
        ctx["model_flops"] = sum(3 * (count.encoder(int(n) // ratio) + count.estimator(int(n)))
                                 for i in r["window_batches"] for n in host[i]["speech_feat_len"])
        ctx["attn_calls"] = traced[-tc.accum_grad:] if r["trace"] else []
        ctx["attn_blocks"] = est.n_blocks * (2 + est.num_mid_blocks)
        ctx["attn_heads"], ctx["attn_head_dim"] = est.num_heads, est.attention_head_dim
    if cuda:
        torch.cuda.empty_cache()

    cycles = [(None, first), (r["last"].pop("start"), last)]
    prog = [r["first"], r["last"]]
    ref = _reference(c, tc, seed, dev, batches, cycles, None)
    checks = training_checks(prog, ref, t["limits"])
    notes = {"cycles": cycle_numbers(prog, ref), "losses": [x["losses"] for x in prog],
             "reference_losses": [x["losses"] for x in ref],
             "streaming": [[s for _, _, s in steps] for _, steps in cycles]}
    if control:
        for mode, key in (("tf32", "control"), ("reordered", "reordered")):
            low = _reference(c, tc, seed, dev, batches, cycles, mode)
            notes[key] = {ch.name: ch.value for ch in training_checks(low, ref, t["limits"])}
            notes[key]["cycles"] = cycle_numbers(low, ref)
    del cycles
    failed = sum(1 for x in prog for y in x["losses"] if not np.isfinite(y))
    return Outcome({"flow_train_frames_per_s": r["work"] / r["window_s"], "setup_s": r["setup_s"]},
                   ctx, checks, attempted=r["steps"] + tc.accum_grad, failed=failed,
                   memory_peak_bytes=peak, trace=r["trace"], notes=notes)


def _blocks(lengths: list, t_mel: int) -> list:
    """Row ranges whose attention scores fit a reference block."""
    per = max(1, int(ROWS_X_FRAMES2 // (t_mel * t_mel)))
    return [(a, min(a + per, len(lengths))) for a in range(0, len(lengths), per)]


def _reference(c, tc, seed, dev, batches, cycles, mode) -> list:
    """The reference's readings of each cycle: ``cycles`` is [(the
    program's state at the cycle's start, or None for the seed's weights and
    zero moments, [(batch index, draws, streaming)])]."""
    out = []
    m = c.flow.output_size
    for start, steps in cycles:
        params = (weights.make(weights.flow(c.flow), seed, dev, FLOW_STREAM) if start is None
                  else start.params)
        moments = None if start is None else training.moments(start.opt_state)
        losses, grads = [], []
        with (exact() if mode is None else lowered(mode)):
            for i, d, streaming in steps:
                b = batches[i]
                lens = b["speech_feat_len"]
                total = float(lens.sum()) * m
                loss, acc = 0.0, None
                for a, e in _blocks(lens.tolist(), b["speech_feat"].shape[1]):
                    part = {k: v[a:e] for k, v in b.items()}
                    dp = {k: v[a:e] for k, v in d.items()}
                    share = float(lens[a:e].sum()) * m / total
                    lo, g = ref_train.loss_and_grads(
                        lambda p: ref_train.flow_loss(p, c.flow, part, dp, streaming) * share,
                        params)
                    loss += float(lo)
                    acc = g if acc is None else tree_map(torch.add, acc, g)
                losses.append(loss)
                grads.append(acc)
            new = ref_train.adam_update(params, grads, tc, moments)
        out.append(reference_readings(losses, grads, params, new))
        del params, grads, new
    return out
