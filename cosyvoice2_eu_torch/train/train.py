"""The trainer's step and CV functions, in PyTorch.

Counterpart of the model branches of ``cosyvoice2_eu_tpu/train/train.py``:
the speech LM's (lines 211-262: plain, DPO against a frozen copy, or LoRA
adapters over a frozen base) and the flow's (270-285: the step wrapper
that draws the step's randomness and tosses the unified-training streaming
coin, and the CV loss with fixed draws), each a step function that
``Executor.train_epoch`` calls and a CV function.  The command line, the
parquet batches (``lm_batches``) and the logger sinks come with the
dataset.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cosyvoice2_eu_torch.config import FlowConfig, LMConfig, TrainConfig
from cosyvoice2_eu_torch.parallel.train_step import (
    flow_loss_fn,
    lm_loss_fn,
    make_flow_draws,
    make_lm_train_step,
)
from cosyvoice2_eu_torch.train.optim import Optimizer
from cosyvoice2_eu_torch.utils.profiling import StageTimer


def make_lm_step_fn(cfg: LMConfig, train_cfg: TrainConfig, tx: Optimizer, params: dict, *,
                    dpo: bool = False, dpo_beta: float = 0.01, lora: bool = False,
                    lora_rank: int = 8, lora_alpha: float = 16.0,
                    gen: Optional[torch.Generator] = None,
                    timer: Optional[StageTimer] = None):
    """The LM branch: (trained params, step_fn(state, batch), cv_fn(params,
    batch) -> metrics).

    Plain: the LM step and its loss.  ``dpo``: against ``params`` as the
    frozen reference (the batches carry the rejected rows).  ``lora``: the
    trained params are adapters of rank ``lora_rank`` drawn from ``gen``
    over ``params`` as the frozen base; the CV loss runs on the adapted
    weights.
    """
    if dpo:
        from cosyvoice2_eu_torch.train.dpo import dpo_loss_fn, make_dpo_train_step

        step_fn = make_dpo_train_step(cfg, train_cfg, tx, params, beta=dpo_beta, timer=timer)
        # the optimizer never writes a tensor in place, so ``params`` stays the reference
        return params, step_fn, lambda p, b: dpo_loss_fn(p, params, cfg, b, dpo_beta)[1]
    if lora:
        from cosyvoice2_eu_torch.train.lora import apply_lora, init_lora, make_lora_lm_train_step

        adapters = init_lora(gen, params, rank=lora_rank)
        step_fn = make_lora_lm_train_step(cfg, train_cfg, tx, params, alpha=lora_alpha,
                                          timer=timer)
        return adapters, step_fn, lambda lo, b: lm_loss_fn(apply_lora(params, lo, lora_alpha),
                                                          cfg, b, train_cfg)[1]
    return (params, make_lm_train_step(cfg, train_cfg, tx, timer),
            lambda p, b: lm_loss_fn(p, cfg, b, train_cfg)[1])


def make_flow_step_fn(raw_step, cfg: FlowConfig, gen: torch.Generator,
                      rng: np.random.Generator):
    """step_fn(state, batch) -> (state, metrics) for ``Executor``.

    Each call takes its draws from ``gen`` (the step generator, on the
    training device) and streaming with probability 0.5 from ``rng``
    (unified training, reference flow.py:201), then calls
    ``raw_step(state, batch, draws, streaming=...)``.
    """

    def step_fn(state, batch):
        draws = make_flow_draws(gen, batch, cfg.output_size)
        streaming = bool(rng.random() < 0.5)
        return raw_step(state, batch, draws, streaming=streaming)

    return step_fn


def make_flow_cv_fn(cfg: FlowConfig):
    """cv_fn(params, batch) -> {"loss"}: non-streaming, with the draws of a
    generator seeded 0 afresh on every call (the JAX package uses
    ``jax.random.key(0)``), so a batch always gets the same loss."""

    def cv_fn(params, batch):
        dev = batch["speech_feat"].device
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        draws = make_flow_draws(gen, batch, cfg.output_size)
        return flow_loss_fn(params, cfg, batch, draws, False)[1]

    return cv_fn
