"""The flow trainer's step and CV functions, in PyTorch.

Counterpart of the flow branch of ``cosyvoice2_eu_tpu/train/train.py``
(lines 270-285): the step wrapper that ``Executor.train_epoch`` calls, which
draws the step's randomness and tosses the unified-training streaming coin,
and the CV loss with fixed draws.  The command line, the parquet batches and
the logger sinks come with the dataset.
"""

from __future__ import annotations

import numpy as np
import torch

from cosyvoice2_eu_torch.config import FlowConfig
from cosyvoice2_eu_torch.parallel.train_step import flow_loss_fn, make_flow_draws


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
