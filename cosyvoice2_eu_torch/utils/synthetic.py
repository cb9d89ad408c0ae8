"""Synthetic prompt inputs for warmup and measurement.

Counterpart of ``cosyvoice2_eu_tpu/utils/synthetic.py``: the same numpy
calls in the same order, so one seed gives the JAX package's arrays.  The
mel bias (-4.0) roughly centres the fake features on log-mel statistics.
"""

from __future__ import annotations

import numpy as np


def synthetic_prompt(cfg, rng: np.random.Generator, n_sp: int,
                     n_text: int = 30, n_prompt_text: int = 12):
    """Random ``PromptInputs`` at a given prompt length (``n_sp`` speech
    tokens, 25 a second: ``n_sp=150`` is a 6 s prompt).  The text ids run
    up to 50000, so the LM's text vocabulary must be at least that wide."""
    from cosyvoice2_eu_torch.runtime.model import PromptInputs

    return PromptInputs(
        text_tokens=rng.integers(100, 50000, n_text).astype(np.int32),
        prompt_text_tokens=rng.integers(100, 50000, n_prompt_text).astype(np.int32),
        llm_prompt_speech_tokens=rng.integers(
            0, cfg.llm.speech_token_size, n_sp).astype(np.int32),
        flow_prompt_speech_tokens=rng.integers(
            0, cfg.flow.vocab_size, n_sp).astype(np.int32),
        prompt_feat=(rng.standard_normal((n_sp * 2, cfg.flow.output_size)) * 0.5
                     - 4.0).astype(np.float32),
        embedding=rng.standard_normal(cfg.frontend.spk_embed_dim).astype(np.float32),
    )
