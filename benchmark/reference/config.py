"""A configuration file's model section as namespaces, with the sizes the
port's config classes derive (HiFT's samples a mel frame, the LM's full
speech vocabulary and its end-of-speech id)."""

from __future__ import annotations

import math
from types import SimpleNamespace


def _ns(x):
    if isinstance(x, dict):
        return SimpleNamespace(**{k: _ns(v) for k, v in x.items()})
    if isinstance(x, list):
        return [_ns(v) for v in x]
    return x


def model_config(model: dict) -> SimpleNamespace:
    c = _ns(model)
    c.hift.upsample_scale = c.hift.istft_hop_len * math.prod(c.hift.upsample_rates)
    c.llm.full_vocab = c.llm.speech_token_size + 3
    c.llm.eos_token = c.llm.speech_token_size
    return c
