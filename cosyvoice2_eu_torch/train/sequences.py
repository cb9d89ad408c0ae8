"""LM training sequences, built on the host in numpy.

Counterpart of ``cosyvoice2_eu_tpu/train/sequences.py`` (reference:
Qwen2LM.prepare_lm_input_target, cosy_repo/cosyvoice/llm/llm.py:437-477):
each example becomes a packed (ids, src, target) triple, where src selects
the embedding table (``models/llm.py``'s ``SRC_*``).  Unistream lays out
``[sos, text..., task, speech...]`` with targets ``[IGNORE..., speech...,
eos]``; bistream interleaves ``mix_ratio`` text and speech chunks with the
FILL token, the layout the bistream decode serves.  Where the JAX package
asserts, the port raises ValueError.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from cosyvoice2_eu_torch.config import LMConfig
from cosyvoice2_eu_torch.models.llm import SRC_SPECIAL, SRC_SPEECH, SRC_TEXT
from cosyvoice2_eu_torch.train.losses import IGNORE_ID


def build_unistream(text: np.ndarray, speech: np.ndarray, cfg: LMConfig):
    nt, ns = len(text), len(speech)
    ids = np.concatenate([[cfg.sos_eos], text, [cfg.task_id], speech]).astype(np.int32)
    src = np.concatenate(
        [[SRC_SPECIAL], [SRC_TEXT] * nt, [SRC_SPECIAL], [SRC_SPEECH] * ns]).astype(np.int32)
    target = np.concatenate([[IGNORE_ID] * (1 + nt), speech, [cfg.eos_token]]).astype(np.int32)
    return ids, src, target


def build_bistream(text: np.ndarray, speech: np.ndarray, cfg: LMConfig):
    """The FILL-token interleave (reference llm.py:444-466): every full
    chunk of ``mix_ratio[0]`` text tokens is followed by ``mix_ratio[1]``
    speech tokens, whose targets end in FILL; the last, partial text chunk
    is followed by ``task_id`` and the rest of the speech, ending in EOS.
    Raises ValueError when the speech runs out before the text."""
    mt, ms = cfg.mix_ratio
    fill = cfg.speech_token_size + 2
    ids: List[int] = [cfg.sos_eos]
    src: List[int] = [SRC_SPECIAL]
    target: List[int] = [IGNORE_ID]
    n_chunks = int(np.ceil((len(text) + 1) / mt))
    for j in range(n_chunks):
        t_chunk = text[j * mt:(j + 1) * mt]
        s_chunk = speech[j * ms:(j + 1) * ms]
        if len(t_chunk) == mt:
            if len(s_chunk) != ms:
                raise ValueError(f"bistream needs {ms} speech tokens per {mt} text tokens: "
                                 f"{len(speech)} for {len(text)}")
            target += [IGNORE_ID] * (mt - 1) + list(s_chunk) + [fill]
            ids += list(t_chunk) + list(s_chunk)
            src += [SRC_TEXT] * mt + [SRC_SPEECH] * ms
        else:
            rest_s = speech[j * ms:]
            target += [IGNORE_ID] * len(t_chunk) + list(rest_s) + [cfg.eos_token]
            ids += list(t_chunk) + [cfg.task_id] + list(rest_s)
            src += [SRC_TEXT] * len(t_chunk) + [SRC_SPECIAL] + [SRC_SPEECH] * len(rest_s)
    return (np.asarray(ids, np.int32), np.asarray(src, np.int32),
            np.asarray(target, np.int32))


def build_lm_batch(texts: Sequence[np.ndarray], speeches: Sequence[np.ndarray], cfg: LMConfig,
                   rng: np.random.Generator, bistream_prob: float = 0.5,
                   pad_to: Optional[int] = None) -> dict:
    """Pack a batch (numpy ids, src, target (B, T) and lengths (B,)).  A row
    whose speech/text ratio exceeds ``mix_ratio[1] / mix_ratio[0]`` takes
    the bistream layout when ``rng.random() < bistream_prob`` (one draw for
    each such row, none for the others); ``pad_to`` below the longest row
    raises ValueError."""
    rows = []
    for text, speech in zip(texts, speeches):
        can_bistream = len(speech) / max(len(text), 1) > cfg.mix_ratio[1] / cfg.mix_ratio[0]
        if can_bistream and rng.random() < bistream_prob:
            rows.append(build_bistream(text, speech, cfg))
        else:
            rows.append(build_unistream(text, speech, cfg))
    max_len = max(len(r[0]) for r in rows)
    if pad_to is not None:
        if pad_to < max_len:
            raise ValueError(f"pad_to={pad_to} < longest sequence {max_len}")
        max_len = pad_to
    b = len(rows)
    ids = np.zeros((b, max_len), np.int32)
    src = np.zeros((b, max_len), np.int32)
    target = np.full((b, max_len), IGNORE_ID, np.int32)
    lengths = np.zeros((b,), np.int32)
    for i, (i_, s_, t_) in enumerate(rows):
        n = len(i_)
        ids[i, :n], src[i, :n], target[i, :n], lengths[i] = i_, s_, t_, n
    return {"ids": ids, "src": src, "target": target, "lengths": lengths}
