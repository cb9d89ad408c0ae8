"""Speech-token language model (Qwen2 backbone + speech head) in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/models/llm.py``.  The prompt
``[sos, text..., task_id, prompt_speech...]`` is a right-padded (ids, src)
pair, where ``src`` selects the embedding table.  The JAX ``lax.while_loop``
becomes a Python loop that checks on the host once per token whether every
row has finished (one device sync per token).

``lm_decode`` is ``lm_prefill`` followed by ``lm_decode_chunk`` run to
the end; streaming resumes ``lm_decode_chunk`` hop by hop on one state.

Random draws: the decode takes a ``draws(step)`` callable that returns the
step's Gumbel vectors ``(gumbel_nuc (B, top_k), gumbel_full (B, V))``;
``generator_draws`` makes one from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from cosyvoice2_eu_torch.config import LMConfig
from cosyvoice2_eu_torch.models.qwen2 import (
    KVCache,
    init_qwen2,
    qwen2_decode_step,
    qwen2_forward,
    qwen2_prefill,
)
from cosyvoice2_eu_torch.ops.sampling import gumbel, ras_sample
from cosyvoice2_eu_torch.utils.params import dense, embedding, init_dense, init_embedding

SRC_SPECIAL = 0  # llm_embedding table (sos_eos / task_id)
SRC_TEXT = 1  # backbone embed_tokens
SRC_SPEECH = 2  # speech_embedding

Draws = Callable[[int], "tuple[torch.Tensor, torch.Tensor]"]


def init_lm(gen: torch.Generator, cfg: LMConfig) -> dict:
    h = cfg.backbone.hidden_size
    return {
        "backbone": init_qwen2(gen, cfg.backbone),
        "llm_embedding": init_embedding(gen, 2, h),
        "speech_embedding": init_embedding(gen, cfg.full_vocab, h),
        "llm_decoder": init_dense(gen, h, cfg.full_vocab, bias=True),
    }


def embed_mixed(params, ids: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """(B, T) ids + table selector -> (B, T, H) embeddings."""
    safe = ids.clamp_min(0)
    e_special = embedding(params["llm_embedding"], safe.clamp(0, 1))
    e_text = embedding(params["backbone"]["embed_tokens"], safe)
    n_speech = params["speech_embedding"]["weight"].shape[0]
    e_speech = embedding(params["speech_embedding"], safe.clamp(0, n_speech - 1))
    sel = src[..., None]
    return torch.where(sel == SRC_TEXT, e_text, torch.where(sel == SRC_SPEECH, e_speech, e_special))


@dataclasses.dataclass
class DecodeState:
    kv: KVCache
    tokens: torch.Tensor  # (B, max_gen) generated ids (eos excluded)
    recent: torch.Tensor  # (B, win_size) rolling window for RAS
    lengths: torch.Tensor  # (B,) number of emitted tokens
    finished: torch.Tensor  # (B,) bool
    last_hidden: torch.Tensor  # (B, H) hidden of last consumed position
    step: int


def lm_prefill(params, cfg: LMConfig, ids, src, prompt_len, max_gen: int) -> DecodeState:
    """Run the prompt through the backbone and initialize decode state."""
    b, p_bucket = ids.shape
    dev = ids.device
    embeds = embed_mixed(params, ids, src)
    kv = KVCache.zeros(cfg.backbone, b, p_bucket + max_gen, device=dev)
    last, kv = qwen2_prefill(params["backbone"], cfg.backbone, embeds, prompt_len, kv)
    return DecodeState(
        kv=kv,
        tokens=torch.zeros((b, max_gen), dtype=torch.long, device=dev),
        recent=torch.full((b, cfg.win_size), -1, dtype=torch.long, device=dev),
        lengths=torch.zeros((b,), dtype=torch.long, device=dev),
        finished=torch.zeros((b,), dtype=torch.bool, device=dev),
        last_hidden=last,
        step=0,
    )


def _sample_tokens(params, cfg: LMConfig, state: DecodeState, min_len, gumbel_nuc, gumbel_full):
    """Sample one token per batch element from state.last_hidden."""
    logits = dense(params["llm_decoder"], state.last_hidden).float()
    logp = torch.log_softmax(logits, dim=-1)
    ignore_eos = (state.lengths < min_len) | (state.step == 0)
    return ras_sample(
        logp, state.recent, ignore_eos, cfg.eos_token, gumbel_nuc, gumbel_full,
        top_p=cfg.top_p, top_k=cfg.top_k, win_size=cfg.win_size, tau_r=cfg.tau_r,
    )


def generator_draws(generator: torch.Generator, batch: int, cfg: LMConfig) -> Draws:
    """``draws(step)`` from ``generator``, consumed in step order."""
    return lambda step: (gumbel((batch, cfg.top_k), generator),
                         gumbel((batch, cfg.full_vocab), generator))


def lm_decode_chunk(params, cfg: LMConfig, state: DecodeState, prompt_len, min_len, max_len,
                    target_step: int, draws: Draws) -> DecodeState:
    """Resumable decode: run steps until ``state.step == min(target_step,
    max_gen)`` or every row has finished (one host check per step).

    ``draws(step)`` is indexed by the absolute step, so a decode split into
    chunks consumes the same draws as one that runs to the end.  The
    state's tensors are replaced, not written in place (the KV cache is).
    """
    b, max_gen = state.tokens.shape
    p_bucket = state.kv.k.shape[3] - max_gen
    vocab = cfg.full_vocab
    dev = state.tokens.device
    slot_idx = torch.arange(p_bucket + max_gen, device=dev)[None, :]
    col = torch.arange(max_gen, device=dev)[None, :]
    target = min(target_step, max_gen)

    while state.step < target and not bool(state.finished.all()):
        gumbel_nuc, gumbel_full = draws(state.step)
        tok = _sample_tokens(params, cfg, state, min_len, gumbel_nuc, gumbel_full)
        # EOS stops; other specials (ids > eos) are fed back but never emitted
        is_eos = tok == cfg.eos_token
        is_special = tok > cfg.eos_token
        emit = (~state.finished) & (~is_eos) & (~is_special)
        state.tokens = torch.where(emit[:, None] & (col == state.lengths[:, None]),
                                   tok[:, None], state.tokens)
        state.lengths = state.lengths + emit.long()
        state.finished = state.finished | is_eos | (state.lengths >= max_len)
        rolled = torch.cat([state.recent[:, 1:], tok[:, None]], dim=1)
        state.recent = torch.where(emit[:, None], rolled, state.recent)

        # feed the sampled token back through the backbone
        embed = embedding(params["speech_embedding"], tok.clamp(0, vocab - 1))
        cache_index = p_bucket + state.step
        rope_pos = prompt_len + state.step
        n = cache_index + 1
        visible = (slot_idx[:, :n] < prompt_len[:, None]) | (slot_idx[:, :n] >= p_bucket)
        state.last_hidden, state.kv = qwen2_decode_step(
            params["backbone"], cfg.backbone, embed, rope_pos, cache_index, visible, state.kv)
        state.step += 1
    return state


def lm_decode(
    params,
    cfg: LMConfig,
    ids: torch.Tensor,
    src: torch.Tensor,
    prompt_len: torch.Tensor,
    min_len: torch.Tensor,
    max_len: torch.Tensor,
    max_gen: int,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Draws] = None,
):
    """Full autoregressive decode: ``lm_prefill`` + ``lm_decode_chunk`` to ``max_gen``.

    Args:
      ids/src: (B, P_bucket) packed prompt (see embed_mixed).
      prompt_len, min_len, max_len: (B,) prompt lengths and decode bounds.
      max_gen: generation capacity.
      generator: source of the Gumbel draws when ``draws`` is None.
      draws: optional ``draws(step) -> (gumbel_nuc, gumbel_full)``.

    Returns (tokens (B, max_gen), lengths (B,), steps): steps counts the
    decode steps run, each of which samples once for the whole batch and
    feeds the tokens back (the JAX function returns the first two).
    """
    if draws is None:
        if generator is None:
            raise ValueError("lm_decode needs a generator or a draws source")
        draws = generator_draws(generator, ids.shape[0], cfg)
    state = lm_prefill(params, cfg, ids, src, prompt_len, max_gen)
    state = lm_decode_chunk(params, cfg, state, prompt_len, min_len, max_len, max_gen, draws)
    return state.tokens, state.lengths, state.step


def lm_training_hidden(params, cfg: LMConfig, ids, src, valid):
    """Training-time forward over packed (ids, src) sequences: logits
    (B, T, full_vocab).  valid: (B, T) bool."""
    embeds = embed_mixed(params, ids, src)
    hidden = qwen2_forward(params["backbone"], cfg.backbone, embeds, valid)
    return dense(params["llm_decoder"], hidden)
