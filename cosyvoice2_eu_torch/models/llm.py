"""Speech-token language model (Qwen2 backbone + speech head) in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/models/llm.py``.  The prompt
``[sos, text..., task_id, prompt_speech...]`` is a right-padded (ids, src)
pair, where ``src`` selects the embedding table.  The JAX ``lax.while_loop``
becomes a Python loop that checks on the host once per token whether every
row has finished (one device sync per token).

``lm_decode`` is ``lm_prefill`` followed by ``lm_decode_chunk`` run to
the end; streaming resumes ``lm_decode_chunk`` hop by hop on one state.

The serving engine's slot API (``SlotState``, ``slots_init``,
``slot_prefill``, ``prefill_row``, ``slot_insert``, ``slots_decode``) keeps
``n_slots`` independent requests in one static (n_slots, max_cache) KV
cache, each with its own prompt bucket, step, length bounds and RAS window,
decoded in lockstep: requests join and leave between calls.

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


# ---------------------------------------------------------------------------
# continuous batching (the serving engine's slot decode)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SlotState:
    """Fixed-capacity decode slots over a static (n_slots, max_cache) KV
    cache; every field but ``step`` is a device tensor with one row a slot.
    ``step`` counts the decode steps run on the state, which index the
    draws (a step that no slot can run is not taken)."""

    kv: KVCache
    tokens: torch.Tensor  # (B, max_gen) emitted ids per slot
    recent: torch.Tensor  # (B, win_size) RAS window
    lengths: torch.Tensor  # (B,) emitted counts
    finished: torch.Tensor  # (B,) bool
    active: torch.Tensor  # (B,) bool: the slot holds a request
    last_hidden: torch.Tensor  # (B, H)
    gen_step: torch.Tensor  # (B,) decode steps taken (specials included)
    base: torch.Tensor  # (B,) cache slot where generation starts (the prompt bucket)
    prompt_len: torch.Tensor  # (B,)
    min_len: torch.Tensor  # (B,)
    max_len: torch.Tensor  # (B,)
    step: int = 0


def slots_init(cfg: LMConfig, n_slots: int, max_cache: int, max_gen: int,
               dtype=torch.bfloat16, device=None) -> SlotState:
    """Empty slots; the KV cache and hidden states in ``dtype``."""
    zeros = lambda *shape, dt=torch.long: torch.zeros(shape, dtype=dt, device=device)
    return SlotState(
        kv=KVCache.zeros(cfg.backbone, n_slots, max_cache, device=device, dtype=dtype),
        tokens=zeros(n_slots, max_gen),
        recent=torch.full((n_slots, cfg.win_size), -1, dtype=torch.long, device=device),
        lengths=zeros(n_slots), finished=zeros(n_slots, dt=torch.bool),
        active=zeros(n_slots, dt=torch.bool),
        last_hidden=zeros(n_slots, cfg.backbone.hidden_size, dt=dtype),
        gen_step=zeros(n_slots), base=zeros(n_slots), prompt_len=zeros(n_slots),
        min_len=zeros(n_slots), max_len=zeros(n_slots))


def _admit(state: SlotState, slot: int, last, prompt_len: int, min_len: int, max_len: int,
           p_bucket: int) -> SlotState:
    """Reset ``slot``'s row for a request whose prompt is in its KV row."""
    state.tokens[slot] = 0
    state.recent[slot] = -1
    state.lengths[slot] = 0
    state.finished[slot] = False
    state.active[slot] = True
    state.last_hidden[slot] = last[0].to(state.last_hidden.dtype)
    state.gen_step[slot] = 0
    state.base[slot] = p_bucket
    state.prompt_len[slot] = prompt_len
    state.min_len[slot] = min_len
    state.max_len[slot] = max_len
    return state


def slot_prefill(params, cfg: LMConfig, state: SlotState, slot: int, ids, src, prompt_len: int,
                 min_len: int, max_len: int) -> SlotState:
    """Admit one request into ``slot``: prefill its (1, P_bucket) prompt
    into that KV row, in place (slots past P_bucket keep what they held)."""
    row = KVCache(state.kv.k[:, slot:slot + 1], state.kv.v[:, slot:slot + 1])
    last, _ = qwen2_prefill(params["backbone"], cfg.backbone, embed_mixed(params, ids, src),
                            torch.tensor([prompt_len], device=ids.device), row)
    return _admit(state, slot, last, prompt_len, min_len, max_len, ids.shape[1])


def prefill_row(params, cfg: LMConfig, ids, src, prompt_len: int, max_cache: int,
                dtype=torch.bfloat16):
    """The prompt prefilled into a KV row of its own: (row, last_hidden
    (1, H)).  It needs no ``SlotState``, so the engine runs it when a request
    arrives and merges the row with ``slot_insert`` when a slot frees."""
    row = KVCache.zeros(cfg.backbone, 1, max_cache, device=ids.device, dtype=dtype)
    last, row = qwen2_prefill(params["backbone"], cfg.backbone, embed_mixed(params, ids, src),
                              torch.tensor([prompt_len], device=ids.device), row)
    return row, last


def slot_insert(state: SlotState, slot: int, row: KVCache, last, prompt_len: int, min_len: int,
                max_len: int, p_bucket: int) -> SlotState:
    """Merge a ``prefill_row`` row into ``slot`` (a copy, no forward pass);
    equal to ``slot_prefill`` on an empty slot."""
    state.kv.k[:, slot] = row.k[:, 0].to(state.kv.k.dtype)
    state.kv.v[:, slot] = row.v[:, 0].to(state.kv.v.dtype)
    return _admit(state, slot, last, prompt_len, min_len, max_len, p_bucket)


def slots_decode(params, cfg: LMConfig, state: SlotState, k_steps: int,
                 draws: Draws) -> SlotState:
    """Advance every active, unfinished slot by up to ``k_steps`` steps; the
    host checks before each step whether any slot can run (the JAX loop's
    condition), so a call stops early once none can.  Every slot takes part
    in each step, running or not; ``draws(state.step)`` serves all of them.
    The state's tensors are replaced, not written in place (the KV cache is).
    """
    max_cache, max_gen = state.kv.k.shape[3], state.tokens.shape[1]
    dev = state.tokens.device
    slot_idx = torch.arange(max_cache, device=dev)[None, :]
    col = torch.arange(max_gen, device=dev)[None, :]
    vocab = cfg.full_vocab
    for _ in range(k_steps):
        run = state.active & ~state.finished
        if not bool(run.any()):
            break
        logits = dense(params["llm_decoder"], state.last_hidden).float()
        logp = torch.log_softmax(logits, dim=-1)
        ignore_eos = (state.lengths < state.min_len) | (state.gen_step == 0)
        gumbel_nuc, gumbel_full = draws(state.step)
        tok = ras_sample(logp, state.recent, ignore_eos, cfg.eos_token, gumbel_nuc, gumbel_full,
                         top_p=cfg.top_p, top_k=cfg.top_k, win_size=cfg.win_size,
                         tau_r=cfg.tau_r)
        is_eos = tok == cfg.eos_token
        is_special = tok > cfg.eos_token
        emit = run & ~is_eos & ~is_special
        state.tokens = torch.where(emit[:, None] & (col == state.lengths[:, None]),
                                   tok[:, None], state.tokens)
        state.lengths = state.lengths + emit.long()
        state.finished = state.finished | (run & (is_eos | (state.lengths >= state.max_len)))
        rolled = torch.cat([state.recent[:, 1:], tok[:, None]], dim=1)
        state.recent = torch.where(emit[:, None], rolled, state.recent)

        embed = embedding(params["speech_embedding"], tok.clamp(0, vocab - 1))
        cache_index = (state.base + state.gen_step).clamp(0, max_cache - 1)
        rope_pos = state.prompt_len + state.gen_step
        visible = (slot_idx < state.prompt_len[:, None]) | (
            (slot_idx >= state.base[:, None]) & (slot_idx <= cache_index[:, None]))
        hidden, state.kv = qwen2_decode_step(params["backbone"], cfg.backbone, embed, rope_pos,
                                             cache_index, visible, state.kv)
        state.last_hidden = torch.where(run[:, None], hidden.to(state.last_hidden.dtype),
                                        state.last_hidden)
        state.gen_step = state.gen_step + run.long()
        # a slot at the end of its cache row finishes
        state.finished = state.finished | (run & (state.base + state.gen_step >= max_cache - 1))
        state.step += 1
    return state
