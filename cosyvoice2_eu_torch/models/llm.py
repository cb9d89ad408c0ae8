"""Speech-token language model (Qwen2 backbone + speech head) in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/models/llm.py``.  The prompt
``[sos, text..., task_id, prompt_speech...]`` is a right-padded (ids, src)
pair, where ``src`` selects the embedding table.  The JAX ``lax.while_loop``
becomes a Python loop that checks on the host once per token whether every
row has finished (one device sync per token).

``lm_decode`` is ``lm_prefill`` followed by ``lm_decode_chunk`` run to
the end; streaming resumes ``lm_decode_chunk`` hop by hop on one state.

The bistream protocol (``BistreamState``, ``bs_init``, ``bs_extend``,
``bs_decode``, ``lm_inference_bistream``) takes text as it arrives: one
session's cache grows at a cursor, text and speech interleave 5:15, and the
model asks for more text with the FILL token.

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

import contextlib
import dataclasses
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from cosyvoice2_eu_torch.config import DeepseekV3Config, LMConfig
from cosyvoice2_eu_torch.models.deepseek_v3 import FROZEN, deepseek_v3_forward, init_deepseek_v3
from cosyvoice2_eu_torch.models.qwen2 import (
    KVCache,
    _layer_forward,
    init_qwen2,
    local_kv_heads,
    qwen2_decode_step,
    qwen2_forward,
    qwen2_prefill,
    rope_cos_sin,
)
from cosyvoice2_eu_torch.ops.masks import NEG_INF
from cosyvoice2_eu_torch.ops.sampling import gumbel, ras_sample
from cosyvoice2_eu_torch.parallel import tp
from cosyvoice2_eu_torch.utils.params import (
    dense,
    embedding,
    init_dense,
    init_embedding,
    rms_norm,
)

SRC_SPECIAL = 0  # llm_embedding table (sos_eos / task_id)
SRC_TEXT = 1  # backbone embed_tokens
SRC_SPEECH = 2  # speech_embedding

Draws = Callable[[int], "tuple[torch.Tensor, torch.Tensor]"]


def moe_backbone(cfg: LMConfig) -> bool:
    """Whether the backbone is a deepseek_v3 MoE (``models/deepseek_v3.py``)."""
    return isinstance(cfg.backbone, DeepseekV3Config)


def split_frozen(params: dict) -> tuple:
    """(the LM's trained tree, ``thaw``): a MoE backbone's router biases
    (``FROZEN``) are read by the forward and never trained, so they leave
    the tree, and ``thaw(trained)`` puts them back.  A tree without them
    comes back as it is, with the identity."""
    bb = params["backbone"]
    if FROZEN not in bb:
        return params, lambda p: p
    frozen = {FROZEN: bb[FROZEN]}
    trained = dict(params, backbone={k: v for k, v in bb.items() if k != FROZEN})
    return trained, lambda p: dict(p, backbone=dict(p["backbone"], **frozen))


def _decodable(cfg: LMConfig) -> None:
    """Raise where the backbone has no decode path (a KV cache) in the port."""
    if moe_backbone(cfg):
        raise ValueError("a deepseek_v3 backbone trains only: its MLA latent cache (decode, "
                         "prefill, bistream, slots) is not ported")


def init_lm(gen: torch.Generator, cfg: LMConfig) -> dict:
    h = cfg.backbone.hidden_size
    init_backbone = init_deepseek_v3 if moe_backbone(cfg) else init_qwen2
    return {
        "backbone": init_backbone(gen, cfg.backbone),
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
    kv = _kv_cache(params, cfg, b, p_bucket + max_gen, dev)
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


def head_logits(params, cfg: LMConfig, hidden: torch.Tensor) -> torch.Tensor:
    """The speech head's fp32 logits over the whole vocabulary; a
    tensor-parallel slice of the head (``parallel/tp.py``) gathers every
    process's columns first, so every process samples alike."""
    head = params["llm_decoder"]
    logits = dense(head, hidden).float()
    if isinstance(head, tp.Sliced):
        logits = tp.gather_columns(logits, cfg.full_vocab, head.mesh)
    elif logits.shape[-1] != cfg.full_vocab:
        raise ValueError(f"{logits.shape[-1]} of {cfg.full_vocab} logits from a head without "
                         "its tensor-parallel group: the tree lost its tp.Sliced marks")
    return logits


def _kv_cache(params, cfg: LMConfig, batch: int, max_len: int, device, **kw) -> KVCache:
    """A cache of the backbone's local kv heads (all of them unless sliced)."""
    _decodable(cfg)
    return KVCache.zeros(cfg.backbone, batch, max_len, device=device,
                         num_kv_heads=local_kv_heads(params["backbone"], cfg.backbone), **kw)


def _sample_tokens(params, cfg: LMConfig, state: DecodeState, min_len, gumbel_nuc, gumbel_full):
    """Sample one token per batch element from state.last_hidden."""
    logits = head_logits(params, cfg, state.last_hidden)
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
    (B, T, full_vocab).  valid: (B, T) bool.  The logits alone: a MoE
    backbone's balance loss is ``lm_training_forward``'s."""
    return lm_training_forward(params, cfg, ids, src, valid)[0]


def lm_training_forward(params, cfg: LMConfig, ids, src, valid, timer=None) -> tuple:
    """``lm_training_hidden``'s logits and what the backbone adds to the
    loss: {} for Qwen, {"balance_loss", "routes", "held_pairs"} for a
    deepseek_v3 backbone (``models/deepseek_v3.py``; ``timer`` gets its MoE
    stages and counters)."""
    embeds = embed_mixed(params, ids, src)
    if moe_backbone(cfg):
        hidden, aux = deepseek_v3_forward(params["backbone"], cfg.backbone, embeds, valid, timer)
    else:
        hidden, aux = qwen2_forward(params["backbone"], cfg.backbone, embeds, valid), {}
    return dense(params["llm_decoder"], hidden), aux


# ---------------------------------------------------------------------------
# bistream decode (streaming text input, reference llm.py:721-834)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BistreamState:
    """One session's cursor cache: slots [0, cache_len) are valid and
    contiguous (prompt segments and generated tokens interleave freely).
    The counters are host ints; ``step`` counts the request's decode steps,
    forced fills and special tokens included, and indexes its draws."""

    kv: KVCache
    cache_len: int
    last_hidden: torch.Tensor  # (1, H) hidden of the last consumed position
    recent: torch.Tensor  # (win_size,) RAS window over emitted tokens
    n_out: int  # emitted speech tokens
    step: int = 0


def _device(params) -> torch.device:
    return params["speech_embedding"]["weight"].device


def bs_init(params, cfg: LMConfig, max_cache: int) -> BistreamState:
    dev = _device(params)
    return BistreamState(
        kv=_kv_cache(params, cfg, 1, max_cache, dev),
        cache_len=0,
        last_hidden=torch.zeros((1, cfg.backbone.hidden_size), device=dev),
        recent=torch.full((cfg.win_size,), -1, dtype=torch.long, device=dev),
        n_out=0,
    )


def bs_extend(params, cfg: LMConfig, state: BistreamState, ids, src,
              seg_len: int) -> BistreamState:
    """Append a right-padded (1, S) segment at the cache cursor; last_hidden
    becomes the hidden state at ``seg_len - 1``.

    Query i sits at RoPE position ``cache_len + i`` and sees the slots
    ``< cache_len + i + 1``.  The segment's K/V go to the slots from
    ``cache_len`` on as far as the cache reaches: the pad rows past its end
    are dropped (a pad slot stays invisible until a later write), and the
    ``seg_len`` valid rows always land at the cursor.  The JAX package
    writes the whole padded segment with ``dynamic_update_slice``, whose
    start XLA clamps so that the segment fits: past ``max_cache - S`` it
    lands early, over valid slots, and its queries see their own segment's
    later tokens.  Raises ValueError when the valid rows do not fit.
    """
    _decodable(cfg)
    bb = cfg.backbone
    s = ids.shape[1]
    max_cache = state.kv.k.shape[3]
    start = state.cache_len
    if start + seg_len > max_cache:
        raise ValueError(f"a segment of {seg_len} tokens at cache position {start} does not "
                         f"fit a cache of {max_cache} slots")
    n = min(start + s, max_cache)  # slots the segment's queries can see
    pos = start + torch.arange(s, device=ids.device)
    visible = torch.arange(n, device=ids.device)[None, :] < (pos[:, None] + 1)
    bias = torch.where(visible, 0.0, NEG_INF)[None, None]  # (1, 1, S, n)
    cos, sin = rope_cos_sin(pos, bb)
    x = embed_mixed(params, ids, src)
    for i, lp in enumerate(params["backbone"]["layers"]):
        x = _layer_forward(lp, bb, x, cos, sin, bias, kv=state.kv, layer_idx=i,
                           write_at=start, attn_len=n)
    x = rms_norm(params["backbone"]["norm"], x, bb.rms_norm_eps)
    state.last_hidden = x[:, seg_len - 1]
    state.cache_len = start + seg_len
    return state


def bs_decode(params, cfg: LMConfig, state: BistreamState, next_fill_index: int,
              allow_eos: bool, max_emit: int, draws: Draws):
    """Decode until a FILL token (stop 1), EOS when ``allow_eos`` (stop 2),
    or ``max_emit`` emitted tokens or the cache's last slot (stop 0).

    Forced fills fire when ``n_out == next_fill_index`` (>= 0) and move it
    by ``mix_ratio[1] + 1``; a sampled FILL sets it to ``n_out +
    mix_ratio[1] + 1``.  Without ``allow_eos`` only the exact EOS id is
    banned (FILL stays samplable).  Every special id is fed back through
    the backbone but never emitted, and the RAS window moves only on
    emitted tokens.  Every step takes ``draws(state.step)`` (forced fills
    too, as JAX splits its key on every step).  One host sync a step.

    Returns (state, emitted tokens (list of int), next_fill_index, stop).
    """
    bb = cfg.backbone
    max_cache = state.kv.k.shape[3]
    fill_id = cfg.speech_token_size + 2
    dev = state.recent.device
    fill = torch.tensor([fill_id], device=dev)
    no_ban = torch.zeros((1,), dtype=torch.bool, device=dev)
    eos_ban = torch.zeros((cfg.full_vocab,), device=dev)
    eos_ban[cfg.eos_token] = float("-inf")
    out: list = []
    nfi, stop = next_fill_index, 0
    while stop == 0 and len(out) < max_emit and state.cache_len < max_cache - 1:
        logits = head_logits(params, cfg, state.last_hidden)
        logp = torch.log_softmax(logits, dim=-1)
        if not allow_eos:
            logp = logp + eos_ban
        gumbel_nuc, gumbel_full = draws(state.step)
        sampled = ras_sample(logp, state.recent[None], no_ban, cfg.full_vocab, gumbel_nuc,
                             gumbel_full, top_p=cfg.top_p, top_k=cfg.top_k,
                             win_size=cfg.win_size, tau_r=cfg.tau_r)
        forced = nfi >= 0 and state.n_out == nfi
        tok = fill_id if forced else int(sampled[0])
        if forced:
            nfi += cfg.mix_ratio[1] + 1
        elif tok == fill_id:
            nfi = state.n_out + cfg.mix_ratio[1] + 1
        emit = tok < cfg.speech_token_size
        if emit:
            out.append(tok)
            state.recent = torch.cat([state.recent[1:], sampled])

        embed = embedding(params["speech_embedding"], fill if forced else sampled)
        visible = torch.ones((1, state.cache_len + 1), dtype=torch.bool, device=dev)
        state.last_hidden, state.kv = qwen2_decode_step(
            params["backbone"], bb, embed, torch.tensor([state.cache_len], device=dev),
            state.cache_len, visible, state.kv)
        state.cache_len += 1
        state.n_out += int(emit)
        state.step += 1
        stop = 1 if tok == fill_id else 2 if tok == cfg.eos_token else 0
    return state, out, nfi, stop


def lm_inference_bistream(
    params,
    cfg: LMConfig,
    text_chunks: Iterable,
    prompt_text: np.ndarray,
    prompt_speech: np.ndarray,
    draws: Draws,
    max_cache: int = 2048,
    seg_bucket: int = 64,
    chunk_capacity: int = 64,
    timer=None,
):
    """Streaming-text decode: a generator of speech token ids (ints).

    As the reference's inference_bistream: ``sos``; the prompt text and
    the prompt speech interleaved ``mix_ratio`` (5:15) as text arrives,
    every pair a text piece unlocks coalesced into ``seg_bucket``-sized
    extends; then ``mix_ratio[0]`` more text tokens, and decoding until the
    model asks for more text with FILL; at the end, the remaining text and
    ``task_id``, and decoding to EOS or until no token comes.

    draws: ``draws(step) -> (gumbel_nuc (1, top_k), gumbel_full (1, V))``,
    indexed by the request's decode step across every ``bs_decode`` call
    (``generator_draws(gen, 1, cfg)`` draws them from a generator).
    ``timer`` (a ``StageTimer``, optional) records the stages "bs_extend"
    and "bs_decode".
    """
    stage = timer.stage if timer is not None else (lambda name: contextlib.nullcontext())
    dev = _device(params)
    mt, ms = cfg.mix_ratio

    def extend(st, pairs):  # pairs: [(id, src)], at most seg_bucket
        seg = np.zeros((2, 1, seg_bucket), np.int64)
        seg[:, 0, :len(pairs)] = np.asarray(pairs, np.int64).T
        ids, src = torch.from_numpy(seg).to(dev)
        with stage("bs_extend"):
            return bs_extend(params, cfg, st, ids, src, len(pairs))

    def extend_all(st, pairs):
        for start in range(0, len(pairs), seg_bucket):
            st = extend(st, pairs[start:start + seg_bucket])
        return st

    def decode(st, nfi, allow_eos):
        with stage("bs_decode"):
            return bs_decode(params, cfg, st, nfi, allow_eos, chunk_capacity, draws)

    state = extend(bs_init(params, cfg, max_cache), [(cfg.sos_eos, SRC_SPECIAL)])
    text_cache = [int(t) for t in prompt_text]
    speech_left = [int(t) for t in prompt_speech]
    next_fill = -1
    need_text = True  # nothing appended beyond sos yet

    for this_text in text_chunks:
        text_cache.extend(int(t) for t in this_text)
        # interleave the prompt speech with text 5:15 as far as the text goes
        pairs = []
        while speech_left and len(text_cache) >= mt:
            pairs += [(t, SRC_TEXT) for t in text_cache[:mt]] + [
                (s, SRC_SPEECH) for s in speech_left[:ms]]
            text_cache, speech_left = text_cache[mt:], speech_left[ms:]
        state = extend_all(state, pairs)
        if speech_left:
            continue  # wait for more text to finish the interleave
        if need_text:
            if len(text_cache) < mt:
                continue  # wait for more text
            state = extend(state, [(t, SRC_TEXT) for t in text_cache[:mt]])
            text_cache = text_cache[mt:]
            need_text = False
        # decode until the model asks for more text with a FILL token
        while True:
            state, out, next_fill, stop = decode(state, next_fill, False)
            yield from out
            if stop == 1:
                need_text = True
                break
            if not out:
                break

    # the remaining text and the task id, then decode to EOS
    state = extend_all(state, [(t, SRC_TEXT) for t in text_cache] + [(cfg.task_id, SRC_SPECIAL)])
    while True:
        state, out, next_fill, stop = decode(state, -1, True)
        yield from out
        if stop == 2 or not out:
            break


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
               dtype=torch.bfloat16, device=None, num_kv_heads: Optional[int] = None) -> SlotState:
    """Empty slots; the KV cache and hidden states in ``dtype``; the cache
    holds ``num_kv_heads`` heads (a tensor-parallel slice's, ``local_kv_heads``;
    the config's by default)."""
    _decodable(cfg)
    zeros = lambda *shape, dt=torch.long: torch.zeros(shape, dtype=dt, device=device)
    return SlotState(
        kv=KVCache.zeros(cfg.backbone, n_slots, max_cache, device=device, dtype=dtype,
                         num_kv_heads=num_kv_heads),
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
    row = _kv_cache(params, cfg, 1, max_cache, ids.device, dtype=dtype)
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
        logits = head_logits(params, cfg, state.last_hidden)
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
