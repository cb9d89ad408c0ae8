"""The v1 speech LM (TransformerLM), in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/models/llm_v1.py``.  Text ids go through a
causal conformer (chunk size 1) and an affine layer; the packed prefix
``[sos, spk?, text, task, prompt speech]`` runs through a 14-block
TransformerEncoder with ESPnet relative positions, which then decodes the
speech tokens one at a time over a KV cache with RAS sampling.  The JAX
``lax.while_loop`` is a host loop that checks once per token whether every
row has finished.

The cache has the JAX layout: slots [0, P_bucket) hold the padded prefix,
[P_bucket, P_bucket + max_gen) the generated tokens.  A decode step's
relative-position bias is ``(q + pos_bias_v) . (W_pos pe)`` gathered at the
distance between the query and each key, from a per-layer table of
``P_bucket + max_gen`` rows projected once per decode.  Parameter trees are
the generic encoder's, so ``convert_generic_encoder`` reads reference
checkpoints.

Random draws are inputs: ``draws(step) -> (gumbel_nuc (B, top_k),
gumbel_full (B, speech_token_size + 1))``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from cosyvoice2_eu_torch.config import GenericEncoderConfig, LMV1Config
from cosyvoice2_eu_torch.models.generic_encoder import (
    _attention_core,
    _ffn,
    apply_input_layer,
    full_pos_emb,
    generic_encoder_forward,
    init_generic_encoder,
)
from cosyvoice2_eu_torch.ops.masks import NEG_INF, chunk_attention_mask
from cosyvoice2_eu_torch.ops.sampling import gumbel, ras_sample
from cosyvoice2_eu_torch.utils.params import (
    dense,
    embedding,
    init_dense,
    init_embedding,
    layer_norm,
)

IGNORE_ID = -1

Draws = Callable[[int], "tuple[torch.Tensor, torch.Tensor]"]


def init_lm_v1(gen, cfg: LMV1Config) -> dict:
    return {
        "text_embedding": init_embedding(gen, cfg.text_token_size, cfg.text_encoder_input_size),
        "text_encoder": init_generic_encoder(gen, cfg.text_encoder),
        "text_encoder_affine_layer": init_dense(gen, cfg.text_encoder.output_size,
                                                cfg.llm_input_size),
        "llm_embedding": init_embedding(gen, 2, cfg.llm_input_size),  # sos_eos, task
        "speech_embedding": init_embedding(gen, cfg.speech_token_size, cfg.llm_input_size),
        "spk_embed_affine_layer": init_dense(gen, cfg.spk_embed_dim, cfg.llm_input_size),
        "llm": init_generic_encoder(gen, cfg.llm),
        "llm_decoder": init_dense(gen, cfg.llm_output_size, cfg.speech_token_size + 1),
    }


def encode_text(params, cfg: LMV1Config, text_token, text_len):
    """Text ids -> LM-width vectors: the causal conformer (chunk 1) + affine."""
    emb = embedding(params["text_embedding"], text_token)
    h, _ = generic_encoder_forward(params["text_encoder"], cfg.text_encoder, emb, text_len,
                                   decoding_chunk_size=1, num_decoding_left_chunks=-1)
    return dense(params["text_encoder_affine_layer"], h)


def _normalized_spk(params, emb):
    emb = emb.float()
    emb = emb / torch.linalg.norm(emb, dim=-1, keepdim=True).clamp_min(1e-12)
    return dense(params["spk_embed_affine_layer"], emb)


def _pack(sos, spk, text_h, text_len, task, speech_emb, speech_len):
    """Pack rows ``[sos, spk?, text[:t], task, speech[:s]]`` (spk None drops
    the speaker slot) -> (x (B, off + 1 + Tt + Ts, D), lengths off + 1 + t +
    s), off 2 with the speaker, 1 without."""
    b, tt, d = text_h.shape
    ts = speech_emb.shape[1]
    off = 2 if spk is not None else 1
    L = off + 1 + tt + ts
    dev = text_h.device
    j = torch.arange(L, device=dev)[None, :]
    t = text_len[:, None]
    text_idx = (j - off).clamp(0, max(tt - 1, 0)).expand(b, L)
    text_g = torch.gather(text_h, 1, text_idx[..., None].expand(b, L, d))
    sp_idx = (j - off - 1 - t).clamp(0, max(ts - 1, 0))
    sp_g = torch.gather(speech_emb, 1, sp_idx[..., None].expand(b, L, d))
    out = torch.where((j < off + t)[..., None], text_g,
                      torch.where((j == off + t)[..., None], task[None, None, :], sp_g))
    if spk is not None:
        out = torch.where((j == 1)[..., None], spk[:, None, :], out)
    out = torch.where((j == 0)[..., None], sos[None, None, :], out)
    return out, off + 1 + text_len + speech_len


def lm_v1_training_logits(params, cfg: LMV1Config, batch):
    """Training forward -> (logits (B, L, V + 1), targets (B, L)): IGNORE over
    the (2 + text_len)-long prefix, then the speech tokens, then EOS."""
    text_token, text_len = batch["text_token"], batch["text_token_len"]
    speech_token, speech_len = batch["speech_token"], batch["speech_token_len"]
    text_h = encode_text(params, cfg, text_token, text_len)
    spk = _normalized_spk(params, batch["embedding"])
    sos, task = params["llm_embedding"]["weight"][0], params["llm_embedding"]["weight"][1]
    sp_emb = embedding(params["speech_embedding"], speech_token.clamp_min(0))
    x, lens = _pack(sos, spk, text_h, text_len, task, sp_emb, speech_len)
    h, _ = generic_encoder_forward(params["llm"], cfg.llm, x, lens)
    logits = dense(params["llm_decoder"], h)

    L = x.shape[1]
    j = torch.arange(L, device=x.device)[None, :]
    t, s = text_len[:, None], speech_len[:, None]
    sp_idx = (j - 2 - t).clamp(0, max(speech_token.shape[1] - 1, 0))
    sp_t = torch.gather(speech_token, 1, sp_idx)
    ignore = torch.full_like(sp_t, IGNORE_ID)
    targets = torch.where(j < 2 + t, ignore,
                          torch.where(j - 2 - t < s, sp_t,
                                      torch.where(j - 2 - t == s,
                                                  torch.full_like(sp_t, cfg.eos_token), ignore)))
    return logits, targets


def lm_v1_loss(params, cfg: LMV1Config, batch):
    """(loss, accuracy) of the label-smoothed cross-entropy."""
    from cosyvoice2_eu_torch.train.losses import label_smoothing_ce

    logits, targets = lm_v1_training_logits(params, cfg, batch)
    return label_smoothing_ce(logits, targets, smoothing=cfg.lsm_weight,
                              normalize_length=cfg.length_normalized_loss)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _pos_table_positive(max_rel: int, d: int) -> np.ndarray:
    """Positive-distance sin/cos rows for relative distances 0 .. max_rel - 1."""
    pe = np.zeros((max_rel, d), np.float32)
    pos = np.arange(max_rel, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32) * -(math.log(10000.0) / d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def _heads(cfg_llm: GenericEncoderConfig) -> tuple[int, int]:
    return cfg_llm.attention_heads, cfg_llm.output_size // cfg_llm.attention_heads


def _prefill(params_llm, cfg_llm: GenericEncoderConfig, x, lens, max_cache: int):
    """The packed prefix (B, P_bucket, D_in) under the causal mask; fills KV
    slots [0, P_bucket).  Returns (k, v (layers, B, H, max_cache, d_k),
    hidden (B, P_bucket, D))."""
    b, p_bucket, _ = x.shape
    h_heads, d_k = _heads(cfg_llm)
    eps = cfg_llm.layer_norm_eps
    x, _ = apply_input_layer(params_llm, cfg_llm, x,
                             torch.ones((b, p_bucket), dtype=torch.bool, device=x.device))
    x = x * math.sqrt(cfg_llm.output_size)  # the ESPnet xscale
    pos_emb = full_pos_emb(params_llm, cfg_llm, p_bucket, x.dtype, x.device)
    mask = chunk_attention_mask(lens, p_bucket, 1)  # chunk 1: causal
    n_layers = len(params_llm["encoders"])
    k_cache = torch.zeros((n_layers, b, h_heads, max_cache, d_k), dtype=x.dtype, device=x.device)
    v_cache = torch.zeros_like(k_cache)
    for i, lp in enumerate(params_llm["encoders"]):
        att = lp["self_attn"]
        hn = layer_norm(lp["norm1"], x, eps)
        q = dense(att["linear_q"], hn).reshape(b, p_bucket, h_heads, d_k)
        k = dense(att["linear_k"], hn).reshape(b, p_bucket, h_heads, d_k).transpose(1, 2)
        v = dense(att["linear_v"], hn).reshape(b, p_bucket, h_heads, d_k).transpose(1, 2)
        k_cache[i, :, :, :p_bucket] = k
        v_cache[i, :, :, :p_bucket] = v
        x = x + _attention_core(att, cfg_llm, q, k, v, pos_emb, mask)
        x = x + _ffn(lp["feed_forward"], cfg_llm, layer_norm(lp["norm2"], x, eps))
    return k_cache, v_cache, layer_norm(params_llm["after_norm"], x, 1e-5)


def _decode_step(params_llm, cfg_llm: GenericEncoderConfig, pos_proj, x_tok, k_cache, v_cache,
                 prefix_len, p_bucket: int, step: int):
    """One token through the LM stack; writes its K/V at slot P_bucket + step
    and attends over slots [0, P_bucket + step] (the later ones are masked
    in the JAX function and weigh exactly 0 there).

    x_tok: (B, 1, D_in); pos_proj: (layers, max_rel, H, d_k); prefix_len:
    (B,).  Returns hidden (B, D); the caches are written in place."""
    b = x_tok.shape[0]
    h_heads, d_k = _heads(cfg_llm)
    eps = cfg_llm.layer_norm_eps
    dev = x_tok.device
    max_rel = pos_proj.shape[1]
    x, _ = apply_input_layer(params_llm, cfg_llm, x_tok,
                             torch.ones((b, 1), dtype=torch.bool, device=dev))
    x = x * math.sqrt(cfg_llm.output_size)

    cache_index = p_bucket + step
    n = cache_index + 1
    slot = torch.arange(n, device=dev)[None, :]
    # absolute position of each slot: the prefix at its index, generated
    # tokens after the row's valid prefix
    slot_pos = torch.where(slot < p_bucket, slot, prefix_len[:, None] + (slot - p_bucket))
    pos_q = prefix_len + step
    visible = (slot < prefix_len[:, None]) | (slot >= p_bucket)
    rel = pos_q[:, None] - slot_pos  # (B, n)
    bias = torch.where(visible & (rel >= 0), 0.0, NEG_INF)
    rel_idx = rel.clamp(0, max_rel - 1)

    for i, lp in enumerate(params_llm["encoders"]):
        att = lp["self_attn"]
        hn = layer_norm(lp["norm1"], x, eps)
        q = dense(att["linear_q"], hn).reshape(b, h_heads, d_k)
        k_cache[i, :, :, cache_index] = dense(att["linear_k"], hn).reshape(b, h_heads, d_k)
        v_cache[i, :, :, cache_index] = dense(att["linear_v"], hn).reshape(b, h_heads, d_k)
        q_u = q + att["pos_bias_u"].to(q.dtype)
        q_v = q + att["pos_bias_v"].to(q.dtype)
        ac = torch.einsum("bhd,bhkd->bhk", q_u, k_cache[i, :, :, :n])
        qp = torch.einsum("bhd,nhd->bhn", q_v, pos_proj[i].to(q.dtype))
        bd = torch.gather(qp, 2, rel_idx[:, None, :].expand(b, h_heads, n))
        scores = (ac + bd).float() / math.sqrt(d_k)
        probs = torch.softmax(scores + bias[:, None, :], dim=-1).to(x.dtype)
        out = torch.einsum("bhk,bhkd->bhd", probs, v_cache[i, :, :, :n]).reshape(b, h_heads * d_k)
        x = x + dense(att["linear_out"], out)[:, None, :]
        x = x + _ffn(lp["feed_forward"], cfg_llm, layer_norm(lp["norm2"], x, eps))
    return layer_norm(params_llm["after_norm"], x, 1e-5)[:, 0]


def generator_draws(generator: torch.Generator, batch: int, cfg: LMV1Config) -> Draws:
    """``draws(step)`` from ``generator``, consumed in step order."""
    return lambda step: (gumbel((batch, cfg.top_k), generator),
                         gumbel((batch, cfg.speech_token_size + 1), generator))


def lm_v1_decode(
    params,
    cfg: LMV1Config,
    text_token: torch.Tensor,
    text_len: torch.Tensor,
    prompt_text_len: torch.Tensor,
    prompt_speech: torch.Tensor,
    prompt_speech_len: torch.Tensor,
    emb: torch.Tensor,
    max_gen: int,
    use_spk: bool = True,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Draws] = None,
):
    """The whole autoregressive decode.

    text_token: (B, Tt) prompt_text ++ text, padded; prompt_speech: (B, Ts)
    padded (at least one column); emb: (B, spk_embed_dim), ignored when
    ``use_spk`` is False (the speaker slot is dropped).  min/max lengths
    are ratios of (text_len - prompt_text_len); the first step may not
    emit EOS.  Returns (tokens (B, max_gen), lengths (B,), steps).
    """
    cfg_llm = cfg.llm
    b = text_token.shape[0]
    if draws is None:
        if generator is None:
            raise ValueError("lm_v1_decode needs a generator or a draws source")
        draws = generator_draws(generator, b, cfg)
    text_h = encode_text(params, cfg, text_token, text_len)
    spk = _normalized_spk(params, emb) if use_spk else None
    sos, task = params["llm_embedding"]["weight"][0], params["llm_embedding"]["weight"][1]
    sp_emb = embedding(params["speech_embedding"], prompt_speech.clamp_min(0))
    x, prefix_len = _pack(sos, spk, text_h, text_len, task, sp_emb, prompt_speech_len)

    _, p_bucket, _ = x.shape
    max_cache = p_bucket + max_gen
    k_cache, v_cache, hidden = _prefill(params["llm"], cfg_llm, x, prefix_len, max_cache)
    last_hidden = hidden[torch.arange(b, device=x.device), prefix_len - 1]

    n_text = (text_len - prompt_text_len).float()
    min_len = (n_text * cfg.min_token_text_ratio).to(torch.int64)
    max_len = (n_text * cfg.max_token_text_ratio).to(torch.int64).clamp_max(max_gen)

    # each layer's W_pos projection of the positive-distance table, once per decode
    h_heads, d_k = _heads(cfg_llm)
    table = torch.as_tensor(_pos_table_positive(max_cache, cfg_llm.output_size),
                            device=x.device).to(x.dtype)
    pos_proj = torch.stack([dense(lp["self_attn"]["linear_pos"], table).reshape(-1, h_heads, d_k)
                            for lp in params["llm"]["encoders"]])

    dev = x.device
    tokens = torch.zeros((b, max_gen), dtype=torch.long, device=dev)
    recent = torch.full((b, cfg.win_size), -1, dtype=torch.long, device=dev)
    lengths = torch.zeros((b,), dtype=torch.long, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    col = torch.arange(max_gen, device=dev)[None, :]
    step = 0
    while step < max_gen and not bool(finished.all()):
        logp = torch.log_softmax(dense(params["llm_decoder"], last_hidden).float(), dim=-1)
        ignore_eos = (lengths < min_len) | (step == 0)
        gumbel_nuc, gumbel_full = draws(step)
        tok = ras_sample(logp, recent, ignore_eos, cfg.eos_token, gumbel_nuc.to(dev),
                         gumbel_full.to(dev), top_p=cfg.top_p, top_k=cfg.top_k,
                         win_size=cfg.win_size, tau_r=cfg.tau_r)
        is_eos = tok == cfg.eos_token
        emit = (~finished) & (~is_eos)
        tokens = torch.where(emit[:, None] & (col == lengths[:, None]), tok[:, None], tokens)
        lengths = lengths + emit.long()
        finished = finished | is_eos | (lengths >= max_len)
        recent = torch.where(emit[:, None], torch.cat([recent[:, 1:], tok[:, None]], dim=1),
                             recent)
        x_tok = embedding(params["speech_embedding"],
                          tok.clamp(0, cfg.speech_token_size - 1))[:, None, :]
        last_hidden = _decode_step(params["llm"], cfg_llm, pos_proj, x_tok, k_cache, v_cache,
                                   prefix_len, p_bucket, step)
        step += 1
    return tokens, lengths, step

