"""ASR-style attention decoder and MoE feed-forward, in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/models/decoder.py`` (reference:
cosy_repo/cosyvoice/transformer/decoder.py:33 TransformerDecoder, :256
BiTransformerDecoder, decoder_layer.py:24 DecoderLayer, and
positionwise_feed_forward.py:58 MoEFFNLayer).  The v1/ASR path rescores
n-best hypotheses with it; the EU synthesis path does not run it.

* Rescoring is one batched forward over the padded n-best list (a causal
  mask and cross-attention over the encoder memory).
  ``decoder_forward_one_step`` is the reference's incremental step with its
  layer-output cache (each layer's output over the whole prefix, the
  last position recomputed from the full prefix).
* ``moe_ffn`` runs each expert on the tokens routed to it (a gather, then
  an ``index_add_`` of the weighted outputs), where the JAX package runs
  every expert on every token and masks the top-k weights; the results
  agree up to the order of the sums.

Plain PyTorch on any device: no kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from cosyvoice2_eu_torch.config import AsrDecoderConfig
from cosyvoice2_eu_torch.models.generic_encoder import sinusoid_pos_table
from cosyvoice2_eu_torch.ops.masks import NEG_INF, make_non_pad_mask
from cosyvoice2_eu_torch.registry import ACTIVATIONS
from cosyvoice2_eu_torch.utils.params import (
    dense,
    embedding,
    init_dense,
    init_embedding,
    init_layer_norm,
    layer_norm,
)

# ---------------------------------------------------------------------------
# cross-capable MHA (attention.py:26 MultiHeadedAttention)
# ---------------------------------------------------------------------------


def _init_mha(gen, dim: int, key_bias: bool) -> dict:
    return {"linear_q": init_dense(gen, dim, dim),
            "linear_k": init_dense(gen, dim, dim, bias=key_bias),
            "linear_v": init_dense(gen, dim, dim),
            "linear_out": init_dense(gen, dim, dim)}


def _mha(p, heads: int, q_in, k_in, v_in, mask):
    """q_in: (B, Tq, D); k_in, v_in: (B, Tk, D); mask: (B, Tq|1, Tk) bool."""
    b, tq, d = q_in.shape
    tk = k_in.shape[1]
    d_k = d // heads
    q = dense(p["linear_q"], q_in).reshape(b, tq, heads, d_k).transpose(1, 2)
    k = dense(p["linear_k"], k_in).reshape(b, tk, heads, d_k).transpose(1, 2)
    v = dense(p["linear_v"], v_in).reshape(b, tk, heads, d_k).transpose(1, 2)
    scores = (q @ k.transpose(-1, -2)).float() / math.sqrt(d_k)
    scores = scores + torch.where(mask, 0.0, NEG_INF)[:, None]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return dense(p["linear_out"], (probs @ v).transpose(1, 2).reshape(b, tq, d))


# ---------------------------------------------------------------------------
# decoder layer (decoder_layer.py:24)
# ---------------------------------------------------------------------------

def _init_layer(gen, cfg: AsrDecoderConfig) -> dict:
    d = cfg.encoder_output_size
    p = {"self_attn": _init_mha(gen, d, cfg.key_bias),
         "feed_forward": {"w_1": init_dense(gen, d, cfg.linear_units),
                          "w_2": init_dense(gen, cfg.linear_units, d)},
         "norm1": init_layer_norm(gen, d),
         "norm3": init_layer_norm(gen, d)}
    if cfg.src_attention:
        p["src_attn"] = _init_mha(gen, d, cfg.key_bias)
        p["norm2"] = init_layer_norm(gen, d)
    return p


def _ffn(p, cfg: AsrDecoderConfig, h):
    act = ACTIVATIONS[cfg.activation_type]
    return dense(p["feed_forward"]["w_2"], act(dense(p["feed_forward"]["w_1"], h)))


def _decoder_layer(p, cfg: AsrDecoderConfig, x, tgt_mask, memory, memory_mask):
    """x: (B, L, D); tgt_mask: (B, L, L); memory_mask: (B, 1, Tmem)."""
    pre = cfg.normalize_before

    def sub(norm_key, fn, x):
        h = layer_norm(p[norm_key], x) if pre else x
        y = x + fn(h)
        return y if pre else layer_norm(p[norm_key], y)

    heads = cfg.attention_heads
    x = sub("norm1", lambda h: _mha(p["self_attn"], heads, h, h, h, tgt_mask), x)
    if cfg.src_attention:
        x = sub("norm2", lambda h: _mha(p["src_attn"], heads, h, memory, memory, memory_mask), x)
    return sub("norm3", lambda h: _ffn(p, cfg, h), x)


# ---------------------------------------------------------------------------
# TransformerDecoder (decoder.py:33)
# ---------------------------------------------------------------------------

def init_transformer_decoder(gen, cfg: AsrDecoderConfig,
                             num_blocks: Optional[int] = None) -> dict:
    n = cfg.num_blocks if num_blocks is None else num_blocks
    d = cfg.encoder_output_size
    p = {"decoders": [_init_layer(gen, cfg) for _ in range(n)],
         "after_norm": init_layer_norm(gen, d)}
    if cfg.input_layer == "embed":
        p["embed"] = init_embedding(gen, cfg.vocab_size, d)
    if cfg.use_output_layer:
        p["output_layer"] = init_dense(gen, d, cfg.vocab_size)
    return p


def _embed_tgt(params, cfg: AsrDecoderConfig, tgt):
    if cfg.input_layer != "embed":  # no_pos: float features pass through (decoder.py:83)
        return tgt
    x = embedding(params["embed"], tgt)
    d = cfg.encoder_output_size
    pe = torch.as_tensor(sinusoid_pos_table(x.shape[1], d), dtype=x.dtype, device=x.device)
    return x * math.sqrt(d) + pe[None]


def _causal(l: int, device) -> torch.Tensor:
    return torch.tril(torch.ones((l, l), dtype=torch.bool, device=device))


def transformer_decoder_forward(params: dict, cfg: AsrDecoderConfig, memory: torch.Tensor,
                                memory_lens: torch.Tensor, ys_in_pad: torch.Tensor,
                                ys_in_lens: torch.Tensor):
    """Batched rescoring forward (decoder.py:116).  memory: (B, Tmem, D);
    ys_in_pad: (B, L) ids.  Returns (logits (B, L, vocab), or the hidden
    states without an output layer, and ys_in_lens)."""
    l = ys_in_pad.shape[1]
    valid = make_non_pad_mask(ys_in_lens, l)
    tgt_mask = valid[:, None, :] & _causal(l, memory.device)[None]
    memory_mask = make_non_pad_mask(memory_lens, memory.shape[1])[:, None, :]
    x = _embed_tgt(params, cfg, ys_in_pad)
    for lp in params["decoders"]:
        x = _decoder_layer(lp, cfg, x, tgt_mask, memory, memory_mask)
    if cfg.normalize_before:
        x = layer_norm(params["after_norm"], x)
    if cfg.use_output_layer:
        x = dense(params["output_layer"], x)
    return x, ys_in_lens


def decoder_forward_one_step(params: dict, cfg: AsrDecoderConfig, memory: torch.Tensor,
                             memory_lens: torch.Tensor, tgt: torch.Tensor,
                             cache: Optional[list] = None):
    """Incremental decode step (decoder.py:187 forward_one_step): the last
    position's query against the whole prefix, each layer's output over the
    prefix cached.  Returns (log_probs (B, vocab), new_cache)."""
    l = tgt.shape[1]
    causal = _causal(l, memory.device)
    memory_mask = make_non_pad_mask(memory_lens, memory.shape[1])[:, None, :]
    x = _embed_tgt(params, cfg, tgt)
    pre, heads = cfg.normalize_before, cfg.attention_heads
    new_cache = []
    for i, lp in enumerate(params["decoders"]):
        if cache is None:
            y = _decoder_layer(lp, cfg, x, causal[None], memory, memory_mask)
        else:
            # query = the last position only; keys = the whole prefix (decoder_layer.py:94)
            h_all = layer_norm(lp["norm1"], x) if pre else x
            h = x[:, -1:] + _mha(lp["self_attn"], heads, h_all[:, -1:], h_all, h_all,
                                 causal[None, -1:, :])
            if not pre:
                h = layer_norm(lp["norm1"], h)
            if cfg.src_attention:
                hh = layer_norm(lp["norm2"], h) if pre else h
                h = h + _mha(lp["src_attn"], heads, hh, memory, memory, memory_mask)
                if not pre:
                    h = layer_norm(lp["norm2"], h)
            hh = layer_norm(lp["norm3"], h) if pre else h
            h = h + _ffn(lp, cfg, hh)
            if not pre:
                h = layer_norm(lp["norm3"], h)
            y = torch.cat([cache[i], h], dim=1)
        new_cache.append(y)
        x = y
    out = x[:, -1]
    if cfg.normalize_before:
        out = layer_norm(params["after_norm"], out)
    if cfg.use_output_layer:
        out = torch.log_softmax(dense(params["output_layer"], out), dim=-1)
    return out, new_cache


# ---------------------------------------------------------------------------
# BiTransformerDecoder (decoder.py:256)
# ---------------------------------------------------------------------------

def init_bi_transformer_decoder(gen, cfg: AsrDecoderConfig) -> dict:
    return {"left_decoder": init_transformer_decoder(gen, cfg),
            "right_decoder": init_transformer_decoder(gen, cfg, num_blocks=cfg.r_num_blocks)}


def bi_transformer_decoder_forward(params: dict, cfg: AsrDecoderConfig, memory, memory_lens,
                                   ys_in_pad, ys_in_lens, r_ys_in_pad=None,
                                   reverse_weight: float = 0.0):
    """Left-to-right and, with ``reverse_weight`` > 0, right-to-left
    scoring (decoder.py:332): (l_x, r_x, olens), r_x a 0-d zero without."""
    l_x, olens = transformer_decoder_forward(params["left_decoder"], cfg, memory, memory_lens,
                                             ys_in_pad, ys_in_lens)
    r_x = torch.zeros((), device=memory.device)
    if reverse_weight > 0.0 and r_ys_in_pad is not None:
        r_x, olens = transformer_decoder_forward(params["right_decoder"], cfg, memory,
                                                 memory_lens, r_ys_in_pad, ys_in_lens)
    return l_x, r_x, olens


# ---------------------------------------------------------------------------
# reference state-dict conversion (numpy trees, as runtime/checkpoint.py)
# ---------------------------------------------------------------------------

def convert_transformer_decoder(state: dict, cfg: AsrDecoderConfig,
                                num_blocks: Optional[int] = None) -> dict:
    j = {k: np.asarray(v) for k, v in state.items()}
    n = cfg.num_blocks if num_blocks is None else num_blocks

    def lin(prefix):
        p = {"weight": j[f"{prefix}.weight"]}
        if f"{prefix}.bias" in j:
            p["bias"] = j[f"{prefix}.bias"]
        return p

    def norm(prefix):
        return {"weight": j[f"{prefix}.weight"], "bias": j[f"{prefix}.bias"]}

    def mha(prefix):
        return {k: lin(f"{prefix}.{k}") for k in ("linear_q", "linear_k", "linear_v", "linear_out")}

    layers = []
    for i in range(n):
        pre = f"decoders.{i}"
        lp = {"self_attn": mha(f"{pre}.self_attn"),
              "feed_forward": {"w_1": lin(f"{pre}.feed_forward.w_1"),
                               "w_2": lin(f"{pre}.feed_forward.w_2")},
              "norm1": norm(f"{pre}.norm1"),
              "norm3": norm(f"{pre}.norm3")}
        if cfg.src_attention:
            lp["src_attn"] = mha(f"{pre}.src_attn")
            lp["norm2"] = norm(f"{pre}.norm2")
        layers.append(lp)
    p = {"decoders": layers, "after_norm": norm("after_norm")}
    if cfg.input_layer == "embed":
        p["embed"] = {"weight": j["embed.0.weight"]}
    if cfg.use_output_layer:
        p["output_layer"] = lin("output_layer")
    return p


def convert_bi_transformer_decoder(state: dict, cfg: AsrDecoderConfig) -> dict:
    def side(prefix):
        return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}

    return {"left_decoder": convert_transformer_decoder(side("left_decoder."), cfg),
            "right_decoder": convert_transformer_decoder(side("right_decoder."), cfg,
                                                         num_blocks=cfg.r_num_blocks)}


# ---------------------------------------------------------------------------
# MoE FFN (positionwise_feed_forward.py:58 MoEFFNLayer)
# ---------------------------------------------------------------------------

def init_moe_ffn(gen, n_expert: int, idim: int, hidden_units: int) -> dict:
    return {"gate": init_dense(gen, idim, n_expert, bias=False),
            "experts": [{"w_1": init_dense(gen, idim, hidden_units),
                         "w_2": init_dense(gen, hidden_units, idim)} for _ in range(n_expert)]}


def moe_ffn(p: dict, x: torch.Tensor, n_expert_per_token: int,
            activation: str = "relu") -> torch.Tensor:
    """x: (B, L, D) -> (B, L, D): each token through its top-k experts by
    the gate, weighted by the softmax of their gate logits (in fp32)."""
    act = ACTIVATIONS[activation]
    b, l, d = x.shape
    xs = x.reshape(-1, d)
    top_logits, top_idx = torch.topk(dense(p["gate"], xs), n_expert_per_token, dim=1)
    top_w = torch.softmax(top_logits.float(), dim=1).to(x.dtype)
    out = torch.zeros_like(xs)
    for e, ep in enumerate(p["experts"]):
        rows, slot = torch.nonzero(top_idx == e, as_tuple=True)
        if rows.numel():
            y = dense(ep["w_2"], act(dense(ep["w_1"], xs[rows])))
            out.index_add_(0, rows, top_w[rows, slot][:, None] * y)
    return out.reshape(b, l, d)


def convert_moe_ffn(state: dict, n_expert: int) -> dict:
    j = {k: np.asarray(v) for k, v in state.items()}
    return {"gate": {"weight": j["gate.weight"]},
            "experts": [{"w_1": {"weight": j[f"experts.{i}.w_1.weight"],
                                 "bias": j[f"experts.{i}.w_1.bias"]},
                         "w_2": {"weight": j[f"experts.{i}.w_2.weight"],
                                 "bias": j[f"experts.{i}.w_2.bias"]}}
                        for i in range(n_expert)]}
