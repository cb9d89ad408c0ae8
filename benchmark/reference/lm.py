"""The speech LM's full forward pass, in plain PyTorch.

Frozen copy of the port's plain path (``models/qwen2.py::qwen2_forward``,
``models/llm.py::embed_mixed`` and ``lm_training_hidden``): a Qwen2 / Qwen3
decoder (GQA, RoPE, RMSNorm; Qwen3's per-head q/k norms before RoPE) over
mixed embeddings, causal attention over the valid positions, no KV cache,
then the speech head.  Configs are namespaces with the port's field names.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import dense, embedding, rms_norm
from .masks import NEG_INF

SRC_SPECIAL, SRC_TEXT, SRC_SPEECH = 0, 1, 2


def rope_cos_sin(positions: torch.Tensor, c):
    half = c.head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv_freq = 1.0 / (c.rope_theta ** exps)
    ang = positions.float()[..., None] * inv_freq
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos.to(x.dtype) + rotated * sin.to(x.dtype)


def _layer(lp, c, x, cos, sin, bias):
    b, t, _ = x.shape
    hd = c.head_dim
    h = rms_norm(lp["input_layernorm"], x, c.rms_norm_eps)
    q = dense(lp["q_proj"], h).reshape(b, t, c.num_heads, hd).transpose(1, 2)
    k = dense(lp["k_proj"], h).reshape(b, t, c.num_kv_heads, hd).transpose(1, 2)
    v = dense(lp["v_proj"], h).reshape(b, t, c.num_kv_heads, hd).transpose(1, 2)
    if "q_norm" in lp:
        q = rms_norm(lp["q_norm"], q, c.rms_norm_eps)
        k = rms_norm(lp["k_norm"], k, c.rms_norm_eps)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    groups = c.num_heads // c.num_kv_heads
    qg = q.reshape(b, c.num_kv_heads, groups, t, hd)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, k) / math.sqrt(hd)
    probs = torch.softmax(scores.float() + bias[:, :, None], dim=-1).to(v.dtype)
    att = torch.einsum("bhgqk,bhkd->bhgqd", probs, v).reshape(b, c.num_heads, t, hd)
    x = x + dense(lp["o_proj"], att.transpose(1, 2).reshape(b, t, c.num_heads * hd))
    h = rms_norm(lp["post_attention_layernorm"], x, c.rms_norm_eps)
    return x + dense(lp["down_proj"], F.silu(dense(lp["gate_proj"], h)) * dense(lp["up_proj"], h))


def embed_mixed(params, ids: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    safe = ids.clamp_min(0)
    e_special = embedding(params["llm_embedding"], safe.clamp(0, 1))
    e_text = embedding(params["backbone"]["embed_tokens"], safe)
    n_speech = params["speech_embedding"]["weight"].shape[0]
    e_speech = embedding(params["speech_embedding"], safe.clamp(0, n_speech - 1))
    sel = src[..., None]
    return torch.where(sel == SRC_TEXT, e_text, torch.where(sel == SRC_SPEECH, e_speech, e_special))


def lm_logits(params, c, ids, src, valid) -> torch.Tensor:
    """(B, T) ids and table selectors, (B, T) valid -> (B, T, full_vocab)
    speech-head logits; position t sees the valid positions up to t."""
    bb = c.backbone
    x = embed_mixed(params, ids, src)
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)
    mask = (pos[None, None, :] <= pos[None, :, None]) & valid[:, None, :]
    bias = torch.where(mask, 0.0, NEG_INF)[:, None]
    cos, sin = rope_cos_sin(pos, bb)
    for lp in params["backbone"]["layers"]:
        x = _layer(lp, bb, x, cos, sin, bias)
    x = rms_norm(params["backbone"]["norm"], x, bb.rms_norm_eps)
    return dense(params["llm_decoder"], x)
