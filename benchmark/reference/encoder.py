"""Frozen copy of the port's ``cosyvoice2_eu_torch/models/encoder.py`` (plain
PyTorch, no kernel), for the benchmark's reference: it imports nothing of
the port, and a later change to the port does not change it. Configs are
namespaces with the port's field names."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .masks import NEG_INF, chunk_attention_mask, make_non_pad_mask
from .layers import conv1d, dense, layer_norm


def espnet_rel_pos_emb(size: int, d_model: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Relative position embeddings for offsets [size-1 .. -(size-1)], (2*size-1, d_model)."""
    pos = np.arange(size, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * -(math.log(10000.0) / d_model))
    pe_pos = np.zeros((size, d_model), np.float32)
    pe_pos[:, 0::2] = np.sin(pos * div)
    pe_pos[:, 1::2] = np.cos(pos * div)
    pe_neg = np.zeros((size, d_model), np.float32)
    pe_neg[:, 0::2] = np.sin(-pos * div)
    pe_neg[:, 1::2] = np.cos(-pos * div)
    pe = np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0)
    return torch.as_tensor(pe, device=device).to(dtype)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL relative shift: (B, H, T, 2T-1) -> (B, H, T, T)."""
    b, h, t, n = x.shape
    xp = F.pad(x, (1, 0)).reshape(b, h, n + 1, t)
    x = xp[:, :, 1:].reshape(b, h, t, n)
    return x[..., : n // 2 + 1]


def rel_attention(p: dict, heads: int, x: torch.Tensor, pos_emb: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Relative-position MHA.  x: (B, T, D); pos_emb: (2T-1, D); mask: (B, T, T) bool."""
    b, t, dim = x.shape
    d_k = dim // heads
    q = dense(p["linear_q"], x).reshape(b, t, heads, d_k)
    k = dense(p["linear_k"], x).reshape(b, t, heads, d_k).transpose(1, 2)
    v = dense(p["linear_v"], x).reshape(b, t, heads, d_k).transpose(1, 2)
    pe = dense(p["linear_pos"], pos_emb).reshape(-1, heads, d_k).transpose(0, 1)  # (H, 2T-1, dk)

    q_u = (q + p["pos_bias_u"].to(x.dtype)).transpose(1, 2)
    q_v = (q + p["pos_bias_v"].to(x.dtype)).transpose(1, 2)
    ac = q_u @ k.transpose(-1, -2)
    bd = torch.einsum("bhqd,hnd->bhqn", q_v, pe)  # (B, H, T, 2T-1)
    bd = rel_shift(bd)
    scores = (ac + bd) / math.sqrt(d_k)
    scores = scores.float() + torch.where(mask, 0.0, NEG_INF)[:, None]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = (probs @ v).transpose(1, 2).reshape(b, t, dim)
    return dense(p["linear_out"], out)


def conformer_layer(p: dict, cfg, x, pos_emb, mask):
    h = layer_norm(p["norm_mha"], x, cfg.layer_norm_eps)
    x = x + rel_attention(p["self_attn"], cfg.attention_heads, h, pos_emb, mask)
    h = layer_norm(p["norm_ff"], x, cfg.layer_norm_eps)
    h = dense(p["ffn_w2"], F.silu(dense(p["ffn_w1"], h)))
    return x + h


def _embed(p, x, d_model):
    """LinearNoSubsampling + EspnetRelPositionalEncoding scale."""
    x = dense(p["linear"], x)
    x = layer_norm(p["norm"], x, eps=1e-5)
    return x * math.sqrt(d_model)


def _pre_lookahead(p, x, lookahead_len: int, context: torch.Tensor | None = None):
    """(B, T, D) -> (B, T, D).  Right-context conv; ``context`` replaces the
    zero right padding in chunked streaming."""
    h = x.transpose(1, 2)  # (B, D, T)
    if context is not None:
        h = torch.cat([h, context.transpose(1, 2)], dim=2)
    else:
        h = F.pad(h, (0, lookahead_len))
    h = F.leaky_relu(conv1d(p["conv1"], h), 0.01)
    h = F.pad(h, (2, 0))
    h = conv1d(p["conv2"], h)
    return h.transpose(1, 2) + x


def upsample_conformer_forward(
    params: dict,
    cfg,
    xs: torch.Tensor,
    xs_lens: torch.Tensor,
    context: torch.Tensor | None = None,
    streaming: bool = False,
):
    """xs: (B, T, input_size); xs_lens: (B,).

    Returns (ys (B, T*stride, output_size), ys_lens (B,)).
    """
    b, t, _ = xs.shape
    d = cfg.output_size
    stride = cfg.upsample_stride
    dev = xs.device

    # zero pad slots after the embed's LayerNorm so the right-context conv
    # sees true zeros
    valid = make_non_pad_mask(xs_lens, t)[..., None].to(xs.dtype)
    x = _embed(params["embed"], xs, d) * valid
    ctx = _embed(params["embed"], context, d) if context is not None else None
    pos_emb = espnet_rel_pos_emb(t, d, dev, x.dtype)
    chunk = cfg.static_chunk_size if streaming else 0
    mask = chunk_attention_mask(xs_lens, t, chunk)

    x = _pre_lookahead(params["pre_lookahead"], x, cfg.pre_lookahead_len, ctx)
    for lp in params["encoders"]:
        x = conformer_layer(lp, cfg, x, pos_emb, mask)

    # 2x nearest upsample + causal conv
    h = x.transpose(1, 2).repeat_interleave(stride, dim=2)
    h = F.pad(h, (stride * 2, 0))
    h = conv1d(params["up_layer"], h)
    x = h.transpose(1, 2)
    up_lens = xs_lens * stride

    t_up = t * stride
    valid_up = make_non_pad_mask(up_lens, t_up)[..., None].to(x.dtype)
    x = _embed(params["up_embed"], x, d) * valid_up
    pos_emb_up = espnet_rel_pos_emb(t_up, d, dev, x.dtype)
    chunk_up = cfg.static_chunk_size * stride if streaming else 0
    mask_up = chunk_attention_mask(up_lens, t_up, chunk_up)
    for lp in params["up_encoders"]:
        x = conformer_layer(lp, cfg, x, pos_emb_up, mask_up)

    x = layer_norm(params["after_norm"], x, eps=1e-5)
    return x, up_lens
