"""Frozen copy of the port's ``cosyvoice2_eu_torch/models/estimator.py`` (plain
PyTorch, no kernel), for the benchmark's reference: it imports nothing of
the port, and a later change to the port does not change it. Attention is
always the masked softmax (the port's CPU branch), on any device."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .masks import NEG_INF, chunk_attention_mask
from .layers import causal_conv1d, conv1d, dense, layer_norm


def _mish(x):
    return x * torch.tanh(F.softplus(x))


def sinusoidal_time_emb(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """(B,) -> (B, dim)."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
    ang = scale * t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def causal_block(p, x, mask):
    """x: (B, C, T); mask: (B, 1, T)."""
    h = causal_conv1d(p["conv"], x * mask)
    h = layer_norm(p["norm"], h.transpose(1, 2)).transpose(1, 2)
    return _mish(h) * mask


def causal_resnet(p, x, mask, temb):
    h = causal_block(p["block1"], x, mask)
    h = h + dense(p["mlp"], _mish(temb))[:, :, None]
    h = causal_block(p["block2"], h, mask)
    return h + conv1d(p["res_conv"], x * mask)


def _masked_softmax_attention(q, k, v, lengths, chunk):
    """The plain path of the JAX estimator: additive -1e10 bias, scores in q's dtype."""
    t, d_k = q.shape[2], q.shape[3]
    attn_bias = torch.where(chunk_attention_mask(lengths, t, chunk), 0.0, NEG_INF)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(d_k)
    scores = scores.float() + attn_bias[:, None]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return probs @ v


def transformer_block(p, x, mask_info, heads):
    """x: (B, T, C); mask_info: (lengths (B,), chunk_size)."""
    b, t, c = x.shape
    lengths, chunk = mask_info
    h = layer_norm(p["norm1"], x)
    inner = p["to_q"]["weight"].shape[0]
    d_k = inner // heads
    q = dense(p["to_q"], h).reshape(b, t, heads, d_k).transpose(1, 2).contiguous()
    k = dense(p["to_k"], h).reshape(b, t, heads, d_k).transpose(1, 2).contiguous()
    v = dense(p["to_v"], h).reshape(b, t, heads, d_k).transpose(1, 2).contiguous()
    att = _masked_softmax_attention(q, k, v, lengths, chunk)
    att = att.transpose(1, 2).reshape(b, t, inner)
    x = x + dense(p["to_out"], att)
    h = layer_norm(p["norm3"], x)
    h = dense(p["ff_out"], F.gelu(dense(p["ff_in"], h)))
    return x + h


def estimator_forward(
    params: dict,
    cfg,
    x: torch.Tensor,
    mask: torch.Tensor,
    mu: torch.Tensor,
    t: torch.Tensor,
    spks: torch.Tensor,
    cond: torch.Tensor,
    streaming: bool = False,
) -> torch.Tensor:
    """Predict velocity.  x/mu/cond: (B, 80, T); mask: (B, 1, T); t: (B,); spks: (B, 80)."""
    b, _, T = x.shape
    temb = sinusoidal_time_emb(t, cfg.in_channels, cfg.time_embed_scale).to(x.dtype)
    temb = dense(params["time_mlp"]["linear_1"], temb)
    temb = dense(params["time_mlp"]["linear_2"], F.silu(temb))

    h = torch.cat([x, mu, spks[:, :, None].expand(b, spks.shape[1], T), cond], dim=1)

    lengths = mask[:, 0].to(torch.int32).sum(-1, dtype=torch.int32)
    chunk = cfg.static_chunk_size if streaming else 0
    mask_info = (lengths, chunk)

    def run_blocks(sp, h):
        h = causal_resnet(sp["resnet"], h, mask, temb)
        ht = h.transpose(1, 2)
        for tp in sp["transformer"]:
            ht = transformer_block(tp, ht, mask_info, cfg.num_heads)
        return ht.transpose(1, 2)

    # down stage: skip is captured BEFORE the downsample conv
    h = run_blocks(params["down"], h)
    skip = h
    h = causal_conv1d(params["down"]["conv"], h * mask)
    for sp in params["mid"]:
        h = run_blocks(sp, h)
    h = torch.cat([h, skip], dim=1)
    h = run_blocks(params["up"], h)
    h = causal_conv1d(params["up"]["conv"], h * mask)
    h = causal_block(params["final_block"], h, mask)
    out = conv1d(params["final_proj"], h * mask)
    return out * mask
