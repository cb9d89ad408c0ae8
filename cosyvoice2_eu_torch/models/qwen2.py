"""Qwen2 decoder backbone in PyTorch (GQA + RoPE + RMSNorm).

Counterpart of ``cosyvoice2_eu_tpu/models/qwen2.py``.  Decode uses a
pre-allocated KV cache of static length, bf16 by default as in the JAX
package (so even an fp32 LM rounds K/V to bf16).  Unlike the JAX arrays the
cache is updated in place, which saves a copy of it per layer and step.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from cosyvoice2_eu_torch.config import Qwen2Config
from cosyvoice2_eu_torch.ops.masks import NEG_INF
from cosyvoice2_eu_torch.utils.params import (
    dense,
    init_dense,
    init_embedding,
    init_rms_norm,
    rms_norm,
)


@dataclasses.dataclass
class KVCache:
    """Static-shape KV cache: (layers, B, n_kv_heads, max_len, head_dim)."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def zeros(cls, cfg: Qwen2Config, batch: int, max_len: int, device,
              dtype=torch.bfloat16):
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def init_qwen2(gen: torch.Generator, cfg: Qwen2Config) -> dict:
    layers = []
    h, q_dim = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    kv_dim = cfg.num_kv_heads * cfg.head_dim
    for _ in range(cfg.num_layers):
        layer = {
            "input_layernorm": init_rms_norm(gen, h),
            "q_proj": init_dense(gen, h, q_dim, bias=cfg.attention_bias),
            "k_proj": init_dense(gen, h, kv_dim, bias=cfg.attention_bias),
            "v_proj": init_dense(gen, h, kv_dim, bias=cfg.attention_bias),
            "o_proj": init_dense(gen, q_dim, h, bias=False),
            "post_attention_layernorm": init_rms_norm(gen, h),
            "gate_proj": init_dense(gen, h, cfg.intermediate_size, bias=False),
            "up_proj": init_dense(gen, h, cfg.intermediate_size, bias=False),
            "down_proj": init_dense(gen, cfg.intermediate_size, h, bias=False),
        }
        if cfg.use_qk_norm:
            layer["q_norm"] = init_rms_norm(gen, cfg.head_dim)
            layer["k_norm"] = init_rms_norm(gen, cfg.head_dim)
        layers.append(layer)
    return {
        "embed_tokens": init_embedding(gen, cfg.vocab_size, h),
        "layers": layers,
        "norm": init_rms_norm(gen, h),
    }


def rope_cos_sin(positions: torch.Tensor, cfg: Qwen2Config, dtype=torch.float32):
    """positions: (..., T) int -> cos/sin (..., T, head_dim)."""
    half = cfg.head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv_freq = 1.0 / (cfg.rope_theta ** exps)
    ang = positions.float()[..., None] * inv_freq
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, H, T, D); cos/sin: (B, T, D) or (T, D)."""
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    if cos.ndim == 2:
        cos, sin = cos[None, None], sin[None, None]
    else:
        cos, sin = cos[:, None], sin[:, None]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return x * cos + rotated * sin


def _attention(q, k, v, bias, num_groups: int):
    """q: (B, Hq, Tq, D); k,v: (B, Hkv, Tk, D); bias: (B, 1, Tq, Tk)."""
    b, hq, tq, d = q.shape
    hkv = k.shape[1]
    q = q.reshape(b, hkv, num_groups, tq, d)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", q, k) / math.sqrt(d)
    scores = scores.float() + bias[:, :, None]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v)
    return out.reshape(b, hq, tq, d)


def _layer_forward(lp, cfg: Qwen2Config, x, cos, sin, bias, kv: KVCache | None = None,
                   layer_idx: int = 0, write_at: int | torch.Tensor = 0,
                   attn_len: int | None = None):
    """One decoder layer.  If kv is given, k/v are written at slot ``write_at``
    and attention runs over the first ``attn_len`` cache slots (the whole
    cache when None).  A (B,) tensor ``write_at`` writes each row's one new
    K/V at its own slot (the slot-batched decode)."""
    b, t, _ = x.shape
    h = rms_norm(lp["input_layernorm"], x, cfg.rms_norm_eps)
    q = dense(lp["q_proj"], h).reshape(b, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)
    k = dense(lp["k_proj"], h).reshape(b, t, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    v = dense(lp["v_proj"], h).reshape(b, t, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    if "q_norm" in lp:  # qwen3-style per-head norms (applied pre-RoPE)
        q = rms_norm(lp["q_norm"], q, cfg.rms_norm_eps)
        k = rms_norm(lp["k_norm"], k, cfg.rms_norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    groups = cfg.num_heads // cfg.num_kv_heads
    if kv is not None:
        if torch.is_tensor(write_at):  # one new position a row, at its own slot
            rows = torch.arange(b, device=write_at.device)
            kv.k[layer_idx][rows, :, write_at] = k[:, :, 0].to(kv.k.dtype)
            kv.v[layer_idx][rows, :, write_at] = v[:, :, 0].to(kv.v.dtype)
        else:  # rows past the cache's end are not written (a segment's pad rows)
            fit = min(t, kv.k.shape[3] - write_at)
            kv.k[layer_idx, :, :, write_at:write_at + fit] = k[:, :, :fit].to(kv.k.dtype)
            kv.v[layer_idx, :, :, write_at:write_at + fit] = v[:, :, :fit].to(kv.v.dtype)
        n = kv.k.shape[3] if attn_len is None else attn_len
        att = _attention(q, kv.k[layer_idx, :, :, :n].to(q.dtype),
                         kv.v[layer_idx, :, :, :n].to(q.dtype), bias, groups)
    else:
        att = _attention(q, k, v, bias, groups)

    att = att.transpose(1, 2).reshape(b, t, cfg.num_heads * cfg.head_dim)
    x = x + dense(lp["o_proj"], att)

    h = rms_norm(lp["post_attention_layernorm"], x, cfg.rms_norm_eps)
    gated = F.silu(dense(lp["gate_proj"], h)) * dense(lp["up_proj"], h)
    return x + dense(lp["down_proj"], gated)


def qwen2_forward(params, cfg: Qwen2Config, embeds: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Full (training / no-cache) forward.

    embeds: (B, T, H); valid: (B, T) bool -> final hidden states (B, T, H).
    Causal attention restricted to valid positions.
    """
    t = embeds.shape[1]
    pos = torch.arange(t, device=embeds.device)
    mask = (pos[None, None, :] <= pos[None, :, None]) & valid[:, None, :]
    bias = torch.where(mask, 0.0, NEG_INF)[:, None]  # (B, 1, T, T)
    cos, sin = rope_cos_sin(pos, cfg)
    x = embeds
    for lp in params["layers"]:
        x = _layer_forward(lp, cfg, x, cos, sin, bias)
    return rms_norm(params["norm"], x, cfg.rms_norm_eps)


def qwen2_prefill(params, cfg: Qwen2Config, embeds, prompt_len, kv: KVCache):
    """Prefill the KV cache with a right-padded prompt.

    embeds: (B, P_bucket, H); prompt_len: (B,) actual lengths.  K/V go to
    cache slots [0, P_bucket); attention runs over the prompt window only.
    Returns (last_valid_hidden (B, H), kv).
    """
    b, p, _ = embeds.shape
    dev = embeds.device
    pos_idx = torch.arange(p, device=dev)
    mask = (pos_idx[None, None, :] <= pos_idx[None, :, None]) & (
        pos_idx[None, None, :] < prompt_len[:, None, None]
    )
    bias = torch.where(mask, 0.0, NEG_INF)[:, None]  # (B, 1, P, P)
    cos, sin = rope_cos_sin(pos_idx, cfg)

    x = embeds
    for i, lp in enumerate(params["layers"]):
        x = _layer_forward(lp, cfg, x, cos, sin, bias, kv=kv, layer_idx=i, write_at=0,
                           attn_len=p)
    x = rms_norm(params["norm"], x, cfg.rms_norm_eps)
    last = torch.gather(x, 1, (prompt_len - 1).long()[:, None, None].expand(b, 1, x.shape[2]))
    return last[:, 0], kv


def qwen2_decode_step(params, cfg: Qwen2Config, embed, rope_pos,
                      cache_index: int | torch.Tensor, valid_mask, kv: KVCache):
    """One AR step.

    embed: (B, H); rope_pos: (B,) true sequence position; cache_index: slot
    to write, an int for every row or a (B,) tensor of per-row slots;
    valid_mask: (B, n) bool over the first n cache slots (n >= every slot
    written; the whole cache for per-row slots), the new slot included.
    Slots past n are masked anyway, so attention reads only the first n.
    Returns (hidden (B, H), kv).
    """
    x = embed[:, None, :]
    n = valid_mask.shape[1]
    bias = torch.where(valid_mask, 0.0, NEG_INF)[:, None, None]  # (B,1,1,n)
    cos, sin = rope_cos_sin(rope_pos[:, None], cfg)  # (B,1,D)
    for i, lp in enumerate(params["layers"]):
        x = _layer_forward(lp, cfg, x, cos, sin, bias, kv=kv, layer_idx=i,
                           write_at=cache_index, attn_len=n)
    x = rms_norm(params["norm"], x, cfg.rms_norm_eps)
    return x[:, 0], kv
