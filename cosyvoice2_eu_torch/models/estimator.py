"""Causal 1-D U-Net velocity estimator of the CFM mel decoder, in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/models/estimator.py``: channel concat
[x, mu, spks, cond]; one down stage (causal ResNet block + n_blocks
transformer blocks + causal conv), the mid stages, one up stage with a skip
connection, a causal final block and a 1x1 projection.  Every attention of a
transformer block on a CUDA tensor runs the differentiable flash attention
(``ops/flash_attention.py``): kernel K1 alone at inference, K1 with LSE and
then K3 and K4 in the backward under autograd.  On a CPU tensor it runs the
plain masked softmax of the JAX package's non-Pallas branch, differentiated
by autograd.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cosyvoice2_eu_torch.config import EstimatorConfig
from cosyvoice2_eu_torch.ops.flash_attention import flash_attention
from cosyvoice2_eu_torch.ops.masks import NEG_INF, chunk_attention_mask
from cosyvoice2_eu_torch.utils.params import (
    causal_conv1d,
    conv1d,
    dense,
    init_conv1d,
    init_dense,
    init_layer_norm,
    layer_norm,
)


def _mish(x):
    return x * torch.tanh(F.softplus(x))


def sinusoidal_time_emb(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """(B,) -> (B, dim)."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
    ang = scale * t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_causal_block(gen, dim, dim_out):
    return {"conv": init_conv1d(gen, dim, dim_out, 3), "norm": init_layer_norm(gen, dim_out)}


def causal_block(p, x, mask):
    """x: (B, C, T); mask: (B, 1, T)."""
    h = causal_conv1d(p["conv"], x * mask)
    h = layer_norm(p["norm"], h.transpose(1, 2)).transpose(1, 2)
    return _mish(h) * mask


def init_causal_resnet(gen, dim, dim_out, time_dim):
    return {
        "block1": init_causal_block(gen, dim, dim_out),
        "block2": init_causal_block(gen, dim_out, dim_out),
        "mlp": init_dense(gen, time_dim, dim_out),
        "res_conv": init_conv1d(gen, dim, dim_out, 1),
    }


def causal_resnet(p, x, mask, temb):
    h = causal_block(p["block1"], x, mask)
    h = h + dense(p["mlp"], _mish(temb))[:, :, None]
    h = causal_block(p["block2"], h, mask)
    return h + conv1d(p["res_conv"], x * mask)


def init_transformer_block(gen, dim, heads, head_dim):
    inner = heads * head_dim
    return {
        "norm1": init_layer_norm(gen, dim),
        "to_q": init_dense(gen, dim, inner, bias=False),
        "to_k": init_dense(gen, dim, inner, bias=False),
        "to_v": init_dense(gen, dim, inner, bias=False),
        "to_out": init_dense(gen, inner, dim),
        "norm3": init_layer_norm(gen, dim),
        "ff_in": init_dense(gen, dim, 4 * dim),
        "ff_out": init_dense(gen, 4 * dim, dim),
    }


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
    if x.is_cuda:
        att = flash_attention(q, k, v, lengths, chunk_size=chunk)
    else:
        att = _masked_softmax_attention(q, k, v, lengths, chunk)
    att = att.transpose(1, 2).reshape(b, t, inner)
    x = x + dense(p["to_out"], att)
    h = layer_norm(p["norm3"], x)
    h = dense(p["ff_out"], F.gelu(dense(p["ff_in"], h)))
    return x + h


def init_estimator(gen, cfg: EstimatorConfig) -> dict:
    ch = cfg.channels[0]
    time_dim = ch * 4

    def stage(dim_in, dim_out, with_conv):
        s = {
            "resnet": init_causal_resnet(gen, dim_in, dim_out, time_dim),
            "transformer": [
                init_transformer_block(gen, dim_out, cfg.num_heads, cfg.attention_head_dim)
                for _ in range(cfg.n_blocks)
            ],
        }
        if with_conv:
            s["conv"] = init_conv1d(gen, dim_out, dim_out, 3)
        return s

    return {
        "time_mlp": {
            "linear_1": init_dense(gen, cfg.in_channels, time_dim),
            "linear_2": init_dense(gen, time_dim, time_dim),
        },
        "down": stage(cfg.in_channels, ch, with_conv=True),
        "mid": [stage(ch, ch, with_conv=False) for _ in range(cfg.num_mid_blocks)],
        "up": stage(ch * 2, ch, with_conv=True),
        "final_block": init_causal_block(gen, ch, ch),
        "final_proj": init_conv1d(gen, ch, cfg.out_channels, 1),
    }


def estimator_forward(
    params: dict,
    cfg: EstimatorConfig,
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
