"""Supervised semantic speech tokenizer (whisper-style encoder + FSQ), in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/models/speech_tokenizer.py``, the
replacement for the reference's ``speech_tokenizer_v2.onnx`` (consumed at
cosy_repo/cosyvoice/cli/frontend.py:262-274).  Topology of the public
S3Tokenizer "v2_25hz" design: two gelu Conv1d layers (strides 2, 2: 100 fps
128-bin log-mel -> 25 Hz), whisper sinusoidal positions, 6 pre-norm
attention blocks (1280 wide, 20 heads, key projection without bias), then a
finite scalar quantization head: Linear(1280 -> 8), tanh * 0.9990000128746033,
round, and a base-3 positional code => vocab 3^8 = 6561.

Attention is the plain masked softmax in fp32, as the JAX package computes
it outside Pallas.  Weights come from the ONNX graph through
``runtime/onnx_convert.py``, or from ``init_speech_tokenizer``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from cosyvoice2_eu_torch.ops.masks import NEG_INF, make_non_pad_mask
from cosyvoice2_eu_torch.utils.params import (
    conv1d,
    dense,
    init_conv1d,
    init_dense,
    init_layer_norm,
    layer_norm,
)

# the exact bound S3Tokenizer's FSQCodebook applies before rounding
FSQ_TANH_SCALE = 0.9990000128746033


@dataclasses.dataclass(frozen=True)
class SpeechTokenizerConfig:
    n_mels: int = 128
    d_model: int = 1280  # whisper-large width
    num_heads: int = 20
    num_layers: int = 6
    ffn_dim: int = 5120
    conv_strides: tuple = (2, 2)  # v2_25hz: 100 fps mel -> 25 Hz tokens
    fsq_dim: int = 8
    fsq_levels: int = 3
    max_frames: int = 3000  # 30 s at 100 fps

    @property
    def vocab_size(self) -> int:
        return self.fsq_levels**self.fsq_dim  # 6561

    @property
    def downsample(self) -> int:
        out = 1
        for s in self.conv_strides:
            out *= s
        return out


def tiny_tokenizer_config() -> SpeechTokenizerConfig:
    return SpeechTokenizerConfig(
        n_mels=16, d_model=32, num_heads=4, num_layers=2, ffn_dim=64, max_frames=256,
    )


def _sinusoid_pos(length: int, dim: int, device=None) -> torch.Tensor:
    """Whisper's sinusoidal positions."""
    log_timescale = math.log(10000.0) / (dim // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(dim // 2, dtype=torch.float32, device=device))
    ang = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def init_speech_tokenizer(gen: torch.Generator, cfg: SpeechTokenizerConfig) -> dict:
    """Random parameters drawn from ``gen`` on its device (the JAX init's
    distributions)."""
    d = cfg.d_model

    def attn_block():
        return {
            "attn_ln": init_layer_norm(gen, d),
            "q": init_dense(gen, d, d),
            "k": init_dense(gen, d, d, bias=False),
            "v": init_dense(gen, d, d),
            "out": init_dense(gen, d, d),
            "mlp_ln": init_layer_norm(gen, d),
            "ff1": init_dense(gen, d, cfg.ffn_dim),
            "ff2": init_dense(gen, cfg.ffn_dim, d),
        }

    return {
        "conv1": init_conv1d(gen, cfg.n_mels, d, 3),
        "conv2": init_conv1d(gen, d, d, 3),
        "layers": [attn_block() for _ in range(cfg.num_layers)],
        "project_down": init_dense(gen, d, cfg.fsq_dim),
    }


def _block(p, cfg, x, bias):
    b, t, d = x.shape
    h = layer_norm(p["attn_ln"], x)
    hd = d // cfg.num_heads

    def heads(y):
        return y.reshape(b, t, cfg.num_heads, hd).transpose(1, 2)

    q, k, v = heads(dense(p["q"], h)), heads(dense(p["k"], h)), heads(dense(p["v"], h))
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
    scores = scores.float() + bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    att = torch.einsum("bhqk,bhkd->bhqd", probs, v).transpose(1, 2).reshape(b, t, d)
    x = x + dense(p["out"], att)
    h = layer_norm(p["mlp_ln"], x)
    return x + dense(p["ff2"], F.gelu(dense(p["ff1"], h)))


def fsq_quantize(z: torch.Tensor, levels: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Finite scalar quantization with S3Tokenizer's exact semantics.

    h = tanh(z) * half * FSQ_TANH_SCALE; digits = round(h) + half (round
    half to even, as ``jnp.round``); code = sum(digits * levels^i).  Returns
    (codes int32, quantized z in [-1, 1] with straight-through gradients).
    """
    half = (levels - 1) / 2.0
    bounded = torch.tanh(z) * (half * FSQ_TANH_SCALE)
    rounded = torch.round(bounded)
    quantized = bounded + (rounded - bounded).detach()
    digits = (rounded + half).to(torch.int32)  # in [0, levels)
    basis = levels ** torch.arange(z.shape[-1], dtype=torch.int32, device=z.device)
    codes = (digits * basis).sum(dim=-1, dtype=torch.int32)
    return codes, quantized / half


def fsq_embed(codes: torch.Tensor, dim: int, levels: int) -> torch.Tensor:
    """codes -> normalized quantized vector (inverse of fsq_quantize's index)."""
    half = (levels - 1) / 2.0
    basis = levels ** torch.arange(dim, dtype=torch.int32, device=codes.device)
    digits = torch.div(codes[..., None], basis, rounding_mode="floor") % levels
    return (digits.float() - half) / half


def conv_out_len(length, stride: int, kernel: int = 3, padding: int = 1):
    return (length + 2 * padding - kernel) // stride + 1


def encode_z(
    params: dict,
    cfg: SpeechTokenizerConfig,
    mel: torch.Tensor,
    mel_len: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The encoder before the FSQ head: mel (B, n_mels, T at 100 fps) ->
    (z (B, T', fsq_dim), valid (B, T') bool, code_len (B,)).

    Conv front-end: gelu(conv k3 s2) -> gelu(conv k3 s2), whisper positions
    (or the table an ONNX export froze, ``positional_embedding``), then
    num_layers attention blocks over the valid frames and ``project_down``.
    """
    x = F.gelu(conv1d(params["conv1"], mel, stride=cfg.conv_strides[0], padding=1))
    x = F.gelu(conv1d(params["conv2"], x, stride=cfg.conv_strides[1], padding=1))
    x = x.transpose(1, 2)  # (B, T', D)
    t = x.shape[1]
    if "positional_embedding" in params:  # the table frozen into an ONNX export
        x = x + params["positional_embedding"][:t].to(x.dtype)
    else:
        x = x + _sinusoid_pos(t, cfg.d_model, x.device).to(x.dtype)

    code_len = mel_len
    for s in cfg.conv_strides:
        code_len = conv_out_len(code_len, s)
    valid = make_non_pad_mask(code_len, t)
    bias = torch.where(valid, 0.0, NEG_INF)[:, None, None, :]
    for p in params["layers"]:
        x = _block(p, cfg, x, bias)
    return dense(params["project_down"], x), valid, code_len


def encode(
    params: dict,
    cfg: SpeechTokenizerConfig,
    mel: torch.Tensor,
    mel_len: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """mel (B, n_mels, T at 100 fps) -> (codes (B, T//downsample), code_len);
    codes past a row's length are 0."""
    z, valid, code_len = encode_z(params, cfg, mel, mel_len)
    codes, _ = fsq_quantize(z, cfg.fsq_levels)
    return torch.where(valid, codes, 0), code_len
