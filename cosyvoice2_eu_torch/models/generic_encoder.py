"""The generic Transformer/Conformer encoder family (the ESPnet-derived zoo), in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/models/generic_encoder.py``: every input
layer (linear, linear_legacy, embed, conv1d2, conv2d, conv2d6, conv2d8), the
absolute, whisper, learnable, legacy relative and ESPnet relative position
encodings, multi-head attention with the ESPnet ``pos_bias_u``/``pos_bias_v``
split and relative shift, the convolution module (causal or not, batch or
layer norm), macaron FFN, pre- and post-LN, static chunk masks, and
KV-cached chunk streaming.  The v1 family runs its text encoder, its speech
LM and its flow encoder on it.

Attention is plain PyTorch (masked softmax over an additive -1e10 bias), as
the JAX function computes it by einsum.  The streaming cache is a
right-aligned window of ``cache_t`` keys with a fill counter, as in the JAX
package; the offsets are host integers.  ``convert_generic_encoder`` maps a
reference ``state_dict()`` onto these trees key for key.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from cosyvoice2_eu_torch.config import GenericEncoderConfig
from cosyvoice2_eu_torch.models.encoder import espnet_rel_pos_emb, rel_shift
from cosyvoice2_eu_torch.ops.masks import NEG_INF, chunk_attention_mask, make_non_pad_mask
from cosyvoice2_eu_torch.registry import ACTIVATIONS, validate_encoder_names
from cosyvoice2_eu_torch.utils.params import (
    batch_norm1d,
    conv1d,
    conv2d,
    dense,
    embedding,
    init_batch_norm,
    init_conv1d,
    init_conv2d,
    init_dense,
    init_embedding,
    init_layer_norm,
    init_uniform,
    layer_norm,
)

# (subsampling rate, right context) of each input layer
_SUBSAMPLE_INFO = {
    "linear": (1, 0),
    "linear_legacy": (1, 0),
    "embed": (1, 0),
    "conv1d2": (2, 4),
    "conv2d": (4, 6),
    "conv2d6": (6, 10),
    "conv2d8": (8, 14),
}


def subsample_info(input_layer: str) -> tuple[int, int]:
    """(subsampling_rate, right_context) of an input layer."""
    return _SUBSAMPLE_INFO[input_layer]


# ---------------------------------------------------------------------------
# positional tables
# ---------------------------------------------------------------------------

def sinusoid_pos_table(max_len: int, d_model: int) -> np.ndarray:
    """Interleaved sin/cos table (the reference's PositionalEncoding)."""
    pe = np.zeros((max_len, d_model), np.float32)
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def whisper_pos_table(max_len: int, d_model: int) -> np.ndarray:
    """Half-sin/half-cos table (the reference's WhisperPositionalEncoding)."""
    inc = math.log(10000.0) / (d_model // 2 - 1)
    inv = np.exp(-inc * np.arange(d_model // 2, dtype=np.float32))
    t = np.arange(max_len, dtype=np.float32)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def _abs_pos_table(cfg: GenericEncoderConfig) -> np.ndarray:
    if cfg.pos_enc_layer_type == "abs_pos_whisper":
        return whisper_pos_table(cfg.max_len, cfg.output_size)
    return sinusoid_pos_table(cfg.max_len, cfg.output_size)


def _xscale(cfg: GenericEncoderConfig) -> float:
    if cfg.pos_enc_layer_type in ("abs_pos_whisper", "embed_learnable_pe", "no_pos"):
        return 1.0
    return math.sqrt(cfg.output_size)


def _is_rel_attn(cfg: GenericEncoderConfig) -> bool:
    return cfg.selfattention_layer_type == "rel_selfattn"


def _pos_table(params, cfg, dtype, device) -> torch.Tensor:
    if cfg.pos_enc_layer_type == "embed_learnable_pe":
        return params["embed"]["pos_pe"].to(dtype)
    return torch.as_tensor(_abs_pos_table(cfg), device=device).to(dtype)


def _pos_for_queries(params, cfg, offset: int, size: int, dtype, device) -> torch.Tensor:
    """Positional rows for query positions [offset, offset + size), the
    start clamped into the table as a dynamic slice is."""
    if cfg.pos_enc_layer_type == "no_pos":
        return torch.zeros((size, cfg.output_size), dtype=dtype, device=device)
    table = _pos_table(params, cfg, dtype, device)
    start = min(max(offset, 0), table.shape[0] - size)
    return table[start:start + size]


def _pos_for_keys(params, cfg, start: int, size: int, dtype, device) -> torch.Tensor:
    """Positional rows for key positions [start, start + size), each index
    clamped into the table (``start`` may be negative for unfilled cache
    slots, which the mask hides)."""
    if cfg.pos_enc_layer_type == "no_pos":
        return torch.zeros((size, cfg.output_size), dtype=dtype, device=device)
    table = _pos_table(params, cfg, dtype, device)
    idx = (start + torch.arange(size, device=device)).clamp(0, table.shape[0] - 1)
    return table[idx]


# ---------------------------------------------------------------------------
# input layers
# ---------------------------------------------------------------------------

def init_input_layer(gen, cfg: GenericEncoderConfig) -> dict:
    d, idim = cfg.output_size, cfg.input_size
    kind = cfg.input_layer
    if kind in ("linear", "linear_legacy"):
        p = {"linear": init_dense(gen, idim, d), "norm": init_layer_norm(gen, d)}
    elif kind == "embed":
        if cfg.vocab_size <= 0:
            raise ValueError("input_layer='embed' requires vocab_size > 0")
        p = {"embedding": init_embedding(gen, cfg.vocab_size, d)}
    elif kind == "conv1d2":
        p = {"conv1": init_conv1d(gen, idim, d, 3), "conv2": init_conv1d(gen, d, d, 3)}
    elif kind == "conv2d":
        f = ((idim - 1) // 2 - 1) // 2
        p = {"conv1": init_conv2d(gen, 1, d, 3), "conv2": init_conv2d(gen, d, d, 3),
             "out": init_dense(gen, d * f, d)}
    elif kind == "conv2d6":
        f = ((idim - 1) // 2 - 2) // 3
        p = {"conv1": init_conv2d(gen, 1, d, 3), "conv2": init_conv2d(gen, d, d, 5),
             "out": init_dense(gen, d * f, d)}
    elif kind == "conv2d8":
        f = (((idim - 1) // 2 - 1) // 2 - 1) // 2
        p = {"conv1": init_conv2d(gen, 1, d, 3), "conv2": init_conv2d(gen, d, d, 3),
             "conv3": init_conv2d(gen, d, d, 3), "out": init_dense(gen, d * f, d)}
    else:
        raise ValueError(f"unknown input_layer {kind!r}")
    if cfg.pos_enc_layer_type == "embed_learnable_pe":
        p["pos_pe"] = 0.02 * torch.randn((cfg.max_len, d), generator=gen, device=gen.device)
    return p


def apply_input_layer(params, cfg: GenericEncoderConfig, xs, mask):
    """xs: (B, T, idim) (or (B, T) ids for 'embed') -> (x (B, T', D), mask
    (B, T')), slicing the mask as each reference subsampling class does."""
    p = params["embed"]
    kind = cfg.input_layer
    if kind == "linear":
        x = layer_norm(p["norm"], dense(p["linear"], xs), eps=1e-5)
    elif kind == "linear_legacy":
        x = F.relu(layer_norm(p["norm"], dense(p["linear"], xs), eps=1e-5))
    elif kind == "embed":
        x = embedding(p["embedding"], xs)
    elif kind == "conv1d2":
        h = xs.transpose(1, 2)
        h = F.gelu(conv1d(p["conv1"], h, padding=1))
        h = F.gelu(conv1d(p["conv2"], h, stride=2, padding=1))
        x = h.transpose(1, 2)
        t = xs.shape[1]
        mask = mask[:, (t + 1) % 2::2]
    elif kind in ("conv2d", "conv2d6", "conv2d8"):
        h = xs[:, None]  # (B, 1, T, F)
        h = F.relu(conv2d(p["conv1"], h, stride=2))
        h = F.relu(conv2d(p["conv2"], h, stride=3 if kind == "conv2d6" else 2))
        if kind == "conv2d8":
            h = F.relu(conv2d(p["conv3"], h, stride=2))
        b, c, t, f = h.shape
        x = dense(p["out"], h.transpose(1, 2).reshape(b, t, c * f))
        mask = mask[:, 2::2]
        mask = mask[:, 4::3] if kind == "conv2d6" else mask[:, 2::2]
        if kind == "conv2d8":
            mask = mask[:, 2::2]
    else:
        raise ValueError(kind)
    return x, mask[:, :x.shape[1]]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_self_attention(gen, cfg: GenericEncoderConfig) -> dict:
    d, h = cfg.output_size, cfg.attention_heads
    p = {
        "linear_q": init_dense(gen, d, d),
        "linear_k": init_dense(gen, d, d, bias=cfg.key_bias),
        "linear_v": init_dense(gen, d, d),
        "linear_out": init_dense(gen, d, d),
    }
    if _is_rel_attn(cfg):
        d_k = d // h
        bound = math.sqrt(6.0 / (h + d_k) / 2)
        p["linear_pos"] = init_dense(gen, d, d, bias=False)
        p["pos_bias_u"] = init_uniform(gen, (h, d_k), -bound, bound)
        p["pos_bias_v"] = init_uniform(gen, (h, d_k), -bound, bound)
    return p


def _attention_core(p, cfg: GenericEncoderConfig, q, k, v, pos_emb, mask):
    """q: (B, Tq, H, dk); k/v: (B, H, Tk, dk); mask: (B, Tq|1, Tk) bool.

    ``pos_emb`` (P, D): P == 2 Tq - 1 is the ESPnet table and takes the
    relative shift; P == Tk is one row per key (legacy rel_pos, streaming).
    Only the rel_selfattn variant reads it.
    """
    b, tq, h, d_k = q.shape
    tk = k.shape[2]
    if _is_rel_attn(cfg):
        q_u = (q + p["pos_bias_u"].to(q.dtype)).transpose(1, 2)
        q_v = (q + p["pos_bias_v"].to(q.dtype)).transpose(1, 2)
        scores = q_u @ k.transpose(-1, -2)
        pe = dense(p["linear_pos"], pos_emb).reshape(-1, h, d_k).transpose(0, 1)
        bd = torch.einsum("bhqd,hnd->bhqn", q_v, pe)
        if pos_emb.shape[0] != tk:
            bd = rel_shift(bd)  # (B, H, Tq, 2 Tq - 1) -> (B, H, Tq, Tq)
        scores = scores + bd[..., :tk]
    else:
        scores = q.transpose(1, 2) @ k.transpose(-1, -2)
    scores = scores.float() / math.sqrt(d_k)
    scores = scores + torch.where(mask, 0.0, NEG_INF)[:, None]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = probs @ v
    return dense(p["linear_out"], out.transpose(1, 2).reshape(b, tq, h * d_k))


def _qkv(p, cfg: GenericEncoderConfig, x):
    b, t, d = x.shape
    h = cfg.attention_heads
    d_k = d // h
    q = dense(p["linear_q"], x).reshape(b, t, h, d_k)
    k = dense(p["linear_k"], x).reshape(b, t, h, d_k).transpose(1, 2)
    v = dense(p["linear_v"], x).reshape(b, t, h, d_k).transpose(1, 2)
    return q, k, v


def self_attention(p, cfg: GenericEncoderConfig, x, pos_emb, mask):
    """Full-utterance self-attention.  x: (B, T, D); mask: (B, T, T)."""
    q, k, v = _qkv(p, cfg, x)
    return _attention_core(p, cfg, q, k, v, pos_emb, mask)


# ---------------------------------------------------------------------------
# convolution module
# ---------------------------------------------------------------------------

def init_conv_module(gen, cfg: GenericEncoderConfig) -> dict:
    d = cfg.output_size
    p = {
        "pointwise_conv1": init_conv1d(gen, d, 2 * d, 1),
        "depthwise_conv": init_conv1d(gen, d, d, cfg.cnn_module_kernel, groups=d),
        "pointwise_conv2": init_conv1d(gen, d, d, 1),
    }
    p["norm"] = (init_batch_norm(gen, d) if cfg.cnn_module_norm == "batch_norm"
                 else init_layer_norm(gen, d))
    return p


def conv_module(p, cfg: GenericEncoderConfig, x, mask_pad,
                cache: Optional[torch.Tensor] = None):
    """x: (B, T, D); mask_pad: (B, T) bool valid; cache: (B, D, lorder) for
    causal streaming.  Returns (y (B, T, D), new_cache)."""
    act = ACTIVATIONS[cfg.activation_type]
    lorder = cfg.cnn_module_kernel - 1 if cfg.causal else 0
    h = (x * mask_pad[..., None].to(x.dtype)).transpose(1, 2)  # (B, D, T)
    new_cache = None
    if lorder > 0:
        if cache is None:
            cache = torch.zeros((h.shape[0], h.shape[1], lorder), dtype=h.dtype, device=h.device)
        h = torch.cat([cache, h], dim=2)
        new_cache = h[:, :, -lorder:]
        pad = 0
    else:
        pad = (cfg.cnn_module_kernel - 1) // 2
    a, g = conv1d(p["pointwise_conv1"], h).chunk(2, dim=1)
    h = a * torch.sigmoid(g)  # GLU over channels
    h = conv1d(p["depthwise_conv"], h, padding=pad, groups=cfg.output_size)
    if cfg.cnn_module_norm == "batch_norm":
        h = act(batch_norm1d(p["norm"], h))
    else:
        h = act(layer_norm(p["norm"], h.transpose(1, 2), eps=1e-5).transpose(1, 2))
    h = conv1d(p["pointwise_conv2"], h)
    return h.transpose(1, 2) * mask_pad[..., None].to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# encoder layers
# ---------------------------------------------------------------------------

def _init_ffn(gen, cfg: GenericEncoderConfig) -> dict:
    return {"w_1": init_dense(gen, cfg.output_size, cfg.linear_units),
            "w_2": init_dense(gen, cfg.linear_units, cfg.output_size)}


def _ffn(p, cfg, x):
    return dense(p["w_2"], ACTIVATIONS[cfg.activation_type](dense(p["w_1"], x)))


def init_encoder_layer(gen, cfg: GenericEncoderConfig) -> dict:
    d = cfg.output_size
    p = {"self_attn": init_self_attention(gen, cfg), "feed_forward": _init_ffn(gen, cfg)}
    if cfg.arch == "transformer":
        p["norm1"] = init_layer_norm(gen, d)
        p["norm2"] = init_layer_norm(gen, d)
        return p
    p["norm_mha"] = init_layer_norm(gen, d)
    p["norm_ff"] = init_layer_norm(gen, d)
    if cfg.macaron_style:
        p["feed_forward_macaron"] = _init_ffn(gen, cfg)
        p["norm_ff_macaron"] = init_layer_norm(gen, d)
    if cfg.use_cnn_module:
        p["conv_module"] = init_conv_module(gen, cfg)
        p["norm_conv"] = init_layer_norm(gen, d)
        p["norm_final"] = init_layer_norm(gen, d)
    return p


def _attend(p, cfg, x, pos_emb, mask, kv_cache):
    """Full attention, or attention over the cache window and x."""
    if kv_cache is None:
        return self_attention(p, cfg, x, pos_emb, mask), None
    q, k, v = _qkv(p, cfg, x)
    k_full = torch.cat([kv_cache[0], k], dim=2)
    v_full = torch.cat([kv_cache[1], v], dim=2)
    out = _attention_core(p, cfg, q, k_full, v_full, pos_emb, mask)
    t = x.shape[1]
    return out, (k_full[:, :, t:], v_full[:, :, t:])  # right-aligned: drop the oldest t


def encoder_layer(p, cfg: GenericEncoderConfig, x, pos_emb, mask, mask_pad,
                  kv_cache=None, cnn_cache=None):
    """One Transformer/Conformer block -> (x, new_kv_cache, new_cnn_cache).
    ``normalize_before`` True is pre-LN, False post-LN."""
    eps = cfg.layer_norm_eps
    pre = cfg.normalize_before
    new_kv = [None]

    def sub(norm_key, fn, x):
        h = layer_norm(p[norm_key], x, eps) if pre else x
        y = x + fn(h)
        return y if pre else layer_norm(p[norm_key], y, eps)

    def attn(h):
        out, new_kv[0] = _attend(p["self_attn"], cfg, h, pos_emb, mask, kv_cache)
        return out

    if cfg.arch == "transformer":
        x = sub("norm1", attn, x)
        x = sub("norm2", lambda h: _ffn(p["feed_forward"], cfg, h), x)
        return x, new_kv[0], None

    ff_scale = 0.5 if cfg.macaron_style else 1.0
    if cfg.macaron_style:
        x = sub("norm_ff_macaron", lambda h: ff_scale * _ffn(p["feed_forward_macaron"], cfg, h), x)
    x = sub("norm_mha", attn, x)
    new_cnn = None
    if cfg.use_cnn_module:
        h = layer_norm(p["norm_conv"], x, eps) if pre else x
        y, new_cnn = conv_module(p["conv_module"], cfg, h, mask_pad, cnn_cache)
        x = x + y
        if not pre:
            x = layer_norm(p["norm_conv"], x, eps)
    x = sub("norm_ff", lambda h: ff_scale * _ffn(p["feed_forward"], cfg, h), x)
    if cfg.use_cnn_module:
        x = layer_norm(p["norm_final"], x, eps)
    return x, new_kv[0], new_cnn


# ---------------------------------------------------------------------------
# full encoder
# ---------------------------------------------------------------------------

def init_generic_encoder(gen, cfg: GenericEncoderConfig) -> dict:
    validate_encoder_names(cfg)
    return {
        "embed": init_input_layer(gen, cfg),
        "encoders": [init_encoder_layer(gen, cfg) for _ in range(cfg.num_blocks)],
        "after_norm": init_layer_norm(gen, cfg.output_size),
    }


def full_pos_emb(params, cfg: GenericEncoderConfig, t: int, dtype, device) -> torch.Tensor:
    """The positional rows a full-utterance forward of T frames attends with."""
    if not _is_rel_attn(cfg):
        return _pos_for_queries(params, cfg, 0, t, dtype, device)
    if cfg.pos_enc_layer_type == "rel_pos_espnet":
        return espnet_rel_pos_emb(t, cfg.output_size, device=device, dtype=dtype)
    return _pos_for_keys(params, cfg, 0, t, dtype, device)  # legacy rel_pos


def _adds_abs_pos(cfg: GenericEncoderConfig) -> bool:
    return cfg.pos_enc_layer_type in ("abs_pos", "abs_pos_whisper", "embed_learnable_pe")


def generic_encoder_forward(params: dict, cfg: GenericEncoderConfig, xs: torch.Tensor,
                            xs_lens: torch.Tensor, decoding_chunk_size: int = 0,
                            num_decoding_left_chunks: int = -1):
    """Full-utterance forward.

    xs: (B, T, input_size), or (B, T) ids for input_layer 'embed'; xs_lens:
    (B,).  decoding_chunk_size 0 takes the config's static chunk, < 0 full
    attention, > 0 that chunk with ``num_decoding_left_chunks``.  Returns
    (ys (B, T', D), valid (B, T') bool).
    """
    valid = make_non_pad_mask(xs_lens, xs.shape[1])
    x, valid = apply_input_layer(params, cfg, xs, valid)
    t = x.shape[1]
    sub_lens = valid.to(torch.int32).sum(1)
    x = x * _xscale(cfg)
    if _adds_abs_pos(cfg):
        x = x + _pos_for_queries(params, cfg, 0, t, x.dtype, x.device)[None]
    pos_emb = full_pos_emb(params, cfg, t, x.dtype, x.device)
    if decoding_chunk_size < 0:
        chunk, n_left = 0, -1
    elif decoding_chunk_size > 0:
        chunk, n_left = decoding_chunk_size, num_decoding_left_chunks
    else:
        chunk, n_left = cfg.static_chunk_size, -1
    mask = chunk_attention_mask(sub_lens, t, chunk, n_left)
    for lp in params["encoders"]:
        x, _, _ = encoder_layer(lp, cfg, x, pos_emb, mask, valid)
    if cfg.normalize_before:
        x = layer_norm(params["after_norm"], x, eps=1e-5)
    return x, valid


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------

def init_chunk_state(cfg: GenericEncoderConfig, cache_t: int, batch: int = 1,
                     dtype=torch.float32, device="cpu") -> dict:
    """A right-aligned streaming cache of ``cache_t`` keys per layer;
    ``filled`` counts the valid right-most slots, ``offset`` the frames
    emitted so far.  ESPnet relative positions raise ``ValueError``: the
    reference's own forward_chunk is not defined for them."""
    if cfg.pos_enc_layer_type == "rel_pos_espnet":
        raise ValueError("chunk streaming is not defined for rel_pos_espnet "
                         "(matches the reference encoder's own constraint)")
    d_k = cfg.output_size // cfg.attention_heads
    lorder = (cfg.cnn_module_kernel - 1
              if cfg.arch == "conformer" and cfg.use_cnn_module and cfg.causal else 0)
    kv = (cfg.num_blocks, batch, cfg.attention_heads, cache_t, d_k)
    return {
        "att_k": torch.zeros(kv, dtype=dtype, device=device),
        "att_v": torch.zeros(kv, dtype=dtype, device=device),
        "cnn": torch.zeros((cfg.num_blocks, batch, cfg.output_size, lorder), dtype=dtype,
                           device=device),
        "offset": 0,
        "filled": 0,
    }


def generic_encoder_forward_chunk(params: dict, cfg: GenericEncoderConfig, state: dict,
                                  xs: torch.Tensor):
    """One streaming chunk.  xs: (B, time, input_size), time = (chunk - 1) x
    subsampling + right context + 1.  Returns (ys, new_state)."""
    b = xs.shape[0]
    dev = xs.device
    x, _ = apply_input_layer(params, cfg, xs, torch.ones((b, xs.shape[1]), dtype=torch.bool,
                                                         device=dev))
    t = x.shape[1]
    cache_t = state["att_k"].shape[3]
    offset, filled = state["offset"], state["filled"]
    x = x * _xscale(cfg)
    if _adds_abs_pos(cfg):
        x = x + _pos_for_queries(params, cfg, offset, t, x.dtype, dev)[None]
    # keys at absolute positions [offset - cache_t, offset + t); unfilled slots masked
    pos_emb = (_pos_for_keys(params, cfg, offset - cache_t, cache_t + t, x.dtype, dev)
               if _is_rel_attn(cfg) else _pos_for_queries(params, cfg, 0, t, x.dtype, dev))
    key_valid = torch.arange(cache_t + t, device=dev) >= (cache_t - filled)
    mask = key_valid[None, None, :].expand(b, t, cache_t + t)
    mask_pad = torch.ones((b, t), dtype=torch.bool, device=dev)
    new_k, new_v, new_cnn = [], [], []
    for i, lp in enumerate(params["encoders"]):
        kv = (state["att_k"][i], state["att_v"][i])
        cnn = state["cnn"][i] if state["cnn"].shape[-1] > 0 else None
        x, kv_out, cnn_out = encoder_layer(lp, cfg, x, pos_emb, mask, mask_pad, kv, cnn)
        new_k.append(kv_out[0])
        new_v.append(kv_out[1])
        new_cnn.append(cnn_out if cnn_out is not None else state["cnn"][i])
    if cfg.normalize_before:
        x = layer_norm(params["after_norm"], x, eps=1e-5)
    return x, {"att_k": torch.stack(new_k), "att_v": torch.stack(new_v),
               "cnn": torch.stack(new_cnn), "offset": offset + t,
               "filled": min(filled + t, cache_t)}


def generic_encoder_forward_chunk_by_chunk(params: dict, cfg: GenericEncoderConfig,
                                           xs: torch.Tensor, decoding_chunk_size: int,
                                           num_decoding_left_chunks: int = -1):
    """Streams ``xs`` in overlapping windows, chunk by chunk.  -1 left chunks
    sizes the cache to every chunk of the utterance (unlimited left
    context).  Returns (ys, masks)."""
    if decoding_chunk_size <= 0:
        raise ValueError("decoding_chunk_size must be positive")
    subsampling, right_context = subsample_info(cfg.input_layer)
    context = right_context + 1
    stride = subsampling * decoding_chunk_size
    window = (decoding_chunk_size - 1) * subsampling + context
    starts = range(0, xs.shape[1] - context + 1, stride)
    n_left = num_decoding_left_chunks if num_decoding_left_chunks >= 0 else max(len(starts), 1)
    state = init_chunk_state(cfg, decoding_chunk_size * n_left, xs.shape[0], xs.dtype, xs.device)
    outputs = []
    for cur in starts:
        y, state = generic_encoder_forward_chunk(params, cfg, state, xs[:, cur:cur + window])
        outputs.append(y)
    ys = torch.cat(outputs, dim=1)
    return ys, torch.ones(ys.shape[:2], dtype=torch.bool, device=ys.device)


# ---------------------------------------------------------------------------
# reference state-dict conversion
# ---------------------------------------------------------------------------

def convert_generic_encoder(state, cfg: GenericEncoderConfig) -> dict:
    """A reference TransformerEncoder/ConformerEncoder ``state_dict()`` (a
    ``runtime.checkpoint._State`` or a dict of numpy arrays) -> this
    module's tree, key for key."""
    from cosyvoice2_eu_torch.runtime.checkpoint import _State

    s = state if isinstance(state, _State) else _State(state)
    kind = cfg.input_layer
    if kind in ("linear", "linear_legacy"):
        embed = {"linear": s.linear("embed.out.0"), "norm": s.norm("embed.out.1")}
    elif kind == "embed":
        embed = {"embedding": {"weight": s.take("embed.embed.weight")}}
    elif kind == "conv1d2":
        embed = {"conv1": s.linear("embed.conv.0"), "conv2": s.linear("embed.conv.2")}
    elif kind == "conv2d":
        embed = {"conv1": s.linear("embed.conv.0"), "conv2": s.linear("embed.conv.2"),
                 "out": s.linear("embed.out.0")}
    elif kind in ("conv2d6", "conv2d8"):
        embed = {"conv1": s.linear("embed.conv.0"), "conv2": s.linear("embed.conv.2"),
                 "out": s.linear("embed.linear")}
        if kind == "conv2d8":
            embed["conv3"] = s.linear("embed.conv.4")
    else:
        raise ValueError(kind)
    if cfg.pos_enc_layer_type == "embed_learnable_pe":
        embed["pos_pe"] = s.take("embed.pos_enc.pe")[0]

    def ffn(pre):
        return {"w_1": s.linear(f"{pre}.w_1"), "w_2": s.linear(f"{pre}.w_2")}

    layers = []
    for i in range(cfg.num_blocks):
        pre = f"encoders.{i}"
        attn = {name: s.linear(f"{pre}.self_attn.{name}")
                for name in ("linear_q", "linear_k", "linear_v", "linear_out")}
        if _is_rel_attn(cfg):
            attn["linear_pos"] = s.linear(f"{pre}.self_attn.linear_pos", bias=False)
            attn["pos_bias_u"] = s.take(f"{pre}.self_attn.pos_bias_u")
            attn["pos_bias_v"] = s.take(f"{pre}.self_attn.pos_bias_v")
        lp = {"self_attn": attn, "feed_forward": ffn(f"{pre}.feed_forward")}
        if cfg.arch == "transformer":
            lp["norm1"] = s.norm(f"{pre}.norm1")
            lp["norm2"] = s.norm(f"{pre}.norm2")
        else:
            lp["norm_mha"] = s.norm(f"{pre}.norm_mha")
            lp["norm_ff"] = s.norm(f"{pre}.norm_ff")
            if cfg.macaron_style:
                lp["feed_forward_macaron"] = ffn(f"{pre}.feed_forward_macaron")
                lp["norm_ff_macaron"] = s.norm(f"{pre}.norm_ff_macaron")
            if cfg.use_cnn_module:
                cm = {name: s.linear(f"{pre}.conv_module.{name}")
                      for name in ("pointwise_conv1", "depthwise_conv", "pointwise_conv2")}
                cm["norm"] = s.norm(f"{pre}.conv_module.norm")
                if cfg.cnn_module_norm == "batch_norm":
                    cm["norm"]["running_mean"] = s.take(f"{pre}.conv_module.norm.running_mean")
                    cm["norm"]["running_var"] = s.take(f"{pre}.conv_module.norm.running_var")
                lp["conv_module"] = cm
                lp["norm_conv"] = s.norm(f"{pre}.norm_conv")
                lp["norm_final"] = s.norm(f"{pre}.norm_final")
        layers.append(lp)
    return {"embed": embed, "encoders": layers, "after_norm": s.norm("after_norm")}
