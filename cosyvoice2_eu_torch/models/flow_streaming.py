"""Chunk-cached streaming flow: O(T) per chunk instead of the O(T^2) recompute, in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/models/flow_streaming.py``.  Streaming
mode uses chunked causal attention (chunk 25 tokens / 50 mel frames, full
left context) and causal convolutions, so every position already computed
is a function of its past alone: per-layer K/V caches and small causal-conv
tail caches reproduce the full-prefix recompute
(``flow_inference(streaming=True, finalize=False)``) chunk by chunk.

Cache inventory of a session (``FlowStreamState``):
  * conformer token-rate and mel-rate stacks: per layer K/V (the rel-pos
    tables are per model, built once by ``prepare_stream_params``);
  * the pre-lookahead conv2 tail (2 frames) and the upsample conv tail (4);
  * estimator: per (Euler step, stage) the post-LayerNorm attention inputs,
    from which K/V are re-projected each chunk, and the (k-1)-frame input
    tails of its 31 causal convolutions.

The JAX functions return a new state; these update the state's tensors in
place and return it (a snapshot is a ``clone()``).

A state's cursor (``t_tok``, ``t_mel``) is a Python int, or a (B,) tensor
for a state that ``stack_states`` made of several sessions: each row then
writes its K/V, builds its mask and relative positions and takes its slice
of the fixed noise at its own cursor (the JAX package ``vmap``s
``flow_chunk`` over such rows, ``runtime/model.py::_stream_chunk_fused_batch_fn``).

Attention here is the JAX package's plain einsum and softmax (fp32 scores
plus the ``NEG_INF`` mask, probabilities cast back to the input dtype): no
kernel.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from cosyvoice2_eu_torch.config import FlowConfig
from cosyvoice2_eu_torch.models.encoder import _embed, espnet_rel_pos_emb
from cosyvoice2_eu_torch.models.estimator import _mish, sinusoidal_time_emb
from cosyvoice2_eu_torch.models.flow import cosine_t_span
from cosyvoice2_eu_torch.ops.masks import NEG_INF
from cosyvoice2_eu_torch.utils.params import conv1d, dense, embedding, layer_norm

# ---------------------------------------------------------------------------
# cached primitives
# ---------------------------------------------------------------------------


def causal_conv_cached(p, x_new, tail, dilation: int = 1):
    """Causal conv over a chunk given the (k-1)*dilation-frame input tail.

    x_new: (B, C, n); tail: (B, C, (k-1)*d).  Returns (y (B, C_out, n), new_tail).
    """
    ctx = (p["weight"].shape[-1] - 1) * dilation
    full = torch.cat([tail, x_new], dim=2)
    y = conv1d(p, full, dilation=dilation)
    return y, (full[:, :, full.shape[2] - ctx:] if ctx else tail)


def _at(t0, n: int):
    """Where ``n`` new positions from cursor ``t0`` go in a (B, T, ...)
    cache: a slice at an int cursor, per-row (rows, positions) indices at a
    (B,) tensor cursor."""
    if isinstance(t0, int):
        return slice(None), slice(t0, t0 + n)
    return (torch.arange(t0.shape[0], device=t0.device)[:, None],
            t0[:, None] + torch.arange(n, device=t0.device))


def _softmax_attend(scores, mask, v):
    """fp32 scores plus the NEG_INF mask (B, n, T) -> probabilities in v's dtype, times v."""
    scores = scores.float() + torch.where(mask, 0.0, NEG_INF)[:, None]
    return torch.softmax(scores, dim=-1).to(v.dtype) @ v


def attn_cached(q, k_new, v_new, k_cache, v_cache, t0: int, mask_new, scale: float):
    """Cached attention: write k_new/v_new at ``t0`` into the caches (in
    place), attend over every cache slot under ``mask_new``.

    q/k_new/v_new: (B, H, n, D); caches: (B, H, T_max, D); mask_new:
    (B, n, T_max) bool (True = attend).  Returns (out (B, H, n, D), k_cache,
    v_cache).
    """
    n = k_new.shape[2]
    k_cache[:, :, t0:t0 + n] = k_new.to(k_cache.dtype)
    v_cache[:, :, t0:t0 + n] = v_new.to(v_cache.dtype)
    scores = (q @ k_cache.to(q.dtype).transpose(-1, -2)) * scale
    return _softmax_attend(scores, mask_new, v_cache.to(q.dtype)), k_cache, v_cache


def _chunk_mask(t0, n: int, t_max: int, chunk: int, device=None) -> torch.Tensor:
    """(n, t_max) visibility of key j to query t0+i: j // chunk <= (t0+i) //
    chunk (chunked causality) and j < t0 + n (nothing beyond what exists).
    A (B,) tensor ``t0`` gives each row's mask, (B, n, t_max)."""
    start = t0 if isinstance(t0, int) else t0[:, None, None]
    q_abs = start + torch.arange(n, device=device)[:, None]
    j = torch.arange(t_max, device=device)[None, :]
    return ((j // chunk) <= (q_abs // chunk)) & (j < start + n)


def _rel_bd_cached(q_v, p_table, t0, t_max: int):
    """bd[i, j] = q_v[i] . P[(L-1) - (t0+i - j)]: a full-offset product, then
    a gather on clipped indices (the exact rel_shift of the recompute).

    q_v: (B, H, n, dk); p_table: (2L-1, H, dk); t0 an int or a (B,) tensor.
    Returns (B, H, n, t_max)."""
    b, h, n, _ = q_v.shape
    L = t_max
    bd_all = torch.einsum("bhnd,mhd->bhnm", q_v, p_table)  # (B, H, n, 2L-1)
    start = t0 if isinstance(t0, int) else t0[:, None, None]
    abs_i = start + torch.arange(n, device=q_v.device)[:, None]
    j = torch.arange(t_max, device=q_v.device)[None, :]
    idx = ((L - 1) - (abs_i - j)).clamp(0, 2 * L - 2)
    return torch.gather(bd_all, -1, idx.reshape(-1, 1, n, t_max).expand(b, h, n, t_max))


def conformer_layer_cached(lp, heads: int, x_new, p_table, cache_k, cache_v, t0, mask,
                           eps: float = 1e-12):
    """One rel-pos conformer block over n new frames at ``t0`` (an int or a
    (B,) tensor); writes their K/V into ``cache_k``/``cache_v`` (B, H,
    T_max, dk) in place.
    Returns (x (B, n, D), cache_k, cache_v)."""
    b, n, dim = x_new.shape
    dk = dim // heads
    sa = lp["self_attn"]
    h = layer_norm(lp["norm_mha"], x_new, eps)
    q = dense(sa["linear_q"], h).reshape(b, n, heads, dk)
    k = dense(sa["linear_k"], h).reshape(b, n, heads, dk).transpose(1, 2)
    v = dense(sa["linear_v"], h).reshape(b, n, heads, dk).transpose(1, 2)
    q_u = (q + sa["pos_bias_u"].to(x_new.dtype)).transpose(1, 2)
    q_v = (q + sa["pos_bias_v"].to(x_new.dtype)).transpose(1, 2)

    at = _at(t0, n)
    cache_k.transpose(1, 2)[at] = k.transpose(1, 2).to(cache_k.dtype)
    cache_v.transpose(1, 2)[at] = v.transpose(1, 2).to(cache_v.dtype)
    ac = q_u @ cache_k.to(q_u.dtype).transpose(-1, -2)
    bd = _rel_bd_cached(q_v, p_table, t0, cache_k.shape[2])
    att = _softmax_attend((ac + bd) / math.sqrt(dk), mask, cache_v.to(x_new.dtype))
    x = x_new + dense(sa["linear_out"], att.transpose(1, 2).reshape(b, n, dim))
    h = layer_norm(lp["norm_ff"], x, eps)
    return x + dense(lp["ffn_w2"], F.silu(dense(lp["ffn_w1"], h))), cache_k, cache_v


# ---------------------------------------------------------------------------
# full streaming flow state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FlowStreamState:
    pre_k: torch.Tensor  # (L1, B, H, T_tok, dk) conformer token-rate stack
    pre_v: torch.Tensor
    lookahead_tail: torch.Tensor  # (B, D, 2) conv2 input tail
    up_conv_tail: torch.Tensor  # (B, D, stride*2) upsample conv input tail
    up_k: torch.Tensor  # (L2, B, H, T_mel, dk) conformer mel-rate stack
    up_v: torch.Tensor
    # the estimator's POST-LayerNorm attention inputs (steps, stages, 2B,
    # T_mel, ch): K/V are re-projected from them each chunk (linear and
    # bias-free, so the history equals caching K/V, at a quarter of the bytes)
    est_h: torch.Tensor
    conv_tails: dict  # site -> (steps, 2B, C, k-1); mid sites (mid, steps, 2B, C, k-1)
    t_tok: int | torch.Tensor = 0  # tokens cached so far ((B,) for a stacked state)
    t_mel: int | torch.Tensor = 0

    def tensors(self) -> list:
        return [self.pre_k, self.pre_v, self.lookahead_tail, self.up_conv_tail, self.up_k,
                self.up_v, self.est_h, *self.conv_tails.values()]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())

    def clone(self) -> "FlowStreamState":
        """A deep copy: chunks update a state in place."""
        return dataclasses.replace(
            self, pre_k=self.pre_k.clone(), pre_v=self.pre_v.clone(),
            lookahead_tail=self.lookahead_tail.clone(), up_conv_tail=self.up_conv_tail.clone(),
            up_k=self.up_k.clone(), up_v=self.up_v.clone(), est_h=self.est_h.clone(),
            conv_tails={k: v.clone() for k, v in self.conv_tails.items()})


def init_flow_stream_state(cfg: FlowConfig, t_tok_max: int, dtype=torch.bfloat16,
                           batch: int = 1, device=None) -> FlowStreamState:
    """Zeroed caches for ``t_tok_max`` tokens (``device="meta"`` sizes one
    without allocating it)."""
    enc, est = cfg.encoder, cfg.estimator
    t_mel_max = t_tok_max * enc.upsample_stride
    h1 = enc.attention_heads
    dk = enc.output_size // h1
    steps = cfg.cfm.n_timesteps
    stages = 2 + est.num_mid_blocks
    ch = est.channels[0]
    b2 = 2 * batch  # CFG double batch
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    conv_tails = {
        # 31 causal-conv sites; tails keyed by site name
        "down_b1": zeros(steps, b2, est.in_channels, 2),
        "down_b2": zeros(steps, b2, ch, 2),
        "down_conv": zeros(steps, b2, ch, 2),
        "mid_b1": zeros(est.num_mid_blocks, steps, b2, ch, 2),
        "mid_b2": zeros(est.num_mid_blocks, steps, b2, ch, 2),
        "up_b1": zeros(steps, b2, ch * 2, 2),
        "up_b2": zeros(steps, b2, ch, 2),
        "up_conv": zeros(steps, b2, ch, 2),
        "final_b": zeros(steps, b2, ch, 2),
    }
    return FlowStreamState(
        pre_k=zeros(enc.num_blocks, batch, h1, t_tok_max, dk),
        pre_v=zeros(enc.num_blocks, batch, h1, t_tok_max, dk),
        lookahead_tail=zeros(batch, enc.output_size, 2),
        up_conv_tail=zeros(batch, enc.output_size, enc.upsample_stride * 2),
        up_k=zeros(enc.num_up_blocks, batch, h1, t_mel_max, dk),
        up_v=zeros(enc.num_up_blocks, batch, h1, t_mel_max, dk),
        est_h=zeros(steps, stages, b2, t_mel_max, ch),
        conv_tails=conv_tails,
    )


def _cfg_dim(site: str) -> int:
    """The CFG double-batch dimension of a conv-tail site."""
    return 2 if site.startswith("mid_") else 1


def stack_states(states: list) -> FlowStreamState:
    """One state over several single-session states, row i from
    ``states[i]``, its cursors a (B,) tensor.  The estimator's caches hold
    the B cond rows, then the B uncond rows, as a batched chunk runs them
    (each session's own cache holds its cond row, then its uncond row)."""
    def rows(get, dim):
        return torch.cat([get(s) for s in states], dim=dim)

    def cfg_rows(get, dim):
        return torch.cat([get(s).narrow(dim, half, 1) for half in (0, 1) for s in states],
                         dim=dim)

    dev = states[0].pre_k.device
    return FlowStreamState(
        pre_k=rows(lambda s: s.pre_k, 1), pre_v=rows(lambda s: s.pre_v, 1),
        lookahead_tail=rows(lambda s: s.lookahead_tail, 0),
        up_conv_tail=rows(lambda s: s.up_conv_tail, 0),
        up_k=rows(lambda s: s.up_k, 1), up_v=rows(lambda s: s.up_v, 1),
        est_h=cfg_rows(lambda s: s.est_h, 2),
        conv_tails={k: cfg_rows(lambda s, k=k: s.conv_tails[k], _cfg_dim(k))
                    for k in states[0].conv_tails},
        t_tok=torch.tensor([s.t_tok for s in states], device=dev),
        t_mel=torch.tensor([s.t_mel for s in states], device=dev))


def unstack_states(state: FlowStreamState) -> list:
    """The single-session states of a ``stack_states`` state, each a copy
    with int cursors."""
    n = state.pre_k.shape[1]

    def cfg_row(x, dim, i):
        return torch.cat([x.narrow(dim, i, 1), x.narrow(dim, n + i, 1)], dim=dim)

    return [FlowStreamState(
        pre_k=state.pre_k[:, i:i + 1].clone(), pre_v=state.pre_v[:, i:i + 1].clone(),
        lookahead_tail=state.lookahead_tail[i:i + 1].clone(),
        up_conv_tail=state.up_conv_tail[i:i + 1].clone(),
        up_k=state.up_k[:, i:i + 1].clone(), up_v=state.up_v[:, i:i + 1].clone(),
        est_h=cfg_row(state.est_h, 2, i),
        conv_tails={k: cfg_row(v, _cfg_dim(k), i) for k, v in state.conv_tails.items()},
        t_tok=t_tok, t_mel=t_mel)
        for i, (t_tok, t_mel) in enumerate(zip(state.t_tok.tolist(), state.t_mel.tolist()))]


def _encoder_chunk(params, cfg: FlowConfig, state: FlowStreamState, h_tok_new, context):
    """n new tokens (+ the 3-token lookahead context) through the cached
    conformer.  Returns (mel-rate features (B, 2n, D), state)."""
    enc = cfg.encoder
    d = enc.output_size
    n = h_tok_new.shape[1]
    t_tok_max, t_mel_max = state.pre_k.shape[3], state.up_k.shape[3]
    stride = enc.upsample_stride
    t0 = state.t_tok
    dev = h_tok_new.device
    ep = params["encoder"]

    x = _embed(ep["embed"], h_tok_new, d)
    ctx = _embed(ep["embed"], context, d)

    # pre-lookahead: conv1 (k = la+1, reads the 3 context tokens) + causal conv2 (k=3)
    pl = ep["pre_lookahead"]
    h = torch.cat([x, ctx], dim=1).transpose(1, 2)  # (B, D, n+3)
    h = F.leaky_relu(conv1d(pl["conv1"], h), 0.01)  # (B, D, n)
    h2, state.lookahead_tail = causal_conv_cached(pl["conv2"], h, state.lookahead_tail)
    x = h2.transpose(1, 2) + x

    mask_tok = _chunk_mask(t0, n, t_tok_max, enc.static_chunk_size, dev).reshape(-1, n, t_tok_max)
    for i, lp in enumerate(ep["encoders"]):
        x, _, _ = conformer_layer_cached(lp, enc.attention_heads, x, params["_ptab_pre"][i],
                                         state.pre_k[i], state.pre_v[i], t0, mask_tok)

    # upsample: nearest x2 + causal conv (k = 2*stride+1, tail 2*stride)
    h = x.transpose(1, 2).repeat_interleave(stride, dim=2)  # (B, D, 2n)
    full = torch.cat([state.up_conv_tail, h], dim=2)
    xu = conv1d(ep["up_layer"], full).transpose(1, 2)  # (B, 2n, D)
    state.up_conv_tail = full[:, :, full.shape[2] - stride * 2:]

    m0, nm = t0 * stride, n * stride
    xu = _embed(ep["up_embed"], xu, d)
    mask_mel = _chunk_mask(m0, nm, t_mel_max, enc.static_chunk_size * stride,
                           dev).reshape(-1, nm, t_mel_max)
    for i, lp in enumerate(ep["up_encoders"]):
        xu, _, _ = conformer_layer_cached(lp, enc.attention_heads, xu, params["_ptab_up"][i],
                                          state.up_k[i], state.up_v[i], m0, mask_mel)
    xu = layer_norm(ep["after_norm"], xu, eps=1e-5)
    state.t_tok, state.t_mel = t0 + n, m0 + nm
    return xu, state


def _estimator_chunk(params, cfg: FlowConfig, state: FlowStreamState, x_new, mu_new, spks,
                     cond_new):
    """Every Euler step over the new mel chunk with per-(step, stage) caches.

    x_new (B, 80, n) is the fixed-noise slice of these positions; each
    position evolves independently given the estimator's outputs, which see
    the cached history.  Returns (x (B, 80, n), state).
    """
    est = cfg.estimator
    b, _, n = x_new.shape
    t_mel_max = state.est_h.shape[3]
    m0 = state.t_mel - n  # the encoder already advanced t_mel by n
    rate = cfg.cfm.inference_cfg_rate
    t_span = cosine_t_span(cfg.cfm.n_timesteps)
    dev = x_new.device
    mask2 = _chunk_mask(m0, n, t_mel_max, est.static_chunk_size, dev).reshape(
        -1, n, t_mel_max).expand(b, n, t_mel_max).repeat(2, 1, 1)
    # the history rows of the cond and uncond halves, at each row's cursor
    at2 = _at(m0 if isinstance(m0, int) else torch.cat([m0, m0]), n)
    mu_in = torch.cat([mu_new, torch.zeros_like(mu_new)], dim=0)
    spks_in = torch.cat([spks, torch.zeros_like(spks)], dim=0)
    cond_in = torch.cat([cond_new, torch.zeros_like(cond_new)], dim=0)
    est_h, tails = state.est_h, state.conv_tails
    ep = params["estimator"]
    heads, dh = est.num_heads, est.attention_head_dim

    def tf_block_cached(tp, ht, step, stage_idx):
        b2, nn, _ = ht.shape
        h = layer_norm(tp["norm1"], ht)
        # cache the LayerNorm'd attention inputs; re-project the whole prefix to K/V
        est_h[step, stage_idx][at2] = h.to(est_h.dtype)
        hist = est_h[step, stage_idx].to(h.dtype)
        q = dense(tp["to_q"], h).reshape(b2, nn, heads, dh).transpose(1, 2)
        k = dense(tp["to_k"], hist).reshape(b2, t_mel_max, heads, dh).transpose(1, 2)
        v = dense(tp["to_v"], hist).reshape(b2, t_mel_max, heads, dh).transpose(1, 2)
        out = _softmax_attend((q @ k.transpose(-1, -2)) / math.sqrt(dh), mask2, v)
        ht = ht + dense(tp["to_out"], out.transpose(1, 2).reshape(b2, nn, heads * dh))
        h = layer_norm(tp["norm3"], ht)
        return ht + dense(tp["ff_out"], F.gelu(dense(tp["ff_in"], h)))

    def conv(p, h, site, idx):
        y, tails[site][idx] = causal_conv_cached(p, h, tails[site][idx])
        return y

    def resnet_cached(rp, h, temb, site1, site2, idx):
        y = conv(rp["block1"]["conv"], h, site1, idx)
        y = _mish(layer_norm(rp["block1"]["norm"], y.transpose(1, 2)).transpose(1, 2))
        y = y + dense(rp["mlp"], _mish(temb))[:, :, None]
        y = conv(rp["block2"]["conv"], y, site2, idx)
        y = _mish(layer_norm(rp["block2"]["norm"], y.transpose(1, 2)).transpose(1, 2))
        return y + conv1d(rp["res_conv"], h)

    def blocks(sp, h, s, stage_idx):
        ht = h.transpose(1, 2)
        for tp in sp["transformer"]:
            ht = tf_block_cached(tp, ht, s, stage_idx)
        return ht.transpose(1, 2)

    x = x_new
    for s in range(len(t_span) - 1):
        t_cur = torch.full((2 * b,), float(t_span[s]), dtype=torch.float32, device=dev)
        dt = torch.tensor(t_span[s + 1] - t_span[s], dtype=torch.float32, device=dev)
        temb = sinusoidal_time_emb(t_cur, est.in_channels, est.time_embed_scale).to(x.dtype)
        temb = dense(ep["time_mlp"]["linear_1"], temb)
        temb = dense(ep["time_mlp"]["linear_2"], F.silu(temb))
        h = torch.cat([torch.cat([x, x], dim=0), mu_in,
                       spks_in[:, :, None].expand(2 * b, spks.shape[1], n), cond_in], dim=1)
        # down stage (stage 0); the skip is taken before the downsample conv
        h = resnet_cached(ep["down"]["resnet"], h, temb, "down_b1", "down_b2", s)
        h = blocks(ep["down"], h, s, 0)
        skip = h
        h = conv(ep["down"]["conv"], h, "down_conv", s)
        for mi, sp in enumerate(ep["mid"]):  # stages 1 .. num_mid
            h = resnet_cached(sp["resnet"], h, temb, "mid_b1", "mid_b2", (mi, s))
            h = blocks(sp, h, s, 1 + mi)
        h = torch.cat([h, skip], dim=1)  # up stage (last)
        h = resnet_cached(ep["up"]["resnet"], h, temb, "up_b1", "up_b2", s)
        h = blocks(ep["up"], h, s, 1 + est.num_mid_blocks)
        h = conv(ep["up"]["conv"], h, "up_conv", s)
        h = conv(ep["final_block"]["conv"], h, "final_b", s)
        h = _mish(layer_norm(ep["final_block"]["norm"], h.transpose(1, 2)).transpose(1, 2))
        dphi = conv1d(ep["final_proj"], h)
        vfield = (1.0 + rate) * dphi[:b] - rate * dphi[b:]
        x = (x + dt.to(x.dtype) * vfield).to(x_new.dtype)
    return x, state


def prepare_stream_params(params: dict, cfg: FlowConfig, t_tok_max: int) -> dict:
    """The flow's parameters plus the per-layer rel-pos projection tables of
    the cached conformer stacks: ``_ptab_pre`` (2 t_tok_max - 1, H, dk) and
    ``_ptab_up`` at the mel rate, in the parameters' dtype."""
    enc = cfg.encoder
    d, heads = enc.output_size, enc.attention_heads
    w = params["input_embedding"]["weight"]

    def tables(layers, L):
        pe = espnet_rel_pos_emb(L, d, w.device, w.dtype)
        return [dense(lp["self_attn"]["linear_pos"], pe).reshape(-1, heads, d // heads)
                for lp in layers]

    return dict(params, _ptab_pre=tables(params["encoder"]["encoders"], t_tok_max),
                _ptab_up=tables(params["encoder"]["up_encoders"], t_tok_max * enc.upsample_stride))


def flow_chunk(params: dict, cfg: FlowConfig, state: FlowStreamState, token_new, context_tokens,
               embedding_vec, prompt_feat_chunk):
    """Mel for n new tokens (with the 3-token lookahead context).

    token_new: (B, n) the next hop of speech tokens; context_tokens: (B, 3);
    embedding_vec: (B, 192) raw x-vector; prompt_feat_chunk: (B, 2n, 80)
    prompt mel over these positions (zeros past the prompt).  ``params``
    come from ``prepare_stream_params``; ``state`` is one session's, or
    ``stack_states``'s over B sessions at their own cursors.  Returns (mel
    (B, 80, 2n) float32, state).
    """
    dtype = params["input_embedding"]["weight"].dtype
    spk = embedding_vec / torch.linalg.norm(embedding_vec, dim=1, keepdim=True).clamp_min(1e-12)
    spk = dense(params["spk_embed_affine_layer"], spk.to(dtype))
    h_tok = embedding(params["input_embedding"], token_new.clamp_min(0)).to(dtype)
    h_ctx = embedding(params["input_embedding"], context_tokens.clamp_min(0)).to(dtype)

    h_mel, state = _encoder_chunk(params, cfg, state, h_tok, h_ctx)
    mu = dense(params["encoder_proj"], h_mel).transpose(1, 2)  # (B, 80, 2n)
    n_mel = mu.shape[2]
    m0 = state.t_mel - n_mel
    # the fixed noise of each row's positions
    noise = params["rand_noise"].transpose(1, 2).expand(mu.shape[0], -1, -1)[_at(m0, n_mel)]
    z = noise.transpose(1, 2).to(dtype)
    cond = prompt_feat_chunk.transpose(1, 2).to(dtype)
    mel, state = _estimator_chunk(params, cfg, state, z, mu, spk, cond)
    return mel.float(), state
