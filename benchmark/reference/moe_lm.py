"""The speech LM on a DeepSeek-V3 backbone (Moonlight-16B-A3B), its loss with
the balance loss, in plain PyTorch; gradients by autograd
(``reference/train.py::loss_and_grads``).

Written from the published description, not from the port: the DeepSeek-V3
block of moonshotai/Moonlight-16B-A3B's ``config.json`` (``model_type``
deepseek_v3) and DeepSeek-V3's report (arXiv:2412.19437 §2.1), under the
CosyVoice2 speech head of ``reference/lm.py`` (mixed embeddings, the speech
decoder).  Per layer: ``x += o_proj(MLA(RMSNorm(x)))``, then ``x +=
FFN(RMSNorm(x))``, the FFN dense in the first ``first_k_dense_replace``
layers and a mixture of experts after them.

* MLA with no q compression: ``q = W_q h`` (16 heads of 128 + 64),
  ``[c_kv, k_pe] = W_kva h``, ``c_kv = RMSNorm(c_kv)``, ``[k_nope, v] = W_kvb
  c_kv``, RoPE on ``q_pe`` and on the one ``k_pe`` that all heads share,
  ``softmax(q k^T / sqrt(192) + mask) v``, ``o_proj``.
* Router: ``s = sigmoid(W_g h)`` in fp32 over all experts, the top K of
  ``s + b``, weights the chosen ``s`` over their sum (+1e-20) times
  ``routed_scaling_factor``; ``y = sum_k w_k E_k(h) + S(h)``, ``E(h) =
  W_down(silu(W_gate h) * W_up h)``, ``S`` one such MLP of ``n_shared *
  moe_intermediate_size``.  Computed as written: each held expert on every
  position, times its weight (zero where it was not chosen).
* Balance loss: per row over its valid positions, ``alpha sum_i f_i P_i``,
  ``f_i = N/(K T) #{t: i chosen}``, ``P_i = (1/T) sum_t s_it / sum_j s_jt``;
  the mean over rows, summed over the MoE layers.

Departures from the published model, each the program's too:

* the chip's share of the experts: each MoE layer holds the experts
  ``[held_offset, held_offset + held_experts)`` and adds their part alone;
  the router keeps all its outputs and its top K;
* ``b`` (``e_score_correction_bias``) is a frozen buffer drawn from the
  seed (uniform in [-0.05, 0.05]); DeepSeek-V3's ±γ update of it from the
  experts' load is not done;
* RoPE in the half-split layout (``reference/lm.py``): the published code
  reads the rope features as interleaved pairs, which with random weights
  is a relabelling of the rope rows of ``W_q`` and ``W_kva``;
* ``routes`` (optional): each MoE layer's chosen experts as the program
  chose them, in place of the reference's own top K, so that a choice that
  flipped on rounding (the 6th and 7th of 64 scores can tie to 1e-6) is not
  read as a gap; the weights are still the reference's own ``s`` there.
  ``forward`` returns each layer's ``s + b``, to check the given choice.

Training only: no cache, no decode.  fp32, TF32 off (``layers.exact``).
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from . import weights
from .layers import dense, rms_norm
from .lm import NEG_INF, apply_rope, embed_mixed, rope_cos_sin
from .masks import make_non_pad_mask
from .train import label_smoothing_ce

BIAS_BOUND = 0.05


def _mlp_specs(h: int, width: int) -> dict:
    return {"gate_proj": weights.dense(h, width, False), "up_proj": weights.dense(h, width, False),
            "down_proj": weights.dense(width, h, False)}


def backbone_specs(c) -> dict:
    """The backbone's trained tree (the routers' biases apart)."""
    h, nh = c.hidden_size, c.num_heads
    qd = c.qk_nope_head_dim + c.qk_rope_head_dim
    layers = []
    for i in range(c.num_layers):
        layer = {
            "input_layernorm": weights.rms_norm(h),
            "q_proj": weights.dense(h, nh * qd, False),
            "kv_a_proj_with_mqa": weights.dense(h, c.kv_lora_rank + c.qk_rope_head_dim, False),
            "kv_a_layernorm": weights.rms_norm(c.kv_lora_rank),
            "kv_b_proj": weights.dense(c.kv_lora_rank, nh * (c.qk_nope_head_dim + c.v_head_dim),
                                       False),
            "o_proj": weights.dense(nh * c.v_head_dim, h, False),
            "post_attention_layernorm": weights.rms_norm(h),
        }
        if i < c.first_k_dense_replace:
            layer["mlp"] = _mlp_specs(h, c.intermediate_size)
        else:
            e, w = c.held_experts, c.moe_intermediate_size
            layer["mlp"] = {
                "gate": weights.dense(h, c.n_routed_experts, False),
                "experts": {"gate_proj": weights.Spec("u", (e, w, h), h ** -0.5),
                            "up_proj": weights.Spec("u", (e, w, h), h ** -0.5),
                            "down_proj": weights.Spec("u", (e, h, w), w ** -0.5)},
                "shared_experts": _mlp_specs(h, c.n_shared_experts * w),
            }
        layers.append(layer)
    return {"embed_tokens": weights.embedding(c.vocab_size, h), "layers": layers,
            "norm": weights.rms_norm(h)}


def lm_specs(c) -> dict:
    """The speech LM's trained tree over this backbone (``weights.lm``'s
    layout)."""
    h, full_vocab = c.backbone.hidden_size, c.speech_token_size + 3
    return {"backbone": backbone_specs(c.backbone), "llm_embedding": weights.embedding(2, h),
            "speech_embedding": weights.embedding(full_vocab, h),
            "llm_decoder": weights.dense(h, full_vocab)}


def make(c, seed: int, device) -> dict:
    """The trained weights, from the seed."""
    return weights.make(lm_specs(c), seed, device)


def router_biases(c, seed: int, device) -> list:
    """The routers' biases, one (experts,) tensor a MoE layer, from the
    seed (drawn apart from the trained weights)."""
    bb = c.backbone
    n_moe = bb.num_layers - bb.first_k_dense_replace
    specs = [weights.Spec("u", (bb.n_routed_experts,), BIAS_BOUND) for _ in range(n_moe)]
    return weights.make(specs, seed, device, stream=1)


def _mlp(p, x):
    return dense(p["down_proj"], F.silu(dense(p["gate_proj"], x)) * dense(p["up_proj"], x))


def _mla(lp, c, x, cos, sin, bias):
    b, t, _ = x.shape
    nh, dn, dr, dv = c.num_heads, c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim
    q = dense(lp["q_proj"], x).reshape(b, t, nh, dn + dr).transpose(1, 2)
    kva = dense(lp["kv_a_proj_with_mqa"], x)
    c_kv, k_pe = kva[..., :c.kv_lora_rank], kva[..., c.kv_lora_rank:]
    kv = dense(lp["kv_b_proj"], rms_norm(lp["kv_a_layernorm"], c_kv, c.rms_norm_eps))
    kv = kv.reshape(b, t, nh, dn + dv).transpose(1, 2)
    k_pe = apply_rope(k_pe[:, None], cos, sin).expand(b, nh, t, dr)
    q = torch.cat([q[..., :dn], apply_rope(q[..., dn:], cos, sin)], dim=-1)
    k = torch.cat([kv[..., :dn], k_pe], dim=-1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(dn + dr)
    probs = torch.softmax(scores.float() + bias, dim=-1)
    att = torch.einsum("bhqk,bhkd->bhqd", probs, kv[..., dn:])
    return dense(lp["o_proj"], att.transpose(1, 2).reshape(b, t, nh * dv))


def _moe(mp, b_corr, c, x, valid, route):
    """(y, balance loss, s + b) of one MoE layer; ``route``: the chosen
    experts (B, T, K) to use, or None for the reference's own."""
    s = torch.sigmoid(dense(mp["gate"], x.float()))
    choice = s.detach() + b_corr
    top = torch.topk(choice, c.num_experts_per_tok, dim=-1).indices if route is None else route
    w = s.gather(-1, top)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * c.routed_scaling_factor
    combine = torch.zeros_like(s).scatter(-1, top, w)  # (B, T, E): zero where not chosen
    y = _mlp(mp["shared_experts"], x)
    ex = mp["experts"]
    for j, (g, u, d) in enumerate(zip(ex["gate_proj"].unbind(0), ex["up_proj"].unbind(0),
                                      ex["down_proj"].unbind(0))):
        e = c.held_offset + j
        y = y + combine[..., e:e + 1] * _mlp({"gate_proj": {"weight": g},
                                              "up_proj": {"weight": u},
                                              "down_proj": {"weight": d}}, x)
    m = valid.float()[..., None]
    n = m.sum(1).clamp_min(1.0)
    chosen = torch.zeros_like(s).scatter(-1, top, 1.0) * m
    f = chosen.sum(1) * c.n_routed_experts / c.num_experts_per_tok / n
    p = (s / s.sum(-1, keepdim=True) * m).sum(1) / n
    return y, c.aux_loss_alpha * (f * p).sum(-1).mean(), choice


def backbone(params, biases, bb, x, valid, routes=None) -> tuple:
    """(B, T, H) inputs, (B, T) valid -> (the final hidden states, the
    balance loss summed over the MoE layers, each MoE layer's s + b (B, T,
    experts), detached).  ``routes``: the chosen experts of each MoE layer
    ((layers, B, T, K) or a list), or None."""
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)
    mask = (pos[None, None, :] <= pos[None, :, None]) & valid[:, None, :]
    bias = torch.where(mask, 0.0, NEG_INF)[:, None]
    cos, sin = rope_cos_sin(pos, SimpleNamespace(head_dim=bb.qk_rope_head_dim,
                                                 rope_theta=bb.rope_theta))
    balance, choices = x.new_zeros(()), []
    for i, lp in enumerate(params["layers"]):
        x = x + _mla(lp, bb, rms_norm(lp["input_layernorm"], x, bb.rms_norm_eps), cos, sin, bias)
        h = rms_norm(lp["post_attention_layernorm"], x, bb.rms_norm_eps)
        if i < bb.first_k_dense_replace:
            x = x + _mlp(lp["mlp"], h)
            continue
        k = len(choices)
        y, bal, choice = _moe(lp["mlp"], biases[k], bb, h, valid,
                              None if routes is None else routes[k])
        x, balance = x + y, balance + bal
        choices.append(choice)
    return rms_norm(params["norm"], x, bb.rms_norm_eps), balance, choices


def forward(params, biases, c, ids, src, valid, routes=None) -> tuple:
    """(B, T) ids and table selectors, (B, T) valid -> (speech-head logits
    (B, T, full_vocab), and ``backbone``'s balance loss and s + b)."""
    x, balance, choices = backbone(params["backbone"], biases, c.backbone,
                                   embed_mixed(params, ids, src), valid, routes)
    return dense(params["llm_decoder"], x), balance, choices


def lm_loss(params, biases, c, batch, routes=None, choices=None) -> torch.Tensor:
    """The step's loss: the speech head's cross-entropy over the valid
    targets plus the balance loss; each MoE layer's s + b is appended to
    ``choices`` when given."""
    valid = make_non_pad_mask(batch["lengths"], batch["ids"].shape[1])
    logits, balance, ch = forward(params, biases, c, batch["ids"], batch["src"], valid, routes)
    if choices is not None:
        choices.extend(ch)
    return label_smoothing_ce(logits, batch["target"], c.lsm_weight,
                              c.length_normalized_loss) + balance
