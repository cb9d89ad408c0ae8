"""DeepSeek-V3 decoder backbone (Moonlight-16B-A3B) in PyTorch: the training
forward, with no cache.

The port's one backbone without a JAX counterpart.  Each layer is
pre-norm attention then a pre-norm feed-forward, both residual; the first
``first_k_dense_replace`` layers have a dense SwiGLU MLP, the rest a mixture
of experts.

* **MLA** (multi-head latent attention, no q compression):
  ``q = W_q h`` (heads of ``qk_nope + qk_rope``), ``[c_kv, k_pe] = W_kva h``,
  ``c_kv = RMSNorm(c_kv)``, ``[k_nope, v] = W_kvb c_kv``; RoPE on ``q_pe``
  and on the one ``k_pe`` that every head shares; ``softmax(q k^T /
  sqrt(q_head_dim) + mask) v`` into ``o_proj``.  RoPE takes the half-split
  layout of the port's Qwen (``rotate_half`` over the first and the last 32
  of the 64 rope features).  The published modelling code reads each rope
  part as interleaved pairs and permutes it to this layout first, so a
  released checkpoint converts by permuting the rope rows of ``q_proj``
  (each head's last 64) and of ``kv_a_proj_with_mqa`` (its last 64) by
  (0, 2, ..., 62, 1, 3, ..., 63).
* **Router** (sigmoid, noaux_tc, one group): ``s = sigmoid(W_g h)`` in fp32
  over all ``n_routed_experts``; the chosen experts are the top
  ``num_experts_per_tok`` of ``s + b``, ``b`` the correction bias; their
  weights are the chosen ``s`` over their sum (+1e-20), times
  ``routed_scaling_factor``.  ``b`` steers the choice and never the weight.
  ``b`` is a frozen buffer (``FROZEN``; ``models/llm.py::split_frozen`` keeps
  it out of the trained tree): DeepSeek-V3 moves it by ±γ from the experts'
  load after each step; that update is not done here.
* **Experts held** (expert parallelism): the layer holds the routed experts
  ``[held_offset, held_offset + held_experts)`` as stacked tensors (gate and
  up ``(E, I, H)``, down ``(E, H, I)``) and computes their part: the (token,
  slot) pairs routed to a held expert are sorted by expert, their rows
  gathered, one product taken per expert, and the weighted rows
  scatter-added back.  No token is dropped; padding is not routed.  The
  other experts' part is left out (on one process the layer runs without
  its exchange).  The ``n_shared_experts`` shared experts are one SwiGLU MLP
  of ``n_shared_experts * moe_intermediate_size`` on every token.
* **Balance loss**: DeepSeek-V3's complementary sequence-wise loss
  (arXiv:2412.19437 §2.1.2) of each MoE layer, per row over its valid
  positions, ``alpha * sum_i f_i P_i`` with ``f_i = N/(K T) * #{t: i
  chosen}`` and ``P_i = (1/T) sum_t s_it / sum_j s_jt``; the mean over rows,
  summed over the layers.  It reaches the router from all its experts.

With a ``StageTimer`` each MoE block's forward is the nested stage ``moe``
and its backward the nested stage ``moe_backward`` (opened and closed by
identity autograd functions at the block's output and input; the balance
loss's few elementwise operations may run before it opens), and the timer
counts ``moe.tokens_routed`` (valid tokens routed to each of the router's
experts), ``moe.tokens_held`` (to each held expert), ``moe.dispatch.calls``
and ``moe.load_max_over_mean`` (the sum over calls of the most tokens a held
expert got over the held experts' mean), each summed over the MoE layers.
Without a timer the timer's counters are not kept and nothing waits but the
dispatch, which reads the held experts' sizes on the host (one sync a MoE
layer); their sum comes back as ``held_pairs`` with or without a timer.

Decoding (MLA's latent cache) is not ported: ``models/llm.py``'s decode
paths raise ``ValueError`` for this backbone.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from cosyvoice2_eu_torch.config import DeepseekV3Config
from cosyvoice2_eu_torch.models.qwen2 import _attention, apply_rope, rope_cos_sin
from cosyvoice2_eu_torch.ops.masks import NEG_INF
from cosyvoice2_eu_torch.utils.params import (
    dense,
    init_dense,
    init_embedding,
    init_rms_norm,
    init_uniform,
    rms_norm,
)

FROZEN = "e_score_correction_bias"  # the backbone's key of the routers' biases, one a MoE layer
BIAS_BOUND = 0.05  # a random bias's draw: uniform in [-0.05, 0.05]


def init_deepseek_v3(gen: torch.Generator, cfg: DeepseekV3Config) -> dict:
    """Random weights (Kaiming-uniform dense layers, normal embeddings,
    unit norms) and the routers' biases under ``FROZEN``."""
    h, nh = cfg.hidden_size, cfg.num_heads
    layers, biases = [], []
    for i in range(cfg.num_layers):
        layer = {
            "input_layernorm": init_rms_norm(gen, h),
            "q_proj": init_dense(gen, h, nh * cfg.q_head_dim, bias=False),
            "kv_a_proj_with_mqa": init_dense(gen, h, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                                             bias=False),
            "kv_a_layernorm": init_rms_norm(gen, cfg.kv_lora_rank),
            "kv_b_proj": init_dense(gen, cfg.kv_lora_rank,
                                    nh * (cfg.qk_nope_head_dim + cfg.v_head_dim), bias=False),
            "o_proj": init_dense(gen, nh * cfg.v_head_dim, h, bias=False),
            "post_attention_layernorm": init_rms_norm(gen, h),
        }
        if i < cfg.first_k_dense_replace:
            layer["mlp"] = _init_mlp(gen, h, cfg.intermediate_size)
        else:
            e, w = cfg.held_experts, cfg.moe_intermediate_size
            layer["mlp"] = {
                "gate": {"weight": init_uniform(gen, (cfg.n_routed_experts, h),
                                                -h ** -0.5, h ** -0.5)},
                "experts": {"gate_proj": init_uniform(gen, (e, w, h), -h ** -0.5, h ** -0.5),
                            "up_proj": init_uniform(gen, (e, w, h), -h ** -0.5, h ** -0.5),
                            "down_proj": init_uniform(gen, (e, h, w), -w ** -0.5, w ** -0.5)},
                "shared_experts": _init_mlp(gen, h, cfg.n_shared_experts * w),
            }
            biases.append(init_uniform(gen, (cfg.n_routed_experts,), -BIAS_BOUND, BIAS_BOUND))
        layers.append(layer)
    return {"embed_tokens": init_embedding(gen, cfg.vocab_size, h), "layers": layers,
            "norm": init_rms_norm(gen, h), FROZEN: biases}


def _init_mlp(gen, h: int, width: int) -> dict:
    return {"gate_proj": init_dense(gen, h, width, bias=False),
            "up_proj": init_dense(gen, h, width, bias=False),
            "down_proj": init_dense(gen, width, h, bias=False)}


def _mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    return dense(p["down_proj"], F.silu(dense(p["gate_proj"], x)) * dense(p["up_proj"], x))


def _mla(lp: dict, cfg: DeepseekV3Config, x, cos, sin, bias) -> torch.Tensor:
    b, t, _ = x.shape
    nh, dn, dr, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q = dense(lp["q_proj"], x).view(b, t, nh, dn + dr).transpose(1, 2)
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    c_kv, k_pe = dense(lp["kv_a_proj_with_mqa"], x).split([cfg.kv_lora_rank, dr], dim=-1)
    kv = dense(lp["kv_b_proj"], rms_norm(lp["kv_a_layernorm"], c_kv, cfg.rms_norm_eps))
    k_nope, v = kv.view(b, t, nh, dn + dv).transpose(1, 2).split([dn, dv], dim=-1)
    k_pe = apply_rope(k_pe[:, None], cos, sin)  # (B, 1, T, dr): one for every head
    q = torch.cat([q_nope, apply_rope(q_pe, cos, sin)], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(b, nh, t, dr)], dim=-1)
    att = _attention(q, k, v, bias, 1)  # scaled by q_head_dim^-0.5
    return dense(lp["o_proj"], att.transpose(1, 2).reshape(b, t, nh * dv))


def route(gate: dict, bias: torch.Tensor, x: torch.Tensor, cfg: DeepseekV3Config) -> tuple:
    """x (N, H) -> (scores s (N, E) fp32, chosen experts (N, K), their
    weights (N, K)): the top K of s + bias, weighted by s normalised over
    the chosen and scaled."""
    s = torch.sigmoid(F.linear(x.float(), gate["weight"].float()))
    idx = torch.topk(s.detach() + bias.float(), cfg.num_experts_per_tok, dim=-1).indices
    w = s.gather(1, idx)
    return s, idx, w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor


def held_experts(experts: dict, x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                 valid: torch.Tensor, offset: int) -> tuple:
    """The held experts' part of the layer: x (N, H), the chosen experts
    idx and weights w (N, K), valid (N,) -> (sum over each token's pairs
    routed to a held expert of w E(x) (N, H), each held expert's count of
    pairs, on the host)."""
    n, k = idx.shape
    gate, up, down = experts["gate_proj"], experts["up_proj"], experts["down_proj"]
    e_held = gate.shape[0]
    local = idx - offset
    held = (local >= 0) & (local < e_held) & valid[:, None]
    key, order = torch.sort(torch.where(held, local, e_held).reshape(-1), stable=True)
    bounds = torch.searchsorted(key, torch.arange(e_held + 1, device=key.device)).tolist()
    sizes = [b - a for a, b in zip(bounds[:-1], bounds[1:])]
    pairs = order[:bounds[-1]]
    tok = pairs // k
    outs = [F.linear(F.silu(F.linear(r, g)) * F.linear(r, u), d)
            for r, g, u, d in zip(x[tok].split(sizes), gate.unbind(0), up.unbind(0),
                                  down.unbind(0))]
    y = torch.cat(outs) * w.reshape(-1)[pairs, None].to(x.dtype)
    return x.new_zeros(x.shape).index_add(0, tok, y), sizes


def shared_experts(p: dict, x: torch.Tensor) -> torch.Tensor:
    return _mlp(p, x)


def balance_loss(s: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                 cfg: DeepseekV3Config) -> torch.Tensor:
    """One layer's sequence-wise balance loss: s (B, T, E), idx (B, T, K),
    valid (B, T) -> alpha * sum_i f_i P_i, the mean over rows."""
    e, k = cfg.n_routed_experts, cfg.num_experts_per_tok
    m = valid.to(s.dtype)[..., None]
    n = m.sum(1).clamp_min(1.0)  # (B, 1) valid positions a row
    chosen = torch.zeros_like(s).scatter_(2, idx, 1.0) * m
    f = chosen.sum(1) * (e / k) / n
    p = (s / s.sum(-1, keepdim=True) * m).sum(1) / n
    return cfg.aux_loss_alpha * (f * p).sum(-1).mean()


class _StageEdge(torch.autograd.Function):
    """The identity; its backward enters (``opening``) or leaves the timer
    stage that ``box`` carries from the block's output to its input."""

    @staticmethod
    def forward(ctx, x, timer, name, opening, box):
        ctx.args = (timer, name, opening, box)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        timer, name, opening, box = ctx.args
        if opening:
            box.append(timer.stage(name))
            box[-1].__enter__()
        else:
            box.pop().__exit__(None, None, None)
        return grad, None, None, None, None


def _moe(mp: dict, bias: torch.Tensor, cfg: DeepseekV3Config, h: torch.Tensor,
         valid: torch.Tensor, aux: dict, timer) -> torch.Tensor:
    b, t, d = h.shape
    box: list = []
    if timer is not None:
        h = _StageEdge.apply(h, timer, "moe_backward", False, box)
    x = h.reshape(b * t, d)
    s, idx, w = route(mp["gate"], bias, x, cfg)
    routed, sizes = held_experts(mp["experts"], x, idx, w, valid.reshape(-1), cfg.held_offset)
    y = (routed + shared_experts(mp["shared_experts"], x)).view(b, t, d)
    k = cfg.num_experts_per_tok
    aux["balance_loss"] = aux["balance_loss"] + balance_loss(
        s.view(b, t, -1), idx.view(b, t, k), valid, cfg)
    aux["routes"].append(idx.view(b, t, k))
    aux["held_pairs"] += sum(sizes)
    if timer is not None:
        ones = valid.reshape(-1, 1).expand(-1, k).reshape(-1).float()
        timer.count("moe.tokens_routed",
                    torch.zeros(cfg.n_routed_experts, device=x.device).index_add_(
                        0, idx.reshape(-1), ones))
        timer.count("moe.tokens_held", torch.tensor(sizes, dtype=torch.float64))
        timer.count("moe.dispatch.calls", 1)
        mean = sum(sizes) / len(sizes)
        timer.count("moe.load_max_over_mean", max(sizes) / mean if mean else 1.0)
        y = _StageEdge.apply(y, timer, "moe_backward", True, box)
    return y


def deepseek_v3_forward(params: dict, cfg: DeepseekV3Config, embeds: torch.Tensor,
                        valid: torch.Tensor, timer=None) -> tuple:
    """Full (training) forward.  embeds: (B, T, H); valid: (B, T) bool ->
    (final hidden states (B, T, H), {"balance_loss": the layers' sum,
    "routes": (MoE layers, B, T, K) chosen experts, "held_pairs": the
    (token, slot) pairs routed to the held experts over the layers, a host
    int from the sizes the dispatch reads}).  Causal attention restricted
    to valid positions."""
    t = embeds.shape[1]
    pos = torch.arange(t, device=embeds.device)
    mask = (pos[None, None, :] <= pos[None, :, None]) & valid[:, None, :]
    bias = torch.where(mask, 0.0, NEG_INF)[:, None]  # (B, 1, T, T)
    cos, sin = rope_cos_sin(pos, cfg, dim=cfg.qk_rope_head_dim)
    eps = cfg.rms_norm_eps
    aux = {"balance_loss": embeds.new_zeros(()), "routes": [], "held_pairs": 0}
    router_bias = iter(params[FROZEN])
    x = embeds
    for lp in params["layers"]:
        x = x + _mla(lp, cfg, rms_norm(lp["input_layernorm"], x, eps), cos, sin, bias)
        h = rms_norm(lp["post_attention_layernorm"], x, eps)
        if "experts" in lp["mlp"]:
            with timer.stage("moe") if timer is not None else contextlib.nullcontext():
                x = x + _moe(lp["mlp"], next(router_bias), cfg, h, valid, aux, timer)
        else:
            x = x + _mlp(lp["mlp"], h)
    aux["routes"] = torch.stack(aux["routes"]) if aux["routes"] else None
    return rms_norm(params["norm"], x, eps), aux
