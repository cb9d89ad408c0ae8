"""What the MoE training cell adds to the harness: its model FLOPs, the check
of the program's expert choice, and the faults planted in its timed path.

FLOPs of the speech LM on a deepseek_v3 backbone, as ``flops.py`` counts
the dense LM: 2 a multiply-add of every product a token runs through (MLA's
projections, the dense MLP, the router, the shared experts, the speech
head), 2·heads·(q_head_dim + v_head_dim) a context position for attention,
and 2·3·hidden·moe_intermediate a (token, slot) pair routed to a held
expert: what this chip computes, not what the whole model would.  Biases
and norms are not counted.  ``tests/test_bench_moe.py`` holds the count to
``torch.utils.flop_counter`` over the reference on the meta device.
"""

from __future__ import annotations

import importlib

import torch

from harness import faults as lm_faults


def token_params(b) -> int:
    """Multiply-adds a token runs through in the backbone's layers, the
    routed experts and the embeddings apart (``b``: the backbone's
    config namespace)."""
    h, nh = b.hidden_size, b.num_heads
    qd = b.qk_nope_head_dim + b.qk_rope_head_dim
    mla = (h * nh * qd + h * (b.kv_lora_rank + b.qk_rope_head_dim)
           + b.kv_lora_rank * nh * (b.qk_nope_head_dim + b.v_head_dim) + nh * b.v_head_dim * h)
    dense = 3 * h * b.intermediate_size
    moe = h * b.n_routed_experts + 3 * h * b.n_shared_experts * b.moe_intermediate_size
    n_moe = b.num_layers - b.first_k_dense_replace
    return b.num_layers * mla + b.first_k_dense_replace * dense + n_moe * moe


def forward_flops(c, context_lengths, held_pairs: float) -> float:
    """Forward FLOPs of the LM (``c``: the LM's config namespace) over tokens
    whose attention context lengths are given, with ``held_pairs`` (token,
    slot) pairs routed to held experts, summed over the MoE layers."""
    b = c.backbone
    per_token = 2 * (token_params(b) + b.hidden_size * (c.speech_token_size + 3))
    attn = 2 * b.num_layers * b.num_heads * (b.qk_nope_head_dim + b.qk_rope_head_dim
                                             + b.v_head_dim)
    expert = 2 * 3 * b.hidden_size * b.moe_intermediate_size
    return sum(per_token + attn * ctx for ctx in context_lengths) + expert * held_pairs


def route_gaps(choice: torch.Tensor, routes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """For each valid token: the largest score (s + b) outside the chosen
    experts less the smallest inside; at most 0 where the chosen set is a
    top K of ``choice`` (B, T, E).  routes (B, T, K); valid (B, T)."""
    inside = torch.zeros_like(choice, dtype=torch.bool).scatter(-1, routes, True)
    lo = choice.masked_fill(~inside, float("inf")).amin(-1)
    hi = choice.masked_fill(inside, float("-inf")).amax(-1)
    return (hi - lo)[valid]


# ---------------------------------------------------------------------------
# faults planted in the timed path (tests/test_bench_moe.py at the tiny size,
# tools/moe_readings.py at the cell's own size on the card)
# ---------------------------------------------------------------------------

def _bias_dropped(fn):
    """The choice by s alone."""
    return lambda gate, bias, x, cfg: fn(gate, bias * 0, x, cfg)


def _held_norm(fn):
    """The weights normalised over the chosen experts that are held here."""
    def f(gate, bias, x, cfg):
        s, idx, w = fn(gate, bias, x, cfg)
        local = idx - cfg.held_offset
        sel = s.gather(1, idx) * ((local >= 0) & (local < cfg.held_experts))
        return s, idx, sel / (sel.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor
    return f


def _scale_dropped(fn):
    """The weights without ``routed_scaling_factor``."""
    def f(gate, bias, x, cfg):
        s, idx, w = fn(gate, bias, x, cfg)
        return s, idx, w / cfg.routed_scaling_factor
    return f


def _shared_dropped(fn):
    return lambda p, x: torch.zeros_like(x)


def _balance_dropped(fn):
    return lambda *a: 0 * fn(*a)


_BACKBONE = "cosyvoice2_eu_torch.models.deepseek_v3"
FAULTS = {
    "bias_dropped": (_BACKBONE, "route", _bias_dropped),
    "held_norm": (_BACKBONE, "route", _held_norm),
    "scale_dropped": (_BACKBONE, "route", _scale_dropped),
    "shared_dropped": (_BACKBONE, "shared_experts", _shared_dropped),
    "balance_dropped": (_BACKBONE, "balance_loss", _balance_dropped),
    "half_batch": lm_faults.FAULTS[("lm_train", "half_batch")],
    "state_unchanged": lm_faults.FAULTS[("lm_train", "state_unchanged")],
}


def plant(fault: str):
    """Replace the attribute that ``FAULTS[fault]`` names with its wrapped
    original; returns a function that puts it back."""
    mod_name, attr, wrap = FAULTS[fault]
    target = importlib.import_module(mod_name)
    if "." in attr:
        cls, attr = attr.split(".")
        target = getattr(target, cls)
    original = getattr(target, attr)
    setattr(target, attr, wrap(original))
    return lambda: setattr(target, attr, original)
