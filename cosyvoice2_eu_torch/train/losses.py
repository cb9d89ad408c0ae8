"""Training losses, in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/train/losses.py``: the OT conditional
flow-matching loss with CFG dropout (reference:
cosy_repo/cosyvoice/flow/flow_matching.py:152-191).  The random draws are
inputs: the caller makes them from a ``torch.Generator`` (or, in the parity
tests, from JAX's key chain).  The LM losses come with LM training.
"""

from __future__ import annotations

import math

import torch


def cfm_loss(
    estimator_fn,
    x1: torch.Tensor,
    mask: torch.Tensor,
    mu: torch.Tensor,
    spks: torch.Tensor,
    cond: torch.Tensor,
    u_t: torch.Tensor,
    z: torch.Tensor,
    u_cfg: torch.Tensor,
    sigma_min: float = 1e-6,
    training_cfg_rate: float = 0.2,
    t_scheduler: str = "cosine",
) -> torch.Tensor:
    """OT-CFM loss: y_t = (1-(1-sigma)t) z + t x1, target u = x1 - (1-sigma) z.

    x1/mu/cond: (B, C, T); mask: (B, 1, T); spks: (B, C).  Draws: u_t
    (B, 1, 1) uniform [0, 1) for the time, z (B, C, T) standard normal noise,
    u_cfg (B,) uniform [0, 1) for the CFG keep coin.
    estimator_fn(y, mask, mu, t, spks, cond) -> velocity prediction.
    """
    c = x1.shape[1]
    t = u_t.to(x1.dtype)
    if t_scheduler == "cosine":
        t = 1.0 - torch.cos(t * 0.5 * math.pi)
    y = (1.0 - (1.0 - sigma_min) * t) * z + t * x1
    u = x1 - (1.0 - sigma_min) * z

    if training_cfg_rate > 0:
        keep = (u_cfg > training_cfg_rate).to(x1.dtype)
        mu = mu * keep[:, None, None]
        spks = spks * keep[:, None]
        cond = cond * keep[:, None, None]

    pred = estimator_fn(y, mask, mu, t[:, 0, 0], spks, cond)
    sq = torch.square(pred * mask - u * mask)
    return torch.sum(sq) / (torch.clamp_min(torch.sum(mask), 1.0) * c)
