"""Training losses, in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/train/losses.py``:

* label-smoothing cross-entropy and accuracy for the speech LM (reference:
  cosy_repo/cosyvoice/transformer/label_smoothing_loss.py:21,
  cosy_repo/cosyvoice/utils/common.py:78);
* the OT conditional flow-matching loss with CFG dropout (reference:
  cosy_repo/cosyvoice/flow/flow_matching.py:152-191), whose random draws are
  inputs: the caller makes them from a ``torch.Generator`` (or, in the
  parity tests, from JAX's key chain);
* the sigmoid DPO loss for preference finetuning (reference:
  cosy_repo/cosyvoice/utils/losses.py:43).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

IGNORE_ID = -1


def label_smoothing_ce(logits: torch.Tensor, targets: torch.Tensor, smoothing: float = 0.0,
                       normalize_length: bool = True, with_counts: bool = False) -> tuple:
    """(B, T, V) logits against (B, T) targets padded with IGNORE_ID ->
    (loss, accuracy).

    KL-style smoothing: the true class gets 1 - smoothing and the others
    share smoothing / (V - 1), as the reference's LabelSmoothingLoss.  The
    loss is summed and divided by the supervised positions
    (``normalize_length``) or by the rows that have any.  ``with_counts``:
    (loss, accuracy, the loss's count, the accuracy's count), the counts
    unclamped.
    """
    v = logits.shape[-1]
    mask = targets != IGNORE_ID
    safe_t = torch.where(mask, targets, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    confidence = 1.0 - smoothing
    other = smoothing / (v - 1)
    true_logp = torch.gather(logp, -1, safe_t[..., None])[..., 0]
    if smoothing > 0.0:
        kl = -(other * logp.sum(-1) + (confidence - other) * true_logp)
    else:
        kl = -true_logp
    kl = torch.where(mask, kl, 0.0)
    denom = mask.sum() if normalize_length else mask.any(-1).sum()
    loss = kl.sum() / denom.clamp_min(1)
    pred = logits.argmax(-1)
    acc = ((pred == targets) & mask).sum() / mask.sum().clamp_min(1)
    if with_counts:
        return loss, acc, denom, mask.sum()
    return loss, acc


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
    with_count: bool = False,
):
    """OT-CFM loss: y_t = (1-(1-sigma)t) z + t x1, target u = x1 - (1-sigma) z.

    x1/mu/cond: (B, C, T); mask: (B, 1, T); spks: (B, C).  Draws: u_t
    (B, 1, 1) uniform [0, 1) for the time, z (B, C, T) standard normal noise,
    u_cfg (B,) uniform [0, 1) for the CFG keep coin.
    estimator_fn(y, mask, mu, t, spks, cond) -> velocity prediction.
    ``with_count``: (loss, the count its sum is divided by, unclamped).
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
    loss = torch.sum(sq) / (torch.clamp_min(torch.sum(mask), 1.0) * c)
    return (loss, torch.sum(mask) * c) if with_count else loss


def dpo_loss(chosen_logps: torch.Tensor, rejected_logps: torch.Tensor,
             ref_chosen_logps: torch.Tensor, ref_rejected_logps: torch.Tensor,
             beta: float = 0.01, label_smoothing: float = 0.0) -> tuple:
    """Sigmoid DPO -> (loss, chosen reward, rejected reward), each a mean
    over the batch."""
    ratio = (chosen_logps - rejected_logps) - (ref_chosen_logps - ref_rejected_logps)
    losses = (-F.logsigmoid(beta * ratio) * (1 - label_smoothing)
              - F.logsigmoid(-beta * ratio) * label_smoothing)
    chosen_rewards = beta * (chosen_logps - ref_chosen_logps)
    rejected_rewards = beta * (rejected_logps - ref_rejected_logps)
    return losses.mean(), chosen_rewards.mean(), rejected_rewards.mean()
