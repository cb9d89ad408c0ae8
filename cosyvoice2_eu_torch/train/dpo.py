"""DPO preference finetuning of the speech LM, in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/train/dpo.py`` (reference:
Qwen2LM.forward_dpo, cosy_repo/cosyvoice/llm/llm.py:521-573, and DPOLoss,
utils/losses.py:43): chosen and rejected sequences share the text prompt;
per-sequence mean log-probs feed the sigmoid DPO objective against a frozen
reference policy, added to the CE loss of the chosen sequences
(train_utils.py:290-328).
"""

from __future__ import annotations

from typing import Optional

import torch

from cosyvoice2_eu_torch.config import LMConfig, TrainConfig
from cosyvoice2_eu_torch.models.llm import lm_training_hidden
from cosyvoice2_eu_torch.ops.masks import make_non_pad_mask
from cosyvoice2_eu_torch.parallel.train_step import make_step
from cosyvoice2_eu_torch.train.losses import IGNORE_ID, dpo_loss, label_smoothing_ce
from cosyvoice2_eu_torch.train.optim import Optimizer
from cosyvoice2_eu_torch.utils.params import tree_map
from cosyvoice2_eu_torch.utils.profiling import StageTimer


def _sequence_logps(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(B,) mean log-prob of each row's supervised targets (the standard
    form; the reference weights by the chosen row's mask)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    mask = target != IGNORE_ID
    safe = torch.where(mask, target, 0).long()
    tok_logp = torch.gather(logp, -1, safe[..., None])[..., 0]
    return (tok_logp * mask).sum(-1) / mask.sum(-1).clamp_min(1)


def dpo_loss_fn(params, ref_params, cfg: LMConfig, batch: dict, beta: float = 0.01):
    """batch: the chosen rows' ids/src/target/lengths and the rejected
    rows' reject_ids/reject_src/reject_target/reject_lengths, padded to one
    length.  The reference policy runs without gradients.  Returns (loss,
    {"loss", "ce", "acc", "dpo", "chosen_reward", "rejected_reward"})."""
    ids = torch.cat([batch["ids"], batch["reject_ids"]])
    src = torch.cat([batch["src"], batch["reject_src"]])
    target = torch.cat([batch["target"], batch["reject_target"]])
    lengths = torch.cat([batch["lengths"], batch["reject_lengths"]])
    b = batch["ids"].shape[0]

    valid = make_non_pad_mask(lengths, ids.shape[1])
    logits = lm_training_hidden(params, cfg, ids, src, valid)
    with torch.no_grad():
        ref_logits = lm_training_hidden(ref_params, cfg, ids, src, valid)

    ce, acc = label_smoothing_ce(logits[:b], target[:b], smoothing=cfg.lsm_weight,
                                 normalize_length=cfg.length_normalized_loss)
    logps = _sequence_logps(logits, target)
    ref_logps = _sequence_logps(ref_logits, target)
    pref, chosen_r, rejected_r = dpo_loss(logps[:b], logps[b:], ref_logps[:b], ref_logps[b:],
                                          beta=beta)
    loss = ce + pref
    return loss, {"loss": loss, "ce": ce, "acc": acc, "dpo": pref,
                  "chosen_reward": chosen_r, "rejected_reward": rejected_r}


def make_dpo_train_step(cfg: LMConfig, train_cfg: TrainConfig, tx: Optimizer, ref_params: dict,
                        beta: float = 0.01, timer: Optional[StageTimer] = None):
    """step(state, batch) -> (state, metrics, with ``grad_norm``).  The
    reference parameters are copied once, detached, so an update of the
    trained ones never reaches them."""
    ref = tree_map(lambda a: a.detach().clone(), ref_params)
    return make_step(lambda p, batch: dpo_loss_fn(p, ref, cfg, batch, beta), tx, timer)
