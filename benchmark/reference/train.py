"""The training steps' losses, gradients and first update, in plain PyTorch.

Frozen copies of the port's ``train/losses.py`` (``label_smoothing_ce``,
``cfm_loss``) and ``parallel/train_step.py`` (``lm_loss_fn``,
``flow_loss_fn``), over the reference's own LM and flow.  ``adam_update``
is the update that ``TrainConfig()``'s optimizer makes when it emits:
the mean of the accumulated gradients, clipped to a global norm, then one
Adam(W) step at a constant learning rate, from zero moments or from given
ones.
"""

from __future__ import annotations

import math

import torch

from .encoder import upsample_conformer_forward
from .estimator import estimator_forward
from .layers import dense, embedding, tree_leaves, tree_map
from .lm import lm_logits
from .masks import make_non_pad_mask

IGNORE_ID = -1


def label_smoothing_ce(logits, targets, smoothing: float = 0.0, normalize_length: bool = True):
    v = logits.shape[-1]
    mask = targets != IGNORE_ID
    safe_t = torch.where(mask, targets, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    true_logp = torch.gather(logp, -1, safe_t[..., None])[..., 0]
    if smoothing > 0.0:
        other = smoothing / (v - 1)
        kl = -(other * logp.sum(-1) + (1.0 - smoothing - other) * true_logp)
    else:
        kl = -true_logp
    kl = torch.where(mask, kl, 0.0)
    denom = mask.sum() if normalize_length else mask.any(-1).sum()
    return kl.sum() / denom.clamp_min(1)


def lm_loss(params, c, batch) -> torch.Tensor:
    valid = make_non_pad_mask(batch["lengths"], batch["ids"].shape[1])
    logits = lm_logits(params, c, batch["ids"], batch["src"], valid)
    return label_smoothing_ce(logits, batch["target"], c.lsm_weight, c.length_normalized_loss)


def cfm_loss(estimator_fn, x1, mask, mu, spks, cond, u_t, z, u_cfg, sigma_min, training_cfg_rate,
             t_scheduler):
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


def flow_loss(params, c, batch, draws, streaming: bool) -> torch.Tensor:
    """CausalMaskedDiffWithXvec.forward's loss: unified streaming training
    and random prompt conditioning, from the step's draws."""
    token, token_len = batch["speech_token"], batch["speech_token_len"]
    feat, feat_len = batch["speech_feat"], batch["speech_feat_len"]
    t_tok, t_mel = token.shape[1], feat.shape[1]
    spk = batch["embedding"]
    spk = spk / torch.linalg.norm(spk, dim=1, keepdim=True).clamp_min(1e-12)
    spk = dense(params["spk_embed_affine_layer"], spk)
    tok_mask = make_non_pad_mask(token_len, t_tok)[..., None].to(feat.dtype)
    h_tok = embedding(params["input_embedding"], token.clamp_min(0)) * tok_mask
    h, _ = upsample_conformer_forward(params["encoder"], c.encoder, h_tok, token_len,
                                      streaming=streaming)
    h = dense(params["encoder_proj"], h)
    if h.shape[1] > t_mel:
        h = h[:, :t_mel]
    elif h.shape[1] < t_mel:
        h = torch.nn.functional.pad(h, (0, 0, 0, t_mel - h.shape[1]))
    use_cond = draws["u_cond"] < 0.5
    cond_len = (draws["u_frac"] * 0.3 * feat_len.float()).to(torch.int32)
    idx = torch.arange(t_mel, device=feat.device)[None, :]
    cond_mask = (idx < cond_len[:, None]) & use_cond[:, None]
    conds = torch.where(cond_mask[..., None], feat, 0.0).transpose(1, 2)
    mask = make_non_pad_mask(feat_len, t_mel)[:, None].to(feat.dtype)

    def est_fn(y, m, mu, t, s, cnd):
        return estimator_forward(params["estimator"], c.estimator, y, m, mu, t, s, cnd,
                                 streaming=streaming)

    cfm = c.cfm
    return cfm_loss(est_fn, feat.transpose(1, 2), mask, h.transpose(1, 2) * mask, spk, conds,
                    draws["u_t"], draws["z"], draws["u_cfg"], cfm.sigma_min,
                    cfm.training_cfg_rate, cfm.t_scheduler)


def loss_and_grads(loss_fn, params):
    """(loss, gradient tree) of ``loss_fn(params)``; a leaf the loss does
    not reach gets zeros."""
    p = tree_map(lambda x: x.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(p)
        grads = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True)
    it = iter(grads)
    return loss.detach(), tree_map(lambda x: torch.zeros_like(x) if (g := next(it)) is None
                                   else g.detach(), p)


def adam_update(params, grads_list, tc, moments=None) -> dict:
    """The parameters after an emitting step of ``tc``'s optimizer
    (clip_by_global_norm(grad_clip), Adam b1 0.9, b2 0.999, eps 1e-8,
    decoupled weight decay, constant learning rate), from the mean of the
    ``accum_grad`` gradients in ``grads_list``, all taken at ``params``.
    ``moments``: (mu leaves, nu leaves, count) before the step; None for
    the first step (zero moments).  The bias corrections are exact (fp64)."""
    if tc.optim not in ("adam", "adamw") or tc.scheduler != "constantlr":
        raise ValueError("the reference follows adam/adamw at a constant learning rate")
    b1, b2, eps = 0.9, 0.999, 1e-8
    leaves = [torch.stack(gs).mean(0) for gs in zip(*(tree_leaves(g) for g in grads_list))]
    norm = float(torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                         for g in leaves])))
    scale = tc.grad_clip / norm if norm >= tc.grad_clip else 1.0
    wd = tc.weight_decay if tc.optim == "adamw" else 0.0
    mu, nu, count = moments if moments is not None else (None, None, 0)
    bc1, bc2 = 1.0 - b1 ** (count + 1), 1.0 - b2 ** (count + 1)
    out = []
    for k, (p, g) in enumerate(zip(tree_leaves(params), leaves)):
        g = g * scale
        m = (1 - b1) * g if mu is None else b1 * mu[k] + (1 - b1) * g
        v = (1 - b2) * g * g if nu is None else b2 * nu[k] + (1 - b2) * g * g
        out.append(p - tc.lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * p))
    it = iter(out)
    return tree_map(lambda _: next(it), params)
