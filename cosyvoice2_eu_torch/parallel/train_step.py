"""Training steps (speech LM, flow CFM), in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/parallel/train_step.py``
(``TrainState``, ``init_train_state``, ``lm_loss_fn``,
``make_lm_train_step``, ``flow_loss_fn``, ``make_flow_train_step``), on one
device.  The random draws that JAX makes from a key are a dict of tensors
(``make_flow_draws`` makes them from a ``torch.Generator``); gradients come
from ``torch.autograd.grad`` over the parameter tree, and a leaf that gets
none (the fixed inference noise ``rand_noise``) gets zeros, as
``jax.value_and_grad`` gives it.  Every step is ``make_step`` over its loss.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from cosyvoice2_eu_torch.config import FlowConfig, LMConfig, TrainConfig
from cosyvoice2_eu_torch.models.encoder import upsample_conformer_forward
from cosyvoice2_eu_torch.models.estimator import estimator_forward
from cosyvoice2_eu_torch.models.llm import lm_training_hidden
from cosyvoice2_eu_torch.ops.masks import make_non_pad_mask
from cosyvoice2_eu_torch.train.losses import cfm_loss, label_smoothing_ce
from cosyvoice2_eu_torch.train.optim import Optimizer, global_norm
from cosyvoice2_eu_torch.utils.params import dense, embedding, tree_leaves, tree_map
from cosyvoice2_eu_torch.utils.profiling import StageTimer


class TrainState(NamedTuple):
    params: dict
    opt_state: dict
    step: int


def init_train_state(params, tx: Optimizer) -> TrainState:
    return TrainState(params, tx.init(params), 0)


# ---------------------------------------------------------------------------
# speech LM
# ---------------------------------------------------------------------------

def lm_loss_fn(params, cfg: LMConfig, batch: dict, train_cfg: TrainConfig):
    """batch: packed ids/src/target (B, T) and lengths (B,), as
    ``train/sequences.py::build_lm_batch`` makes them (unistream or
    bistream rows).  Returns (loss, {"loss", "acc"}): the label-smoothing CE
    of the logits over the valid positions."""
    valid = make_non_pad_mask(batch["lengths"], batch["ids"].shape[1])
    logits = lm_training_hidden(params, cfg, batch["ids"], batch["src"], valid)
    loss, acc = label_smoothing_ce(logits, batch["target"], smoothing=cfg.lsm_weight,
                                   normalize_length=cfg.length_normalized_loss)
    return loss, {"loss": loss, "acc": acc}


def make_lm_train_step(cfg: LMConfig, train_cfg: TrainConfig, tx: Optimizer,
                       timer: Optional[StageTimer] = None):
    """step(state, batch) -> (state, {"loss", "acc", "grad_norm"})."""
    return make_step(lambda p, batch: lm_loss_fn(p, cfg, batch, train_cfg), tx, timer)


# ---------------------------------------------------------------------------
# flow (CFM)
# ---------------------------------------------------------------------------

def make_flow_draws(gen: torch.Generator, batch: dict, n_mels: int) -> dict:
    """The draws of one flow step, with the shapes JAX draws them in.

    u_cond, u_frac, u_cfg: (B,) uniform; u_t: (B, 1, 1) uniform; z:
    (B, n_mels, T_mel) standard normal; all on the generator's device.
    """
    b, t_mel = batch["speech_feat"].shape[:2]
    dev = gen.device
    return {
        "u_cond": torch.rand((b,), generator=gen, device=dev),
        "u_frac": torch.rand((b,), generator=gen, device=dev),
        "u_t": torch.rand((b, 1, 1), generator=gen, device=dev),
        "z": torch.randn((b, n_mels, t_mel), generator=gen, device=dev),
        "u_cfg": torch.rand((b,), generator=gen, device=dev),
    }


def flow_loss_fn(params, cfg: FlowConfig, batch: dict, draws: dict, streaming: bool):
    """batch: speech_token (B, T_tok), speech_token_len, speech_feat
    (B, T_mel, 80), speech_feat_len, embedding (B, 192); draws as
    ``make_flow_draws``.  Returns (loss, {"loss": loss}).

    Mirrors CausalMaskedDiffWithXvec.forward (reference flow.py:189-233):
    unified streaming/non-streaming training, random prompt conditioning.
    """
    token = batch["speech_token"]
    token_len = batch["speech_token_len"]
    feat = batch["speech_feat"]
    feat_len = batch["speech_feat_len"]
    b, t_tok = token.shape
    t_mel = feat.shape[1]

    spk = batch["embedding"]
    spk = spk / torch.linalg.norm(spk, dim=1, keepdim=True).clamp_min(1e-12)
    spk = dense(params["spk_embed_affine_layer"], spk)

    tok_mask = make_non_pad_mask(token_len, t_tok)[..., None].to(feat.dtype)
    h_tok = embedding(params["input_embedding"], token.clamp_min(0)) * tok_mask
    h, _ = upsample_conformer_forward(params["encoder"], cfg.encoder, h_tok, token_len,
                                      streaming=streaming)
    h = dense(params["encoder_proj"], h)  # (B, T_mel', 80)
    # trim/pad to the target mel length
    if h.shape[1] > t_mel:
        h = h[:, :t_mel]
    elif h.shape[1] < t_mel:
        h = torch.nn.functional.pad(h, (0, 0, 0, t_mel - h.shape[1]))

    # random prompt conditioning: 50% of rows expose a random prefix (0-30%)
    use_cond = draws["u_cond"] < 0.5
    frac = draws["u_frac"] * 0.3
    cond_len = (frac * feat_len.float()).to(torch.int32)
    idx = torch.arange(t_mel, device=feat.device)[None, :]
    cond_mask = (idx < cond_len[:, None]) & use_cond[:, None]
    conds = torch.where(cond_mask[..., None], feat, 0.0).transpose(1, 2)

    mask = make_non_pad_mask(feat_len, t_mel)[:, None].to(feat.dtype)

    def est_fn(y, m, mu, t, s, c):
        return estimator_forward(params["estimator"], cfg.estimator, y, m, mu, t, s, c,
                                 streaming=streaming)

    loss = cfm_loss(
        est_fn, feat.transpose(1, 2), mask, h.transpose(1, 2) * mask, spk, conds,
        draws["u_t"], draws["z"], draws["u_cfg"],
        sigma_min=cfg.cfm.sigma_min,
        training_cfg_rate=cfg.cfm.training_cfg_rate,
        t_scheduler=cfg.cfm.t_scheduler,
    )
    return loss, {"loss": loss}


def _no_stage(name):
    return contextlib.nullcontext()


def value_and_grad(loss_fn, params, stage=_no_stage):
    """(loss, metrics), grads of ``loss_fn(params) -> (loss, metrics)`` over
    every leaf of the parameter tree, as ``jax.value_and_grad(has_aux=True)``.

    The leaves enter as fresh tensors that require grad (the caller's are
    left alone); a leaf the loss does not reach gets a zero gradient.
    ``stage(name)`` wraps the "forward" and the "backward" pass.
    """
    p = tree_map(lambda x: x.detach().requires_grad_(True), params)
    with torch.enable_grad():
        with stage("forward"):
            loss, metrics = loss_fn(p)
        with stage("backward"):
            grads = iter(torch.autograd.grad(loss, tree_leaves(p), allow_unused=True))
            grads = tree_map(lambda x: torch.zeros_like(x) if (g := next(grads)) is None
                             else g, p)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), grads


def make_step(loss_fn, tx: Optimizer, timer: Optional[StageTimer] = None):
    """step(state, *args) -> (state, metrics): ``loss_fn(params, *args) ->
    (loss, metrics)`` differentiated over ``state.params``, then the
    optimizer; the metrics gain ``grad_norm``, the global norm of the
    gradients.  ``timer`` (optional) records the stages "forward",
    "backward" and "optimizer" of every step."""
    stage = timer.stage if timer is not None else _no_stage

    def step(state: TrainState, *args, **kwargs):
        (_, metrics), grads = value_and_grad(lambda p: loss_fn(p, *args, **kwargs),
                                             state.params, stage)
        with stage("optimizer"):
            params, opt_state = tx.step(state.params, grads, state.opt_state)
            metrics = dict(metrics, grad_norm=global_norm(grads))
        return TrainState(params, opt_state, state.step + 1), metrics

    return step


def make_flow_train_step(cfg: FlowConfig, train_cfg: TrainConfig, tx: Optimizer,
                         timer: Optional[StageTimer] = None):
    """step(state, batch, draws, streaming=False) -> (state, {"loss", "grad_norm"})."""
    return make_step(lambda p, batch, draws, streaming=False:
                     flow_loss_fn(p, cfg, batch, draws, streaming), tx, timer)
