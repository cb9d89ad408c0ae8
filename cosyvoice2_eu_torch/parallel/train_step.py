"""Training steps (speech LM, flow CFM), in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/parallel/train_step.py``
(``TrainState``, ``init_train_state``, ``lm_loss_fn``,
``make_lm_train_step``, ``flow_loss_fn``, ``make_flow_train_step``), on one
device or data-parallel over a process group (``DataParallel``, where the
JAX package lets XLA insert the gradient all-reduce over its mesh).  The
random draws that JAX makes from a key are a dict of tensors
(``make_flow_draws`` makes them from a ``torch.Generator``); gradients come
from ``torch.autograd.grad`` over the parameter tree, and a leaf that gets
none (the fixed inference noise ``rand_noise``) gets zeros, as
``jax.value_and_grad`` gives it.  Every step is ``make_step`` over its loss.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from cosyvoice2_eu_torch.config import FlowConfig, LMConfig, TrainConfig
from cosyvoice2_eu_torch.models.encoder import upsample_conformer_forward
from cosyvoice2_eu_torch.models.estimator import estimator_forward
from cosyvoice2_eu_torch.models.llm import lm_training_forward, moe_backbone
from cosyvoice2_eu_torch.ops.masks import make_non_pad_mask
from cosyvoice2_eu_torch.parallel.distributed import in_group
from cosyvoice2_eu_torch.train.losses import cfm_loss, label_smoothing_ce
from cosyvoice2_eu_torch.train.optim import Optimizer
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

def lm_loss_fn(params, cfg: LMConfig, batch: dict, train_cfg: TrainConfig,
               timer: Optional[StageTimer] = None):
    """batch: packed ids/src/target (B, T) and lengths (B,), as
    ``train/sequences.py::build_lm_batch`` makes them (unistream or
    bistream rows).  Returns (loss, {"loss", "acc", "denom", "acc_denom"}):
    the label-smoothing CE of the logits over the valid positions, and the
    counts the loss and the accuracy divide by.  A MoE backbone
    (deepseek_v3) adds its balance loss, a mean over rows, to the loss and
    reports both terms (``ce``, ``balance_loss``), the balance loss's count
    (``balance_loss_denom``: the rows), the chosen experts of each MoE
    layer (``routes``, (layers, B, T, K), left on the device) and the pairs
    its held experts got (``held_pairs``, a host int)."""
    valid = make_non_pad_mask(batch["lengths"], batch["ids"].shape[1])
    logits, aux = lm_training_forward(params, cfg, batch["ids"], batch["src"], valid, timer)
    loss, acc, denom, acc_denom = label_smoothing_ce(
        logits, batch["target"], smoothing=cfg.lsm_weight,
        normalize_length=cfg.length_normalized_loss, with_counts=True)
    metrics = {"loss": loss, "acc": acc, "denom": denom, "acc_denom": acc_denom}
    if aux:
        rows = valid.new_full((), valid.shape[0], dtype=torch.float32)  # no host copy, no sync
        metrics.update(ce=loss, balance_loss=aux["balance_loss"], balance_loss_denom=rows,
                       routes=aux["routes"], held_pairs=aux["held_pairs"])
        loss = metrics["loss"] = loss + aux["balance_loss"]
    return loss, metrics


def lm_terms(cfg: LMConfig) -> tuple:
    """``make_step``'s ``terms`` for ``lm_loss_fn``: a MoE backbone's loss is
    the CE plus the balance loss, each weighted by its own count under data
    parallelism (tokens, rows)."""
    return ("ce", "balance_loss") if moe_backbone(cfg) else ("loss",)


def make_lm_train_step(cfg: LMConfig, train_cfg: TrainConfig, tx: Optimizer,
                       timer: Optional[StageTimer] = None, mesh=None, thaw=None):
    """step(state, batch) -> (state, {"loss", "acc", "grad_norm"});
    data-parallel over ``mesh`` (this process's rows of the batch).
    ``timer`` also reaches the backbone's own stages.  ``thaw``, when
    given, puts back into the state's trained tree what the loss reads and
    never trains (``models/llm.py::split_frozen``)."""
    thaw = thaw or (lambda p: p)
    return make_step(lambda p, batch: lm_loss_fn(thaw(p), cfg, batch, train_cfg, timer), tx,
                     timer, mesh, lm_terms(cfg))


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
    ``make_flow_draws``.  Returns (loss, {"loss": loss, "denom": count}),
    the count being what the masked sum is divided by.

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

    loss, denom = cfm_loss(
        est_fn, feat.transpose(1, 2), mask, h.transpose(1, 2) * mask, spk, conds,
        draws["u_t"], draws["z"], draws["u_cfg"],
        sigma_min=cfg.cfm.sigma_min,
        training_cfg_rate=cfg.cfm.training_cfg_rate,
        t_scheduler=cfg.cfm.t_scheduler,
        with_count=True,
    )
    return loss, {"loss": loss, "denom": denom}


def _no_stage(name):
    return contextlib.nullcontext()


def value_and_grad(loss_fn, params, stage=_no_stage, scale=None):
    """(loss, metrics), grads of ``loss_fn(params) -> (loss, metrics)`` over
    every leaf of the parameter tree, as ``jax.value_and_grad(has_aux=True)``.

    The leaves enter as fresh tensors that require grad (the caller's are
    left alone); a leaf the loss does not reach gets a zero gradient.
    ``stage(name)`` wraps the "forward" and the "backward" pass.
    ``scale(loss, metrics)`` (optional), called between them, gives the
    tensor that is differentiated in place of the loss (the returned loss
    is the loss itself).
    """
    p = tree_map(lambda x: x.detach().requires_grad_(True), params)
    with torch.enable_grad():
        with stage("forward"):
            loss, metrics = loss_fn(p)
        scaled = loss if scale is None else scale(loss, metrics)
        with stage("backward"):
            grads = iter(torch.autograd.grad(scaled, tree_leaves(p), allow_unused=True))
            grads = tree_map(lambda x: torch.zeros_like(x) if (g := next(grads)) is None
                             else g, p)
    return (loss.detach(), {k: v.detach() if torch.is_tensor(v) else v
                            for k, v in metrics.items()}), grads


def _denom_keys(metrics: dict) -> list:
    return sorted(k for k in metrics if k == "denom" or k.endswith("_denom"))


class DataParallel:
    """The collectives of a data-parallel step over the process group.

    Every loss of the port divides a masked sum by a count that it reports
    in its metrics (``denom``; a metric ``m`` with a count of its own
    reports it as ``m_denom``).  The JAX package divides by the count over
    the *global* batch, so a plain mean of the processes' losses (DDP's) is
    another number whenever their counts differ, which the frame batcher
    makes them do in every real step.  Here each process's loss is weighted
    by ``count / sum of counts`` before its backward pass, the gradients are
    summed with one all-reduce of a flat buffer, and each metric is the
    count-weighted sum over the processes: the step is the one-process step
    on the global batch.  A loss that is a sum of terms with counts of
    their own (DPO: a token mean plus a row mean) names them in ``terms``;
    each is weighted by its own share.
    """

    def __init__(self, terms: tuple = ("loss",)):
        self.terms = terms
        self.shares: dict = {}

    def share(self, name: str) -> torch.Tensor:
        return self.shares.get(f"{name}_denom", self.shares["denom"])

    def scale(self, loss: torch.Tensor, metrics: dict) -> torch.Tensor:
        keys = _denom_keys(metrics)
        if "denom" not in keys:
            raise KeyError("a data-parallel loss must report its count as metrics['denom']")
        counts = torch.stack([metrics[k].detach().float() for k in keys])
        totals = counts.clone()
        dist.all_reduce(totals)
        self.shares = dict(zip(keys, counts / totals.clamp_min(1.0)))
        if self.terms == ("loss",):
            return loss * self.share("loss")
        return sum(metrics[t] * self.share(t) for t in self.terms)

    def metrics(self, metrics: dict) -> dict:
        """The count-weighted sum of each one-element tensor metric over
        the processes; any other metric (a MoE backbone's ``routes`` and
        ``held_pairs``) is this process's own, passed on as it is."""
        own = {k: v for k, v in metrics.items()
               if not (isinstance(v, torch.Tensor) and v.numel() == 1)}
        names = [k for k in metrics if k not in self.shares and k not in own]
        vals = torch.stack([metrics[k].float() * self.share(k) for k in names])
        dist.all_reduce(vals)
        out = dict(zip(names, vals.unbind()), **own)
        if self.terms != ("loss",):
            out["loss"] = sum(out[t] for t in self.terms)
        return out

    @staticmethod
    def sum_metrics(metrics: dict) -> dict:
        """Each metric summed over the processes (one all-reduce)."""
        vals = torch.stack([v.float() for v in metrics.values()])
        dist.all_reduce(vals)
        return dict(zip(metrics, vals.unbind()))

    @staticmethod
    def sum_grads(grads):
        """The gradients summed over the processes: one all-reduce per dtype
        of a flat buffer of every leaf."""
        leaves = tree_leaves(grads)
        out = list(leaves)
        by_dtype: dict = {}
        for i, g in enumerate(leaves):
            by_dtype.setdefault(g.dtype, []).append(i)
        for idx in by_dtype.values():
            buf = torch.cat([leaves[i].reshape(-1) for i in idx])
            dist.all_reduce(buf)
            off = 0
            for i in idx:
                n = leaves[i].numel()
                out[i] = buf[off:off + n].view(leaves[i].shape)
                off += n
        it = iter(out)
        return tree_map(lambda _: next(it), grads)


class _GatherRows(torch.autograd.Function):
    """The global batch's rows of ``x`` on every process: one all-reduce of
    a zero-filled (rows, ...) buffer into which each process writes its
    block; the backward pass takes this process's block of the gradient
    (every process differentiates the same global function)."""

    @staticmethod
    def forward(ctx, x, start: int, total: int):
        buf = x.new_zeros((total,) + tuple(x.shape[1:]))
        buf[start:start + x.shape[0]] = x
        dist.all_reduce(buf)
        ctx.block = (start, x.shape[0])
        return buf

    @staticmethod
    def backward(ctx, grad):
        start, n = ctx.block
        return grad[start:start + n], None, None


class RowShare:
    """This process's rows of a global batch, for losses that average over
    rows and terms that read every row (``train/gan.py``): ``share`` is the
    rows' fraction of the global batch, ``gather(x)`` the global rows of a
    per-row tensor.  All processes build it together (one all-reduce)."""

    def __init__(self, n_rows: int, mesh, device):
        counts = torch.zeros(mesh.world, dtype=torch.float64, device=device)
        counts[mesh.rank] = n_rows
        dist.all_reduce(counts)
        self.world = mesh.world
        self.total = int(counts.sum())
        self.start = int(counts[:mesh.rank].sum())
        self.share = n_rows / self.total

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherRows.apply(x, self.start, self.total)


def make_step(loss_fn, tx: Optimizer, timer: Optional[StageTimer] = None, mesh=None,
              terms: tuple = ("loss",)):
    """step(state, *args) -> (state, metrics): ``loss_fn(params, *args) ->
    (loss, metrics)`` differentiated over ``state.params``, then the
    optimizer; the metrics gain ``grad_norm``, the global norm of the
    gradients.  ``timer`` (optional) records the stages "forward",
    "backward" and "optimizer" of every step.

    With a ``mesh`` (``parallel/mesh.py``) in a process group, of any size,
    ``args`` are this process's rows of the global batch (and of its
    draws), and the step is the one-process step on the global batch
    (``DataParallel``).  ``terms``: the metrics whose sum is the loss,
    when they have counts of their own.  The counts (``*denom`` keys) are
    not among the metrics returned.
    """
    stage = timer.stage if timer is not None else _no_stage
    dp = DataParallel(terms) if mesh is not None and in_group() else None

    def step(state: TrainState, *args, **kwargs):
        (_, metrics), grads = value_and_grad(lambda p: loss_fn(p, *args, **kwargs),
                                             state.params, stage,
                                             None if dp is None else dp.scale)
        if dp is not None:
            with stage("all_reduce"):
                grads = dp.sum_grads(grads)
                metrics = dp.metrics(metrics)
        metrics = {k: v for k, v in metrics.items() if k not in _denom_keys(metrics)}
        with stage("optimizer"):
            params, opt_state = tx.step(state.params, grads, state.opt_state)
            metrics = dict(metrics, grad_norm=tx.grad_norm)
        return TrainState(params, opt_state, state.step + 1), metrics

    return step


def make_flow_train_step(cfg: FlowConfig, train_cfg: TrainConfig, tx: Optimizer,
                         timer: Optional[StageTimer] = None, mesh=None):
    """step(state, batch, draws, streaming=False) -> (state, {"loss", "grad_norm"});
    data-parallel over ``mesh`` (this process's rows of the batch and draws)."""
    return make_step(lambda p, batch, draws, streaming=False:
                     flow_loss_fn(p, cfg, batch, draws, streaming), tx, timer, mesh)
