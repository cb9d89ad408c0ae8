"""Optimizers and LR schedules, in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/train/optim.py`` (reference:
cosy_repo/cosyvoice/utils/train_utils.py:122 and utils/scheduler.py).  The
schedules evaluate in float32, as the JAX ones do inside optax.
``make_optimizer`` reproduces the JAX package's optax chain

    MultiSteps(apply_if_finite(chain(clip_by_global_norm(grad_clip),
                                     adam | adamw(schedule))), accum_grad)

value for value, as a hand-written update over the parameter tree (no
``torch.optim``): optax's clip (``g * max / |g|`` only when |g| >= max),
Adam's bias correction, the schedule read at the count before it
increments, the skip of a non-finite update that leaves the inner state as
it was, and MultiSteps' running mean over ``accum_grad`` micro-steps, whose
reset multiplies the sum by zero (so a non-finite micro-step poisons it, as
in optax).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from cosyvoice2_eu_torch.config import TrainConfig
from cosyvoice2_eu_torch.parallel.mesh import param_sharding_spec
from cosyvoice2_eu_torch.utils.params import tree_leaves, tree_map

_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32)


# ---------------------------------------------------------------------------
# schedules: step (int) -> learning rate (float32 scalar tensor)
# ---------------------------------------------------------------------------

def warmup_lr(lr: float, warmup_steps: int):
    """WarmupLR (scheduler.py:27): lr * warmup^0.5 * min(step^-0.5, step*warmup^-1.5)."""

    def sched(step):
        s = torch.clamp_min(_f32(step), 1.0)
        return lr * warmup_steps**0.5 * torch.minimum(s**-0.5, s * warmup_steps**-1.5)

    return sched


def constant_lr(lr: float, warmup_steps: int = 0):
    def sched(step):
        return _f32(lr)

    return sched


def noam_hold_annealing(lr: float, warmup_steps: int, hold_steps: int = 0,
                        decay_rate: float = 0.5, min_lr: float = 0.0):
    """NoamHoldAnnealing (reference scheduler.py:623): Noam warmup, optional
    hold plateau, then polynomial annealing to min_lr."""

    def sched(step):
        s = torch.clamp_min(_f32(step), 1.0)
        warm = lr * s / warmup_steps
        hold_end = warmup_steps + hold_steps
        decay = lr * ((hold_end / torch.clamp_min(s, hold_end)) ** decay_rate)
        out = torch.where(s <= warmup_steps, warm, torch.where(s <= hold_end, _f32(lr), decay))
        return torch.clamp_min(out, min_lr)

    return sched


def noam_annealing(lr: float, d_model: int, warmup_steps: int, min_lr: float = 0.0):
    """NoamAnnealing (scheduler.py:558): d_model^-0.5 scaled Noam curve;
    the min_lr floor applies only past warmup."""

    def sched(step):
        s = torch.clamp_min(_f32(step), 1.0)
        if warmup_steps > 0:
            mult = torch.minimum(s**-0.5, s * warmup_steps**-1.5)
        else:
            mult = s**-0.5
        out = lr * d_model**-0.5 * mult
        return torch.where(s > warmup_steps, torch.clamp_min(out, min_lr), out)

    return sched


def cosine_annealing(lr: float, max_steps: int, warmup_steps: int = 0,
                     constant_steps: int = 0, min_lr: float = 0.0):
    """CosineAnnealing (scheduler.py:497).  constant_steps == 0: linear
    warmup (step+1)/(warmup+1), then half-cosine to min_lr over max_steps;
    constant_steps > 0: the Megatron variant (warmup step/warmup, cosine
    over decay_steps, then hold at min_lr)."""

    def sched(step):
        s = _f32(step)
        if constant_steps == 0:
            warm = lr * (s + 1.0) / (warmup_steps + 1.0)
            frac = (s - warmup_steps) / max(max_steps - warmup_steps, 1)
            ann = (lr - min_lr) * 0.5 * (1.0 + torch.cos(math.pi * frac)) + min_lr
            out = torch.where((s <= warmup_steps) & (warmup_steps > 0), warm, ann)
            return torch.where(s > max_steps, _f32(min_lr), out)
        decay_steps = max_steps - (constant_steps + warmup_steps)
        warm = lr * s / max(warmup_steps, 1)
        ratio = torch.clamp((s - warmup_steps) / max(decay_steps, 1), 0.0, 1.0)
        coeff = 0.5 * (torch.cos(math.pi * ratio) + 1.0)
        ann = min_lr + coeff * (lr - min_lr)
        out = torch.where((s <= warmup_steps) & (warmup_steps > 0), warm, ann)
        return torch.where(s > warmup_steps + decay_steps, _f32(min_lr), out)

    return sched


def square_annealing(lr: float, max_steps: int, warmup_steps: int = 0, min_lr: float = 1e-5):
    """SquareAnnealing (scheduler.py:444): ((max-s)/max)^2 decay past warmup
    (both shifted by warmup_steps), floored at min_lr."""

    def sched(step):
        s = _f32(step)
        warm = lr * (s + 1.0) / (warmup_steps + 1.0)
        span = max(max_steps - warmup_steps, 1)
        mult = ((max_steps - warmup_steps) - (s - warmup_steps)) / span
        ann = torch.clamp_min(lr * mult**2, min_lr)
        out = torch.where((s <= warmup_steps) & (warmup_steps > 0), warm, ann)
        return torch.where(s > max_steps, _f32(min_lr), out)

    return sched


def squareroot_annealing(lr: float, max_steps: int, warmup_steps: int = 0,
                         min_lr: float = 0.0):
    """SquareRootAnnealing (scheduler.py:471): ((max-s)/max)^0.5 over the
    unshifted step, floored at min_lr."""

    def sched(step):
        s = _f32(step)
        warm = lr * (s + 1.0) / (warmup_steps + 1.0)
        mult = torch.clamp_min((max_steps - s) / max_steps, 0.0)
        ann = torch.clamp_min(lr * torch.sqrt(mult), min_lr)
        out = torch.where((s <= warmup_steps) & (warmup_steps > 0), warm, ann)
        return torch.where(s > max_steps, _f32(min_lr), out)

    return sched


def squareroot_constant(lr: float, max_steps: int, constant_steps: int, min_lr: float = 0.0):
    """SquareRootConstantPolicy (scheduler.py:137): 1/sqrt(constant_steps)
    (an absolute LR, not scaled by lr) up to constant_steps, lr to
    max_steps, then min_lr."""

    def sched(step):
        s = _f32(step)
        const = constant_steps**-0.5 if constant_steps > 0 else lr
        out = torch.where(s <= constant_steps, _f32(const), _f32(lr))
        return torch.where(s > max_steps, _f32(min_lr), out)

    return sched


def make_schedule(cfg: TrainConfig):
    if cfg.scheduler == "warmuplr":
        return warmup_lr(cfg.lr, cfg.warmup_steps)
    if cfg.scheduler == "constantlr":
        return constant_lr(cfg.lr)
    if cfg.scheduler == "noamhold":
        return noam_hold_annealing(cfg.lr, cfg.warmup_steps)
    if cfg.scheduler == "noamannealing":
        return noam_annealing(cfg.lr, cfg.sched_d_model, cfg.warmup_steps, min_lr=cfg.min_lr)
    if cfg.scheduler == "cosineannealing":
        return cosine_annealing(cfg.lr, cfg.max_steps, cfg.warmup_steps,
                                constant_steps=cfg.constant_steps, min_lr=cfg.min_lr)
    if cfg.scheduler == "squareannealing":
        return square_annealing(cfg.lr, cfg.max_steps, cfg.warmup_steps,
                                min_lr=max(cfg.min_lr, 1e-5))
    if cfg.scheduler == "squarerootannealing":
        return squareroot_annealing(cfg.lr, cfg.max_steps, cfg.warmup_steps, min_lr=cfg.min_lr)
    if cfg.scheduler == "squarerootconstant":
        return squareroot_constant(cfg.lr, cfg.max_steps, cfg.constant_steps, min_lr=cfg.min_lr)
    raise ValueError(f"unknown scheduler {cfg.scheduler}")


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (optax.global_norm), from one
    multi-tensor pass over the leaves."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tree_leaves(tree))))


def _all_finite(leaves: list) -> bool:
    # x * 0 is 0 for a finite x and NaN for an inf or a NaN
    return bool(torch.isfinite(_finite_sum(leaves)))


def _finite_sum(leaves: list) -> torch.Tensor:
    return torch.stack(torch._foreach_norm(torch._foreach_mul(leaves, 0.0))).sum()


def _bias_correction(decay: float, count: int) -> float:
    # 1 - decay^count in float32, as optax computes it
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def _unflatten(tree, leaves: list):
    """``tree``'s structure with ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


class Optimizer:
    """The optax chain of ``make_optimizer``, over a tree of fp32 tensors.

    ``init(params)`` gives the state: a dict of tensor trees (Adam moments,
    the MultiSteps sum) and integer counters, which ``torch.save`` stores as
    it is.  ``step(params, grads, state)`` returns ``(params, state)``: the
    result of optax's ``tx.update`` then ``apply_updates``.  It does not
    modify its arguments; on a step that emits no update the parameters come
    back as the same tensors.  Each elementwise stage is one multi-tensor
    (``torch._foreach_*``) operation over all leaves.

    With a ``mesh`` of ``fsdp`` > 1 (``parallel/mesh.py``) the state is
    sharded, ZeRO-2 style: each process of an fsdp group keeps the moments
    and the MultiSteps sum only for its slice of each leaf, along
    ``param_sharding_spec``'s axis (leaves with no such axis stay whole on
    every process).  Parameters and gradients stay whole: each process
    updates its slices and rebuilds every parameter with one all-reduce over
    the group.  The global norm of the clip and the finite check are taken
    over the group, so every process clips and skips alike.
    ``gather_state`` / ``shard_state`` convert to and from the whole state
    that checkpoints hold, so a checkpoint restores at any fsdp size.
    """

    B1, B2, EPS = 0.9, 0.999, 1e-8
    MAX_CONSECUTIVE_ERRORS = 100000  # apply_if_finite's give-up count
    SHARDED = ("mu", "nu", "acc_grads")

    def __init__(self, cfg: TrainConfig, mesh=None):
        if cfg.optim not in ("adam", "adamw"):
            raise ValueError(f"unknown optimizer {cfg.optim}")
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.weight_decay = cfg.weight_decay if cfg.optim == "adamw" else None
        self.k = cfg.accum_grad
        self.mesh = mesh if mesh is not None and mesh.fsdp > 1 else None

    # -- the fsdp slices ------------------------------------------------------

    def _axes(self, leaves: list) -> list:
        if self.mesh is None:
            return [None] * len(leaves)
        return [param_sharding_spec(x, self.mesh.fsdp) for x in leaves]

    def _slices(self, leaves: list, axes: list) -> list:
        """This process's slice of each leaf (a view; the leaf where unsharded)."""
        if self.mesh is None:
            return leaves
        r, n = self.mesh.fsdp_rank, self.mesh.fsdp
        return [x if ax is None else x.chunk(n, ax)[r] for x, ax in zip(leaves, axes)]

    def _gather(self, full_like: list, slices: list, axes: list) -> list:
        """Whole leaves from every process's slices: one all-reduce over the
        group of a zero-filled flat buffer into which each writes its slices
        (unsharded leaves are the process's own, equal on every process)."""
        sharded = [i for i, ax in enumerate(axes) if ax is not None]
        out = list(slices)
        if not sharded:
            return out
        buf = torch.cat([torch.zeros_like(full_like[i]).reshape(-1) for i in sharded])
        views, off = [], 0
        for i in sharded:
            n = full_like[i].numel()
            whole = buf[off:off + n].view(full_like[i].shape)
            whole.chunk(self.mesh.fsdp, axes[i])[self.mesh.fsdp_rank].copy_(slices[i])
            views.append(whole)
            off += n
        dist.all_reduce(buf, group=self.mesh.fsdp_group)
        for i, v in zip(sharded, views):
            out[i] = v
        return out

    def _norm_and_finite(self, g: list, axes: list) -> tuple:
        """(global norm, all finite) of the gradient whose slices are ``g``:
        a leaf kept whole counts once, on the group's first process."""
        if self.mesh is None:
            return float(global_norm(g)), _all_finite(g)
        own = [x for x, ax in zip(g, axes) if ax is not None or self.mesh.fsdp_rank == 0]
        sq = torch.stack(torch._foreach_norm(own)).square().sum() if own \
            else torch.zeros((), device=g[0].device)
        nf = _finite_sum(own) if own else torch.zeros((), device=g[0].device)
        both = torch.stack([sq.float(), nf.float()])
        dist.all_reduce(both, group=self.mesh.fsdp_group)
        return float(both[0].sqrt()), bool(torch.isfinite(both[1]))

    def init(self, params, shard: bool = True) -> dict:
        """The initial state; ``shard=False`` gives the whole state a
        checkpoint holds, whatever the mesh."""
        leaves = tree_leaves(params)
        axes = self._axes(leaves) if shard else [None] * len(leaves)
        zeros = lambda: _unflatten(params, [  # noqa: E731
            torch.zeros_like(x) for x in self._slices(leaves, axes)])
        state = {
            # apply_if_finite
            "notfinite_count": 0, "last_finite": True, "total_notfinite": 0,
            # scale_by_adam and scale_by_schedule
            "count": 0, "mu": zeros(), "nu": zeros(), "schedule_count": 0,
        }
        if self.k > 1:  # MultiSteps
            state.update(mini_step=0, gradient_step=0, acc_grads=zeros())
        return state

    def gather_state(self, state: dict, params) -> dict:
        """The whole state from every process's slices (a collective over the
        fsdp group; ``params`` gives the whole shapes); the state as it is
        without a mesh."""
        if self.mesh is None:
            return state
        full = tree_leaves(params)
        axes = self._axes(full)
        out = dict(state)
        for key in self.SHARDED:
            if key in state:
                out[key] = _unflatten(state[key],
                                      self._gather(full, tree_leaves(state[key]), axes))
        return out

    def shard_state(self, state: dict) -> dict:
        """This process's slices of a whole state (a checkpoint's)."""
        if self.mesh is None:
            return state
        out = dict(state)
        for key in self.SHARDED:
            if key in state:
                leaves = tree_leaves(state[key])
                axes = self._axes(leaves)
                out[key] = _unflatten(state[key], [x.clone() for x in
                                                   self._slices(leaves, axes)])
        return out

    def _inner(self, g: list, state, params, p: list, axes: list):
        """apply_if_finite(chain(clip_by_global_norm, adam|adamw)) then
        apply_updates, on this process's slices ``g`` of the gradient of the
        parameters ``p`` (whole leaves, sharded along ``axes``)."""
        state = dict(state)
        g_norm, finite = self._norm_and_finite(g, axes)
        state["notfinite_count"] = 0 if finite else state["notfinite_count"] + 1
        state["last_finite"] = finite
        state["total_notfinite"] += 0 if finite else 1
        if not (finite or state["notfinite_count"] > self.MAX_CONSECUTIVE_ERRORS):
            return params, state  # rejected: zero update, inner state unchanged

        # clip_by_global_norm: g * max / |g| unless |g| < max (the norm is
        # an fp32 value, so its Python float is exact)
        max_norm = self.cfg.grad_clip
        if not g_norm < max_norm:
            g = torch._foreach_div(g, g_norm)
            torch._foreach_mul_(g, max_norm)

        b1, b2 = self.B1, self.B2
        mu = torch._foreach_mul(tree_leaves(state["mu"]), b1)   # (1 - b1) g + b1 m
        torch._foreach_add_(mu, g, alpha=1 - b1)
        nu = torch._foreach_mul(tree_leaves(state["nu"]), b2)   # (1 - b2) g^2 + b2 v
        torch._foreach_addcmul_(nu, g, g, value=1 - b2)
        count = state["count"] + 1
        bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
        denom = torch._foreach_div(nu, bc2)                      # sqrt(v / bc2) + eps
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.EPS)
        upd = torch._foreach_div(mu, bc1)                        # (m / bc1) / denom
        torch._foreach_div_(upd, denom)
        p_own = self._slices(p, axes)
        if self.weight_decay is not None:
            torch._foreach_add_(upd, p_own, alpha=self.weight_decay)
        # scale_by_learning_rate (lr(count) is a float32 value, exact as a
        # float), then apply_updates: p + (-lr u)
        torch._foreach_mul_(upd, -float(self.schedule(state["schedule_count"])))
        torch._foreach_add_(upd, p_own)
        if self.mesh is not None:
            upd = self._gather(p, upd, axes)
        params_out = _unflatten(params, upd)
        state.update(mu=_unflatten(state["mu"], mu), nu=_unflatten(state["nu"], nu),
                     count=count, schedule_count=state["schedule_count"] + 1)
        return params_out, state

    def step(self, params, grads, state):
        p = tree_leaves(params)
        axes = self._axes(p)
        g = self._slices(tree_leaves(grads), axes)
        if self.k == 1:
            return self._inner(g, state, params, p, axes)
        n = state["mini_step"]
        # Welford running mean, as MultiSteps(use_grad_mean=True): a + (g - a) / (n + 1)
        a = tree_leaves(state["acc_grads"])
        acc = torch._foreach_sub(g, a)
        torch._foreach_div_(acc, n + 1)
        torch._foreach_add_(acc, a)
        state = dict(state)
        if n < self.k - 1:
            # optax also runs the inner update here and multiplies it by 0;
            # it is zero (the inner update of a finite mean is finite, and a
            # non-finite one is rejected), so it is skipped
            state.update(mini_step=n + 1, acc_grads=_unflatten(state["acc_grads"], acc))
            return params, state
        inner = {k: v for k, v in state.items()
                 if k not in ("mini_step", "gradient_step", "acc_grads")}
        params, inner = self._inner(acc, inner, params, p, axes)
        state.update(inner)
        state.update(mini_step=0, gradient_step=state["gradient_step"] + 1,
                     acc_grads=_unflatten(state["acc_grads"],
                                          torch._foreach_mul(acc, 0.0)))  # (1 - emit) acc
        return params, state


def make_optimizer(cfg: TrainConfig, mesh=None) -> Optimizer:
    """clip-by-global-norm -> adam/adamw(schedule), skipping non-finite
    updates, accumulated over ``cfg.accum_grad`` micro-steps; its state
    sharded over ``mesh``'s fsdp groups when given."""
    return Optimizer(cfg, mesh)
