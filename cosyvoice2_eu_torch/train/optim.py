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
in optax).  The arithmetic is ``ops/optim_passes.py``'s: two fused passes
over flat state buffers, or its plain version.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from cosyvoice2_eu_torch.config import TrainConfig
from cosyvoice2_eu_torch.ops import optim_passes as passes
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


def _finite_sum(leaves: list) -> torch.Tensor:
    # x * 0 is 0 for a finite x and NaN for an inf or a NaN
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
    modify its arguments: every tensor it returns is new, or one it was
    given.

    Each tree of the state lies in a flat buffer of its own
    (``ops/optim_passes.py::FlatLayout``, found by the gradient's sizes),
    each leaf a view of it: a step that meets a state whose trees are not
    such views (the first step, a restored checkpoint) copies them into
    flat buffers once (``adopt``).  Each micro-step runs pass A (the running
    mean), each emission reads the clip's norm and the finite check and, if
    finite, runs pass B (the update); on a step that emits no update the
    parameters come back as they were.  Without a mesh (or at ``fsdp`` 1)
    the parameters lie in a flat buffer too, returned as its views, and
    pass A also gives ``grad_norm``, the clip's norm and the finite check,
    read in the step's one sync.

    With a ``mesh`` of ``fsdp`` > 1 (``parallel/mesh.py``) the state is
    sharded, ZeRO-2 style: each process of an fsdp group keeps the moments
    and the MultiSteps sum only for its slice of each leaf, along
    ``param_sharding_spec``'s axis (leaves with no such axis stay whole on
    every process); its flat layout is that of its slices.  Parameters and
    gradients stay whole: each process updates its slices (pass B over a
    flat copy of its parameters' slices) and rebuilds every parameter with
    one all-reduce over the group.  The global norm of the clip and the
    finite check are taken over the group, so every process clips and skips
    alike; with ``accum_grad`` 1 no pass A runs.
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
        self._layouts: list = []  # one a tree met (GAN: the generator's, the critics')
        self.grad_norm = None  # the last step's gradient norm

    def _hyper(self, norm: float, state: dict) -> passes.Hyper:
        """The numbers of the update from ``state`` with the clip's norm ``norm``."""
        count = state["count"] + 1
        return passes.Hyper(norm, self.cfg.grad_clip, self.B1, self.B2,
                            _bias_correction(self.B1, count), _bias_correction(self.B2, count),
                            self.EPS, self.weight_decay,
                            # lr(count) is a float32 value, exact as a float
                            float(self.schedule(state["schedule_count"])))

    def _if_finite(self, state: dict, finite: bool) -> bool:
        """apply_if_finite's counters, in ``state``; whether the update applies
        (a rejected one is zero and leaves the inner state as it was)."""
        state["notfinite_count"] = 0 if finite else state["notfinite_count"] + 1
        state["last_finite"] = finite
        state["total_notfinite"] += 0 if finite else 1
        return finite or state["notfinite_count"] > self.MAX_CONSECUTIVE_ERRORS

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

    # -- the step -------------------------------------------------------------

    def step(self, params, grads, state):
        """(params, state) after one micro-step; ``self.grad_norm`` is then the
        global norm of ``grads`` (a 0-d tensor, not synced: pass A's sum
        without a mesh)."""
        sharded = self.mesh is not None
        g = tree_leaves(grads)
        if sharded:
            self.grad_norm = global_norm(grads)
            p = tree_leaves(params)
            axes = self._axes(p)
            g = self._slices(g, axes)
        layout = self._layout(g)
        n = state["mini_step"] if self.k > 1 else 0
        emit = n == self.k - 1
        trees = {} if sharded else {"params": params}
        trees.update(mu=state["mu"], nu=state["nu"])
        if self.k > 1:
            trees["acc_grads"] = state["acc_grads"]
        state = dict(state)
        # (buffer, builder) of each tree the step reads: all of them when it emits
        flat = self._flat_trees(layout, trees, [key for key in trees
                                                if emit or key == "acc_grads"], state)
        params = state.pop("params", params)
        views = lambda key, buf: layout.build(key, flat[key][1], buf)  # noqa: E731
        mean = None
        if self.k > 1 or not sharded:
            # sharded, the clip's norm and the finite check are the group's, not pass A's
            mean, sums = passes.accumulate(layout, g, flat["acc_grads"][0] if self.k > 1
                                           else None, n, emit and not sharded)
            if not sharded:
                self.grad_norm = sums[0]
            if not emit:
                state.update(mini_step=n + 1, acc_grads=views("acc_grads", mean))
                return params, state
        if sharded:
            norm, finite = self._norm_and_finite(g if mean is None else layout.views(mean), axes)
        else:
            norm, bad = sums[1:].tolist()  # the step's one sync
            finite = bad == 0
        reset = None
        if self._if_finite(state, finite):
            p_flat = layout.flatten(self._slices(p, axes)) if sharded else flat["params"][0]
            mu, nu, p_new, reset = passes.update(layout, g if mean is None else mean,
                                                 flat["mu"][0], flat["nu"][0], p_flat,
                                                 self._hyper(norm, state), reset=mean is not None)
            params = (_unflatten(params, self._gather(p, layout.views(p_new), axes)) if sharded
                      else views("params", p_new))
            state.update(mu=views("mu", mu), nu=views("nu", nu),
                         count=state["count"] + 1, schedule_count=state["schedule_count"] + 1)
        elif mean is not None:
            reset = mean * 0.0  # (1 - emit) acc, also after a rejected update
        if mean is not None:
            state.update(mini_step=0, gradient_step=state["gradient_step"] + 1,
                         acc_grads=views("acc_grads", reset))
        return params, state

    def _layout(self, g: list) -> passes.FlatLayout:
        for layout in self._layouts:
            if layout.matches(g):
                return layout
        self._layouts.append(passes.FlatLayout(g))
        return self._layouts[-1]

    @staticmethod
    def _flat_trees(layout: passes.FlatLayout, trees: dict, read: list, state: dict) -> dict:
        """(flat buffer, builder) of each tree of ``trees`` named in ``read``.
        Where one of them is not a tree of views of a flat buffer at
        ``layout``'s offsets (the first step, a restored checkpoint), every
        tree of ``trees`` is copied into a flat buffer of its own
        (``adopt``), and ``state`` takes the trees of views of the copies."""
        flat = {key: layout.flat(key, trees[key]) for key in read}
        if None not in flat.values():
            return flat
        leaves = {key: tree_leaves(tree) for key, tree in trees.items()}
        if any([x.shape for x in v] != layout.shapes for v in leaves.values()):
            raise ValueError("the state's shapes are not those of the tree of the same sizes "
                             "that this optimizer met first")
        bufs = passes.adopt(layout, leaves)
        flat = {key: (buf, layout.builder(trees[key])) for key, buf in bufs.items()}
        state.update({key: layout.build(key, flat[key][1], buf) for key, buf in bufs.items()})
        return flat


def make_optimizer(cfg: TrainConfig, mesh=None) -> Optimizer:
    """clip-by-global-norm -> adam/adamw(schedule), skipping non-finite
    updates, accumulated over ``cfg.accum_grad`` micro-steps; its state
    sharded over ``mesh``'s fsdp groups when given."""
    return Optimizer(cfg, mesh)
