"""Training executor: epoch loop, cross-validation, checkpoints, in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/train/executor.py`` (reference:
cosy_repo/cosyvoice/utils/executor.py:26-176, train_utils.py:206-246
save_model, bin/train.py:420-473 resume, bin/average_model.py:44-75).

A checkpoint ``<model_dir>/<tag>`` is a ``torch.save`` file of the parameter
tree, ``<tag>-opt`` one of the optimizer state (when saved), and
``<tag>.json`` the sidecar with the keys the JAX package writes (``tag``,
``has_opt``, ``save_time`` and the caller's ``epoch``, ``step``,
``cv_loss``), which resume and best-N averaging read back.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist

from cosyvoice2_eu_torch.config import TrainConfig
from cosyvoice2_eu_torch.parallel.distributed import (
    collective_device,
    is_distributed,
    rank_and_world,
)
from cosyvoice2_eu_torch.utils.params import tree_map


def _to_cpu(tree):
    return tree_map(lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x, tree)


def save_checkpoint(model_dir: str, tag: str, params, info: dict, opt_state=None) -> str:
    """Persist params (and the optimizer state, when given) with a JSON sidecar."""
    path = os.path.join(model_dir, tag)
    torch.save(_to_cpu(params), path)
    if opt_state is not None:
        torch.save(_to_cpu(opt_state), path + "-opt")
    with open(path + ".json", "w") as f:
        json.dump(dict(info, tag=tag, has_opt=opt_state is not None,
                       save_time=time.strftime("%d/%m/%Y %H:%M:%S")), f, indent=2)
    return path


def _load(path: str):
    # a checkpoint holds only tensor trees and numbers, which weights_only reads
    return torch.load(path, map_location="cpu", weights_only=True)


def _like(template, restored):
    """``restored``'s values on ``template``'s devices and in its dtypes."""
    return tree_map(lambda t, r: r.to(device=t.device, dtype=t.dtype)
                    if isinstance(t, torch.Tensor) else r, template, restored)


def load_params(path: str, like):
    """The parameter tree saved at ``path`` (a checkpoint's params file, as
    ``save_checkpoint`` writes it), on ``like``'s devices and in its dtypes."""
    return _like(like, _load(path))


def restore_train_state(model_dir: str, info: dict, state, tx=None):
    """Rebuild a TrainState from a checkpoint.

    ``state`` is a freshly initialised TrainState used as the template of
    structure, devices and dtypes.  Restores the parameters, the optimizer
    state when the checkpoint has one (Adam moments, the schedule's count
    and the MultiSteps sum resume exactly) and the step counter.  A
    checkpoint holds the whole optimizer state; ``tx`` (an ``Optimizer``
    with a mesh) takes this process's slices of it, so a checkpoint written
    at any fsdp size restores at any other.
    """
    path = os.path.join(model_dir, info["tag"])
    params = load_params(path, state.params)
    opt_state = state.opt_state
    if info.get("has_opt"):
        if tx is None:
            opt_state = _like(state.opt_state, _load(path + "-opt"))
        else:
            opt_state = tx.shard_state(_like(tx.init(params, shard=False), _load(path + "-opt")))
    return type(state)(params, opt_state, int(info.get("step", 0)))


def list_checkpoints(model_dir: str) -> list[dict]:
    out = []
    for name in os.listdir(model_dir) if os.path.isdir(model_dir) else []:
        if name.endswith(".json"):
            with open(os.path.join(model_dir, name)) as f:
                out.append(json.load(f))
    return out


def latest_checkpoint(model_dir: str) -> Optional[dict]:
    """Resume picker: newest checkpoint by save order (bin/train.py:420-455)."""
    infos = list_checkpoints(model_dir)
    if not infos:
        return None
    return max(infos, key=lambda i: (i.get("epoch", -1), i.get("step", -1)))


def average_checkpoints(model_dir: str, num: int = 5, metric: str = "cv_loss"):
    """Average the top-N checkpoints by CV loss (average_model.py:44-75).

    Returns (the fp32 average parameter tree on the CPU, the chosen tags).
    """
    infos = [i for i in list_checkpoints(model_dir) if metric in i]
    infos.sort(key=lambda i: i[metric])
    chosen = infos[:num]
    if not chosen:
        raise ValueError(f"no checkpoints with {metric} in {model_dir}")
    acc = None
    for info in chosen:
        tree = _load(os.path.join(model_dir, info["tag"]))
        if acc is None:
            acc = tree_map(lambda a: a.double(), tree)
        else:
            acc = tree_map(lambda a, b: a + b.double(), acc, tree)
    n = len(chosen)
    return tree_map(lambda a: (a / n).float(), acc), [i["tag"] for i in chosen]


def _scalar(v) -> bool:
    """A metric that logs as one number (a MoE backbone's ``routes`` do not)."""
    return isinstance(v, (int, float)) or (isinstance(v, torch.Tensor) and v.numel() == 1)


class Executor:
    """Epoch loop with periodic CV and step checkpoints.

    ``step_fn(state, batch) -> (state, metrics)``; ``cv_fn(params, batch) ->
    metrics`` runs under ``torch.no_grad()``; ``log_fn`` gets the metrics
    that are one number (as floats, with step and epoch) every
    ``log_interval`` steps;
    ``on_step(step)`` runs after every step (the trainer hangs
    ``StragglerGuard.beat`` on it).

    In a process group, CV losses combine over the processes, and ``tx``
    (the step's ``Optimizer``, when its state is sharded) gathers the whole
    optimizer state for each checkpoint, which process 0 alone writes.
    """

    def __init__(
        self,
        train_cfg: TrainConfig,
        step_fn: Callable,
        cv_fn: Optional[Callable] = None,
        model_dir: str = "exp",
        log_fn: Optional[Callable[[dict], None]] = None,
        tx=None,
    ):
        self.cfg = train_cfg
        self.tx = tx
        self.step_fn = step_fn
        self.cv_fn = cv_fn
        self.model_dir = model_dir
        self.log_fn = log_fn or (lambda m: None)
        self.step = 0
        self.epoch = 0
        self.on_step: Callable[[int], None] = lambda step: None
        os.makedirs(model_dir, exist_ok=True)

    def cross_validate(self, state, cv_batches) -> float:
        """Utterance-weighted CV loss (executor.py:146-176).

        ``cv_batches`` may be a re-iterable, or a zero-argument factory of a
        fresh iterator (needed when CV runs more than once per epoch)."""
        batches = cv_batches() if callable(cv_batches) else cv_batches
        total, weight = 0.0, 0
        with torch.no_grad():
            for batch in batches:
                metrics = self.cv_fn(state.params, batch)
                n = int(next(iter(batch.values())).shape[0])
                total += float(metrics["loss"]) * n
                weight += n
        if is_distributed():
            sums = torch.tensor([total, weight], dtype=torch.float64,
                                device=collective_device())
            dist.all_reduce(sums)
            total, weight = float(sums[0]), int(sums[1])
        return total / max(weight, 1)

    def save(self, tag: str, state, info: dict) -> None:
        """The checkpoint ``tag`` of ``state``, with the whole optimizer
        state, written by process 0."""
        opt_state = (self.tx.gather_state(state.opt_state, state.params)
                     if self.tx is not None else state.opt_state)
        if rank_and_world()[0] == 0:
            save_checkpoint(self.model_dir, tag, state.params, info, opt_state=opt_state)

    def train_epoch(self, state, train_batches: Iterable[dict], cv_batches=None):
        cfg = self.cfg
        for batch in train_batches:
            state, metrics = self.step_fn(state, batch)
            self.step += 1
            self.on_step(self.step)
            if self.step % cfg.log_interval == 0:
                log = {k: float(v) for k, v in metrics.items() if _scalar(v)}
                log.update(step=self.step, epoch=self.epoch)
                logging.info("TRAIN %s", log)
                self.log_fn(log)
            if cfg.save_per_step > 0 and self.step % cfg.save_per_step == 0 \
                    and cv_batches is not None:
                cv_loss = self.cross_validate(state, cv_batches)
                tag = f"epoch_{self.epoch}_step_{self.step}"
                self.save(tag, state, {"epoch": self.epoch, "step": self.step,
                                       "cv_loss": cv_loss})
                logging.info("saved %s cv_loss=%.4f", tag, cv_loss)
        # end of epoch
        info = {"epoch": self.epoch, "step": self.step}
        if cv_batches is not None:
            info["cv_loss"] = self.cross_validate(state, cv_batches)
        self.save(f"epoch_{self.epoch}_whole", state, info)
        self.epoch += 1
        return state
