"""LoRA finetuning of the speech LM, in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/train/lora.py`` (reference: the peft path
of cosy_repo/cosyvoice/bin/train.py:389-406, and its merged export at
:513-592).  Adapters attach to the backbone's attention and MLP
projections; the loss sees ``base + (alpha / rank) * B @ A``, built inside
it, so gradients reach only A and B while the base stays detached.
``merge_lora`` gives a plain parameter tree.

The JAX package seeds each adapter with ``fold_in(rng, i * 131 + hash(name)
% 1000)``; Python salts ``hash`` per process, so its A matrices differ from
run to run.  The port draws every A in order from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from cosyvoice2_eu_torch.config import LMConfig, TrainConfig
from cosyvoice2_eu_torch.parallel.train_step import lm_loss_fn, make_step
from cosyvoice2_eu_torch.train.optim import Optimizer
from cosyvoice2_eu_torch.utils.params import tree_map
from cosyvoice2_eu_torch.utils.profiling import StageTimer

DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def init_lora(gen: torch.Generator, base_params: dict, rank: int = 8,
              targets: Sequence[str] = DEFAULT_TARGETS) -> dict:
    """{"layers": [{name: {"A" (rank, in), "B" (out, rank)}}]}: A ~ N(0, 0.01^2)
    drawn from ``gen`` layer by layer in ``targets`` order, B = 0 (the
    adapted model starts as the base), on the base weights' device."""
    layers = []
    for lp in base_params["backbone"]["layers"]:
        entry = {}
        for name in targets:
            if name not in lp:
                continue
            w = lp[name]["weight"]
            out_dim, in_dim = w.shape
            a = torch.randn((rank, in_dim), generator=gen, device=gen.device) * 0.01
            entry[name] = {"A": a.to(w.device), "B": torch.zeros((out_dim, rank), device=w.device)}
        layers.append(entry)
    return {"layers": layers}


def apply_lora(base_params: dict, lora: dict, alpha: float = 16.0) -> dict:
    """The parameters with adapted weights; every base leaf is detached."""
    first = lora["layers"][0]
    scale = alpha / first[next(iter(first))]["A"].shape[0]
    frozen = tree_map(torch.Tensor.detach, base_params)
    layers = []
    for lp, ad in zip(frozen["backbone"]["layers"], lora["layers"]):
        new_lp = dict(lp)
        for name, w in ad.items():
            delta = (w["B"] @ w["A"]) * scale
            weight = lp[name]["weight"]
            new_lp[name] = dict(lp[name], weight=weight + delta.to(weight.dtype))
        layers.append(new_lp)
    return dict(frozen, backbone=dict(frozen["backbone"], layers=layers))


def merge_lora(base_params: dict, lora: dict, alpha: float = 16.0) -> dict:
    """The adapters folded into a plain parameter tree (the reference's
    merged checkpoint), sharing no storage with the base."""
    return tree_map(lambda a: a.detach().clone(), apply_lora(base_params, lora, alpha))


def make_lora_lm_train_step(cfg: LMConfig, train_cfg: TrainConfig, tx: Optimizer,
                            base_params: dict, alpha: float = 16.0,
                            timer: Optional[StageTimer] = None, mesh=None):
    """step(state, batch) -> (state, {"loss", "acc", "grad_norm"}) over a
    state whose params are the adapters; the base is held detached.
    Data-parallel over ``mesh``."""
    base = tree_map(torch.Tensor.detach, base_params)
    return make_step(lambda lora, batch: lm_loss_fn(apply_lora(base, lora, alpha), cfg, batch,
                                                    train_cfg), tx, timer, mesh)
