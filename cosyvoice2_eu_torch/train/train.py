"""The trainer: its command line, batches, step and CV functions, in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/train/train.py`` (reference:
cosy_repo/cosyvoice/bin/train.py:80-168: ``--model {llm,flow,hifigan}``,
``--train_data``/``--cv_data`` lists of parquet shards, ``--model_dir``,
``--resume``, the tensorboard dir).  The speech LM trains plain, with DPO
against a frozen copy, or as LoRA adapters over a frozen base; the flow
with the unified-training streaming coin on each step; ``hifigan`` is
``train_gan``'s.  On the card unless ``--device cpu``; under ``torchrun``,
one process per GPU, each reading its own shards of the parquet lists (the
reference's DistributedSampler), and ``--fsdp K`` shards the optimizer
state over groups of K processes (ZeRO-2, ``train/optim.py``).

``main`` parses the arguments and opens the parquet shards; ``run`` does
the rest from an opener of sample dicts (the pipeline after
``parquet_opener``, the batches, the model, the epochs with CV and
checkpoints), so that a caller without ``pyarrow`` can feed it samples
from memory.

Usage:
  python -m cosyvoice2_eu_torch.train.train --model llm \\
      --train_data data/train.list --cv_data data/cv.list \\
      --model_dir exp/llm --qwen_pretrain_path <tokenizer dir> [--device cpu]
  torchrun --nproc-per-node N -m cosyvoice2_eu_torch.train.train ... [--fsdp K]
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import random
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from cosyvoice2_eu_torch.config import FlowConfig, LMConfig, TrainConfig, TTSConfig
from cosyvoice2_eu_torch.models.llm import moe_backbone, split_frozen
from cosyvoice2_eu_torch.parallel.train_step import (
    flow_loss_fn,
    lm_loss_fn,
    make_flow_draws,
    make_lm_train_step,
)
from cosyvoice2_eu_torch.train.optim import Optimizer
from cosyvoice2_eu_torch.utils.profiling import StageTimer


def make_lm_step_fn(cfg: LMConfig, train_cfg: TrainConfig, tx: Optimizer, params: dict, *,
                    dpo: bool = False, dpo_beta: float = 0.01, lora: bool = False,
                    lora_rank: int = 8, lora_alpha: float = 16.0,
                    gen: Optional[torch.Generator] = None,
                    timer: Optional[StageTimer] = None, mesh=None):
    """The LM branch: (trained params, step_fn(state, batch), cv_fn(params,
    batch) -> metrics).

    Plain: the LM step and its loss; the trained params leave out a MoE
    backbone's router biases, which the loss reads frozen.  ``dpo``:
    against ``params`` as the frozen reference (the batches carry the
    rejected rows).  ``lora``: the trained params are adapters of rank
    ``lora_rank`` drawn from ``gen`` over ``params`` as the frozen base; the
    CV loss runs on the adapted weights.  Each step is data-parallel over
    ``mesh`` when given.  A MoE backbone (deepseek_v3) trains by the plain
    step only: ``dpo`` and ``lora`` raise ``ValueError`` for it.
    """
    if (dpo or lora) and moe_backbone(cfg):
        raise ValueError("a deepseek_v3 backbone trains by the plain LM step only: DPO and "
                         "LoRA are not ported for its router biases and balance loss")
    if dpo:
        from cosyvoice2_eu_torch.train.dpo import dpo_loss_fn, make_dpo_train_step

        step_fn = make_dpo_train_step(cfg, train_cfg, tx, params, beta=dpo_beta, timer=timer,
                                      mesh=mesh)
        # the optimizer never writes a tensor in place, so ``params`` stays the reference
        return params, step_fn, lambda p, b: dpo_loss_fn(p, params, cfg, b, dpo_beta)[1]
    if lora:
        from cosyvoice2_eu_torch.train.lora import apply_lora, init_lora, make_lora_lm_train_step

        adapters = init_lora(gen, params, rank=lora_rank)
        step_fn = make_lora_lm_train_step(cfg, train_cfg, tx, params, alpha=lora_alpha,
                                          timer=timer, mesh=mesh)
        return adapters, step_fn, lambda lo, b: lm_loss_fn(apply_lora(params, lo, lora_alpha),
                                                          cfg, b, train_cfg)[1]
    params, thaw = split_frozen(params)  # a MoE backbone's router biases stay untrained
    return (params, make_lm_train_step(cfg, train_cfg, tx, timer, mesh, thaw),
            lambda p, b: lm_loss_fn(thaw(p), cfg, b, train_cfg)[1])


def make_flow_step_fn(raw_step, cfg: FlowConfig, gen: torch.Generator,
                      rng: np.random.Generator):
    """step_fn(state, batch) -> (state, metrics) for ``Executor``.

    Each call takes its draws from ``gen`` (the step generator, on the
    training device) and streaming with probability 0.5 from ``rng``
    (unified training, reference flow.py:201), then calls
    ``raw_step(state, batch, draws, streaming=...)``.
    """

    def step_fn(state, batch):
        draws = make_flow_draws(gen, batch, cfg.output_size)
        streaming = bool(rng.random() < 0.5)
        return raw_step(state, batch, draws, streaming=streaming)

    return step_fn


def make_flow_cv_fn(cfg: FlowConfig):
    """cv_fn(params, batch) -> {"loss"}: non-streaming, with the draws of a
    generator seeded 0 afresh on every call (the JAX package uses
    ``jax.random.key(0)``), so a batch always gets the same loss."""

    def cv_fn(params, batch):
        dev = batch["speech_feat"].device
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        draws = make_flow_draws(gen, batch, cfg.output_size)
        return flow_loss_fn(params, cfg, batch, draws, False)[1]

    return cv_fn


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

FLOW_KEYS = ("speech_token", "speech_token_len", "speech_feat", "speech_feat_len", "embedding")


def read_list(path: str) -> list[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


class MetricLogger:
    """The training metrics' sinks (reference train_utils.py:375-439):
    tensorboard under ``tb_dir`` when ``torch.utils.tensorboard`` can be
    imported, and W&B only when asked for.  Called with a dict of metrics
    (``step`` among them); logs its numbers as ``train/<name>``."""

    def __init__(self, tb_dir: str, use_wandb: bool = False, wandb_project: str = "",
                 run_name: str = ""):
        self.writer = None
        self.run = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            logging.info("tensorboard unavailable; metrics go to the log only")
        else:
            self.writer = SummaryWriter(tb_dir)
        if use_wandb:
            try:
                import wandb

                self.run = wandb.init(project=wandb_project or "cosyvoice2-eu-tpu",
                                      name=run_name or None, resume="allow")
            except Exception:  # wandb absent or unreachable: train on without it
                logging.warning("wandb requested but unavailable; continuing without",
                                exc_info=True)

    def __call__(self, metrics: dict) -> None:
        step = int(metrics.get("step", 0))
        numbers = {k: v for k, v in metrics.items() if isinstance(v, (int, float))}
        if self.writer is not None:
            for k, v in numbers.items():
                if k != "step":
                    self.writer.add_scalar(f"train/{k}", v, step)
        if self.run is not None:
            self.run.log({f"train/{k}": v for k, v in numbers.items()}, step=step)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


def make_logger(tb_dir: str, use_wandb: bool = False, wandb_project: str = "",
                run_name: str = "") -> MetricLogger:
    return MetricLogger(tb_dir, use_wandb, wandb_project, run_name)


def pack_lm_batches(batches: Iterable[dict], cfg: TTSConfig, rng: np.random.Generator,
                    pad_multiple: int = 64, dpo: bool = False):
    """The pipeline's padded batches -> the LM's packed batches
    (``build_lm_batch``: unistream, or bistream with probability 0.5 where
    a row allows it), every row padded to the longest row's multiple of
    ``pad_multiple``.  ``dpo``: unistream only, with the rejected
    continuations (``reject_speech_token``) packed as ``reject_*``."""
    from cosyvoice2_eu_torch.train.sequences import build_lm_batch

    for batch in batches:
        if "speech_token" not in batch:
            continue
        if dpo and "reject_speech_token" not in batch:
            continue
        texts = [row[:n] for row, n in zip(batch["text_token"], batch["text_token_len"])]
        speeches = [row[:n] for row, n in zip(batch["speech_token"], batch["speech_token_len"])]
        rejects = ([row[:n] for row, n in zip(batch["reject_speech_token"],
                                              batch["reject_speech_token_len"])]
                   if dpo else [])
        longest = max(len(t) + len(s) + 2 + (len(s) // 15 + 2)
                      for t, s in zip(texts * (2 if dpo else 1), speeches + rejects))
        pad_to = -(-longest // pad_multiple) * pad_multiple
        out = build_lm_batch(texts, speeches, cfg.llm, rng, pad_to=pad_to,
                             bistream_prob=0.0 if dpo else 0.5)  # DPO pairs stay unistream
        if dpo:
            rb = build_lm_batch(texts, rejects, cfg.llm, rng, pad_to=pad_to, bistream_prob=0.0)
            out.update({f"reject_{k}": v for k, v in rb.items()})
        yield out


def lm_batches(paths, tokenizer, mel_fn, cfg: TTSConfig, rank, world, epoch, rng,
               max_frames: int, pad_multiple: int = 64, dpo: bool = False,
               shuffle_rng: Optional[random.Random] = None):
    """The LM's packed batches from parquet shards: ``build_pipeline`` then
    ``pack_lm_batches``."""
    from cosyvoice2_eu_torch.train import dataset as ds

    return pack_lm_batches(
        ds.build_pipeline(paths, tokenizer, mel_fn, rank, world, epoch,
                          max_frames_in_batch=max_frames, rng=shuffle_rng),
        cfg, rng, pad_multiple, dpo)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True, choices=["llm", "flow", "hifigan"])
    parser.add_argument("--train_data", required=True, help="file listing parquet shards")
    parser.add_argument("--cv_data", required=True)
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--tensorboard_dir", default=None)
    parser.add_argument("--qwen_pretrain_path", default="")
    parser.add_argument("--config", default=None,
                        help="JSON TTSConfig (config.load_config); default full-size")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--max_epoch", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--max_frames_in_batch", type=int, default=3000)
    parser.add_argument("--fsdp", type=int, default=1)
    parser.add_argument("--seed", type=int, default=1986)
    # fine-tuning modes (reference bin/train.py --lora/--dpo)
    parser.add_argument("--init_checkpoint", default=None,
                        help="a checkpoint's params file (save_checkpoint) to start from")
    parser.add_argument("--lora", action="store_true")
    parser.add_argument("--lora_rank", type=int, default=8)
    parser.add_argument("--lora_alpha", type=float, default=16.0)
    parser.add_argument("--dpo", action="store_true",
                        help="requires reject_speech_token in the parquet")
    parser.add_argument("--dpo_beta", type=float, default=0.01)
    # logging (reference train.py:202-358)
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--wandb_project", default="cosyvoice2-eu-tpu")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if (args.lora or args.dpo) and args.model != "llm":
        parser.error("--lora/--dpo apply to --model llm")
    if args.lora and args.dpo:
        parser.error("--lora and --dpo are mutually exclusive in this CLI")
    return args


def main(argv=None):
    from cosyvoice2_eu_torch.parallel.distributed import init_distributed
    from cosyvoice2_eu_torch.train import dataset as ds

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    # one process per GPU under torchrun; the rank's shards, as the
    # reference's DistributedSampler gives them (dataset/dataset.py:51-104)
    rank, world = init_distributed(device=args.device)
    return run(args, lambda list_path, epoch: ds.parquet_opener(
        ds.shard_list(read_list(list_path), rank, world, epoch)))


def run(args: argparse.Namespace, open_samples: Callable[[str, int], Iterable[dict]],
        timer: Optional[StageTimer] = None) -> dict:
    """Train as ``args`` say, on the samples ``open_samples(list_path,
    epoch)`` gives for ``args.train_data`` (each epoch) and ``args.cv_data``
    (epoch 0): the pipeline, the model's batches on the device, the epochs
    through ``Executor`` (CV and a checkpoint at each end), under
    ``StragglerGuard`` and ``join_uneven_inputs``.  ``timer`` (optional)
    records the stages "batch" (the pipeline and the copy to the device),
    "step" and "cv_step".  Returns {"state", "executor", "beats",
    "metrics"} (the last step's metrics).

    In a process group (``init_distributed``), the samples are this
    process's (its shards): each step is data-parallel over the mesh
    ``(dp=-1, fsdp=args.fsdp)``, the update the one-process update on every
    process's batch together (``parallel/train_step.py::make_step``); the
    processes stop together at the shortest shard, CV losses combine over
    them, and process 0 writes the checkpoints and the metric logs."""
    from cosyvoice2_eu_torch.frontend.tokenizer import get_tokenizer
    from cosyvoice2_eu_torch.ops.mel import host_mel_fn
    from cosyvoice2_eu_torch.parallel.distributed import StragglerGuard, join_uneven_inputs
    from cosyvoice2_eu_torch.parallel.mesh import make_mesh
    from cosyvoice2_eu_torch.parallel.train_step import init_train_state, make_flow_train_step
    from cosyvoice2_eu_torch.train import dataset as ds
    from cosyvoice2_eu_torch.train.executor import (
        Executor,
        latest_checkpoint,
        load_params,
        restore_train_state,
    )
    from cosyvoice2_eu_torch.train.optim import make_optimizer
    from cosyvoice2_eu_torch.utils.device import resolve_device

    if args.model == "hifigan":
        raise SystemExit("GAN training loop: use cosyvoice2_eu_torch/train/train_gan.py")
    device = resolve_device(args.device)
    mesh = make_mesh(dp=-1, fsdp=args.fsdp)
    stage = timer.stage if timer is not None else (lambda name: contextlib.nullcontext())
    if args.config:
        from cosyvoice2_eu_torch.config import load_config

        cfg = load_config(args.config)
    else:
        cfg = TTSConfig()
    train_cfg = TrainConfig(lr=args.lr) if args.lr else TrainConfig()
    max_epoch = args.max_epoch or train_cfg.max_epoch
    tokenizer = get_tokenizer(args.qwen_pretrain_path)
    # the host numpy featurizer: a device mel per utterance would cost a
    # round trip to the card per sample
    mel_fn = host_mel_fn(cfg.mel)
    tx = make_optimizer(train_cfg, mesh)
    # the flow's streaming coin: drawn once a step from one seed on every
    # process, so the processes of a step take the same branch
    rng = np.random.default_rng(args.seed)

    def pipeline(list_path, epoch, shuffle_seed):
        return ds.samples_pipeline(open_samples(list_path, epoch), tokenizer, mel_fn,
                                   max_frames_in_batch=args.max_frames_in_batch,
                                   rng=random.Random(shuffle_seed))

    def on_device(batches, keys=None):
        it = iter(batches)
        while True:
            with stage("batch"):
                b = next(it, None)
                if b is None:
                    return
                # each process's batch is its own rows (its shards of the
                # lists): nothing is padded across processes, and the step
                # weights each process by its share of the global count
                b = {k: torch.as_tensor(np.asarray(v), device=device) for k, v in b.items()
                     if keys is None or k in keys}
            yield b

    if args.model == "llm":
        from cosyvoice2_eu_torch.models.llm import init_lm

        params = init_lm(torch.Generator(device=device).manual_seed(args.seed), cfg.llm)
        if args.init_checkpoint:  # a checkpoint holds the trained tree (no router biases)
            trained, thaw = split_frozen(params)
            params = thaw(load_params(args.init_checkpoint, trained))
        params, step_fn, cv_fn = make_lm_step_fn(
            cfg.llm, train_cfg, tx, params, dpo=args.dpo, dpo_beta=args.dpo_beta,
            lora=args.lora, lora_rank=args.lora_rank, lora_alpha=args.lora_alpha,
            gen=torch.Generator(device=device).manual_seed(args.seed + 1), mesh=mesh)

        def train_iter(epoch):
            return on_device(pack_lm_batches(pipeline(args.train_data, epoch, args.seed + epoch),
                                             cfg, rng, dpo=args.dpo))

        def cv_iter():
            return on_device(pack_lm_batches(pipeline(args.cv_data, 0, args.seed), cfg, rng,
                                             dpo=args.dpo))
    else:  # flow
        from cosyvoice2_eu_torch.models.flow import init_flow

        params = init_flow(torch.Generator(device=device).manual_seed(args.seed), cfg.flow)
        # the draws: a generator of the process's own, for its own rows
        step_fn = make_flow_step_fn(make_flow_train_step(cfg.flow, train_cfg, tx, mesh=mesh),
                                    cfg.flow,
                                    torch.Generator(device=device).manual_seed(args.seed + mesh.rank),
                                    rng)
        cv_fn = make_flow_cv_fn(cfg.flow)

        def flow_batches(list_path, epoch, shuffle_seed):
            return on_device((b for b in pipeline(list_path, epoch, shuffle_seed)
                              if "speech_token" in b and "embedding" in b), FLOW_KEYS)

        def train_iter(epoch):
            return flow_batches(args.train_data, epoch, args.seed + epoch)

        def cv_iter():
            return flow_batches(args.cv_data, 0, args.seed)

    last = {}

    def timed_step(state, batch):
        with stage("step"):
            state, last["metrics"] = step_fn(state, batch)
        return state, last["metrics"]

    def timed_cv(p, batch):
        with stage("cv_step"):
            return cv_fn(p, batch)

    state = init_train_state(params, tx)
    logger = (make_logger(args.tensorboard_dir or os.path.join(args.model_dir, "tb"),
                          use_wandb=args.wandb, wandb_project=args.wandb_project,
                          run_name=os.path.basename(args.model_dir.rstrip("/")))
              if mesh.rank == 0 else None)
    executor = Executor(train_cfg, timed_step, timed_cv, args.model_dir, log_fn=logger, tx=tx)
    start_epoch = 0
    if args.resume:
        info = latest_checkpoint(args.model_dir)
        if info:
            logging.info("resuming from %s", info["tag"])
            # params, optimizer moments, the schedule's count and step/epoch
            # (reference bin/train.py:420-473)
            state = restore_train_state(args.model_dir, info, state, tx)
            executor.step = int(info.get("step", 0))
            start_epoch = int(info.get("epoch", 0)) + (1 if info["tag"].endswith("_whole") else 0)
    try:
        # the uneven-shard join and the hung-process watchdog (reference
        # cosyvoice_join, the monitored barrier, train_utils.py:269-287)
        with StragglerGuard(tag=f"{args.model}-train") as guard:
            executor.on_step = guard.beat
            for epoch in range(start_epoch, max_epoch):
                executor.epoch = epoch
                state = executor.train_epoch(
                    state, join_uneven_inputs(train_iter(epoch), tag=f"epoch{epoch}"),
                    # a factory: CV runs at every save_per_step and at the
                    # epoch's end, each pass on a fresh iterator
                    lambda e=epoch: join_uneven_inputs(cv_iter(), tag=f"cv{e}"))
    finally:
        if logger is not None:
            logger.close()
    return {"state": state, "executor": executor, "beats": guard.beats,
            "metrics": last.get("metrics")}


if __name__ == "__main__":
    main()
