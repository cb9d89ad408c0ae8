"""HiFT GAN training: the discriminator and generator turns, in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/train/train_gan.py`` (reference:
cosy_repo/cosyvoice/utils/executor.py:88-144 train_one_epoc_gan: a
discriminator turn, then a generator turn, on each batch; Adam at 2e-4 for
each, accum_grad 1).  Each turn's optimizer is the port's ``Optimizer`` of
``TrainConfig(optim="adam", lr=2e-4, accum_grad=1, grad_clip=5.0)``: global
norm clipping at 5 then Adam at a constant rate, as the JAX package's
``optax.chain(clip_by_global_norm(5.0), adam(2e-4))``, except that a step
with a non-finite gradient is skipped where that chain applies it.

Usage:
  python -m cosyvoice2_eu_torch.train.train_gan --train_data data/train.list \\
      --model_dir exp/hift [--device cpu]
  torchrun --nproc-per-node N -m cosyvoice2_eu_torch.train.train_gan ...  # N GPUs
"""

from __future__ import annotations

import argparse
import contextlib
import logging
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from cosyvoice2_eu_torch.config import TrainConfig, TTSConfig
from cosyvoice2_eu_torch.parallel.distributed import in_group
from cosyvoice2_eu_torch.parallel.mesh import shard_rows
from cosyvoice2_eu_torch.parallel.train_step import DataParallel, RowShare, value_and_grad
from cosyvoice2_eu_torch.train.executor import save_checkpoint
from cosyvoice2_eu_torch.train.gan import (
    discriminator_step_loss,
    generator_step_loss,
    init_discriminator,
    make_gan_draws,
)
from cosyvoice2_eu_torch.train.optim import Optimizer, make_optimizer
from cosyvoice2_eu_torch.utils.profiling import StageTimer

GAN_TRAIN_CONFIG = TrainConfig(optim="adam", lr=2e-4, accum_grad=1, grad_clip=5.0)


def make_gan_steps(cfg: TTSConfig, tx_g: Optimizer, tx_d: Optimizer, mesh=None):
    """(gen_step, disc_step):

    gen_step(gen_params, opt_g, disc_params, batch, draws) -> (gen_params, opt_g, metrics)
    disc_step(disc_params, opt_d, gen_params, batch, draws) -> (disc_params, opt_d, metrics)

    ``draws`` are the sine source's, as ``make_gan_draws`` makes them.  With
    a ``mesh`` in a process group, ``batch`` and ``draws`` are this
    process's rows of the global batch's (``shard_rows``): each turn weights
    the mean terms by the rows' share, reads every row for the TPR term,
    sums the gradients over the processes and reports the global metrics,
    so a turn is the one-process turn on the global batch.
    """
    dp = mesh is not None and in_group()

    def turn(loss_fn, params, tx, opt, batch):
        rows = (RowShare(batch["speech"].shape[0], mesh, batch["speech"].device)
                if dp else None)
        (_, metrics), grads = value_and_grad(lambda p: loss_fn(p, rows), params)
        if dp:
            grads = DataParallel.sum_grads(grads)
            metrics = DataParallel.sum_metrics(metrics)
        params, opt = tx.step(params, grads, opt)
        return params, opt, metrics

    def gen_step(gen_params, opt_g, disc_params, batch, draws):
        return turn(lambda p, rows: generator_step_loss(p, disc_params, cfg.hift, cfg.mel, batch,
                                                        draws, rows=rows),
                    gen_params, tx_g, opt_g, batch)

    def disc_step(disc_params, opt_d, gen_params, batch, draws):
        return turn(lambda p, rows: discriminator_step_loss(p, gen_params, cfg.hift, batch, draws,
                                                            rows=rows),
                    disc_params, tx_d, opt_d, batch)

    return gen_step, disc_step


def gan_mel_fn(cfg: TTSConfig) -> Callable[[np.ndarray], np.ndarray]:
    """The pipeline's host mel for GAN targets: ``cfg.mel`` with fmax 8 kHz,
    as the reference caps it; wav (T,) -> (T_mel, 80)."""
    from cosyvoice2_eu_torch.ops.mel import mel_spectrogram_np

    m = cfg.mel

    def fn(wav: np.ndarray) -> np.ndarray:
        return mel_spectrogram_np(wav, m.n_fft, m.num_mels, m.sampling_rate, m.hop_size,
                                  m.win_size, m.fmin, 8000.0, m.center).T

    return fn


def train_gan(cfg: TTSConfig, batches: Callable[[int], Iterable[dict]], model_dir: str,
              max_epoch: int, seed: int, device: torch.device, log_interval: int = 100,
              timer: Optional[StageTimer] = None, mesh=None):
    """The GAN loop: ``batches(epoch)`` gives the epoch's host batches (the
    pipeline's with ``gan=True``); each that carries ``pitch_feat`` and
    ``speech`` gets a discriminator turn, then a generator turn, with draws
    from a generator seeded ``seed``; each epoch ends with the checkpoint
    ``epoch_<n>_whole`` of {"generator", "discriminator"}.  ``timer``
    (optional) records the stages "disc_turn" and "gen_turn".  Returns
    {"generator", "discriminator", "opt_g", "opt_d", "steps", "metrics"}
    (the last turns' metrics).

    ``mesh`` (``make_mesh(dp=-1, fsdp=1)``, as the JAX package lays it):
    every process reads the same batches, draws for the whole batch and
    turns on its block of rows (``make_gan_steps``); process 0 writes the
    checkpoints."""
    from cosyvoice2_eu_torch.models.hift import init_hift

    stage = timer.stage if timer is not None else (lambda name: contextlib.nullcontext())
    gen_params = init_hift(torch.Generator(device=device).manual_seed(seed), cfg.hift)
    disc_params = init_discriminator(torch.Generator(device=device).manual_seed(seed + 1))
    tx = make_optimizer(GAN_TRAIN_CONFIG)
    gen_step, disc_step = make_gan_steps(cfg, tx, tx, mesh)
    rows = (lambda x: shard_rows(x, mesh)) if mesh is not None else (lambda x: x)
    opt_g, opt_d = tx.init(gen_params), tx.init(disc_params)
    draw_gen = torch.Generator(device=device).manual_seed(seed)
    step, m_d, m_g = 0, None, None
    for epoch in range(max_epoch):
        for batch in batches(epoch):
            if "pitch_feat" not in batch or "speech" not in batch:
                continue
            dev = {k: torch.as_tensor(v, device=device) for k, v in batch.items() if k != "utts"}
            # the discriminator's turn first (executor.py:121-134)
            mine = rows(dev)
            with stage("disc_turn"):
                disc_params, opt_d, m_d = disc_step(disc_params, opt_d, gen_params, mine,
                                                    rows(make_gan_draws(draw_gen, dev, cfg.hift)))
            with stage("gen_turn"):
                gen_params, opt_g, m_g = gen_step(gen_params, opt_g, disc_params, mine,
                                                  rows(make_gan_draws(draw_gen, dev, cfg.hift)))
            step += 1
            if step % log_interval == 0:
                logging.info("GAN step %d disc=%.4f gen=%.4f mel=%.4f", step,
                             float(m_d["loss"]), float(m_g["loss"]), float(m_g["loss_mel"]))
        if mesh is None or mesh.rank == 0:
            save_checkpoint(model_dir, f"epoch_{epoch}_whole",
                            {"generator": gen_params, "discriminator": disc_params},
                            {"epoch": epoch, "step": step})
    return {"generator": gen_params, "discriminator": disc_params, "opt_g": opt_g,
            "opt_d": opt_d, "steps": step, "metrics": (m_d, m_g)}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_data", required=True, help="file listing parquet shards")
    parser.add_argument("--cv_data", required=False)
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--qwen_pretrain_path", default="")
    parser.add_argument("--max_epoch", type=int, default=20)
    parser.add_argument("--seed", type=int, default=1986)
    parser.add_argument("--log_interval", type=int, default=100)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import os
    import random

    from cosyvoice2_eu_torch.frontend.tokenizer import get_tokenizer
    from cosyvoice2_eu_torch.parallel.distributed import init_distributed
    from cosyvoice2_eu_torch.parallel.mesh import make_mesh
    from cosyvoice2_eu_torch.train import dataset as ds
    from cosyvoice2_eu_torch.train.train import read_list
    from cosyvoice2_eu_torch.utils.device import resolve_device

    logging.basicConfig(level=logging.INFO)
    # one process per GPU under torchrun; each reads every shard, as the JAX
    # package's one controller does, and turns on its rows of each batch
    init_distributed(device=args.device)
    device = resolve_device(args.device)
    mesh = make_mesh(dp=-1, fsdp=1)
    cfg = TTSConfig()
    tokenizer = get_tokenizer(args.qwen_pretrain_path)
    mel_fn = gan_mel_fn(cfg)
    paths = read_list(args.train_data)
    os.makedirs(args.model_dir, exist_ok=True)

    def batches(epoch):
        return ds.build_pipeline(paths, tokenizer, mel_fn, 0, 1, epoch, gan=True,
                                 rng=random.Random(args.seed + epoch))

    train_gan(cfg, batches, args.model_dir, args.max_epoch, args.seed, device,
              args.log_interval, mesh=mesh if mesh.world > 1 else None)


if __name__ == "__main__":
    main()
