"""HiFT GAN training: discriminators and the adversarial, feature, mel and TPR losses, in PyTorch.

Counterpart of ``cosyvoice2_eu_tpu/train/gan.py`` (reference:
cosy_repo/cosyvoice/hifigan/hifigan.py:9 HiFiGan,
cosy_repo/cosyvoice/hifigan/discriminator.py:15,149,196 MultipleDiscriminator
= Matcha's MPD + MultiResSpecDiscriminator,
third_party/Matcha-TTS/matcha/hifigan/models.py:209-273,
cosy_repo/cosyvoice/utils/losses.py:6 tpr_loss, :23 mel_loss).

LSGAN objectives; the generator's loss is adv + 2 x feature match + 45 x
multi-mel L1 + 1 x TPR + F0 L1.  The discriminators' convolutions are plain
(the reference's weight norm is a training parametrisation, not another
function class).  The layouts are NCHW / OIHW, as in the JAX package.

The sine source's random draws are inputs, ``(rand_ini (B, H), noise (B, L,
H))`` as ``models/hift.py::sine_source`` takes them; ``make_gan_draws``
makes them from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from cosyvoice2_eu_torch.config import HiFTConfig, MelConfig
from cosyvoice2_eu_torch.models.hift import f0_predict, hift_decode, sine_source
from cosyvoice2_eu_torch.ops.mel import mel_spectrogram
from cosyvoice2_eu_torch.ops.stft import hann_window, stft

LRELU_SLOPE = 0.1
MPD_PERIODS = (2, 3, 5, 7, 11)
MRD_FFT = (1024, 2048, 512)
MRD_HOP = (120, 240, 50)
MRD_WIN = (600, 1200, 240)


def _init_conv2d(gen: torch.Generator, cin: int, cout: int, k) -> dict:
    bound = math.sqrt(1.0 / (cin * k[0] * k[1]))
    draw = lambda shape: torch.empty(shape, device=gen.device).uniform_(  # noqa: E731
        -bound, bound, generator=gen)
    return {"weight": draw((cout, cin, k[0], k[1])), "bias": draw((cout,))}


def _conv2d(p: dict, x: torch.Tensor, stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    """NCHW input, OIHW weight; ``padding`` is symmetric per spatial axis."""
    return F.conv2d(x, p["weight"].to(x.dtype), p["bias"].to(x.dtype), stride=stride,
                    padding=padding)


# ---------------------------------------------------------------------------
# multi-period discriminator (periods 2/3/5/7/11)
# ---------------------------------------------------------------------------

def init_mpd(gen: torch.Generator) -> list:
    chans = [(1, 32), (32, 128), (128, 512), (512, 1024), (1024, 1024)]
    return [{"convs": [_init_conv2d(gen, cin, cout, (5, 1)) for cin, cout in chans],
             "post": _init_conv2d(gen, 1024, 1, (3, 1))} for _ in MPD_PERIODS]


def _period_pad(x: torch.Tensor, period: int) -> torch.Tensor:
    """x (B, C, T) padded on the right to a multiple of ``period`` with its
    last samples reversed, as the JAX package pads: that repeats the edge
    sample ([1, 2, 3, 4] by 2 -> [..., 4, 4, 3]), where F.pad's "reflect"
    (upstream Matcha's) gives [..., 4, 3, 2]."""
    t = x.shape[-1]
    n_pad = (-t) % period
    return torch.cat([x, x[:, :, t - n_pad:].flip(-1)], dim=2) if n_pad else x


def _disc_p(p: dict, x: torch.Tensor, period: int):
    """x (B, 1, T) -> (scores (B, n), feature maps)."""
    x = _period_pad(x, period)
    b, c, t = x.shape
    x = x.reshape(b, c, t // period, period)
    fmap = []
    for j, cp in enumerate(p["convs"]):
        x = F.leaky_relu(_conv2d(cp, x, stride=(3, 1) if j < 4 else (1, 1), padding=(2, 0)),
                         LRELU_SLOPE)
        fmap.append(x)
    x = _conv2d(p["post"], x, padding=(1, 0))
    fmap.append(x)
    return x.reshape(b, -1), fmap


# ---------------------------------------------------------------------------
# multi-resolution spectrogram discriminator
# ---------------------------------------------------------------------------

def init_mrd(gen: torch.Generator) -> list:
    discs = []
    for _ in MRD_FFT:
        convs = [_init_conv2d(gen, 1, 32, (3, 9))]
        convs += [_init_conv2d(gen, 32, 32, (3, 9)) for _ in range(3)]
        convs.append(_init_conv2d(gen, 32, 32, (3, 3)))
        discs.append({"convs": convs, "post": _init_conv2d(gen, 32, 1, (3, 3))})
    return discs


def _mrd_window(fft: int, win: int) -> np.ndarray:
    """torch.stft(win_length=win)'s window: a ``win``-long Hann window in an
    ``fft`` frame, rolled by (fft - win) // 2 to its centre."""
    w = np.zeros(fft, np.float32)
    w[:win] = hann_window(win)
    return np.roll(w, (fft - win) // 2)


def _disc_r(p: dict, y: torch.Tensor, fft: int, hop: int, win: int):
    """y (B, T) -> (scores (B, n), feature maps), over the magnitude
    spectrogram (B, 1, frames, F) as a one-channel image."""
    real, imag = stft(y, fft, hop, _mrd_window(fft, win), center=True)
    x = torch.sqrt(real * real + imag * imag + 1e-9).transpose(1, 2)[:, None]
    fmap = []
    for j, cp in enumerate(p["convs"]):
        kw = cp["weight"].shape[-1]
        x = F.leaky_relu(_conv2d(cp, x, stride=(1, 2) if 1 <= j <= 3 else (1, 1),
                                 padding=(1, kw // 2)), LRELU_SLOPE)
        fmap.append(x)
    x = _conv2d(p["post"], x, padding=(1, 1))
    fmap.append(x)
    return x.reshape(x.shape[0], -1), fmap


def init_discriminator(gen: torch.Generator) -> dict:
    return {"mpd": init_mpd(gen), "mrd": init_mrd(gen)}


def discriminator_forward(params: dict, y: torch.Tensor, y_hat: torch.Tensor):
    """y, y_hat (B, T) -> (scores_real, scores_gen, fmaps_real, fmaps_gen)."""
    yr, yg, fr, fg = [], [], [], []
    for p, period in zip(params["mpd"], MPD_PERIODS):
        for wav, scores, fmaps in ((y, yr, fr), (y_hat, yg, fg)):
            s, f = _disc_p(p, wav[:, None], period)
            scores.append(s)
            fmaps.append(f)
    for p, fft, hop, win in zip(params["mrd"], MRD_FFT, MRD_HOP, MRD_WIN):
        for wav, scores, fmaps in ((y, yr, fr), (y_hat, yg, fg)):
            s, f = _disc_r(p, wav, fft, hop, win)
            scores.append(s)
            fmaps.append(f)
    return yr, yg, fr, fg


# ---------------------------------------------------------------------------
# losses (LSGAN, feature matching, TPR, multi-mel)
# ---------------------------------------------------------------------------

def generator_adv_loss(scores_gen: List[torch.Tensor]) -> torch.Tensor:
    return sum(torch.mean((1.0 - s) ** 2) for s in scores_gen)


def discriminator_adv_loss(scores_real, scores_gen) -> torch.Tensor:
    return sum(torch.mean((1.0 - r) ** 2) + torch.mean(g ** 2)
               for r, g in zip(scores_real, scores_gen))


def feature_loss(fmaps_real, fmaps_gen) -> torch.Tensor:
    loss = 0.0
    for fr, fg in zip(fmaps_real, fmaps_gen):
        for r, g in zip(fr, fg):
            loss = loss + torch.mean(torch.abs(r - g))
    return loss * 2.0  # Matcha's feature_loss scales by 2


def median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` over all entries: on an even count the mean of the two
    middle values (``torch.median`` returns the lower one), and its
    gradient split between them."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def tpr_loss(scores_gen, scores_real, tau: float = 0.04) -> torch.Tensor:
    """Truncated pointwise relativistic loss (utils/losses.py:6)."""
    loss = 0.0
    for dr, dg in zip(scores_real, scores_gen):
        diff = dr - dg
        m = median(diff)
        mask = diff < m
        sq = torch.where(mask, (diff - m) ** 2, 0.0)
        l_rel = torch.sum(sq) / torch.clamp_min(torch.sum(mask), 1)
        loss = loss + tau - F.relu(tau - l_rel)
    return loss


def multi_mel_loss(real: torch.Tensor, gen: torch.Tensor, mel_cfg: MelConfig) -> torch.Tensor:
    """Mel-spectrogram L1 under ``mel_cfg`` as it is (utils/losses.py:23; one
    transform in the reference's yaml)."""
    m = mel_cfg
    args = (m.n_fft, m.num_mels, m.sampling_rate, m.hop_size, m.win_size, m.fmin, m.fmax,
            m.center)
    return torch.mean(torch.abs(mel_spectrogram(real, *args) - mel_spectrogram(gen, *args)))


def make_gan_draws(gen: torch.Generator, batch: dict, hift_cfg: HiFTConfig) -> tuple:
    """One turn's sine-source draws, ``(rand_ini (B, H), noise (B, L, H))``,
    from ``gen`` on its device (L = mel frames x the upsample scale)."""
    b, t_mel = batch["speech_feat"].shape[:2]
    h = hift_cfg.nb_harmonics + 1
    return (torch.rand((b, h), generator=gen, device=gen.device),
            torch.randn((b, t_mel * hift_cfg.upsample_scale, h), generator=gen,
                        device=gen.device))


def _generate(gen_params: dict, hift_cfg: HiFTConfig, batch: dict, draws: tuple):
    """(f0 (B, T_mel), generated (B, n), real (B, n)): the generator on the
    batch's mel, and both waveforms cut to the shorter.  The JAX package
    cuts only the generated one, which assumes it is the longer: a crop of
    51 frames whose mel ``compute_fbank`` trims to 50 (two frames a speech
    token) generates 480 samples fewer than the crop, and its turn fails."""
    mel = batch["speech_feat"].transpose(1, 2)  # (B, 80, T)
    f0 = f0_predict(gen_params["f0_predictor"], hift_cfg, mel)
    f0_up = f0.repeat_interleave(hift_cfg.upsample_scale, dim=-1)[..., None]
    s, _ = sine_source(gen_params["m_source"], hift_cfg, f0_up, draws[0], draws[1])
    wav = hift_decode(gen_params, hift_cfg, mel, s.transpose(1, 2))
    n = min(wav.shape[1], batch["speech"].shape[1])
    return f0, wav[:, :n], batch["speech"][:, :n]


def generator_step_loss(
    gen_params: dict,
    disc_params: dict,
    hift_cfg: HiFTConfig,
    mel_cfg: MelConfig,
    batch: dict,
    draws: tuple,
    feat_match_weight: float = 2.0,
    mel_weight: float = 45.0,
    tpr_weight: float = 1.0,
    tpr_tau: float = 0.04,
    rows=None,
):
    """The generator's turn (hifigan.py:32 forward_generator): (loss, metrics).

    ``rows`` (``parallel/train_step.py::RowShare``, data-parallel turns):
    ``batch`` is this process's rows of the global batch; the mean terms
    are weighted by the rows' share, the TPR term reads the global batch's
    scores (its median is over every row), and each metric is this
    process's part of the global value (summed over the processes)."""
    f0, gen, real = _generate(gen_params, hift_cfg, batch, draws)
    yr, yg, fr, fg = discriminator_forward(disc_params, real, gen)
    loss_gen = generator_adv_loss(yg)
    loss_fm = feature_loss(fr, fg)
    loss_mel = multi_mel_loss(real, gen, mel_cfg)
    loss_tpr = (tpr_loss(*_gathered(rows, yg, yr), tpr_tau) if tpr_weight
                else torch.zeros((), device=gen.device))
    loss_f0 = torch.mean(torch.abs(f0 - batch["pitch_feat"]))
    means = {"loss_gen": loss_gen, "loss_fm": loss_fm, "loss_mel": loss_mel, "loss_f0": loss_f0}
    local = loss_gen + feat_match_weight * loss_fm + mel_weight * loss_mel + loss_f0
    return _turn(rows, local, means, loss_tpr, tpr_weight, tpr_weight * loss_tpr)


def discriminator_step_loss(
    disc_params: dict,
    gen_params: dict,
    hift_cfg: HiFTConfig,
    batch: dict,
    draws: tuple,
    tpr_weight: float = 1.0,
    tpr_tau: float = 0.04,
    rows=None,
):
    """The discriminator's turn (hifigan.py forward_discriminator): (loss,
    metrics).  The generated waveform is detached: no gradient reaches the
    generator.  ``rows``: as ``generator_step_loss``."""
    _, gen, real = _generate(gen_params, hift_cfg, batch, draws)
    gen = gen.detach()
    yr, yg, _, _ = discriminator_forward(disc_params, real, gen)
    loss_disc = discriminator_adv_loss(yr, yg)
    loss_tpr = (tpr_loss(*_gathered(rows, yg, yr), tpr_tau) if tpr_weight
                else torch.zeros((), device=real.device))
    return _turn(rows, loss_disc, {"loss_disc": loss_disc}, loss_tpr, tpr_weight,
                 tpr_weight * loss_tpr)


def _gathered(rows, yg, yr):
    if rows is None:
        return yg, yr
    return [rows.gather(s) for s in yg], [rows.gather(s) for s in yr]


def _turn(rows, local, means: dict, loss_tpr, tpr_weight: float, tpr_term):
    """(loss, metrics) of a turn: ``local`` (the weighted sum of the mean
    terms) plus the TPR term.  In one process, ``local + tpr_term``; under
    ``rows``, the differentiated loss weights ``local`` by the rows' share
    (the TPR term is global already) and the metrics are the process's
    parts of the global values."""
    if rows is None:
        total = local + tpr_term
        return total, {"loss": total, **means, "loss_tpr": loss_tpr}
    share, world = rows.share, rows.world
    metrics = {"loss": share * local + tpr_term / world,
               **{k: share * v for k, v in means.items()}, "loss_tpr": loss_tpr / world}
    return share * local + tpr_term, metrics
