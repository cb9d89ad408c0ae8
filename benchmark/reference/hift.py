"""Frozen copy of the port's ``cosyvoice2_eu_torch/models/hift.py`` (plain
PyTorch, no kernel), for the benchmark's reference: it imports nothing of
the port, and a later change to the port does not change it."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .stft import hann_window, istft, stft
from .layers import conv1d, conv_transpose1d, dense, snake


def _get_padding(k: int, d: int = 1) -> int:
    return (k * d - d) // 2


# ---------------------------------------------------------------------------
# F0 predictor
# ---------------------------------------------------------------------------

def f0_predict(params, cfg, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, 80, T) -> f0 (B, T) in Hz (non-negative)."""
    h = mel
    pad = _get_padding(cfg.f0_predictor.kernel_size)
    for cp in params["convs"]:
        h = F.elu(conv1d(cp, h, padding=pad))
    f0 = dense(params["classifier"], h.transpose(1, 2))[..., 0]
    return f0.abs()


# ---------------------------------------------------------------------------
# NSF source
# ---------------------------------------------------------------------------

def _jax_linear_resize(x: torch.Tensor, new_len: int) -> torch.Tensor:
    """``jax.image.resize(x, x.shape[:-1] + (new_len,), "linear")`` along the last axis.

    Output i samples the input at s_i = (i + 0.5) * m / n - 0.5 with the
    triangle kernel max(0, 1 - |s_i - j| / ks), ks = max(m / n, 1) (wider
    than one input step only when downsampling), weights normalised to sum
    to 1.  Only the ~2*ks+1 input positions around s_i carry weight, so the
    sum is taken over that band instead of a dense (m, n) matrix.
    """
    m, n = x.shape[-1], new_len
    f32 = dict(dtype=torch.float32, device=x.device)
    inv = torch.tensor(1.0 / (n / m), **f32)
    ks = torch.clamp(inv, min=1.0)
    s = (torch.arange(n, **f32) + 0.5) * inv - 0.5
    taps = int(math.ceil(2.0 * float(ks))) + 2
    j = torch.floor(s - ks)[:, None] + torch.arange(taps, **f32)[None, :]
    w = torch.clamp(1.0 - torch.abs(s[:, None] - j) / ks, min=0.0)
    w = torch.where((j >= 0) & (j <= m - 1), w, 0.0)
    total = w.sum(-1, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    w = torch.where(((s >= -0.5) & (s <= m - 0.5))[:, None], w, 0.0)
    gathered = x[..., j.clamp(0, m - 1).long()]  # (..., n, taps)
    return (gathered * w.to(x.dtype)).sum(-1)


def sine_source(
    params,
    cfg,
    f0_up: torch.Tensor,
    rand_ini: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """f0_up: (B, L, 1) F0 at the sample rate -> (source (B, L, 1), uv (B, L, 1)).

    rand_ini: (B, H) uniform initial phases (column 0 is zeroed here);
    noise: (B, L, H) standard normal.  Both are drawn from ``generator``
    when not given.
    """
    b, length, _ = f0_up.shape
    scale = cfg.upsample_scale
    harmonics = cfg.nb_harmonics + 1
    dev, dt = f0_up.device, f0_up.dtype
    if rand_ini is None:
        rand_ini = torch.rand((b, harmonics), generator=generator, device=dev, dtype=dt)
    if noise is None:
        noise = torch.randn((b, length, harmonics), generator=generator, device=dev, dtype=dt)

    mult = torch.arange(1, harmonics + 1, dtype=dt, device=dev)
    fn = f0_up * mult[None, None, :]  # (B, L, H)
    rad = torch.remainder(fn / cfg.sampling_rate, 1.0)

    rand_ini = rand_ini.to(dev, dt).clone()
    rand_ini[:, 0] = 0.0
    rad = rad.clone()
    rad[:, 0, :] = rad[:, 0, :] + rand_ini

    rad_t = rad.transpose(1, 2)  # (B, H, L)
    rad_lo = _jax_linear_resize(rad_t, length // scale)
    phase_lo = torch.cumsum(rad_lo, dim=-1) * 2.0 * np.pi
    phase = _jax_linear_resize(phase_lo * scale, length)
    sines = torch.sin(phase).transpose(1, 2)  # (B, L, H)

    uv = (f0_up > cfg.nsf_voiced_threshold).to(dt)  # (B, L, 1)
    sine_waves = sines * cfg.nsf_alpha
    noise_amp = uv * cfg.nsf_sigma + (1.0 - uv) * cfg.nsf_alpha / 3.0
    sine_waves = sine_waves * uv + noise_amp * noise.to(dev, dt)

    merged = torch.tanh(dense(params["l_linear"], sine_waves))  # (B, L, 1)
    return merged, uv


# ---------------------------------------------------------------------------
# Snake ResBlock
# ---------------------------------------------------------------------------

def resblock(p: dict, x: torch.Tensor, kernel: int, dilations) -> torch.Tensor:
    k = kernel
    for i, d in enumerate(dilations):
        xt = snake(x, p["alpha1"][i])
        xt = conv1d(p["convs1"][i], xt, padding=_get_padding(k, d), dilation=d)
        xt = snake(xt, p["alpha2"][i])
        xt = conv1d(p["convs2"][i], xt, padding=_get_padding(k, 1))
        x = xt + x
    return x


# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------

def _downsample_cum(cfg):
    downsample_rates = [1] + list(cfg.upsample_rates[::-1][:-1])
    return np.cumprod(downsample_rates)[::-1]


def hift_decode(params, cfg, mel: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """mel (B, 80, T), source (B, 1, T*480) -> waveform (B, T*480)."""
    win = hann_window(cfg.istft_n_fft)
    s_real, s_imag = stft(source[:, 0], cfg.istft_n_fft, cfg.istft_hop_len, win, center=True)
    s_stft = torch.cat([s_real, s_imag], dim=1)  # (B, n_fft+2, T')

    num_kernels = len(cfg.resblock_kernel_sizes)
    downsample_cum = _downsample_cum(cfg)

    x = conv1d(params["conv_pre"], mel, padding=3)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        x = F.leaky_relu(x, cfg.lrelu_slope)
        x = conv_transpose1d(params["ups"][i], x, stride=u, padding=(k - u) // 2)
        if i == len(cfg.upsample_rates) - 1:
            x = torch.cat([x[:, :, 1:2], x], dim=2)  # reflection pad (1, 0)
        du = int(downsample_cum[i])
        if du == 1:
            si = conv1d(params["source_downs"][i], s_stft)
        else:
            si = conv1d(params["source_downs"][i], s_stft, stride=du, padding=du // 2)
        si = resblock(
            params["source_resblocks"][i], si,
            cfg.source_resblock_kernel_sizes[i], cfg.source_resblock_dilation_sizes[i],
        )
        x = x + si
        xs = None
        for j in range(num_kernels):
            r = resblock(
                params["resblocks"][i * num_kernels + j], x,
                cfg.resblock_kernel_sizes[j], cfg.resblock_dilation_sizes[j],
            )
            xs = r if xs is None else xs + r
        x = xs / num_kernels

    x = F.leaky_relu(x, 0.01)
    x = conv1d(params["conv_post"], x, padding=3)
    n_half = cfg.istft_n_fft // 2 + 1
    magnitude = torch.exp(torch.clamp(x[:, :n_half], max=1e2))
    phase = torch.sin(x[:, n_half:])

    real = magnitude * torch.cos(phase)
    imag = magnitude * torch.sin(phase)
    audio = istft(real, imag, cfg.istft_n_fft, cfg.istft_hop_len, win, center=True)
    return torch.clamp(audio, -cfg.audio_limit, cfg.audio_limit)


def hift_inference(
    params,
    cfg,
    mel: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    draws: Optional[tuple] = None,
    cache_source: Optional[torch.Tensor] = None,
    cache_len=None,
):
    """mel (B, 80, T) -> (waveform (B, T*480), source (B, 1, T*480)).

    draws: optional (rand_ini (B, H), noise (B, T*480, H)) for sine_source;
    else they come from ``generator``.  cache_source (B, 1, C) replaces the
    first ``cache_len`` (default C) source samples, which keeps the phase
    continuous across streaming chunks.
    """
    f0 = f0_predict(params["f0_predictor"], cfg, mel)  # (B, T)
    f0_up = f0.repeat_interleave(cfg.upsample_scale, dim=-1)[..., None]  # (B, L, 1)
    rand_ini, noise = draws if draws is not None else (None, None)
    s, _ = sine_source(params["m_source"], cfg, f0_up, rand_ini, noise, generator)
    s = s.transpose(1, 2)  # (B, 1, L)
    if cache_source is not None:
        c = cache_source.shape[2]
        idx = torch.arange(s.shape[2], device=s.device)[None, None, :]
        pad_cache = F.pad(cache_source.to(s.dtype), (0, s.shape[2] - c))
        s = torch.where(idx < (c if cache_len is None else cache_len), pad_cache, s)
    audio = hift_decode(params, cfg, mel, s)
    return audio, s
