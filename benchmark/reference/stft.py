"""Frozen copy of the port's ``cosyvoice2_eu_torch/ops/stft.py`` (plain
PyTorch, no kernel), for the benchmark's reference: it imports nothing of
the port, and a later change to the port does not change it."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_MATMUL_DFT_MAX = 64


def hann_window(win_size: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window, as a host numpy array."""
    n = np.arange(win_size)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_size)
    return np.asarray(w).astype(dtype)


def frame(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., n_frames, frame_length)."""
    return x.unfold(-1, frame_length, hop)


@functools.lru_cache(maxsize=8)
def _dft_matrices(n_fft: int):
    """Real/imag DFT analysis matrices, shape (n_fft, n_fft//2+1)."""
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(n_fft)
    ang = -2.0 * np.pi * np.outer(n, k) / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _reflect_pad_last(x: torch.Tensor, pad: int) -> torch.Tensor:
    shape = x.shape
    y = F.pad(x.reshape(-1, 1, shape[-1]), (pad, pad), mode="reflect")
    return y.reshape(shape[:-1] + (y.shape[-1],))


def stft(x: torch.Tensor, n_fft: int, hop: int, window, center: bool = True):
    """torch.stft-compatible (onesided).  x: (..., T).

    Returns (real, imag), each (..., n_fft//2+1, n_frames).
    """
    if center:
        x = _reflect_pad_last(x, n_fft // 2)
    win = torch.as_tensor(np.asarray(window), device=x.device, dtype=x.dtype)
    frames = frame(x, n_fft, hop) * win  # (..., n_frames, n_fft)
    if n_fft <= _MATMUL_DFT_MAX:
        cos_m, sin_m = _dft_matrices(n_fft)
        real = frames @ torch.as_tensor(cos_m, device=x.device, dtype=x.dtype)
        imag = frames @ torch.as_tensor(sin_m, device=x.device, dtype=x.dtype)
    else:
        spec = torch.fft.rfft(frames, dim=-1)
        real, imag = spec.real, spec.imag
    return real.transpose(-1, -2), imag.transpose(-1, -2)


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop: int, window,
          center: bool = True) -> torch.Tensor:
    """torch.istft-compatible overlap-add.  real/imag: (..., F, n_frames).

    Returns (..., hop * (n_frames - 1)) when center=True.
    """
    real = real.transpose(-1, -2)  # (..., n_frames, F)
    imag = imag.transpose(-1, -2)
    dev, dt = real.device, real.dtype
    if n_fft <= _MATMUL_DFT_MAX:
        cos_m, sin_m = _dft_matrices(n_fft)
        # irfft via the conjugate-symmetric expansion: interior bins count 2x
        w = np.full(n_fft // 2 + 1, 2.0, dtype=np.float32)
        w[0] = 1.0
        if n_fft % 2 == 0:
            w[-1] = 1.0
        w_t = torch.as_tensor(w, device=dev, dtype=dt)
        frames = (real * w_t) @ torch.as_tensor(cos_m.T.copy(), device=dev, dtype=dt) + \
            (imag * w_t) @ torch.as_tensor(sin_m.T.copy(), device=dev, dtype=dt)
        frames = frames / n_fft
    else:
        frames = torch.fft.irfft(torch.complex(real, imag), n=n_fft, dim=-1)
    win_np = np.asarray(window, dtype=np.float32)
    frames = frames * torch.as_tensor(win_np, device=dev, dtype=dt)

    n_frames = frames.shape[-2]
    out_len = n_fft + hop * (n_frames - 1)
    batch_shape = frames.shape[:-2]
    flat = frames.reshape(-1, n_frames, n_fft)
    # overlap-add: fold sums the frames at stride hop
    sig = F.fold(flat.transpose(1, 2), output_size=(1, out_len), kernel_size=(1, n_fft),
                 stride=(1, hop)).reshape(flat.shape[0], out_len)

    # window envelope normalization (NOLA)
    wsq = np.zeros(out_len, dtype=np.float32)
    w2 = np.square(win_np)
    for f in range(n_frames):
        wsq[f * hop: f * hop + n_fft] += w2
    sig = sig / torch.as_tensor(np.maximum(wsq, 1e-11), device=dev, dtype=dt)

    if center:
        sig = sig[:, n_fft // 2: out_len - n_fft // 2]
    return sig.reshape(batch_shape + (sig.shape[-1],))
