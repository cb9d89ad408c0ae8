"""Host-side F0 estimation for the GAN trainer's targets.

Counterpart of ``cosyvoice2_eu_tpu/train/pitch.py``, which replaces the
reference's pyworld (WORLD harvest/dio, C++) dependency (reference:
cosy_repo/cosyvoice/dataset/processor.py:188-210) with a YIN estimator:
frame-wise cumulative-mean-normalised difference minima with parabolic
interpolation and a voicing threshold.  ``estimate_f0`` runs the native YIN
(``csrc/yin_f0.cpp``); ``estimate_f0_numpy`` is its plain numpy version,
which the tests hold it against.  Inference never calls either.
"""

from __future__ import annotations

import numpy as np

from cosyvoice2_eu_torch.utils.native import yin_f0


def estimate_f0(
    wav: np.ndarray,
    sample_rate: int = 24000,
    hop: int = 480,
    fmin: float = 60.0,
    fmax: float = 500.0,
    frame_len: int = 1920,
    threshold: float = 0.15,
) -> np.ndarray:
    """wav (T,) -> f0 (T // hop,) in Hz; 0 where unvoiced (the native YIN)."""
    return yin_f0(wav, sample_rate, hop, fmin, fmax, frame_len, threshold)


def estimate_f0_numpy(
    wav: np.ndarray,
    sample_rate: int = 24000,
    hop: int = 480,
    fmin: float = 60.0,
    fmax: float = 500.0,
    frame_len: int = 1920,
    threshold: float = 0.15,
) -> np.ndarray:
    """The plain numpy YIN: the difference function from an FFT
    autocorrelation, ~2 (acf[0] - acf[tau]) for a stationary frame."""
    tau_min = int(sample_rate / fmax)
    tau_max = int(sample_rate / fmin)
    n_frames = max(len(wav) // hop, 0)
    f0 = np.zeros(n_frames, np.float32)
    pad = np.pad(wav, (0, frame_len + tau_max))

    for i in range(n_frames):
        frame = pad[i * hop: i * hop + frame_len]
        if np.abs(frame).max() < 1e-4:
            continue
        fft_size = 1 << int(np.ceil(np.log2(frame_len + tau_max)))
        fx = np.fft.rfft(frame, fft_size)
        acf = np.fft.irfft(fx * np.conj(fx))[: tau_max + 1]
        d = 2.0 * (acf[0] - acf)
        # cumulative mean normalisation
        cmnd = np.ones_like(d)
        cmnd[1:] = d[1:] * np.arange(1, len(d)) / np.maximum(np.cumsum(d[1:]), 1e-12)

        seg = cmnd[tau_min:tau_max]
        below = np.where(seg < threshold)[0]
        if len(below):
            tau = below[0] + tau_min
            # walk to the local minimum
            while tau + 1 < tau_max and cmnd[tau + 1] < cmnd[tau]:
                tau += 1
        else:
            tau = int(np.argmin(seg)) + tau_min
            if cmnd[tau] > 0.5:  # unvoiced
                continue
        # parabolic interpolation
        if 1 <= tau < tau_max - 1:
            a, b, c = cmnd[tau - 1], cmnd[tau], cmnd[tau + 1]
            denom = a - 2 * b + c
            shift = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
            tau_f = tau + np.clip(shift, -1, 1)
        else:
            tau_f = float(tau)
        f0[i] = sample_rate / tau_f
    return f0
