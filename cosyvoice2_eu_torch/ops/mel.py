"""Mel spectrogram featurizers in PyTorch (counterpart of ``cosyvoice2_eu_tpu/ops/mel.py``).

`mel_spectrogram` reproduces the matcha featurizer used for training targets
and prompt features (reference: third_party/Matcha-TTS/matcha/utils/audio.py:45:
reflect pre-pad, center=False STFT, slaney mel, log clamp 1e-5).

`whisper_log_mel` reproduces OpenAI whisper's 128-bin log-mel used as the FSQ
speech-tokenizer input (reference: cosy_repo/cosyvoice/cli/frontend.py:262-274).

The filterbanks are host numpy (``lru_cache``d); the spectrograms run on the
waveform tensor's device.  ``mel_spectrogram_np`` is the host twin of
``mel_spectrogram`` for data pipelines.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cosyvoice2_eu_torch.ops.stft import _reflect_pad_last, hann_window, stft


def hz_to_mel(f: np.ndarray, htk: bool = False) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # slaney: linear below 1 kHz, log above
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = f >= min_log_hz
    mels = np.where(above, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def mel_to_hz(m: np.ndarray, htk: bool = False) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = m >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
) -> np.ndarray:
    """librosa.filters.mel-compatible (n_mels, n_fft//2+1) filterbank."""
    if fmax is None:
        fmax = sr / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel(np.array(fmin), htk), hz_to_mel(np.array(fmax), htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
        weights *= enorm[:, None]
    return weights.astype(np.float32)


def _basis(x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    return torch.as_tensor(mel_filterbank(*args, **kwargs), device=x.device, dtype=x.dtype)


def mel_spectrogram(
    y: torch.Tensor,
    n_fft: int = 1920,
    num_mels: int = 80,
    sampling_rate: int = 24000,
    hop_size: int = 480,
    win_size: int = 1920,
    fmin: float = 0.0,
    fmax: float | None = None,
    center: bool = False,
) -> torch.Tensor:
    """(B, T) waveform -> (B, num_mels, T // hop_size) log-mel.

    matcha.utils.audio.mel_spectrogram (the reference featurizer for both
    training and prompt mels).
    """
    if win_size != n_fft:
        raise ValueError("the reference always uses win_size == n_fft")
    if not center:
        y = _reflect_pad_last(y, (n_fft - hop_size) // 2)
    real, imag = stft(y, n_fft, hop_size, hann_window(win_size), center=center)
    mag = torch.sqrt(real * real + imag * imag + 1e-9)
    mel = torch.einsum("mf,...ft->...mt", _basis(mag, sampling_rate, n_fft, num_mels, fmin, fmax),
                       mag)
    return torch.log(torch.clamp(mel, min=1e-5))


def mel_spectrogram_np(
    y: np.ndarray,
    n_fft: int = 1920,
    num_mels: int = 80,
    sampling_rate: int = 24000,
    hop_size: int = 480,
    win_size: int = 1920,
    fmin: float = 0.0,
    fmax: float | None = None,
    center: bool = False,
) -> np.ndarray:
    """Host-numpy twin of ``mel_spectrogram``: (B, T) or (T,) waveform ->
    (B, num_mels, n_frames) (or unbatched) log-mel, the same math.  A data
    pipeline featurizes one utterance at a time, where a host FFT beats a
    round trip to the card."""
    if win_size != n_fft:
        raise ValueError("the reference always uses win_size == n_fft")
    y = np.asarray(y, np.float32)
    squeeze = y.ndim == 1
    if squeeze:
        y = y[None]
    if not center:
        pad = (n_fft - hop_size) // 2
        y = np.pad(y, [(0, 0)] * (y.ndim - 1) + [(pad, pad)], mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(y, n_fft, axis=-1)[
        ..., ::hop_size, :
    ]
    try:  # pocketfft via scipy is ~5x faster on non-power-of-two n_fft=1920
        from scipy.fft import rfft as _rfft
    except ImportError:
        _rfft = np.fft.rfft
    spec = _rfft(frames * hann_window(n_fft), axis=-1)
    mag = np.sqrt(spec.real**2 + spec.imag**2 + 1e-9).astype(np.float32)
    basis = mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax)
    mel = mag @ basis.T  # (..., n_frames, n_mels)
    out = np.log(np.clip(mel, 1e-5, None)).swapaxes(-1, -2).astype(np.float32)
    return out[0] if squeeze else out


def host_mel_fn(mel_cfg):
    """Data-pipeline featurizer from a MelConfig: wav (T,) -> (T_mel, 80)."""

    def fn(wav: np.ndarray) -> np.ndarray:
        return mel_spectrogram_np(
            wav, mel_cfg.n_fft, mel_cfg.num_mels, mel_cfg.sampling_rate,
            mel_cfg.hop_size, mel_cfg.win_size, mel_cfg.fmin, mel_cfg.fmax,
            mel_cfg.center,
        ).T

    return fn


def whisper_log_mel(
    y: torch.Tensor,
    n_mels: int = 128,
    n_fft: int = 400,
    hop: int = 160,
    sampling_rate: int = 16000,
) -> torch.Tensor:
    """(B, T) 16 kHz waveform -> (B, n_mels, T // hop) whisper log-mel.

    whisper.audio.log_mel_spectrogram: center=True power spectrum with the
    last frame dropped, log10 clamped to (max - 8), scaled (x+4)/4.  The max
    is over a whole batch row, so a padded row changes the result: call it
    on one prompt at a time.
    """
    real, imag = stft(y, n_fft, hop, hann_window(n_fft), center=True)
    power = (real * real + imag * imag)[..., :-1]  # drop the final frame
    mel = torch.einsum("mf,...ft->...mt", _basis(power, sampling_rate, n_fft, n_mels), power)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    peak = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - 8.0)
    return (log_spec + 4.0) / 4.0
