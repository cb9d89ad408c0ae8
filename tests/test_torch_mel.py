"""The port's mel featurizers (``ops/mel.py``) against the JAX package's on
the CPU: the filterbanks exactly, the spectrograms within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice2_eu_torch.config import MelConfig
from cosyvoice2_eu_torch.ops import mel as port_mel
from cosyvoice2_eu_tpu.ops import mel as jax_mel

TOL = 1e-5  # fp32 FFT and mel products in two libraries, log-scale outputs of |x| <= ~25


def _wave(shape, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / 16000.0
    tone = 0.3 * np.sin(2 * np.pi * (180.0 + 40.0 * t) * t)
    return (tone + 0.05 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("args", [
    (24000, 1920, 80, 0.0, None, False, "slaney"),   # prompt mel
    (16000, 400, 128, 0.0, None, False, "slaney"),   # whisper
    (16000, 512, 80, 20.0, None, True, None),        # kaldi fbank (htk, no norm)
    (16000, 400, 16, 0.0, 7000.0, False, "slaney"),  # a narrow one, fmax below Nyquist
])
def test_filterbank_equals_jax(args):
    """The same float64 numpy arithmetic: bit for bit."""
    got = port_mel.mel_filterbank(*args)
    want = jax_mel.mel_filterbank(*args)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [24000, 17371])
def test_mel_spectrogram_matches_jax(n):
    """(2, T) at 24 kHz: reflect pre-pad, center=False STFT, slaney mel, log."""
    y = _wave((2, n), 0) * 1.5
    got = port_mel.mel_spectrogram(torch.tensor(y)).numpy()
    want = np.asarray(jax_mel.mel_spectrogram(jnp.asarray(y)))
    assert got.shape == want.shape == (2, 80, n // 480)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_mel_spectrogram_np_matches_jax_and_the_tensor_version():
    """The host twin: equal to JAX's host twin and to the tensor version
    within 1e-5, batched and not; ``host_mel_fn`` is its transpose."""
    y = _wave((2, 12000), 1)
    got = port_mel.mel_spectrogram_np(y)
    np.testing.assert_allclose(got, jax_mel.mel_spectrogram_np(y), atol=TOL)
    np.testing.assert_allclose(got, port_mel.mel_spectrogram(torch.tensor(y)).numpy(), atol=TOL)
    np.testing.assert_allclose(port_mel.mel_spectrogram_np(y[0]), got[0], atol=0)
    np.testing.assert_allclose(port_mel.host_mel_fn(MelConfig())(y[0]), got[0].T, atol=0)


@pytest.mark.parametrize("n_mels,n", [(128, 16000), (128, 7777), (16, 7680)])
def test_whisper_log_mel_matches_jax(n_mels, n):
    """center=True power spectrum, the last frame dropped, log10 clamped to
    the row's max - 8, (x + 4) / 4."""
    y = _wave((1, n), 2)
    got = port_mel.whisper_log_mel(torch.tensor(y), n_mels=n_mels).numpy()
    want = np.asarray(jax_mel.whisper_log_mel(jnp.asarray(y), n_mels=n_mels))
    assert got.shape == want.shape == (1, n_mels, n // 160)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_whisper_clamp_reads_the_whole_row():
    """The max - 8 floor is taken over a whole row (both axes): a quiet
    stretch is lifted to it, as in the reference."""
    y = _wave((1, 16000), 3)
    y[:, 8000:] *= 1e-6
    got = port_mel.whisper_log_mel(torch.tensor(y)).numpy()
    floor = (got.max() * 4.0 - 4.0 - 8.0 + 4.0) / 4.0
    np.testing.assert_allclose(got.min(), floor, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jax_mel.whisper_log_mel(jnp.asarray(y))),
                               atol=TOL)


def test_mel_spectrogram_rejects_another_window():
    with pytest.raises(ValueError, match="win_size"):
        port_mel.mel_spectrogram(torch.zeros(1, 4800), win_size=1024)
