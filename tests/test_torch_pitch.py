"""The port's YIN (``train/pitch.py``, ``utils/native.py``) against the JAX
package's: the numpy YIN equal to JAX's numpy path, the native YIN equal to
JAX's native library (the same source and flags, built on this machine),
native against numpy within JAX's own tolerance, a tone's pitch and silence."""

import os
import subprocess
import sys

import numpy as np
import pytest

import cosyvoice2_eu_tpu.utils.native as jax_native
from cosyvoice2_eu_torch.train import pitch as port_pitch
from cosyvoice2_eu_torch.utils import native as port_native
from cosyvoice2_eu_tpu.train import pitch as jax_pitch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tone(freq, sr=24000, seconds=0.5):
    t = np.arange(int(sr * seconds)) / sr
    return (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _signals():
    rng = np.random.default_rng(0)
    noisy = _tone(150.0, seconds=0.4) + (rng.standard_normal(9600) * 0.01).astype(np.float32)
    # a glide 120 -> 300 Hz with harmonics, then noise, then silence
    sr, n = 24000, 24480
    f0 = np.linspace(120.0, 300.0, n)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    glide = sum(0.3 / k * np.sin(k * phase) for k in (1, 2, 3)).astype(np.float32)
    glide[16000:20000] = (rng.standard_normal(4000) * 0.2).astype(np.float32)
    glide[20000:] = 0.0
    return {"tone": _tone(220.0), "noisy": noisy, "glide": glide}


SIGNALS = _signals()


def _jax_numpy_f0(wav, monkeypatch):
    """JAX's numpy YIN: its native dispatch bypassed, as tests/test_native.py does."""
    monkeypatch.setattr(jax_native, "yin_f0_native", lambda *a, **k: None)
    return jax_pitch.estimate_f0(wav)


_JAX_NATIVE = """
import sys, time
import numpy as np
import cosyvoice2_eu_tpu.utils.native as jax_native
signals = dict(np.load(sys.argv[1]))
for _ in range(3):  # make may be building the library in another process
    if jax_native.load_library() is not None:
        break
    jax_native.load_library.cache_clear()
    time.sleep(2.0)
else:
    raise SystemExit("the JAX package's native library did not load")
np.savez(sys.argv[2], **{k: jax_native.yin_f0_native(v) for k, v in signals.items()})
"""


@pytest.fixture(scope="module")
def jax_native_f0(tmp_path_factory):
    """JAX's native YIN on every signal, in a process of its own: loading
    its library turns on flush-to-zero for the loading process."""
    d = tmp_path_factory.mktemp("yin")
    np.savez(d / "in.npz", **SIGNALS)
    out = subprocess.run([sys.executable, "-c", _JAX_NATIVE, str(d / "in.npz"), str(d / "out.npz")],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_numpy_yin_equals_jax_numpy_path(name, monkeypatch):
    wav = SIGNALS[name]
    np.testing.assert_array_equal(port_pitch.estimate_f0_numpy(wav),
                                  _jax_numpy_f0(wav, monkeypatch))


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_native_yin_equals_jax_native(name, jax_native_f0):
    np.testing.assert_array_equal(port_pitch.estimate_f0(SIGNALS[name]), jax_native_f0[name])


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_native_matches_numpy_within_jax_tolerance(name):
    """JAX's own tolerance (tests/test_native.py): voicing agrees on more
    than 90% of frames; voiced values within 5%."""
    wav = SIGNALS[name]
    native, ref = port_pitch.estimate_f0(wav), port_pitch.estimate_f0_numpy(wav)
    assert native.shape == ref.shape == (len(wav) // 480,)
    assert np.mean((native > 0) == (ref > 0)) > 0.9
    both = (native > 0) & (ref > 0)
    assert both.any()
    np.testing.assert_allclose(native[both], ref[both], rtol=0.05)


def test_tone_tracks_and_silence_is_unvoiced():
    f0 = port_pitch.estimate_f0(_tone(220.0))
    voiced = f0[f0 > 0]
    assert len(voiced) > len(f0) * 0.8
    assert abs(np.median(voiced) - 220.0) < 5.0
    assert (port_pitch.estimate_f0(np.zeros(24000, np.float32)) == 0).all()
    assert (port_pitch.estimate_f0_numpy(np.zeros(24000, np.float32)) == 0).all()


def test_native_library_is_named_by_source_and_flags_and_rejects_bad_settings():
    path = port_native.library_path()
    assert path.parent == port_native.BUILD_DIR and path.name.startswith("yin_f0_")
    port_native.load_library()
    assert path.exists()
    with pytest.raises(ValueError):
        port_native.yin_f0(np.zeros(960, np.float32), hop=0)


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback onto the numpy YIN: a source that does not compile raises."""
    bad = tmp_path / "yin_f0.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(port_native, "SOURCE", bad)
    monkeypatch.setattr(port_native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(port_native, "_lib", [])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        port_native.load_library()


def test_loading_the_library_keeps_subnormals():
    """The library links without -ffast-math: loading it leaves the
    process's floating-point mode alone (g++'s fast-math start file would
    turn on flush-to-zero, as loading the JAX package's library does)."""
    code = ("import numpy as np\n"
            "from cosyvoice2_eu_torch.utils.native import load_library\n"
            "load_library()\n"
            "x = np.array([1e-39], np.float32)\n"
            "print(float(x[0] * np.float32(3.0)) > 0.0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"
