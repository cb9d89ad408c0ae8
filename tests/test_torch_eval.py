"""The port's evaluation harness (``cosyvoice2_eu_torch/eval/``) against the
JAX package's: every metric on seeded signals, ``evaluate_model`` and the
experiment pipeline with an injected synthesizer (the same CSVs, summaries,
analyses and reports), the report's charts, the ASR hook's gate, and
``Synthesizer`` over a tiny port model on the CPU.

Both packages' metrics reach a YIN pitch tracker.  The JAX package's native
library turns on flush-to-zero in the process that loads it
(``tests/test_torch_pitch.py``), so its native entry is replaced here by the
port's YIN, which equals it bit for bit (``test_torch_pitch.py::
test_native_yin_equals_jax_native``).  Tolerance: exact equality (both
sides run the same numpy on the same inputs), except where noted.
"""

import math
import os
import wave

import numpy as np
import pytest

import cosyvoice2_eu_tpu.utils.native as jax_native
from cosyvoice2_eu_tpu.eval import metrics as JM
from cosyvoice2_eu_tpu.eval import pipeline as jax_pipeline
from cosyvoice2_eu_tpu.eval import report as jax_report
from cosyvoice2_eu_tpu.eval import run_eval as jax_run_eval
from cosyvoice2_eu_tpu.eval import synthesizer as jax_synth
from cosyvoice2_eu_torch.eval import metrics as PM
from cosyvoice2_eu_torch.eval import pipeline as port_pipeline
from cosyvoice2_eu_torch.eval import report as port_report
from cosyvoice2_eu_torch.eval import run_eval as port_run_eval
from cosyvoice2_eu_torch.eval import synthesizer as port_synth
from cosyvoice2_eu_torch.train import pitch as port_pitch


@pytest.fixture(autouse=True)
def _jax_yin_is_the_ports(monkeypatch):
    monkeypatch.setattr(jax_native, "yin_f0_native",
                        lambda wav, *a, **k: port_pitch.estimate_f0(
                            np.ascontiguousarray(wav, np.float32), *a, **k))


def _harmonic(f0, seconds=0.8, sr=24000, noise=0.0, seed=0):
    t = np.arange(int(sr * seconds)) / sr
    x = sum(0.3 / k * np.sin(2 * np.pi * k * f0 * t) for k in (1, 2, 3))
    if noise:
        x = x + noise * np.random.default_rng(seed).standard_normal(len(t))
    return x.astype(np.float32)


def _write_wav(path, x, sr=24000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())


PAIRS = {
    "same": (_harmonic(200), _harmonic(200)),
    "detuned": (_harmonic(200), _harmonic(215, noise=0.03)),
    "octave": (_harmonic(150, seconds=1.1), _harmonic(300, seconds=0.9, noise=0.1, seed=1)),
    "noise": (np.random.default_rng(2).standard_normal(12000).astype(np.float32) * 0.1,
              _harmonic(250, seconds=0.5)),
}


def _same(a, b):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


@pytest.mark.parametrize("name", sorted(PAIRS))
@pytest.mark.parametrize("sr", [24000, 16000])
def test_spectral_and_pitch_metrics_equal_jax(name, sr):
    a, b = PAIRS[name]
    for fn in ("mcd", "mcd_rel", "log_spectral_distance"):
        assert getattr(PM, fn)(a, b, sr) == getattr(JM, fn)(a, b, sr), fn
    got, want = PM.pitch_metrics(a, b, sr), JM.pitch_metrics(a, b, sr)
    for field in ("gpe", "f0_rmse", "f0_corr", "vuv_error"):
        assert _same(getattr(got, field), getattr(want, field)), field


def test_pitch_metrics_are_nan_under_five_voiced_frames():
    silent = np.zeros(24000, np.float32)
    for mod in (PM, JM):
        pm = mod.pitch_metrics(silent, _harmonic(200))
        assert all(math.isnan(v) for v in (pm.gpe, pm.f0_rmse, pm.f0_corr, pm.vuv_error))


@pytest.mark.parametrize("name", sorted(PAIRS) + ["silent"])
def test_defined_pitch_metrics_are_the_finite_ones(name):
    """``defined_pitch_metrics`` names exactly the fields that
    ``pitch_metrics``'s guards leave finite (the eval gate on the card)."""
    a, b = PAIRS.get(name, (np.zeros(24000, np.float32), _harmonic(200)))
    pm = PM.pitch_metrics(a, b)
    finite = tuple(f for f in ("gpe", "f0_rmse", "f0_corr", "vuv_error")
                   if math.isfinite(getattr(pm, f)))
    assert PM.defined_pitch_metrics(a, b) == finite


def test_dtw_cheaptrick_and_sp2mc_equal_jax():
    rng = np.random.default_rng(3)
    cost = rng.random((37, 29))
    for band in (None, 12):
        for x, y in zip(PM.dtw_path(cost, band), JM.dtw_path(cost, band)):
            np.testing.assert_array_equal(x, y)
    wav = _harmonic(180, seconds=0.4, noise=0.05).astype(np.float64)
    f0 = port_pitch.estimate_f0(wav.astype(np.float32), 24000, hop=120, frame_len=1024)
    np.testing.assert_array_equal(PM.cheaptrick_envelope(wav, f0, 24000, 120),
                                  JM.cheaptrick_envelope(wav, f0, 24000, 120))
    sp = np.exp(rng.standard_normal((5, 257)) * 0.3)
    for alpha in (0.0, 0.58):
        np.testing.assert_array_equal(PM.sp2mc(sp, 12, alpha), JM.sp2mc(sp, 12, alpha))
    np.testing.assert_array_equal(PM.mcep_sequence(wav, 24000), JM.mcep_sequence(wav, 24000))


def test_secs_wer_and_normalizer_equal_jax():
    proj = np.random.default_rng(4).standard_normal((192, 64))

    def embed(w):  # a fixed random projection of the first 64 samples
        return proj @ np.asarray(w[:64], np.float64)

    a, b = PAIRS["detuned"]
    assert PM.secs(a, b, embed) == JM.secs(a, b, embed)
    for ref, hyp in [("bonjour le monde", "bonjour monde"), ("a b c", "a x c d"), ("", "a")]:
        assert PM.wer(ref, hyp) == JM.wer(ref, hyp)
    for text, lang in [("C'était 1 234,5 € — vraiment !", "fr"), ("Die Straße Nr. 1.000", "de"),
                       ("œuvre cœur", "fr"), ("Vingt-trois, s'il vous plaît", "fr")]:
        for strip in (True, False):
            assert (PM.normalize_text_for_wer(text, lang, strip)
                    == JM.normalize_text_for_wer(text, lang, strip))


def test_metrics_smoke_mode_equals_jax():
    got, want = PM.test_metrics(), JM.test_metrics()
    assert got["ok"] and want["ok"]
    assert got == want


def _dataset(root, seconds=0.6):
    """A 4-utterance, 2-speaker dataset of seeded harmonics."""
    for spk, f0 in [("spk1", 200.0), ("spk2", 300.0)]:
        d = root / spk / "a"
        os.makedirs(d)
        for i in range(2):
            _write_wav(d / f"{spk}_utt{i}.wav", _harmonic(f0 + 10 * i, seconds, noise=0.01,
                                                          seed=i))
            (d / f"{spk}_utt{i}.normalized.txt").write_text("bonjour le monde")
    return root


def _files(d):
    out = {}
    for sub, _, files in os.walk(d):
        for f in files:
            p = os.path.join(sub, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def _noisy_prompt_synth(load_wav):
    def synthesize(text, prompt_path):
        wav = load_wav(prompt_path, 24000)
        noise = 0.01 * np.random.default_rng(len(text)).standard_normal(len(wav))
        return wav + noise.astype(np.float32), 0.05

    return synthesize


def test_evaluate_model_writes_what_jax_writes(tmp_path):
    from cosyvoice2_eu_torch.frontend.frontend import load_wav

    root = _dataset(tmp_path / "test")
    port_samples = port_run_eval.read_dataset(str(root))
    jax_samples = jax_run_eval.read_dataset(str(root))
    assert [vars(s) for s in port_samples] == [vars(s) for s in jax_samples]
    assert len(port_samples) == 4

    def embed(w):
        return np.abs(np.fft.rfft(np.asarray(w[:400], np.float64)))[:192]

    def asr(wav, sr):
        return "bonjour monde" if len(wav) % 2 else "bonjour le monde"

    synth = _noisy_prompt_synth(load_wav)
    got = port_run_eval.evaluate_model(synth, port_samples, str(tmp_path / "port"), "m",
                                       embed_fn=embed, asr_fn=asr)
    want = jax_run_eval.evaluate_model(synth, jax_samples, str(tmp_path / "jax"), "m",
                                       embed_fn=embed, asr_fn=asr)
    assert got == want
    assert got["n"] == 4 and got["n_failed"] == 0 and "secs" in got and "wer" in got
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_evaluate_model_failure_rows_equal_jax(tmp_path):
    root = _dataset(tmp_path / "test")

    def synth(text, prompt_path):
        if "spk2" in prompt_path:
            raise RuntimeError("no audio")
        return _harmonic(205), 0.1

    got = port_run_eval.evaluate_model(synth, port_run_eval.read_dataset(str(root)),
                                       str(tmp_path / "port"), "m")
    want = jax_run_eval.evaluate_model(synth, jax_run_eval.read_dataset(str(root)),
                                       str(tmp_path / "jax"), "m")
    assert got == want and got["n_failed"] == 2
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


class _FakeModel:
    """The Cosy2EU surface the Synthesizer uses: each package's load_wav."""

    sample_rate = 24000

    def __init__(self, load_wav):
        self._load = load_wav
        self._spk = {}
        outer = self

        class _FE:
            def get_spk(self, k):
                return outer._spk[k]

        self._frontend = _FE()

    def add_zero_shot_spk(self, prompt_text, prompt, spk_id):
        self._spk[spk_id] = prompt
        return True

    def tts(self, text, prompt, **kw):
        wav = self._load(prompt, 24000) if isinstance(prompt, str) else np.zeros(2400, np.float32)
        noise = 0.01 * np.random.default_rng(0).standard_normal(len(wav))
        return (wav + noise.astype(np.float32))[None], 24000


def _run_matrix(pipeline_mod, synth_mod, load_wav, root, out):
    cfg = {
        "models": {"pretrained": {"setting": "original"},
                   "full_finetuned": {"setting": "llm_flow_hifigan"}},
        "hours": [50, 100],
        "results_dir": str(out),
        "timeout_s": 60.0,
    }
    resolved = []

    def factory(model_cfg):
        resolved.append(model_cfg)
        return synth_mod.Synthesizer(model=_FakeModel(load_wav), warmup=False, timeout_s=60.0)

    pipe = pipeline_mod.EvaluationPipeline(cfg, language="fr", model_factory=factory)
    return pipe.run(str(root)), resolved


def test_pipeline_matrix_and_reports_equal_jax(tmp_path, monkeypatch):
    """The hours x setting matrix through an injected factory: the resolved
    run ids, per-model and combined CSVs, analyses and markdown equal JAX's;
    then the report's charts and tables on each results dir."""
    from cosyvoice2_eu_torch.frontend.frontend import load_wav as port_load
    from cosyvoice2_eu_tpu.frontend.frontend import load_wav as jax_load

    # the Synthesizer times each sample on the wall clock: a fixed clock
    # makes both packages write the same synthesis_time and rtf
    class _Clock:
        def __init__(self):
            self.t = 0.0

        def time(self):
            self.t += 0.25
            return self.t

    monkeypatch.setattr(port_synth, "time", _Clock())
    monkeypatch.setattr(jax_synth, "time", _Clock())
    root = _dataset(tmp_path / "test")
    got, got_cfg = _run_matrix(port_pipeline, port_synth, port_load, root, tmp_path / "port")
    want, want_cfg = _run_matrix(jax_pipeline, jax_synth, jax_load, root, tmp_path / "jax")
    for c in got_cfg:  # the port's factory config carries the device
        c.pop("device", None)
    assert got_cfg == want_cfg
    assert got == want
    assert all(r["success_rate"] == 1.0 for r in got["component"])
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")

    out_p = port_report.generate_all(str(tmp_path / "port"), language="fr")
    out_j = jax_report.generate_all(str(tmp_path / "jax"), language="fr")
    assert out_p["charts"] and len(out_p["charts"]) == len(out_j["charts"])
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_synthesizer_timeout_rows_equal_jax(tmp_path):
    import time as _time

    from cosyvoice2_eu_torch.frontend.frontend import load_wav

    class _Slow(_FakeModel):
        def tts(self, text, prompt, **kw):
            if "slow" in text:
                _time.sleep(1.0)
            return super().tts(text, prompt, **kw)

    wav_path = str(tmp_path / "p.wav")
    _write_wav(wav_path, _harmonic(220))
    rows = {}
    for name, mod in (("port", port_synth), ("jax", jax_synth)):
        syn = mod.Synthesizer(model=_Slow(load_wav), warmup=False, timeout_s=0.2)
        rows[name] = syn.synthesize_batch([("a", "slow one", wav_path), ("b", "fast", wav_path)])
    for got, want in zip(rows["port"], rows["jax"]):
        assert got.keys() == want.keys()
        assert got.get("error") == want.get("error")
        if "wav" in got:
            np.testing.assert_array_equal(got["wav"], want["wav"])
    assert "timeout" in rows["port"][0]["error"] and "wav" in rows["port"][1]


def test_synthesizer_over_a_tiny_port_model_on_the_cpu(capsys):
    out = port_synth.test_synthesizer(device="cpu")
    assert out == {"ok": True, "n": 2}


def test_synthesizer_language_hint_and_prompt_cache():
    from cosyvoice2_eu_torch.frontend.frontend import load_wav

    model = _FakeModel(load_wav)
    for mod in (port_synth, jax_synth):
        syn = mod.Synthesizer(model=model, add_language_hint=True, language="de")
        assert syn._text("Hallo.") == "<|de|><|endofprompt|>Hallo."
        assert syn._prompt_for("x.wav") == "x.wav"
        assert syn._spk_cache == {"x.wav": "eval_spk_0"}


def test_asr_hook_is_gated_on_whisper_dir(monkeypatch):
    from cosyvoice2_eu_torch.eval import asr as port_asr
    from cosyvoice2_eu_tpu.eval import asr as jax_asr

    monkeypatch.delenv("WHISPER_DIR", raising=False)
    for mod in (port_asr, jax_asr):
        mod._cached_whisper.cache_clear()
        with pytest.raises(FileNotFoundError, match="WHISPER_DIR"):
            mod.whisper_from_env(np.zeros(160, np.float32), 16000)


def test_pipeline_hooks_and_run_ids_equal_jax():
    for spec in ("cosyvoice2_eu_torch.eval.metrics:wer", "os.path:join"):
        assert port_pipeline._import_hook(spec) is jax_pipeline._import_hook(spec)
    for args in [(500, "bl", "fr", False), (1500, "bl", "de", True)]:
        assert port_run_eval.resolve_run_id(*args) == jax_run_eval.resolve_run_id(*args)
    assert port_pipeline.DEFAULT_MODELS == jax_pipeline.DEFAULT_MODELS
    assert port_pipeline.METRIC_KEYS == jax_pipeline.METRIC_KEYS


def test_eval_cli_smoke_modes(capsys):
    assert port_pipeline.main(["--test-metrics"]) == 0
    assert port_pipeline.main(["--test-baselines"]) == 0


def test_asr_hook_runs_on_the_pipelines_device():
    """The Whisper hook defaults to the card; the pipeline binds its own
    ``device`` to a hook that takes one and leaves other hooks as they are."""
    import inspect

    from cosyvoice2_eu_torch.eval import asr

    assert inspect.signature(asr.make_whisper_asr).parameters["device"].default == "cuda"
    spec = "cosyvoice2_eu_torch.eval.asr:whisper_from_env"
    assert port_pipeline.EvaluationPipeline({"asr_hook": spec}).asr_fn.keywords == \
        {"device": "cuda"}
    pipe = port_pipeline.EvaluationPipeline({"asr_hook": spec, "device": "cpu",
                                             "embed_hook": "numpy:mean"})
    assert pipe.asr_fn.keywords == {"device": "cpu"} and pipe.embed_fn is np.mean
