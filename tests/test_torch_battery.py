"""The port's reporting battery and baselines layer
(``cosyvoice2_eu_torch/eval/battery.py``, ``baselines.py``) against the JAX
package's: on copies of one results dir both write the same tables, LaTeX,
charts and manifest; the fake engine's runner writes the same audio and
metric rows; the RTF backfill fills the same cells; the gated engines raise
alike.  Tolerance: byte equality of every file written (the same numpy on
the same inputs), with the wall clock fixed where rows record it.
"""

import csv
import os
import shutil

import numpy as np
import pytest

import cosyvoice2_eu_tpu.utils.native as jax_native
from cosyvoice2_eu_tpu.eval import baselines as JBL
from cosyvoice2_eu_tpu.eval import battery as JB
from cosyvoice2_eu_tpu.eval.run_eval import EvalSample as JSample
from cosyvoice2_eu_torch.eval import baselines as PBL
from cosyvoice2_eu_torch.eval import battery as PB
from cosyvoice2_eu_torch.eval.run_eval import EvalSample as PSample
from cosyvoice2_eu_torch.train import pitch as port_pitch


@pytest.fixture(autouse=True)
def _jax_yin_is_the_ports(monkeypatch):
    # the JAX native library sets flush-to-zero in its process; the port's
    # YIN equals it bit for bit (tests/test_torch_pitch.py)
    monkeypatch.setattr(jax_native, "yin_f0_native",
                        lambda wav, *a, **k: port_pitch.estimate_f0(
                            np.ascontiguousarray(wav, np.float32), *a, **k))


def _write_combined(path, language, models, hours_list, rng, wer_of):
    rows = []
    for model in models:
        for hours in hours_list:
            for i in range(4):
                rows.append({
                    "utt_id": f"u{i}", "speaker": "spk", "model": model,
                    "hours": hours, "language": language,
                    "wer": round(wer_of(model, hours) + rng.normal(0, 0.01), 4),
                    "mcd": round(8.0 + rng.normal(0, 0.2), 3),
                    "secs": round(0.25 + rng.normal(0, 0.01), 4),
                    "f0_corr": round(0.6 + rng.normal(0, 0.02), 3),
                    "vuv_error": round(40 + rng.normal(0, 1), 2),
                    "rtf": round(0.06 + rng.normal(0, 0.005), 4),
                })
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def _wer_of(model, hours):
    base = {"pretrained": 0.5, "llm_only": 0.3, "flow_only": 0.45,
            "full_finetuned": 0.25}.get(model, 0.35)
    return base - (0.0002 * hours if model == "full_finetuned" else 0)


def _results(d):
    os.makedirs(d)
    rng = np.random.default_rng(0)
    models = ["pretrained", "llm_only", "flow_only", "full_finetuned"]
    for lang in ("fr", "de"):
        _write_combined(os.path.join(d, f"combined_{lang}.csv"), lang, models, [50, 100, 250],
                        rng, _wer_of)
    _write_combined(os.path.join(d, "combined_fr_mix.csv"), "fr", ["full_finetuned"],
                    [50, 100, 250], rng, lambda m, h: _wer_of(m, h) - 0.02)
    return d


def _files(d):
    """Every file under ``d`` by relative path; ``d`` itself, which the
    manifest names, reads as <root>."""
    out = {}
    for sub, _, files in os.walk(d):
        for f in files:
            p = os.path.join(sub, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read().replace(d.encode(), b"<root>")
    return out


def _twin_dirs(tmp_path):
    port = _results(str(tmp_path / "port"))
    jax = str(tmp_path / "jax")
    shutil.copytree(port, jax)
    return port, jax


def _manifest_rel(manifest, root):
    return {k: (os.path.relpath(v, root) if k == "out_dir" else v) for k, v in manifest.items()}


def test_battery_writes_what_jax_writes(tmp_path):
    port, jax = _twin_dirs(tmp_path)
    got, want = PB.generate_battery(port), JB.generate_battery(jax)
    assert _manifest_rel(got, port) == _manifest_rel(want, jax)
    assert got["fr"]["anchor"]["winner"] == "full_finetuned"
    assert _files(port) == _files(jax)


@pytest.mark.parametrize("fn", ["rq1_component_ablation", "rq2_learning_curve",
                                "appendix_efficiency"])
def test_battery_sections_equal_jax(tmp_path, fn):
    port, jax = _twin_dirs(tmp_path)
    for mod, d in ((PB, port), (JB, jax)):
        data = mod.load_all_results(d, "fr")
        getattr(mod, fn)(data["mono"], "fr", os.path.join(d, "report"))
    assert _files(port) == _files(jax)


def test_battery_helpers_equal_jax():
    for cur, base, metric in [(0.08, 0.10, "wer"), (0.30, 0.25, "secs"), (0.2, 0.25, "mcd")]:
        assert PB.pct_impr(cur, base, metric) == JB.pct_impr(cur, base, metric)
        assert PB.fmt(cur, base, metric) == JB.fmt(cur, base, metric)
    assert np.isnan(PB.pct_impr(0.2, 0.0, "mcd")) and np.isnan(JB.pct_impr(0.2, 0.0, "mcd"))
    assert PB.PUBLISHED_BASELINES == JB.PUBLISHED_BASELINES
    assert PB.METRIC_DIRECTION == JB.METRIC_DIRECTION


def test_rq3_and_measured_baselines_equal_jax(tmp_path):
    port, jax = _twin_dirs(tmp_path)
    for d in (port, jax):
        with open(os.path.join(d, "baselines_fr.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["utt_id", "model", "wer", "mcd", "secs",
                                              "f0_corr", "vuv_error"])
            w.writeheader()
            for i in range(3):
                w.writerow({"utt_id": f"u{i}", "model": "baseline_fake", "wer": 0.3,
                            "mcd": 9.0, "secs": 0.2, "f0_corr": 0.5, "vuv_error": 45.0})
    for mod, d in ((PB, port), (JB, jax)):
        data = mod.load_all_results(d, "fr")
        mod.rq3_mix_vs_mono(data["mono"], data["mix"], "fr", os.path.join(d, "rq3"))
        mod.generate_battery(d)
    assert _files(port) == _files(jax)
    with open(os.path.join(port, "report", "tables", "B1_baselines-vs-best_fr.csv")) as f:
        assert "baseline_fake" in {r["system"] for r in csv.DictReader(f)}


def test_export_charts_to_docs_equal_jax(tmp_path):
    port, jax = _twin_dirs(tmp_path)
    got = PB.export_charts_to_docs(PB.generate_battery(port)["out_dir"],
                                   os.path.join(port, "docs"))
    want = JB.export_charts_to_docs(JB.generate_battery(jax)["out_dir"],
                                    os.path.join(jax, "docs"))
    assert got == want and got
    assert _files(port) == _files(jax)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def time(self):
        self.t += 0.5
        return self.t


def _samples(cls, d):
    rng = np.random.default_rng(1)
    out = []
    for i in range(2):
        wav_path = os.path.join(d, "spk", f"u{i}.wav")
        PBL._write_wav(wav_path, rng.normal(0, 0.1, 24000).astype(np.float32), 24000)
        out.append(cls(f"u{i}", "spk", wav_path, "hallo welt " * 3))
    return out


def test_fake_engine_runner_and_backfill_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(PBL, "time", _Clock())
    monkeypatch.setattr(JBL, "time", _Clock())
    port, jax = _twin_dirs(tmp_path)
    # one prompt tree for both: the fake engine seeds its audio on the path
    data = str(tmp_path / "data")
    got = PBL.BaselinesRunner(engine="fake", language="fr").run(_samples(PSample, data), port)
    want = JBL.BaselinesRunner(engine="fake", language="fr").run(_samples(JSample, data), jax)
    assert repr(got) == repr(want)  # NaN pitch metrics (white-noise prompts) compare as text
    assert all(r["model"] == "baseline_fake" for r in got)
    for d in (port, jax):  # wipe rtf, then backfill it from the audio tree
        path = os.path.join(d, "baselines_fr.csv")
        with open(path, newline="") as f:
            r = csv.DictReader(f)
            keys, rows = list(r.fieldnames), list(r)
        for row in rows:
            row["rtf"] = ""
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(rows)
    assert PBL.backfill_rtf(port, languages=("fr",)) == JBL.backfill_rtf(jax, languages=("fr",))
    PB.generate_battery(port)
    JB.generate_battery(jax)
    assert _files(port) == _files(jax)


def test_baselines_smoke_mode(tmp_path):
    assert PBL.test_baselines(str(tmp_path))["ok"]


def test_gated_engines_raise_as_in_jax(monkeypatch):
    monkeypatch.delenv("ELEVENLABS_API_KEY", raising=False)
    assert sorted(PBL.ENGINES) == sorted(JBL.ENGINES)
    for name in ("xtts_v2", "openvoice", "elevenlabs"):
        with pytest.raises(Exception) as got:
            PBL.ENGINES[name](language="fr")
        with pytest.raises(Exception) as want:
            JBL.ENGINES[name](language="fr")
        assert type(got.value) is type(want.value)


def test_openvoice_with_injected_backends_equals_jax(tmp_path):
    prompt = str(tmp_path / "spk.wav")
    PBL._write_wav(prompt, np.random.default_rng(0).normal(0, 0.1, 16000).astype(np.float32),
                   16000)

    def run(mod):
        calls = {"tts": [], "se": 0}

        def base_tts(text):
            calls["tts"].append(text)
            return np.random.default_rng(len(text)).normal(0, 0.1, 24000).astype(np.float32), 24000

        def extract_se(wav, sr):
            calls["se"] += 1
            return np.full((4,), float(np.abs(wav).mean()), np.float32)

        eng = mod.OpenVoiceEngine(language="fr", base_tts=base_tts, extract_se=extract_se,
                                  converter=lambda wav, sr, s, t: (wav * 0.5, sr))
        out = [eng.synthesize(t, prompt_wav=prompt) for t in ("bonjour", "deuxieme phrase")]
        return out, calls

    (got, calls_p), (want, calls_j) = run(PBL), run(JBL)
    assert calls_p == calls_j and calls_p["se"] == 2
    for (a, sr_a), (b, sr_b) in zip(got, want):
        assert sr_a == sr_b == 16000
        np.testing.assert_array_equal(a, b)
