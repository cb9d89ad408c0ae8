"""Baseline TTS systems: registry, synthesis runner, RTF backfill.

Re-expression of the reference's comparison layer
(reference: evaluation/baselines_synthesizer.py:33-787 — Coqui XTTS-v2,
OpenVoice, Fish-Speech, ElevenLabs wrappers behind one batch runner — and
evaluation/backfill_rtf_for_baselines.py:1-50).  The architecture —
engine registry, per-engine config, output audio tree, metrics CSV feeding
the B1 tables (eval/battery.py), RTF backfill from saved audio — is fully
testable with the built-in fake engine; the real engines are import/egress
gated since they need external GPU models or network APIs this environment
does not have.

    reg = ENGINES  # name -> factory(language, **cfg)
    runner = BaselinesRunner(engine="fake", language="fr")
    rows = runner.run(samples, out_dir)          # audio tree + baselines_fr.csv

Output layout (backfill_rtf_for_baselines.py assumptions):
    <out_dir>/baseline_<engine>_<lang>/<utt_id>.wav
    <out_dir>/baselines_<lang>.csv        rows: model=baseline_<engine>, ...

The PyTorch port's copy of ``cosyvoice2_eu_tpu/eval/baselines.py``: it imports
only the port, and gives the same outputs on the same inputs.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import time
import wave
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

class FakeEngine:
    """Deterministic offline engine for testing the wrapper architecture:
    emits prompt-seeded colored noise with duration proportional to text."""

    sample_rate = 24000

    def __init__(self, language: str = "fr", seconds_per_char: float = 0.06,
                 **_):
        self.language = language
        self.seconds_per_char = seconds_per_char

    def synthesize(self, text: str, prompt_wav: Optional[str] = None
                   ) -> Tuple[np.ndarray, int]:
        import hashlib

        n = max(int(len(text) * self.seconds_per_char * self.sample_rate), 1)
        # sha256, not hash(): Python string hashing is salted per process,
        # which would break the documented cross-run determinism
        digest = hashlib.sha256(f"{text}\x00{prompt_wav}".encode()).digest()
        seed = int.from_bytes(digest[:4], "little")
        rng = np.random.default_rng(seed)
        x = rng.normal(0, 0.1, n).astype(np.float32)
        # one-pole lowpass for a speech-ish spectrum
        y = np.empty_like(x)
        acc = 0.0
        for i in range(n):  # small n in tests; fine
            acc = 0.9 * acc + 0.1 * x[i]
            y[i] = acc
        return (y / (np.abs(y).max() + 1e-9) * 0.3).astype(np.float32), self.sample_rate


class XTTSv2Engine:
    """Coqui XTTS-v2 (reference CoquiTTSSynthesizer :33-115). Requires the
    `TTS` package + model download (external GPU weights; gated here)."""

    def __init__(self, language: str = "fr", device: str = "cpu", **_):
        try:
            from TTS.api import TTS  # type: ignore
        except ImportError as e:
            raise ImportError(
                "XTTS-v2 needs the coqui `TTS` package (not in this image); "
                "use engine='fake' for architecture tests"
            ) from e
        self.language = language
        self._tts = TTS("tts_models/multilingual/multi-dataset/xtts_v2").to(device)
        self.sample_rate = 24000

    def synthesize(self, text: str, prompt_wav: Optional[str] = None):
        wav = self._tts.tts(text=text, speaker_wav=prompt_wav,
                            language=self.language)
        return np.asarray(wav, np.float32), self.sample_rate


class ElevenLabsEngine:
    """ElevenLabs API (reference ElevenLabsSynthesizer :629-699). Requires
    network egress + ELEVENLABS_API_KEY; gated here."""

    sample_rate = 24000

    def __init__(self, language: str = "fr", voice_id: Optional[str] = None,
                 model: str = "eleven_multilingual_v2", **_):
        key = os.environ.get("ELEVENLABS_API_KEY")
        if not key:
            raise RuntimeError(
                "ElevenLabs needs ELEVENLABS_API_KEY and network egress; "
                "use engine='fake' for architecture tests"
            )
        self.key, self.voice_id, self.model = key, voice_id, model
        self.language = language

    def synthesize(self, text: str, prompt_wav: Optional[str] = None):
        import urllib.request

        url = (f"https://api.elevenlabs.io/v1/text-to-speech/"
               f"{self.voice_id}?output_format=pcm_24000")
        body = json.dumps({"text": text, "model_id": self.model}).encode()
        req = urllib.request.Request(
            url, data=body,
            headers={"xi-api-key": self.key, "Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            pcm = resp.read()
        wav = np.frombuffer(pcm, np.int16).astype(np.float32) / 32768.0
        return wav, self.sample_rate


class FishSpeechEngine:
    """Fish-Speech HTTP server (reference FishSpeechSynthesizer :299-440).
    Requires a running server at `base_url`; gated here."""

    sample_rate = 44100

    def __init__(self, language: str = "fr",
                 base_url: str = "http://localhost:8080", **_):
        self.base_url = base_url
        self.language = language
        import urllib.request

        try:
            urllib.request.urlopen(base_url + "/v1/health", timeout=2)
        except Exception as e:
            raise RuntimeError(
                f"Fish-Speech server not reachable at {base_url}; "
                "use engine='fake' for architecture tests"
            ) from e

    def synthesize(self, text: str, prompt_wav: Optional[str] = None):
        import urllib.request

        body = {"text": text, "format": "wav"}
        if prompt_wav:
            import base64

            with open(prompt_wav, "rb") as f:
                body["references"] = [
                    {"audio": base64.b64encode(f.read()).decode(), "text": ""}
                ]
        req = urllib.request.Request(
            self.base_url + "/v1/tts", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as resp:
            payload = resp.read()
        import io

        with wave.open(io.BytesIO(payload)) as w:
            sr = w.getframerate()
            pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        return pcm.astype(np.float32) / 32768.0, sr


_OPENVOICE_PROMPT_PREFIX = {
    "fr": "Speak in French:",
    "de": "Sprich auf Deutsch:",
    "en": "Speak in English:",
}


class OpenVoiceEngine:
    """OpenVoice v2 tone-color cloning baseline: a base TTS voices the text,
    then a ToneColorConverter re-timbres it to the reference speaker
    (reference OpenVoiceSynthesizer, evaluation/baselines_synthesizer.py:118-296:
    Gemini TTS base speech + openvoice ToneColorConverter + se_extractor).

    The three stages are injectable (``base_tts`` / ``converter`` /
    ``extract_se``) so the pipeline logic — source-embedding bootstrap from a
    long base utterance, per-prompt target-embedding cache, convert, 16 kHz
    output — is offline-testable like the other wrappers; with no injection
    the real backends load lazily (openvoice package + GOOGLE_API_KEY, both
    absent from this image)."""

    sample_rate = 16000  # reference resamples converted audio to 16 kHz

    def __init__(self, language: str = "fr", ckpt_converter: Optional[str] = None,
                 device: str = "cpu", base_voice: str = "Kore",
                 gemini_model: str = "gemini-2.5-flash-preview-tts",
                 base_tts: Optional[Callable] = None,
                 converter: Optional[Callable] = None,
                 extract_se: Optional[Callable] = None, **_):
        self.language = language
        self._target_se_cache: Dict[str, np.ndarray] = {}
        if base_tts is None or converter is None or extract_se is None:
            base_tts, converter, extract_se = self._load_real(
                ckpt_converter, device, base_voice, gemini_model
            )
        self.base_tts = base_tts  # text -> (wav float32, sr)
        self.converter = converter  # (wav, sr, src_se, tgt_se) -> (wav, sr)
        self.extract_se = extract_se  # (wav, sr) -> (256,) embedding
        # source tone color from one long base utterance (reference :208-219)
        base_text = _OPENVOICE_PROMPT_PREFIX.get(language, "Speak:") + (
            " Bonjour et bienvenue. Ecoutez attentivement chaque mot et "
            "chaque intonation; la clarte et le rythme sont tres importants."
        )
        wav, sr = self.base_tts(base_text)
        self.source_se = self.extract_se(wav, sr)

    def _load_real(self, ckpt_converter, device, base_voice, gemini_model):
        try:
            from openvoice import se_extractor  # type: ignore
            from openvoice.api import ToneColorConverter  # type: ignore
        except ImportError as e:
            raise ImportError(
                "OpenVoice package not in this image; pass base_tts/converter/"
                "extract_se callables or use engine='fake' for architecture "
                "tests"
            ) from e
        ckpt = ckpt_converter or os.environ.get("OPENVOICE_CKPT")
        if not ckpt:
            raise ValueError(
                "OpenVoice checkpoint path not provided "
                "(ckpt_converter or OPENVOICE_CKPT env)")
        ckpt = ckpt.rstrip("/")
        tcc = ToneColorConverter(f"{ckpt}/config.json", device=device)
        tcc.load_ckpt(f"{ckpt}/checkpoint.pth")

        def base_tts(text):
            return _gemini_tts(text, gemini_model, base_voice)

        def extract_se(wav, sr):
            import tempfile

            with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
                _write_wav(f.name, wav, sr)
                path = f.name
            try:
                se, _ = se_extractor.get_se(path, tcc, vad=True)
                return np.asarray(se)
            finally:
                os.unlink(path)

        def convert(wav, sr, src_se, tgt_se):
            import tempfile

            src = tempfile.NamedTemporaryFile(suffix=".wav", delete=False).name
            dst = src + ".converted.wav"
            try:
                _write_wav(src, wav, sr)
                tcc.convert(audio_src_path=src, src_se=src_se, tgt_se=tgt_se,
                            output_path=dst, message="@OpenVoiceBaseline")
                return _read_wav(dst)
            finally:
                for p in (src, dst):
                    try:
                        os.unlink(p)
                    except OSError:
                        pass

        return base_tts, convert, extract_se

    def _target_se(self, prompt_wav: str) -> np.ndarray:
        se = self._target_se_cache.get(prompt_wav)
        if se is None:
            wav, sr = _read_wav(prompt_wav)
            se = self.extract_se(wav, sr)
            self._target_se_cache[prompt_wav] = se
        return se

    def synthesize(self, text: str, prompt_wav: Optional[str] = None
                   ) -> Tuple[np.ndarray, int]:
        prefix = _OPENVOICE_PROMPT_PREFIX.get(self.language, "Speak:")
        base, sr = self.base_tts(f"{prefix}\n{text}")
        tgt_se = self._target_se(prompt_wav) if prompt_wav else self.source_se
        out, out_sr = self.converter(base, sr, self.source_se, tgt_se)
        out = np.asarray(out, np.float32)
        if out_sr != self.sample_rate:  # metrics consistency (reference :276)
            from cosyvoice2_eu_torch.frontend.frontend import resample as _rs

            out = _rs(out, out_sr, self.sample_rate)
        return out, self.sample_rate


def _gemini_tts(text: str, model: str, voice: str) -> Tuple[np.ndarray, int]:
    """Gemini TTS base speaker (reference _generate_base_speech :228-252);
    returns 24 kHz float32 mono.  Needs google-genai + GOOGLE_API_KEY."""
    try:
        from google import genai  # type: ignore
        from google.genai import types  # type: ignore
    except ImportError as e:
        raise ImportError("google-genai package not installed") from e
    if "GOOGLE_API_KEY" not in os.environ:
        raise EnvironmentError("GOOGLE_API_KEY not set")
    client = genai.Client()
    response = client.models.generate_content(
        model=model,
        contents=text,
        config=types.GenerateContentConfig(
            response_modalities=["AUDIO"],
            speech_config=types.SpeechConfig(
                voice_config=types.VoiceConfig(
                    prebuilt_voice_config=types.PrebuiltVoiceConfig(
                        voice_name=voice)
                )
            ),
        ),
    )
    data = response.candidates[0].content.parts[0].inline_data.data
    pcm = np.frombuffer(data, np.int16).astype(np.float32) / 32768.0
    return pcm, 24000


def _read_wav(path: str) -> Tuple[np.ndarray, int]:
    with wave.open(path) as w:
        sr = w.getframerate()
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    return pcm.astype(np.float32) / 32768.0, sr


ENGINES: Dict[str, Callable] = {
    "fake": FakeEngine,
    "xtts_v2": XTTSv2Engine,
    "elevenlabs": ElevenLabsEngine,
    "fish_speech": FishSpeechEngine,
    "openvoice": OpenVoiceEngine,
}


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

def _write_wav(path: str, wav: np.ndarray, sr: int):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pcm = (np.clip(wav, -1, 1) * 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


class BaselinesRunner:
    """Synthesize an eval set with one baseline engine; write the audio tree
    + metrics rows shaped for B1 (eval/battery.py)."""

    def __init__(self, engine: str = "fake", language: str = "fr",
                 engine_cfg: Optional[dict] = None, embed_fn=None, asr_fn=None):
        factory = ENGINES[engine]
        self.name = engine
        self.language = language
        self.engine = factory(language=language, **(engine_cfg or {}))
        self.embed_fn = embed_fn
        self.asr_fn = asr_fn

    def run(self, samples, out_dir: str) -> List[dict]:
        """samples: eval samples (run_eval.EvalSample-like: utt_id, speaker,
        wav_path, text).  Returns metric rows; writes audio + CSV."""
        from cosyvoice2_eu_torch.eval.run_eval import metrics_for_pair
        from cosyvoice2_eu_torch.frontend.frontend import load_wav

        audio_dir = os.path.join(out_dir, f"baseline_{self.name}_{self.language}")
        rows = []
        by_speaker: Dict[str, list] = {}
        for s in samples:
            by_speaker.setdefault(s.speaker, []).append(s)
        for s in samples:
            pool = [p for p in by_speaker[s.speaker] if p.utt_id != s.utt_id] or [s]
            t0 = time.time()
            try:
                wav, sr = self.engine.synthesize(s.text, pool[0].wav_path)
                synth_s = time.time() - t0
            except Exception as e:
                logger.exception("baseline %s failed on %s", self.name, s.utt_id)
                rows.append({"utt_id": s.utt_id, "model": f"baseline_{self.name}",
                             "language": self.language, "error": str(e)})
                continue
            _write_wav(os.path.join(audio_dir, f"{s.utt_id}.wav"), wav, sr)
            ref = load_wav(s.wav_path, sr)
            row = {"utt_id": s.utt_id, "speaker": s.speaker,
                   "model": f"baseline_{self.name}", "language": self.language}
            row.update(
                metrics_for_pair(ref, wav, sr, synth_s, embed_fn=self.embed_fn,
                                 asr_fn=self.asr_fn, lang=self.language,
                                 text=s.text)
            )
            rows.append(row)
        _append_csv(os.path.join(out_dir, f"baselines_{self.language}.csv"), rows)
        return rows


def _append_csv(path: str, rows: List[dict]):
    if not rows:
        return
    keys: List[str] = []
    existing: List[dict] = []
    if os.path.exists(path):
        with open(path, newline="") as f:
            r = csv.DictReader(f)
            keys = list(r.fieldnames or [])
            existing = list(r)
    for row in rows:
        for k in row:
            if k not in keys:
                keys.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(existing + rows)


# ---------------------------------------------------------------------------
# RTF backfill (backfill_rtf_for_baselines.py:1-50)
# ---------------------------------------------------------------------------

def wav_duration_s(path: str) -> float:
    with wave.open(path) as w:
        return w.getnframes() / float(w.getframerate())


def backfill_rtf(results_dir: str, synth_dir: Optional[str] = None,
                 languages: Tuple[str, ...] = ("fr", "de")) -> dict:
    """Fill missing/NaN rtf cells in baselines CSVs from the saved audio:
    rtf = synthesis_time / wav_duration.  Returns per-language fill counts."""
    synth_dir = synth_dir or results_dir
    filled = {}
    for lang in languages:
        path = os.path.join(results_dir, f"baselines_{lang}.csv")
        if not os.path.exists(path):
            continue
        with open(path, newline="") as f:
            r = csv.DictReader(f)
            keys = list(r.fieldnames or [])
            rows = list(r)
        n = 0
        for row in rows:
            rtf = row.get("rtf", "")
            try:
                has_rtf = np.isfinite(float(rtf))
            except (TypeError, ValueError):
                has_rtf = False
            if has_rtf:
                continue
            model = str(row.get("model", "")).replace("baseline_", "")
            wav_path = os.path.join(
                synth_dir, f"baseline_{model}_{lang}", f"{row.get('utt_id')}.wav"
            )
            synth_s = row.get("synthesis_time", "")
            try:
                synth_s = float(synth_s)
            except (TypeError, ValueError):
                continue
            if not os.path.exists(wav_path):
                continue
            dur = wav_duration_s(wav_path)
            if dur > 0:
                row["rtf"] = round(synth_s / dur, 4)
                n += 1
        if "rtf" not in keys:
            keys.append("rtf")
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(rows)
        filled[lang] = n
    return filled


# ---------------------------------------------------------------------------
# smoke mode (the pipeline's --test-baselines)
# ---------------------------------------------------------------------------

def test_baselines(tmp_dir: Optional[str] = None) -> dict:
    """Architecture smoke with the fake engine: synthesize a 3-sample set,
    check the audio tree + CSV + backfill round trip."""
    import tempfile

    from cosyvoice2_eu_torch.eval.run_eval import EvalSample

    td = tmp_dir or tempfile.mkdtemp(prefix="baselines_smoke_")
    data_dir = os.path.join(td, "data")
    out_dir = os.path.join(td, "out")
    rng = np.random.default_rng(0)
    samples = []
    for i in range(3):
        wav_path = os.path.join(data_dir, "spk", f"u{i}.wav")
        _write_wav(wav_path, rng.normal(0, 0.1, 24000).astype(np.float32), 24000)
        samples.append(EvalSample(f"u{i}", "spk", wav_path, "bonjour le monde " * 3))

    runner = BaselinesRunner(engine="fake", language="fr")
    rows = runner.run(samples, out_dir)
    csv_path = os.path.join(out_dir, "baselines_fr.csv")
    n_audio = len(os.listdir(os.path.join(out_dir, "baseline_fake_fr")))

    # wipe rtf then backfill it from the audio tree
    with open(csv_path, newline="") as f:
        r = csv.DictReader(f)
        keys, rws = list(r.fieldnames), list(r)
    for row in rws:
        row["rtf"] = ""
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rws)
    filled = backfill_rtf(out_dir, languages=("fr",))

    ok = (
        len(rows) == 3
        and all("error" not in r for r in rows)
        and n_audio == 3
        and filled.get("fr") == 3
    )
    out = {"ok": bool(ok), "rows": len(rows), "audio_files": n_audio,
           "rtf_backfilled": filled}
    print(out)
    return out


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--engine", default="fake", choices=sorted(ENGINES))
    p.add_argument("--dataset", default=None)
    p.add_argument("--out", default="eval_results")
    p.add_argument("--language", default="fr")
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--backfill-rtf", action="store_true")
    p.add_argument("--test-baselines", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.test_baselines:
        return 0 if test_baselines()["ok"] else 1
    if args.backfill_rtf:
        print(json.dumps(backfill_rtf(args.out, languages=(args.language,))))
        return 0
    from cosyvoice2_eu_torch.eval.run_eval import read_dataset

    samples = read_dataset(args.dataset, args.max_samples)
    runner = BaselinesRunner(engine=args.engine, language=args.language)
    rows = runner.run(samples, args.out)
    ok = [r for r in rows if "error" not in r]
    print(json.dumps({"engine": args.engine, "n": len(rows),
                      "n_failed": len(rows) - len(ok)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
