"""Evaluation pipeline: synthesize a test set, compute metrics, report.

Re-expression of the reference EvaluationPipeline
(reference: evaluation/run_evaluation_pipeline.py:41-842): walks a dataset
tree ``split/speaker/audio_id/*.wav + *.normalized.txt``
(evaluation/dataset_reader.py:17), synthesizes each utterance with a prompt
from the same speaker, computes RTF + MCD/LSD + pitch metrics (+SECS/WER when
an x-vector / ASR hook is supplied), and writes per-model CSV + a markdown
summary.  Run-id auto-resolution ``{hours}-averaged-{bb}-{LANG|mix}`` follows
run_evaluation_pipeline.py:93-108.

The PyTorch port's copy of ``cosyvoice2_eu_tpu/eval/run_eval.py``: it imports
only the port, and gives the same outputs on the same inputs.
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from cosyvoice2_eu_torch.eval import metrics as M


@dataclass
class EvalSample:
    utt_id: str
    speaker: str
    wav_path: str
    text: str


def read_dataset(root: str, max_samples: Optional[int] = None) -> List[EvalSample]:
    """split/speaker/audio_id/*.wav with sibling *.normalized.txt."""
    samples = []
    for speaker in sorted(os.listdir(root)):
        spk_dir = os.path.join(root, speaker)
        if not os.path.isdir(spk_dir):
            continue
        for sub, _, files in os.walk(spk_dir):
            for f in sorted(files):
                if not f.endswith(".wav"):
                    continue
                stem = f[: -len(".wav")]
                txt = os.path.join(sub, stem + ".normalized.txt")
                if not os.path.exists(txt):
                    txt = os.path.join(sub, stem + ".txt")
                    if not os.path.exists(txt):
                        continue
                with open(txt) as fh:
                    text = fh.read().strip()
                samples.append(EvalSample(stem, speaker, os.path.join(sub, f), text))
    if max_samples:
        samples = samples[:max_samples]
    return samples


def resolve_run_id(hours: int, backbone: str, language: str, mixed: bool) -> str:
    lang = "mix" if mixed else language.upper()
    return f"{hours}-averaged-{backbone}-{lang}"


def metrics_for_pair(
    ref: np.ndarray,
    wav: np.ndarray,
    sr: int,
    synth_s: float,
    embed_fn=None,
    asr_fn=None,
    lang: str = "fr",
    text: str = "",
) -> dict:
    """All objective metrics for one (reference, generated) pair.

    mcd is the TRUE dB metric (WORLD-class envelope + warped cepstra,
    eval/metrics.py:mcd) — directly comparable with BASELINE.md; mcd_rel is
    the cheap DCT-mel relative variant for within-run A/B deltas."""
    dur = len(wav) / sr
    row = {
        "audio_duration": round(dur, 3),
        "synthesis_time": round(synth_s, 3),
        "rtf": round(synth_s / max(dur, 1e-6), 4),
        "mcd": round(M.mcd(ref, wav, sr), 3),
        "mcd_rel": round(M.mcd_rel(ref, wav, sr), 3),
        "lsd": round(M.log_spectral_distance(ref, wav, sr), 3),
    }
    pm = M.pitch_metrics(ref, wav, sr)
    row.update(
        gpe=round(pm.gpe, 2), f0_rmse=round(pm.f0_rmse, 2),
        f0_corr=round(pm.f0_corr, 3), vuv_error=round(pm.vuv_error, 2),
    )
    if embed_fn is not None:
        from cosyvoice2_eu_torch.frontend.frontend import resample

        row["secs"] = round(
            M.secs(resample(ref, sr, 16000), resample(wav, sr, 16000), embed_fn), 4
        )
    if asr_fn is not None:
        hyp = asr_fn(wav, sr)
        row["wer"] = round(
            M.wer(M.normalize_text_for_wer(text, lang), M.normalize_text_for_wer(hyp, lang)), 4
        )
    return row


def evaluate_model(
    synthesize: Callable[[str, str], tuple[np.ndarray, float]],
    samples: List[EvalSample],
    out_dir: str,
    model_name: str,
    sr: int = 24000,
    embed_fn=None,
    asr_fn=None,
    lang: str = "fr",
) -> dict:
    """synthesize(text, prompt_wav_path) -> (wav float32, synth_seconds)."""
    from cosyvoice2_eu_torch.frontend.frontend import load_wav

    os.makedirs(out_dir, exist_ok=True)
    rows = []
    by_speaker: dict[str, List[EvalSample]] = {}
    for s in samples:
        by_speaker.setdefault(s.speaker, []).append(s)

    for s in samples:
        # prompt: another utterance of the same speaker (cross-speaker bias
        # guard, run_evaluation_pipeline.py prompt selection)
        pool = [p for p in by_speaker[s.speaker] if p.utt_id != s.utt_id] or [s]
        prompt = pool[0]
        try:
            wav, synth_s = synthesize(s.text, prompt.wav_path)
        except Exception as e:  # failure rows with NaN metrics (:209-224)
            logging.exception("synthesis failed for %s", s.utt_id)
            rows.append({"utt_id": s.utt_id, "speaker": s.speaker, "error": str(e)})
            continue
        ref = load_wav(s.wav_path, sr)
        row = {"utt_id": s.utt_id, "speaker": s.speaker}
        row.update(
            metrics_for_pair(ref, wav, sr, synth_s, embed_fn=embed_fn,
                             asr_fn=asr_fn, lang=lang, text=s.text)
        )
        rows.append(row)

    csv_path = os.path.join(out_dir, f"{model_name}_results.csv")
    keys = sorted({k for r in rows for k in r})
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=keys)
        writer.writeheader()
        writer.writerows(rows)

    ok = [r for r in rows if "error" not in r]
    summary = {"model": model_name, "n": len(rows), "n_failed": len(rows) - len(ok)}
    for k in ("rtf", "mcd", "mcd_rel", "lsd", "gpe", "f0_rmse", "f0_corr", "vuv_error", "secs", "wer"):
        vals = [r[k] for r in ok if k in r and np.isfinite(r[k])]
        if vals:
            summary[k] = round(float(np.mean(vals)), 4)
    with open(os.path.join(out_dir, f"{model_name}_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    _write_markdown(out_dir, model_name, summary)
    return summary


def _write_markdown(out_dir: str, model_name: str, summary: dict) -> None:
    lines = [f"# Evaluation report — {model_name}", ""]
    lines.append("| metric | value |")
    lines.append("|---|---|")
    for k, v in summary.items():
        if k != "model":
            lines.append(f"| {k} | {v} |")
    with open(os.path.join(out_dir, f"{model_name}_report.md"), "w") as f:
        f.write("\n".join(lines) + "\n")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True, help="split dir: speaker/*/wav+txt")
    parser.add_argument("--model-dir", default=None)
    parser.add_argument("--out", default="eval_results")
    parser.add_argument("--language", default="fr")
    parser.add_argument("--max-samples", type=int, default=None)
    parser.add_argument("--stream", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import cosyvoice2_eu_torch as cosy

    model = cosy.load(model_dir=args.model_dir, device=args.device)

    def synthesize(text, prompt_path):
        t0 = time.time()
        wav, _ = model.tts(text, prompt_path)
        return wav[0], time.time() - t0

    samples = read_dataset(args.dataset, args.max_samples)
    logging.info("evaluating %d samples", len(samples))
    # SECS through the model dir's CAM++ (campplus.onnx, converted by load)
    summary = evaluate_model(
        synthesize, samples, args.out, f"cosyvoice2_eu_torch_{args.language}",
        sr=model.sample_rate, embed_fn=model._frontend.spk_embedding_fn, lang=args.language,
    )
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
