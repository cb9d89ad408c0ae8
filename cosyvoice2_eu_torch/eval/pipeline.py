"""Evaluation pipeline: hours x setting x backbone experiment matrix.

Re-expression of the reference EvaluationPipeline
(reference: evaluation/run_evaluation_pipeline.py:41-842):

  * model matrix of 8 component settings (eval_config.yaml:97-139), each
    resolved per training-hours with automatic run ids
    ``{hours}-averaged-{bb}-{LANG|mix}`` (:93-108),
  * per-(hours x model) synthesis (warmup, prompt caching, per-sample
    timeout, optional ``<|fr|>`` language hint) + objective metrics,
  * per-model CSVs, a combined CSV, component/duration analysis CSVs, and a
    markdown report (:444-624),
  * ``--test-dataset / --test-synthesis / --test-metrics`` smoke modes
    (:766-820).

SECS runs whenever a CAM++ x-vector model is available (converted from
campplus.onnx in the model dir, or an ``embed_fn`` passed in); WER runs when
an ASR hook is supplied — any callable ``asr_fn(wav, sr) -> text`` works
(e.g. host-side whisper), configured as ``asr_hook: "module:function"``.

The PyTorch port's copy of ``cosyvoice2_eu_tpu/eval/pipeline.py``: it imports
only the port, and gives the same outputs on the same inputs.
"""

from __future__ import annotations

import argparse
import csv
import functools
import json
import logging
import os
from typing import Callable, List, Optional

import numpy as np

from cosyvoice2_eu_torch.eval import metrics as M
from cosyvoice2_eu_torch.eval.run_eval import (
    EvalSample,
    metrics_for_pair,
    read_dataset,
)
from cosyvoice2_eu_torch.eval.synthesizer import Synthesizer

logger = logging.getLogger(__name__)

# the reference's component-ablation matrix (eval_config.yaml:97-139)
DEFAULT_MODELS = {
    "pretrained": {"setting": "original"},
    "llm_only": {"setting": "llm"},
    "flow_only": {"setting": "flow"},
    "hifigan_only": {"setting": "hifigan", "hifigan_run_id": "original-real"},
    "llm_flow": {"setting": "llm_flow"},
    "llm_hifigan": {"setting": "llm_hifigan", "hifigan_run_id": "original-real"},
    "flow_hifigan": {"setting": "flow_hifigan", "hifigan_run_id": "original-real"},
    "full_finetuned": {"setting": "llm_flow_hifigan", "hifigan_run_id": "original-real"},
}

METRIC_KEYS = ("rtf", "mcd", "mcd_rel", "lsd", "gpe", "f0_rmse", "f0_corr", "vuv_error", "secs", "wer")


def load_config(path: Optional[str]) -> dict:
    if path is None:
        return {}
    with open(path) as f:
        if path.endswith(".json"):
            return json.load(f)
        import yaml

        return yaml.safe_load(f)


def _import_hook(spec: Optional[str], device: Optional[str] = None) -> Optional[Callable]:
    """'pkg.mod:fn' -> callable (the pluggable ASR/embedding hook surface);
    a hook with a ``device`` parameter gets ``device`` bound."""
    if not spec:
        return None
    import importlib
    import inspect

    mod, _, fn = spec.partition(":")
    hook = getattr(importlib.import_module(mod), fn or "main")
    if device is not None and "device" in inspect.signature(hook).parameters:
        hook = functools.partial(hook, device=device)
    return hook


class EvaluationPipeline:
    def __init__(
        self,
        config: Optional[dict] = None,
        language: Optional[str] = None,
        hours: Optional[List[int]] = None,
        use_mixed_model: bool = False,
        add_language_hint: bool = False,
        model_factory: Optional[Callable[[dict], Synthesizer]] = None,
        embed_fn: Optional[Callable] = None,
        asr_fn: Optional[Callable] = None,
    ):
        """model_factory(resolved_model_cfg) -> Synthesizer; the default
        builds cosy.load from model_dir/setting/run ids.  Tests inject a tiny
        random-model factory."""
        self.config = dict(config or {})
        self.language = (language or self.config.get("language", "fr")).lower()
        self.hours = hours or list(self.config.get("hours", [1500]))
        self.use_mixed_model = use_mixed_model or self.config.get("use_mixed_model", False)
        self.add_language_hint = add_language_hint or self.config.get("add_language_hint", False)
        self.models = self.config.get("models", DEFAULT_MODELS)
        self.backbone = self.config.get("backbone", "bl")
        self.out_dir = self.config.get("results_dir", "eval_results")
        self.timeout_s = float(self.config.get("timeout_s", 45.0))
        self.max_samples = self.config.get("max_samples")
        self.device = self.config.get("device", "cuda")
        self.model_factory = model_factory or self._default_factory
        self.embed_fn = embed_fn or _import_hook(self.config.get("embed_hook"), self.device)
        self.asr_fn = asr_fn or _import_hook(self.config.get("asr_hook"), self.device)

    # -- resolution (run_evaluation_pipeline.py:93-108) ----------------------

    def resolve_model_config(self, name: str, model_cfg: dict, hours: int) -> dict:
        cfg = dict(model_cfg)
        cfg.setdefault("model_dir", self.config.get("model_dir"))
        cfg["backbone"] = cfg.get("backbone", self.backbone)
        lang_code = "mix" if self.use_mixed_model else self.language.upper()
        hours_for_id = hours * 2 if lang_code == "mix" else hours
        if cfg.get("setting", "") != "original":
            run_id = f"{hours_for_id}-averaged-{cfg['backbone']}-{lang_code}"
            cfg.setdefault("llm_run_id", run_id)
            cfg.setdefault("flow_run_id", run_id)
        cfg["name"] = name
        cfg["hours"] = hours
        return cfg

    def _default_factory(self, cfg: dict) -> Synthesizer:
        load_kwargs = {
            "model_dir": cfg.get("model_dir"),
            "setting": cfg.get("setting", "llm_flow_hifigan"),
            "llm_run_id": cfg.get("llm_run_id"),
            "flow_run_id": cfg.get("flow_run_id"),
            "hifigan_run_id": cfg.get("hifigan_run_id"),
            "final": cfg.get("final", False),
            "device": cfg.get("device", self.device),
        }
        return Synthesizer(
            load_kwargs=load_kwargs,
            language=self.language,
            add_language_hint=self.add_language_hint,
            timeout_s=self.timeout_s,
        )

    # -- per-model evaluation -------------------------------------------------

    def evaluate_one(self, syn: Synthesizer, samples: List[EvalSample],
                     model_name: str, hours: int) -> List[dict]:
        sr = syn.sample_rate
        by_speaker: dict[str, List[EvalSample]] = {}
        for s in samples:
            by_speaker.setdefault(s.speaker, []).append(s)

        items = []
        for s in samples:
            pool = [p for p in by_speaker[s.speaker] if p.utt_id != s.utt_id] or [s]
            items.append((s.utt_id, s.text, pool[0].wav_path))
        synth_rows = syn.synthesize_batch(items)

        from cosyvoice2_eu_torch.frontend.frontend import load_wav

        rows = []
        for s, sr_row in zip(samples, synth_rows):
            row = {
                "utt_id": s.utt_id, "speaker": s.speaker,
                "model": model_name, "hours": hours, "language": self.language,
            }
            if "error" in sr_row:
                row["error"] = sr_row["error"]
            else:
                ref = load_wav(s.wav_path, sr)
                row.update(
                    metrics_for_pair(
                        ref, sr_row["wav"], sr, sr_row["synthesis_time"],
                        embed_fn=self.embed_fn, asr_fn=self.asr_fn,
                        lang=self.language, text=s.text,
                    )
                )
            rows.append(row)
        return rows

    # -- full matrix ----------------------------------------------------------

    def run(self, dataset_root: str) -> dict:
        os.makedirs(self.out_dir, exist_ok=True)
        samples = read_dataset(dataset_root, self.max_samples)
        logger.info("loaded %d samples from %s", len(samples), dataset_root)
        all_rows: List[dict] = []
        for hours in self.hours:
            for name, mc in self.models.items():
                cfg = self.resolve_model_config(name, mc, hours)
                logger.info("evaluating %s @ %sh (%s)", name, hours, cfg.get("llm_run_id"))
                try:
                    syn = self.model_factory(cfg)
                except Exception as e:
                    logger.exception("model %s @ %sh failed to load", name, hours)
                    all_rows.append(
                        {"model": name, "hours": hours, "language": self.language,
                         "error": f"load failed: {e}"}
                    )
                    continue
                if self.embed_fn is None:
                    # SECS via the CAM++ x-vector converted from
                    # campplus.onnx by load() (frontend.spk_embedding_fn)
                    self.embed_fn = getattr(
                        getattr(syn.model, "_frontend", None), "spk_embedding_fn", None
                    )
                rows = self.evaluate_one(syn, samples, name, hours)
                _write_csv(
                    os.path.join(self.out_dir, f"{name}_{hours}h_{self.language}.csv"),
                    rows,
                )
                all_rows.extend(rows)
        # mixed-model runs land in a _mix-suffixed matrix so the reporting
        # battery (eval/battery.py rq3) can pair them with the mono run
        suffix = "_mix" if self.use_mixed_model else ""
        _write_csv(
            os.path.join(self.out_dir, f"combined_{self.language}{suffix}.csv"),
            all_rows,
        )
        component = self.component_analysis(all_rows)
        duration = self.duration_analysis(all_rows)
        _write_csv(os.path.join(self.out_dir, "component_analysis.csv"), component)
        _write_csv(os.path.join(self.out_dir, "duration_analysis.csv"), duration)
        self._markdown_report(component, duration)
        return {"rows": all_rows, "component": component, "duration": duration}

    # -- analyses (run_evaluation_pipeline.py:471-560) ------------------------

    @staticmethod
    def _agg(rows: List[dict], keys=METRIC_KEYS) -> dict:
        ok = [r for r in rows if "error" not in r]
        out = {
            "total_samples": len(rows),
            "success_rate": round(len(ok) / max(len(rows), 1), 4),
        }
        for k in keys:
            vals = [r[k] for r in ok if k in r and np.isfinite(r[k])]
            if vals:
                out[f"{k}_mean"] = round(float(np.mean(vals)), 4)
                out[f"{k}_std"] = round(float(np.std(vals)), 4)
        return out

    def component_analysis(self, rows: List[dict]) -> List[dict]:
        """Per-(model, language) stats across all hours."""
        out = []
        for model in sorted({r["model"] for r in rows}):
            sub = [r for r in rows if r["model"] == model]
            out.append(dict({"model": model, "language": self.language}, **self._agg(sub)))
        return out

    def duration_analysis(self, rows: List[dict]) -> List[dict]:
        """full_finetuned metrics vs training hours (the learning curve)."""
        sub_all = [r for r in rows if r["model"] == "full_finetuned"]
        out = []
        for hours in sorted({r["hours"] for r in sub_all}):
            sub = [r for r in sub_all if r["hours"] == hours]
            out.append(dict({"hours": hours, "language": self.language}, **self._agg(sub)))
        return out

    def _markdown_report(self, component: List[dict], duration: List[dict]) -> None:
        lines = [f"# Evaluation report — {self.language.upper()}", ""]
        lines.append("mcd is true mel-cepstral distortion in dB (WORLD-class "
                     "envelope + warped cepstra c1-c12, eval/metrics.py:mcd) — "
                     "comparable with published MCD numbers; mcd_rel is the "
                     "cheap DCT-mel relative variant.")
        for title, table in (("Component analysis", component),
                             ("Training-duration analysis", duration)):
            if not table:
                continue
            lines += ["", f"## {title}", ""]
            keys = list(table[0].keys())
            lines.append("| " + " | ".join(keys) + " |")
            lines.append("|" + "---|" * len(keys))
            for row in table:
                lines.append("| " + " | ".join(str(row.get(k, "")) for k in keys) + " |")
        with open(os.path.join(self.out_dir, "evaluation_report.md"), "w") as f:
            f.write("\n".join(lines) + "\n")


def _write_csv(path: str, rows: List[dict]) -> None:
    keys: List[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)


def main(argv=None):
    p = argparse.ArgumentParser(description="CosyVoice2-EU evaluation pipeline (PyTorch port)")
    p.add_argument("--config", default=None, help="yaml/json evaluation config")
    p.add_argument("--dataset", default=None, help="split dir: speaker/*/wav+txt")
    p.add_argument("--language", "--lang", dest="language", default=None)
    p.add_argument("--hours", default=None, help="comma list, e.g. 50,100,250")
    p.add_argument("--use-mixed-model", action="store_true")
    p.add_argument("--add-language-hint", action="store_true")
    p.add_argument("--test-dataset", action="store_true")
    p.add_argument("--test-synthesis", action="store_true")
    p.add_argument("--test-metrics", action="store_true")
    p.add_argument("--test-baselines", action="store_true")
    p.add_argument("--device", default=None,
                   help="cuda or cpu, for the models and the ASR hook (default: the config's, "
                        "else cuda)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.test_metrics:
        return 0 if M.test_metrics()["ok"] else 1
    if args.test_baselines:
        from cosyvoice2_eu_torch.eval.baselines import test_baselines

        return 0 if test_baselines()["ok"] else 1
    if args.test_synthesis:
        from cosyvoice2_eu_torch.eval.synthesizer import test_synthesizer

        return 0 if test_synthesizer(device=args.device or "cuda")["ok"] else 1
    if args.test_dataset:
        cfg = load_config(args.config)
        root = args.dataset or cfg.get("dataset_root")
        samples = read_dataset(root, max_samples=5)
        print(f"Found {len(samples)} samples")
        for s in samples[:3]:
            print(f"  {s.utt_id}: {s.text[:50]}...")
        return 0

    cfg = load_config(args.config)
    if args.device:
        cfg["device"] = args.device
    hours = [int(h) for h in args.hours.split(",")] if args.hours else None
    pipe = EvaluationPipeline(
        cfg, language=args.language, hours=hours,
        use_mixed_model=args.use_mixed_model,
        add_language_hint=args.add_language_hint,
    )
    result = pipe.run(args.dataset or cfg.get("dataset_root"))
    print(json.dumps({"component": result["component"],
                      "duration": result["duration"]}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
