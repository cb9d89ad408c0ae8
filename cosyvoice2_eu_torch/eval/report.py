"""Report + web-chart generation from evaluation results.

Re-expression of the reference's reporting stack
(reference: evaluation/generate_report.py:311-594 — RQ1 component ablation,
RQ2 learning curve, RQ3 mix-vs-mono tables/plots — and
evaluation/generate_web_charts.py — Chart.js JSON payloads consumed by the
docs site, format as docs/generated_charts/*.json).

The PyTorch port's copy of ``cosyvoice2_eu_tpu/eval/report.py``: it imports
only the port, and gives the same outputs on the same inputs.
"""

from __future__ import annotations

import csv
import json
import os
from typing import List, Optional

import numpy as np

# the docs site's palette (docs/generated_charts/*.json backgroundColor)
_PALETTE = ["#667eea", "#f6ad55", "#63b3ed", "#f093fb", "#48bb78", "#fc8181"]

CHART_METRICS = ("wer", "mcd", "secs", "f0_corr", "vuv_error", "rtf")


def read_csv(path: str) -> List[dict]:
    with open(path, newline="") as f:
        rows = []
        for row in csv.DictReader(f):
            out = {}
            for k, v in row.items():
                if v in ("", None):
                    continue
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
            rows.append(out)
        return rows


def chart_payload(labels: List[str], values: List[float], metric: str) -> dict:
    """One Chart.js bar-chart JSON (generate_web_charts.py output shape)."""
    colors = [_PALETTE[i % len(_PALETTE)] for i in range(len(labels))]
    return {
        "labels": labels,
        "datasets": [
            {
                "label": metric.upper(),
                "data": values,
                "backgroundColor": colors,
                "borderColor": colors,
            }
        ],
        "metric_label": metric.upper(),
    }


def write_component_charts(component_rows: List[dict], out_dir: str,
                           language: str) -> List[str]:
    """RQ1: one chart per metric across the component-ablation settings."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for metric in CHART_METRICS:
        key = f"{metric}_mean"
        rows = [r for r in component_rows if key in r]
        if not rows:
            continue
        payload = chart_payload(
            [str(r["model"]) for r in rows], [float(r[key]) for r in rows], metric
        )
        path = os.path.join(out_dir, f"component_{language}_{metric}.json")
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
        written.append(path)
    return written


def write_duration_charts(duration_rows: List[dict], out_dir: str,
                          language: str) -> List[str]:
    """RQ2: learning-curve charts (metric vs training hours)."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for metric in CHART_METRICS:
        key = f"{metric}_mean"
        rows = sorted(
            (r for r in duration_rows if key in r), key=lambda r: float(r["hours"])
        )
        if not rows:
            continue
        payload = {
            "labels": [f"{int(float(r['hours']))}h" for r in rows],
            "datasets": [
                {
                    "label": metric.upper(),
                    "data": [float(r[key]) for r in rows],
                    "borderColor": _PALETTE[0],
                    "backgroundColor": _PALETTE[0],
                    "fill": False,
                }
            ],
            "metric_label": metric.upper(),
        }
        path = os.path.join(out_dir, f"efficiency_{language}_{metric}.json")
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
        written.append(path)
    return written


def write_mix_vs_mono(mono_rows: List[dict], mix_rows: List[dict],
                      out_dir: str, language: str) -> List[str]:
    """RQ3: mixed-language model vs monolingual at matched hours."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for metric in CHART_METRICS:
        key = f"{metric}_mean"
        mono = {float(r["hours"]): float(r[key]) for r in mono_rows if key in r}
        mix = {float(r["hours"]): float(r[key]) for r in mix_rows if key in r}
        hours = sorted(set(mono) & set(mix))
        if not hours:
            continue
        payload = {
            "labels": [f"{int(h)}h" for h in hours],
            "datasets": [
                {"label": "monolingual", "data": [mono[h] for h in hours],
                 "borderColor": _PALETTE[0], "backgroundColor": _PALETTE[0]},
                {"label": "mixed", "data": [mix[h] for h in hours],
                 "borderColor": _PALETTE[1], "backgroundColor": _PALETTE[1]},
            ],
            "metric_label": metric.upper(),
        }
        path = os.path.join(out_dir, f"mix_vs_mono_{language}_{metric}.json")
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
        written.append(path)
    return written


def paper_tables(component_rows: List[dict], duration_rows: List[dict]) -> str:
    """LaTeX-ish summary tables (generate_report.py paper outputs)."""
    lines = []
    if component_rows:
        keys = [k for k in ("mcd_mean", "wer_mean", "secs_mean", "f0_corr_mean")
                if any(k in r for r in component_rows)]
        lines.append("% RQ1 component ablation")
        lines.append("\\begin{tabular}{l" + "r" * len(keys) + "}")
        lines.append("model & " + " & ".join(k[:-5].upper() for k in keys) + " \\\\")
        for r in component_rows:
            vals = " & ".join(f"{r.get(k, float('nan')):.3f}" for k in keys)
            lines.append(f"{r['model']} & {vals} \\\\")
        lines.append("\\end{tabular}")
    if duration_rows:
        lines.append("% RQ2 learning curve")
        for r in duration_rows:
            lines.append(
                f"% {r['hours']}h: " + ", ".join(
                    f"{k}={v}" for k, v in r.items() if k.endswith("_mean")
                )
            )
    return "\n".join(lines) + "\n"


def generate_all(results_dir: str, charts_dir: Optional[str] = None,
                 language: str = "fr") -> dict:
    """Read the pipeline's analysis CSVs and emit charts + tables."""
    charts_dir = charts_dir or os.path.join(results_dir, "generated_charts")
    component = read_csv(os.path.join(results_dir, "component_analysis.csv"))
    duration = read_csv(os.path.join(results_dir, "duration_analysis.csv"))
    written = write_component_charts(component, charts_dir, language)
    written += write_duration_charts(duration, charts_dir, language)
    with open(os.path.join(charts_dir, "manifest.json"), "w") as f:
        json.dump([os.path.basename(p) for p in written], f, indent=2)
    tex = paper_tables(component, duration)
    tex_path = os.path.join(results_dir, "paper_tables.tex")
    with open(tex_path, "w") as f:
        f.write(tex)
    return {"charts": written, "tables": tex_path}


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--results-dir", required=True)
    p.add_argument("--charts-dir", default=None)
    p.add_argument("--language", default="fr")
    args = p.parse_args(argv)
    out = generate_all(args.results_dir, args.charts_dir, args.language)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
