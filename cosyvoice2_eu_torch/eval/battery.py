"""Research-question reporting battery over the evaluation matrix.

Re-expression of the reference's analysis stack
(reference: evaluation/generate_report.py — RQ1 component ablation :311,
RQ2 learning curve :432, RQ3 mix-vs-mono :510, B1 baselines-vs-best :594 and
compact cross-language :792, appendix efficiency :995), emitting for each
question a CSV + LaTeX table + Chart.js JSON in the table shapes the
reference publishes.  One command regenerates everything:

    python -m cosyvoice2_eu_torch.eval.battery --results-dir eval_results \
        [--languages fr,de] [--out-dir eval_results/report]

Inputs: the pipeline's ``combined_{lang}.csv`` per-sample matrices
(eval/pipeline.py:209), plus optional ``combined_{lang}_mix.csv`` (mixed-model
runs) and ``baselines_{lang}.csv`` (eval/baselines.py).  When no baseline rows
exist, B1 falls back to the retained published constants (BASELINE.md) so the
comparison story renders without external engines.

The PyTorch port's copy of ``cosyvoice2_eu_tpu/eval/battery.py``: it imports
only the port, and gives the same outputs on the same inputs.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

# metric direction: -1 = lower is better, +1 = higher is better
METRIC_DIRECTION = {
    "wer": -1, "wer_norm": -1, "cer": -1, "mcd": -1, "mcd_rel": -1,
    "lsd": -1, "gpe": -1, "f0_rmse": -1, "vuv_error": -1, "rtf": -1,
    "secs": 1, "f0_corr": 1,
}
TABLE_METRICS = ("wer", "mcd", "secs", "f0_corr", "vuv_error")
# settings shown in the main tables (the reference's MAIN_COMPONENTS,
# generate_report.py:112: only variants with a finetuned HiFi-GAN + anchors)
MAIN_MODELS = (
    "pretrained", "llm_only", "flow_only", "hifigan_only", "llm_flow",
    "llm_hifigan", "flow_hifigan", "full_finetuned",
)

# published reference numbers (BASELINE.md) used when no baseline_* rows are
# present: system -> language -> metric -> value
PUBLISHED_BASELINES = {
    "CosyVoice2-EU (reference)": {
        "fr": {"wer": 0.0877, "mcd": 8.58, "secs": 0.240, "f0_corr": 0.687, "vuv_error": 42.26},
        "de": {"wer": 0.0603, "mcd": 7.75, "secs": 0.253, "f0_corr": 0.526, "vuv_error": 42.97},
    },
    "CosyVoice2 (original)": {
        "fr": {"wer": 0.4959, "mcd": 9.65, "secs": 0.156, "f0_corr": 0.594, "vuv_error": 44.58},
        "de": {"wer": 0.6453, "mcd": 8.81, "secs": 0.137, "f0_corr": 0.486, "vuv_error": 46.02},
    },
    "XTTS-v2": {
        "fr": {"wer": 0.0897, "mcd": 6.69, "secs": 0.203, "f0_corr": 0.677, "vuv_error": 48.00},
        "de": {"wer": 0.0737, "mcd": 7.45, "secs": 0.231, "f0_corr": 0.471, "vuv_error": 48.68},
    },
    "ElevenLabs": {
        "fr": {"wer": 0.0950, "mcd": 7.77, "secs": 0.276, "f0_corr": 0.643, "vuv_error": 42.69},
        "de": {"wer": 0.0398, "mcd": 7.96, "secs": 0.289, "f0_corr": 0.547, "vuv_error": 44.79},
    },
    "OpenAudio-S1-mini": {
        "fr": {"wer": 0.1589, "mcd": 7.43, "secs": 0.161, "f0_corr": 0.656, "vuv_error": 41.24},
        "de": {"wer": 0.0833, "mcd": 7.50, "secs": 0.175, "f0_corr": 0.536, "vuv_error": 44.57},
    },
}

_PALETTE = ["#667eea", "#f6ad55", "#63b3ed", "#f093fb", "#48bb78", "#fc8181"]


# ---------------------------------------------------------------------------
# loading / aggregation
# ---------------------------------------------------------------------------

def _read_rows(path: str) -> List[dict]:
    if not os.path.exists(path):
        return []
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


def load_all_results(results_dir: str, language: str) -> Dict[str, List[dict]]:
    """{'mono': rows, 'mix': rows, 'baselines': rows} for one language."""
    return {
        "mono": _read_rows(os.path.join(results_dir, f"combined_{language}.csv")),
        "mix": _read_rows(os.path.join(results_dir, f"combined_{language}_mix.csv")),
        "baselines": _read_rows(os.path.join(results_dir, f"baselines_{language}.csv")),
    }


def primary_metric(rows: List[dict]) -> str:
    """wer_norm > wer > mcd (the reference's _pick_primary_metric :202)."""
    for m in ("wer_norm", "wer", "mcd"):
        if any(m in r for r in rows):
            return m
    return "mcd"


def agg(rows: List[dict], metric: str) -> Tuple[float, float, int]:
    vals = [r[metric] for r in rows if "error" not in r
            and isinstance(r.get(metric), float) and np.isfinite(r[metric])]
    if not vals:
        return float("nan"), float("nan"), 0
    return float(np.mean(vals)), float(np.std(vals)), len(vals)


def _sub(rows, **match):
    return [r for r in rows if all(r.get(k) == v for k, v in match.items())]


def select_anchor(rows: List[dict], primary: str) -> Tuple[Optional[str], Optional[float]]:
    """(winner_model, best_hour) minimizing/maximizing the primary metric
    (the reference's _select_best_setting_and_hour :234)."""
    best = (None, None, None)
    direction = METRIC_DIRECTION.get(primary, -1)
    for model in sorted({r.get("model") for r in rows if r.get("model") in MAIN_MODELS}):
        for hours in sorted({r.get("hours") for r in rows if r.get("model") == model}):
            mean, _, n = agg(_sub(rows, model=model, hours=hours), primary)
            if n == 0 or not np.isfinite(mean):
                continue
            score = direction * mean
            if best[2] is None or score > best[2]:
                best = (model, hours, score)
    return best[0], best[1]


def fmt(mean: float, std: float, metric: str) -> str:
    if not np.isfinite(mean):
        return "--"
    digits = 3 if abs(mean) < 10 else 2
    if np.isfinite(std):
        return f"{mean:.{digits}f} ± {std:.{digits}f}"
    return f"{mean:.{digits}f}"


def pct_impr(current: float, baseline: float, metric: str) -> float:
    """Positive = current better (reference _pct_impr :263)."""
    if not (np.isfinite(current) and np.isfinite(baseline)) or baseline == 0:
        return float("nan")
    rel = (baseline - current) / abs(baseline)
    return 100.0 * rel * (1 if METRIC_DIRECTION.get(metric, -1) < 0 else -1)


# ---------------------------------------------------------------------------
# emitters
# ---------------------------------------------------------------------------

def _write_csv(path: str, rows: List[dict]):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    keys: List[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)


def _write_tex(path: str, caption: str, header: List[str], body: List[List[str]]):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    lines = [
        "\\begin{table}[ht]", "\\centering",
        "\\begin{tabular}{l" + "r" * (len(header) - 1) + "}",
        "\\toprule",
        " & ".join(header) + " \\\\",
        "\\midrule",
    ]
    for row in body:
        lines.append(" & ".join(str(c) for c in row) + " \\\\")
    lines += [
        "\\bottomrule", "\\end{tabular}",
        f"\\caption{{{caption}}}", "\\end{table}",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _write_chart(path: str, labels, datasets, metric_label: str):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(
            {"labels": labels, "datasets": datasets, "metric_label": metric_label},
            f, indent=2,
        )


def _dataset(label: str, data, i: int, line=False):
    d = {
        "label": label, "data": data,
        "borderColor": _PALETTE[i % len(_PALETTE)],
        "backgroundColor": _PALETTE[i % len(_PALETTE)],
    }
    if line:
        d["fill"] = False
    return d


# ---------------------------------------------------------------------------
# RQ1 — component ablation at the anchor hour
# ---------------------------------------------------------------------------

def rq1_component_ablation(rows: List[dict], language: str, out_dir: str) -> dict:
    """Per-component table at the best hour + delta-vs-pretrained bars
    (reference :311-427)."""
    primary = primary_metric(rows)
    winner, best_hour = select_anchor(rows, primary)
    if winner is None:
        return {}
    at_hour = [r for r in rows if r.get("hours") == best_hour]
    models = [m for m in MAIN_MODELS if any(r.get("model") == m for r in at_hour)]

    table, csv_rows = [], []
    for m in models:
        sub = _sub(at_hour, model=m)
        cells = [m]
        crow = {"model": m, "hours": best_hour, "language": language}
        for metric in TABLE_METRICS:
            mean, std, n = agg(sub, metric)
            cells.append(fmt(mean, std, metric))
            # per-metric sample count: metrics have different NaN coverage
            # (e.g. WER over 50 rows, pitch over 10), so one shared "n"
            # column would misreport the support of every mean/std
            crow[f"{metric}_mean"], crow[f"{metric}_std"], crow[f"{metric}_n"] = (
                round(mean, 4) if np.isfinite(mean) else "",
                round(std, 4) if np.isfinite(std) else "", n,
            )
        table.append(cells)
        csv_rows.append(crow)

    tag = f"RQ1_component-ablation_{language}_best{int(best_hour)}h_{winner}"
    _write_csv(os.path.join(out_dir, "tables", f"{tag}.csv"), csv_rows)
    _write_tex(
        os.path.join(out_dir, "tables", f"{tag}.tex"),
        f"RQ1 component ablation ({language.upper()}) at the best hour "
        f"({int(best_hour)}h); winner setting: {winner}; primary metric {primary}.",
        ["component"] + [m.upper() for m in TABLE_METRICS],
        table,
    )
    # delta-vs-pretrained bars on the primary metric
    base_mean, _, _ = agg(_sub(at_hour, model="pretrained"), primary)
    deltas, labels = [], []
    for m in models:
        if m == "pretrained":
            continue
        mean, _, n = agg(_sub(at_hour, model=m), primary)
        if n:
            labels.append(m)
            deltas.append(round(pct_impr(mean, base_mean, primary), 2))
    _write_chart(
        os.path.join(out_dir, "charts", f"rq1_delta_{language}_{primary}.json"),
        labels, [_dataset(f"Δ{primary.upper()} vs pretrained (%)", deltas, 0)],
        f"Δ{primary.upper()} %",
    )
    return {"winner": winner, "best_hour": best_hour, "primary": primary,
            "models": models}


# ---------------------------------------------------------------------------
# RQ2 — learning curve
# ---------------------------------------------------------------------------

def rq2_learning_curve(rows: List[dict], language: str, out_dir: str,
                       setting: str = "full_finetuned") -> dict:
    """Primary metric + SECS vs training hours (reference :432-503)."""
    primary = primary_metric(rows)
    sub_all = _sub(rows, model=setting)
    hours = sorted({r.get("hours") for r in sub_all if r.get("hours") is not None})
    if not hours:
        return {}
    csv_rows, prim_vals, secs_vals = [], [], []
    for h in hours:
        sub = _sub(sub_all, hours=h)
        pm, ps, _ = agg(sub, primary)
        sm, ss, _ = agg(sub, "secs")
        prim_vals.append(round(pm, 4) if np.isfinite(pm) else None)
        secs_vals.append(round(sm, 4) if np.isfinite(sm) else None)
        csv_rows.append({
            "hours": h, "language": language,
            f"{primary}_mean": round(pm, 4) if np.isfinite(pm) else "",
            f"{primary}_std": round(ps, 4) if np.isfinite(ps) else "",
            "secs_mean": round(sm, 4) if np.isfinite(sm) else "",
            "secs_std": round(ss, 4) if np.isfinite(ss) else "",
        })
    tag = f"RQ2_learning-curve_{language}_{setting}"
    _write_csv(os.path.join(out_dir, "tables", f"{tag}.csv"), csv_rows)
    _write_tex(
        os.path.join(out_dir, "tables", f"{tag}.tex"),
        f"RQ2 learning curve ({language.upper()}, {setting}).",
        ["hours", primary.upper(), "SECS"],
        [[int(r["hours"]), r.get(f"{primary}_mean", ""), r.get("secs_mean", "")]
         for r in csv_rows],
    )
    labels = [f"{int(h)}h" for h in hours]
    _write_chart(
        os.path.join(out_dir, "charts", f"rq2_curve_{language}.json"),
        labels,
        [_dataset(primary.upper(), prim_vals, 0, line=True),
         _dataset("SECS", secs_vals, 1, line=True)],
        f"{primary.upper()} / SECS vs hours",
    )
    return {"hours": hours, "primary": primary}


# ---------------------------------------------------------------------------
# RQ3 — mix vs mono
# ---------------------------------------------------------------------------

def rq3_mix_vs_mono(mono: List[dict], mix: List[dict], language: str,
                    out_dir: str, setting: str = "full_finetuned") -> dict:
    """Per-metric deltas (mix - mono) at matched hours (reference :510-574)."""
    if not mono or not mix:
        return {}
    mono_s, mix_s = _sub(mono, model=setting), _sub(mix, model=setting)
    hours = sorted(
        {r.get("hours") for r in mono_s} & {r.get("hours") for r in mix_s}
    )
    if not hours:
        return {}
    csv_rows = []
    chart_sets: Dict[str, list] = {m: [] for m in TABLE_METRICS}
    for h in hours:
        row = {"hours": h, "language": language}
        for metric in TABLE_METRICS:
            mm, _, nm = agg(_sub(mono_s, hours=h), metric)
            xm, _, nx = agg(_sub(mix_s, hours=h), metric)
            delta = xm - mm if (nm and nx) else float("nan")
            row[f"{metric}_mono"] = round(mm, 4) if np.isfinite(mm) else ""
            row[f"{metric}_mix"] = round(xm, 4) if np.isfinite(xm) else ""
            row[f"{metric}_delta"] = round(delta, 4) if np.isfinite(delta) else ""
            chart_sets[metric].append(round(delta, 4) if np.isfinite(delta) else None)
        csv_rows.append(row)
    tag = f"RQ3_mix-vs-mono_{language}"
    _write_csv(os.path.join(out_dir, "tables", f"{tag}.csv"), csv_rows)
    _write_tex(
        os.path.join(out_dir, "tables", f"{tag}.tex"),
        f"RQ3 mixed-language vs monolingual deltas ({language.upper()}); "
        "negative favors mixed on error metrics.",
        ["hours"] + [f"Δ{m.upper()}" for m in TABLE_METRICS],
        [[int(r["hours"])] + [r.get(f"{m}_delta", "") for m in TABLE_METRICS]
         for r in csv_rows],
    )
    _write_chart(
        os.path.join(out_dir, "charts", f"rq3_deltas_{language}.json"),
        [f"{int(h)}h" for h in hours],
        [_dataset(f"Δ{m.upper()}", chart_sets[m], i)
         for i, m in enumerate(TABLE_METRICS)],
        "mix − mono",
    )
    return {"hours": hours}


# ---------------------------------------------------------------------------
# B1 — baselines vs best (row-wise + compact cross-language)
# ---------------------------------------------------------------------------

def _baseline_rows_or_published(baselines: List[dict], language: str) -> List[dict]:
    """Measured baseline rows when present; else published constants."""
    if baselines:
        out = []
        for system in sorted({r.get("model") for r in baselines}):
            sub = _sub(baselines, model=system)
            row = {"system": str(system)}
            for metric in TABLE_METRICS:
                mean, std, n = agg(sub, metric)
                row[metric] = mean
                row[f"{metric}_std"] = std
            row["source"] = "measured"
            out.append(row)
        return out
    out = []
    for system, per_lang in PUBLISHED_BASELINES.items():
        vals = per_lang.get(language)
        if vals:
            out.append(dict({"system": system, "source": "published (BASELINE.md)"},
                            **vals))
    return out


def b1_baselines_vs_best(rows: List[dict], baselines: List[dict], language: str,
                         out_dir: str, anchor: Optional[dict] = None) -> dict:
    """Ours at the RQ1 anchor vs each baseline system, row-wise deltas
    (reference :594-787)."""
    primary = primary_metric(rows)
    anchor = anchor or {}
    winner = anchor.get("winner")
    best_hour = anchor.get("best_hour")
    if winner is None:
        winner, best_hour = select_anchor(rows, primary)
    ours = _sub(rows, model=winner, hours=best_hour) if winner else []
    ours_vals = {m: agg(ours, m) for m in TABLE_METRICS}

    systems = _baseline_rows_or_published(baselines, language)
    csv_rows, body = [], []
    ours_cells = ["Ours (anchor)"]
    crow = {"system": "ours", "hours": best_hour, "setting": winner}
    for m in TABLE_METRICS:
        mean, std, _ = ours_vals[m]
        ours_cells.append(fmt(mean, std, m))
        crow[m] = round(mean, 4) if np.isfinite(mean) else ""
    body.append(ours_cells)
    csv_rows.append(crow)
    for srow in systems:
        cells = [srow["system"]]
        crow = {"system": srow["system"], "source": srow.get("source", "")}
        for m in TABLE_METRICS:
            val = srow.get(m, float("nan"))
            ours_mean = ours_vals[m][0]
            delta = ours_mean - val if np.isfinite(ours_mean) and np.isfinite(val) \
                else float("nan")
            cells.append(
                f"{val:.3f}" + (f" (Δ {delta:+.3f})" if np.isfinite(delta) else "")
                if np.isfinite(val) else "--"
            )
            crow[m] = round(val, 4) if np.isfinite(val) else ""
            crow[f"{m}_delta"] = round(delta, 4) if np.isfinite(delta) else ""
        body.append(cells)
        csv_rows.append(crow)

    tag = f"B1_baselines-vs-best_{language}"
    _write_csv(os.path.join(out_dir, "tables", f"{tag}.csv"), csv_rows)
    _write_tex(
        os.path.join(out_dir, "tables", f"{tag}.tex"),
        f"Baselines vs Ours ({language.upper()}); Ours at the RQ1 anchor "
        f"({winner} @ {best_hour}h); deltas are Ours − Baseline (negative "
        "favors Ours on error metrics).",
        ["system"] + [m.upper() for m in TABLE_METRICS],
        body,
    )
    # per-metric bar chart: systems side by side
    for m in TABLE_METRICS:
        labels = ["Ours"] + [s["system"] for s in systems]
        vals = [round(ours_vals[m][0], 4) if np.isfinite(ours_vals[m][0]) else None]
        vals += [round(s.get(m, float("nan")), 4)
                 if np.isfinite(s.get(m, float("nan"))) else None for s in systems]
        _write_chart(
            os.path.join(out_dir, "charts", f"b1_{language}_{m}.json"),
            labels, [_dataset(m.upper(), vals, 0)], m.upper(),
        )
    return {"systems": [s["system"] for s in systems], "anchor": winner}


def b1_compact_cross_language(per_lang: Dict[str, dict], out_dir: str) -> None:
    """Systems × metrics with one column per language (reference :792-991)."""
    langs = sorted(per_lang)
    if len(langs) < 2:
        return
    systems: List[str] = []
    for lang in langs:
        for s in per_lang[lang]["systems_rows"]:
            if s["system"] not in systems:
                systems.append(s["system"])
    body, csv_rows = [], []
    for system in systems:
        for metric in TABLE_METRICS:
            cells = [f"{system} / {metric.upper()}"]
            crow = {"system": system, "metric": metric}
            for lang in langs:
                srows = per_lang[lang]["systems_rows"]
                val = next((s.get(metric) for s in srows if s["system"] == system),
                           float("nan"))
                val = val if isinstance(val, float) else float("nan")
                cells.append(f"{val:.3f}" if np.isfinite(val) else "--")
                crow[lang] = round(val, 4) if np.isfinite(val) else ""
            body.append(cells)
            csv_rows.append(crow)
    _write_csv(os.path.join(out_dir, "tables", "B1_compact_cross_language.csv"),
               csv_rows)
    _write_tex(
        os.path.join(out_dir, "tables", "B1_compact_cross_language.tex"),
        "Systems by language (means; Ours at its per-language RQ1 anchor).",
        ["system / metric"] + [lang.upper() for lang in langs],
        body,
    )


def appendix_efficiency(rows: List[dict], language: str, out_dir: str) -> None:
    """RTF speed table at the anchor (reference :995-1036)."""
    primary = primary_metric(rows)
    winner, best_hour = select_anchor(rows, primary)
    if winner is None:
        return
    body, csv_rows = [], []
    for m in MAIN_MODELS:
        sub = _sub(rows, model=m, hours=best_hour)
        mean, std, n = agg(sub, "rtf")
        if n == 0:
            continue
        body.append([m, fmt(mean, std, "rtf")])
        csv_rows.append({"model": m, "rtf_mean": round(mean, 4),
                         "rtf_std": round(std, 4), "n": n})
    _write_csv(os.path.join(out_dir, "tables", f"APPX_speed_{language}.csv"), csv_rows)
    _write_tex(
        os.path.join(out_dir, "tables", f"APPX_speed_{language}.tex"),
        f"RTF at the anchor hour ({language.upper()}, {int(best_hour)}h).",
        ["model", "RTF"], body,
    )


# ---------------------------------------------------------------------------
# the whole battery
# ---------------------------------------------------------------------------

def generate_battery(results_dir: str, out_dir: Optional[str] = None,
                     languages: Optional[List[str]] = None) -> dict:
    out_dir = out_dir or os.path.join(results_dir, "report")
    languages = languages or _detect_languages(results_dir)
    manifest: dict = {"languages": languages, "out_dir": out_dir, "written": []}
    per_lang_b1: Dict[str, dict] = {}
    for lang in languages:
        data = load_all_results(results_dir, lang)
        rows = data["mono"]
        if not rows:
            continue
        anchor = rq1_component_ablation(rows, lang, out_dir)
        rq2_learning_curve(rows, lang, out_dir)
        rq3_mix_vs_mono(rows, data["mix"], lang, out_dir)
        b1 = b1_baselines_vs_best(rows, data["baselines"], lang, out_dir,
                                  anchor=anchor)
        appendix_efficiency(rows, lang, out_dir)
        # compact table rows: Ours at its per-language anchor + the systems
        ours_row = {"system": "Ours (anchor)"}
        if anchor.get("winner") is not None:
            at = _sub(rows, model=anchor["winner"], hours=anchor["best_hour"])
            for m in TABLE_METRICS:
                mean, _, n = agg(at, m)
                if n:
                    ours_row[m] = mean
        per_lang_b1[lang] = {
            "systems_rows": [ours_row]
            + _baseline_rows_or_published(data["baselines"], lang),
            "anchor": anchor,
        }
        manifest[lang] = {"anchor": anchor, "b1": b1}
    b1_compact_cross_language(per_lang_b1, out_dir)
    for sub in ("tables", "charts"):
        d = os.path.join(out_dir, sub)
        if os.path.isdir(d):
            manifest["written"] += sorted(
                os.path.join(sub, f) for f in os.listdir(d)
            )
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def export_charts_to_docs(out_dir: str, docs_charts_dir: str) -> List[str]:
    """Copy the battery's Chart.js JSONs into the docs site's
    generated_charts/ dir and merge them into its flat manifest.json
    (docs/index.html fetch contract)."""
    import shutil

    src = os.path.join(out_dir, "charts")
    if not os.path.isdir(src):
        return []
    os.makedirs(docs_charts_dir, exist_ok=True)
    manifest_path = os.path.join(docs_charts_dir, "manifest.json")
    names: List[str] = []
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            names = json.load(f)
    copied = []
    for f_name in sorted(os.listdir(src)):
        if f_name.endswith(".json"):
            shutil.copy2(os.path.join(src, f_name),
                         os.path.join(docs_charts_dir, f_name))
            copied.append(f_name)
            if f_name not in names:
                names.append(f_name)
    with open(manifest_path, "w") as f:
        json.dump(names, f, indent=2)
    return copied


def _detect_languages(results_dir: str) -> List[str]:
    langs = []
    if os.path.isdir(results_dir):
        for f in sorted(os.listdir(results_dir)):
            if f.startswith("combined_") and f.endswith(".csv") \
                    and not f.endswith("_mix.csv"):
                langs.append(f[len("combined_"):-len(".csv")])
    return langs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--results-dir", required=True)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--languages", default=None, help="comma list, e.g. fr,de")
    p.add_argument("--docs-charts-dir", default=None,
                   help="also export charts into the docs site "
                        "(docs/generated_charts)")
    args = p.parse_args(argv)
    langs = args.languages.split(",") if args.languages else None
    manifest = generate_battery(args.results_dir, args.out_dir, langs)
    if args.docs_charts_dir:
        copied = export_charts_to_docs(manifest["out_dir"], args.docs_charts_dir)
        manifest["docs_charts"] = copied
    print(json.dumps({k: v for k, v in manifest.items() if k != "written"},
                     indent=2))
    print(f"{len(manifest['written'])} artifacts in {manifest['out_dir']}")


if __name__ == "__main__":
    main()
