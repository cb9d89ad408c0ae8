"""Corpus curation CLI: scan / subset / merge / ood / filter-csv / download.

The port's counterpart of the JAX package's ``tools/corpus_tool.py``: one
entry point for the capabilities of the reference's offline dataset scripts
(reference: dataset/Downloads/ — audio_duration_handler.py,
add_*_to_existing.py, build_mailabs_testset.py, csv_filter_german_emonet.py,
data_librispeech.py, download_emonet_german.py).  See
cosyvoice2_eu_torch/data/corpus.py for the library functions.  ``plot`` needs
matplotlib and ``download`` the network and the ``datasets`` package.

Examples:
  python -m cosyvoice2_eu_torch.tools.corpus_tool scan ROOT [--json out.json] [--plot hist.png]
  python -m cosyvoice2_eu_torch.tools.corpus_tool subset ROOT --hours 100 --out sel.jsonl \
      [--ratios mls_fr=0.4,mls_de=0.4,librispeech=0.2] [--materialize DST]
  python -m cosyvoice2_eu_torch.tools.corpus_tool merge SRC DST [--prefix de_]
  python -m cosyvoice2_eu_torch.tools.corpus_tool ood SRC DST [--per-speaker 20]
  python -m cosyvoice2_eu_torch.tools.corpus_tool filter-csv META.csv [--out filtered.csv]
  python -m cosyvoice2_eu_torch.tools.corpus_tool download facebook/multilingual_librispeech \
      --config french --out ROOT --hours 50 --prefix mls_fr_
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from cosyvoice2_eu_torch.data import corpus


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("scan", help="audit a corpus tree (stats, thresholds)")
    s.add_argument("root")
    s.add_argument("--splits", default=None, help="comma-separated split filter")
    s.add_argument("--json", default=None, help="write full summary JSON here")
    s.add_argument("--plot", default=None, help="write duration histogram PNG")

    s = sub.add_parser("subset", help="balanced duration-budget selection")
    s.add_argument("root")
    s.add_argument("--hours", type=float, required=True)
    s.add_argument("--out", required=True, help="JSONL file list")
    s.add_argument("--ratios", default=None, help="lang=w,lang=w (default: proportional)")
    s.add_argument("--splits", default="train")
    s.add_argument("--max-clip-s", type=float, default=30.0)
    s.add_argument("--min-clip-s", type=float, default=0.5)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--materialize", default=None, help="hardlink selection into this tree")

    s = sub.add_parser("merge", help="merge SRC tree into DST tree")
    s.add_argument("src")
    s.add_argument("dst")
    s.add_argument("--prefix", default="", help="speaker-directory prefix")
    s.add_argument("--copy", action="store_true", help="copy instead of hardlink")

    s = sub.add_parser("ood", help="build a held-out test tree (per-speaker cap)")
    s.add_argument("src")
    s.add_argument("dst")
    s.add_argument("--per-speaker", type=int, default=20)
    s.add_argument("--seed", type=int, default=0)

    s = sub.add_parser("filter-csv", help="drop bad rows from a metadata CSV")
    s.add_argument("csv")
    s.add_argument("--out", default=None, help="default: in-place with .bak backup")
    s.add_argument("--min-chars", type=int, default=3)
    s.add_argument("--max-chars", type=int, default=500)

    s = sub.add_parser("download", help="stream a HF audio dataset into a tree")
    s.add_argument("dataset")
    s.add_argument("--config", required=True)
    s.add_argument("--split", default="train")
    s.add_argument("--out", required=True)
    s.add_argument("--hours", type=float, required=True)
    s.add_argument("--sr", type=int, default=16000)
    s.add_argument("--text-col", default="transcript")
    s.add_argument("--speaker-col", default="speaker_id")
    s.add_argument("--prefix", default="")

    a = p.parse_args(argv)
    if a.cmd in ("scan", "subset") and not os.path.isdir(a.root):
        p.error(f"corpus root is not a directory: {a.root}")
    if a.cmd == "scan":
        splits = a.splits.split(",") if a.splits else None
        utts = corpus.scan_corpus(a.root, splits)
        summary = corpus.summarize(utts)
        print(json.dumps(summary, indent=2))
        if a.json:
            with open(a.json, "w") as f:
                json.dump(summary, f, indent=2)
        if a.plot and not corpus.plot_durations(utts, a.plot):
            print("matplotlib unavailable; skipped plot", file=sys.stderr)
    elif a.cmd == "subset":
        ratios = None
        if a.ratios:
            try:
                ratios = dict(
                    (k, float(v))
                    for k, v in (kv.split("=") for kv in a.ratios.split(","))
                )
            except ValueError:
                p.error(f"--ratios must be lang=weight[,lang=weight...], got {a.ratios!r}")
        utts = corpus.scan_corpus(a.root, a.splits.split(","))
        sel = corpus.budget_subset(
            utts, a.hours, ratios, a.max_clip_s, a.min_clip_s, a.seed
        )
        corpus.write_file_list(sel, a.out)
        hrs = sum(u.duration for u in sel) / 3600
        print(f"selected {len(sel)} clips, {hrs:.2f} h -> {a.out}")
        if a.materialize:
            n = corpus.materialize_subset(sel, a.root, a.materialize)
            print(f"materialized {n} files under {a.materialize}")
    elif a.cmd == "merge":
        counts = corpus.merge_tree(a.src, a.dst, a.prefix, link=not a.copy)
        print(json.dumps(counts))
    elif a.cmd == "ood":
        n = corpus.build_ood_testset(a.src, a.dst, a.per_speaker, seed=a.seed)
        print(f"wrote {n} test clips under {a.dst}")
    elif a.cmd == "filter-csv":
        kept, dropped = corpus.filter_metadata_csv(
            a.csv, a.out or a.csv, a.min_chars, a.max_chars
        )
        print(f"kept {kept}, dropped {dropped}")
    elif a.cmd == "download":
        stats = corpus.download_hf_corpus(
            a.dataset, a.config, a.split, a.out, a.hours,
            target_sr=a.sr, text_col=a.text_col,
            speaker_col=a.speaker_col, speaker_prefix=a.prefix,
        )
        print(json.dumps(stats))


if __name__ == "__main__":
    main()
