"""Corpus curation: scan / audit / subset / merge `split/speaker/*.wav` trees.

The port's own copy of ``cosyvoice2_eu_tpu/data/corpus.py`` (reference:
dataset/Downloads/audio_duration_handler.py:291-1000 scan+stats+balanced
subsets, add_*_to_existing.py merge helpers, build_mailabs_testset.py OOD
test-set builder, csv_filter_german_emonet.py metadata filtering,
data_librispeech.py / download_emonet_german.py HF-streaming downloaders).
The on-disk layout is the one the whole stack consumes
(evaluation/dataset_reader.py:17): ``<root>/<split>/<speaker>/<utt>.wav`` with
a sibling ``<utt>.normalized.txt`` transcript.

Everything here is host-side stdlib + numpy: wav durations come from header
metadata (no decode), selection is deterministic under a seed, and network
downloaders are import-gated so the module works in hermetic environments.
"""

from __future__ import annotations

import csv
import hashlib
import json
import os
import random
import shutil
import wave
from collections import defaultdict
from dataclasses import dataclass, field, asdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Scanning
# ---------------------------------------------------------------------------


@dataclass
class Utt:
    """One utterance: a wav + transcript pair inside a corpus tree."""

    wav: str
    text: str  # transcript path ("" if missing)
    split: str
    speaker: str
    duration: float  # seconds (0.0 if unreadable)
    chars: int
    words: int
    lang: str  # dataset/language tag inferred from the speaker prefix

    @property
    def ok(self) -> bool:
        return self.duration > 0.0 and self.chars > 0


def wav_duration(path: str) -> float:
    """Duration in seconds from the wav header only (no sample decode)."""
    try:
        with wave.open(path, "rb") as w:
            fr = w.getframerate()
            return w.getnframes() / fr if fr else 0.0
    except Exception:
        return 0.0


def infer_lang(speaker: str) -> str:
    """Dataset/language tag from the speaker-directory naming convention.

    The reference corpora prefix speakers with their source
    (e.g. ``mls_fr_1234``, ``de_emonet_anna``, ``librispeech_5678``);
    bare numeric ids are treated as ``librispeech``.
    """
    parts = speaker.split("_")
    if parts[0].isdigit():
        return "librispeech"
    tag = []
    for p in parts:
        if p.isdigit():
            break
        tag.append(p)
    return "_".join(tag) or "unknown"


def scan_corpus(
    root: str, splits: Optional[Sequence[str]] = None
) -> List[Utt]:
    """Walk a ``root/split/speaker/*.wav`` tree and pair transcripts.

    Mirrors the pairing rules of the reference scanner
    (audio_duration_handler.py:245-289): a transcript is
    ``<utt>.normalized.txt`` next to the wav, falling back to ``<utt>.txt``.
    """
    rootp = Path(root)
    out: List[Utt] = []
    for split_dir in sorted(p for p in rootp.iterdir() if p.is_dir()):
        if splits and split_dir.name not in splits:
            continue
        for spk_dir in sorted(p for p in split_dir.iterdir() if p.is_dir()):
            for wav_p in sorted(spk_dir.glob("*.wav")):
                txt_p = wav_p.with_suffix(".normalized.txt")
                if not txt_p.exists():
                    txt_p = wav_p.with_suffix(".txt")
                chars = words = 0
                if txt_p.exists():
                    try:
                        text = txt_p.read_text(encoding="utf-8").strip()
                        chars, words = len(text), len(text.split())
                    except Exception:
                        pass
                out.append(
                    Utt(
                        wav=str(wav_p),
                        text=str(txt_p) if txt_p.exists() else "",
                        split=split_dir.name,
                        speaker=spk_dir.name,
                        duration=wav_duration(str(wav_p)),
                        chars=chars,
                        words=words,
                        lang=infer_lang(spk_dir.name),
                    )
                )
    return out


# ---------------------------------------------------------------------------
# Stats / audit
# ---------------------------------------------------------------------------


def summarize(utts: Sequence[Utt]) -> Dict:
    """Aggregate stats per split / lang / speaker plus duration thresholds.

    Covers the reporting surface of the reference auditor
    (audio_duration_handler.py:183-576): totals, per-category hours,
    problem counts, and the share of audio above common clip-length
    thresholds (which drives truncation/bucket choices).
    """
    import numpy as np

    by = lambda: defaultdict(lambda: {"n": 0, "seconds": 0.0, "bad": 0})
    per_split, per_lang, per_speaker = by(), by(), by()
    durs = []
    for u in utts:
        for table, key in (
            (per_split, u.split),
            (per_lang, u.lang),
            (per_speaker, f"{u.split}/{u.speaker}"),
        ):
            row = table[key]
            row["n"] += 1
            row["seconds"] += u.duration
            row["bad"] += 0 if u.ok else 1
        if u.duration > 0:
            durs.append(u.duration)
    d = np.asarray(durs, np.float64) if durs else np.zeros(0)
    thresholds = {
        f">{t}s": {
            "clips": int((d > t).sum()),
            "hours": float(d[d > t].sum() / 3600.0),
        }
        for t in (10, 20, 30, 60)
    }
    return {
        "total": {
            "n": len(utts),
            "hours": float(d.sum() / 3600.0),
            "bad": sum(0 if u.ok else 1 for u in utts),
            "mean_s": float(d.mean()) if d.size else 0.0,
            "p50_s": float(np.median(d)) if d.size else 0.0,
            "p95_s": float(np.percentile(d, 95)) if d.size else 0.0,
        },
        "per_split": {k: dict(v) for k, v in sorted(per_split.items())},
        "per_lang": {k: dict(v) for k, v in sorted(per_lang.items())},
        "speakers": len(per_speaker),
        "thresholds": thresholds,
    }


def plot_durations(utts: Sequence[Utt], out_png: str) -> bool:
    """Clip-length histogram (matplotlib-gated), as in the reference plots."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False
    durs = [u.duration for u in utts if u.duration > 0]
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.hist(durs, bins=60)
    ax.set_xlabel("clip duration (s)")
    ax.set_ylabel("count")
    ax.set_title(f"{len(durs)} clips, {sum(durs) / 3600:.1f} h")
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return True


# ---------------------------------------------------------------------------
# Duration-budget subsets
# ---------------------------------------------------------------------------


def budget_subset(
    utts: Sequence[Utt],
    target_hours: float,
    lang_ratios: Optional[Dict[str, float]] = None,
    max_clip_s: float = 30.0,
    min_clip_s: float = 0.5,
    seed: int = 0,
) -> List[Utt]:
    """Select ~target_hours of clips, balanced across languages and speakers.

    Re-expression of the reference's balanced-split builder
    (audio_duration_handler.py:651-1000): per-language budgets from
    ``lang_ratios`` (default: proportional to available hours), then
    round-robin across that language's speakers so no speaker dominates.
    Deterministic under ``seed``.
    """
    rng = random.Random(seed)
    eligible = [u for u in utts if u.ok and min_clip_s <= u.duration <= max_clip_s]
    by_lang: Dict[str, List[Utt]] = defaultdict(list)
    for u in eligible:
        by_lang[u.lang].append(u)
    avail = {k: sum(u.duration for u in v) for k, v in by_lang.items()}
    total_avail = sum(avail.values()) or 1.0
    if lang_ratios is None:
        lang_ratios = {k: v / total_avail for k, v in avail.items()}
    norm = sum(lang_ratios.values()) or 1.0
    target_s = target_hours * 3600.0

    picked: List[Utt] = []
    for lang, ratio in sorted(lang_ratios.items()):
        budget = target_s * ratio / norm
        by_spk: Dict[str, List[Utt]] = defaultdict(list)
        for u in by_lang.get(lang, []):
            by_spk[u.speaker].append(u)
        queues = []
        for spk in sorted(by_spk):
            q = by_spk[spk]
            rng.shuffle(q)
            queues.append(q)
        rng.shuffle(queues)
        got = 0.0
        # round-robin one clip per speaker per pass until the budget is met
        while queues and got < budget:
            next_queues = []
            for q in queues:
                if got >= budget:
                    break
                u = q.pop()
                picked.append(u)
                got += u.duration
                if q:
                    next_queues.append(q)
            queues = next_queues
    return picked


def write_file_list(utts: Sequence[Utt], path: str) -> None:
    """Persist a selection as JSONL (one utterance record per line)."""
    with open(path, "w", encoding="utf-8") as f:
        for u in utts:
            f.write(json.dumps(asdict(u), ensure_ascii=False) + "\n")


def read_file_list(path: str) -> List[Utt]:
    with open(path, encoding="utf-8") as f:
        return [Utt(**json.loads(line)) for line in f if line.strip()]


def materialize_subset(
    utts: Sequence[Utt], src_root: str, dst_root: str, link: bool = True
) -> int:
    """Copy (or hardlink) a selection into a new corpus tree."""
    n = 0
    for u in utts:
        for src in filter(None, (u.wav, u.text)):
            rel = os.path.relpath(src, src_root)
            dst = os.path.join(dst_root, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            if os.path.exists(dst):
                continue
            if link:
                try:
                    os.link(src, dst)
                except OSError:
                    shutil.copy2(src, dst)
            else:
                shutil.copy2(src, dst)
            n += 1
    return n


# ---------------------------------------------------------------------------
# Merging corpora
# ---------------------------------------------------------------------------


def merge_tree(
    src_root: str,
    dst_root: str,
    speaker_prefix: str = "",
    splits: Optional[Sequence[str]] = None,
    link: bool = True,
) -> Dict[str, int]:
    """Merge one corpus tree into another, optionally prefixing speakers.

    Replaces the reference's add_*_to_existing.py family: speaker
    directories from ``src_root`` land under the same split in
    ``dst_root`` as ``<prefix><speaker>`` so merged datasets stay
    distinguishable (and `infer_lang` keeps working).
    """
    counts: Dict[str, int] = defaultdict(int)
    for u in scan_corpus(src_root, splits):
        spk = f"{speaker_prefix}{u.speaker}" if speaker_prefix else u.speaker
        dst_dir = os.path.join(dst_root, u.split, spk)
        os.makedirs(dst_dir, exist_ok=True)
        for src in filter(None, (u.wav, u.text)):
            dst = os.path.join(dst_dir, os.path.basename(src))
            if os.path.exists(dst):
                continue
            if link:
                try:
                    os.link(src, dst)
                except OSError:
                    shutil.copy2(src, dst)
            else:
                shutil.copy2(src, dst)
            counts[u.split] += 1
    return dict(counts)


# ---------------------------------------------------------------------------
# OOD test set (M-AILABS style)
# ---------------------------------------------------------------------------


def build_ood_testset(
    src_root: str,
    dst_root: str,
    per_speaker: int = 20,
    min_clip_s: float = 1.0,
    max_clip_s: float = 20.0,
    seed: int = 0,
) -> int:
    """Build a small held-out test tree by sampling per speaker.

    Capability match for build_mailabs_testset.py: cap clips per speaker,
    bound clip lengths, deterministic sampling; the output keeps the
    standard tree layout under split name ``test``.
    """
    rng = random.Random(seed)
    by_spk: Dict[str, List[Utt]] = defaultdict(list)
    for u in scan_corpus(src_root):
        if u.ok and min_clip_s <= u.duration <= max_clip_s:
            by_spk[u.speaker].append(u)
    n = 0
    for spk in sorted(by_spk):
        clips = by_spk[spk]
        rng.shuffle(clips)
        for u in clips[:per_speaker]:
            dst_dir = os.path.join(dst_root, "test", spk)
            os.makedirs(dst_dir, exist_ok=True)
            for src in filter(None, (u.wav, u.text)):
                dst = os.path.join(dst_dir, os.path.basename(src))
                if not os.path.exists(dst):
                    shutil.copy2(src, dst)
            n += 1
    return n


# ---------------------------------------------------------------------------
# Metadata CSV filtering
# ---------------------------------------------------------------------------


def filter_metadata_csv(
    src_csv: str,
    dst_csv: str,
    min_chars: int = 3,
    max_chars: int = 500,
    required_cols: Sequence[str] = ("file", "text"),
    backup: bool = True,
) -> Tuple[int, int]:
    """Filter bad rows from a metadata CSV, keeping a .bak of the original.

    Capability match for csv_filter_german_emonet.py /
    backup_and_filter_emonet.py: drops rows with missing columns or
    out-of-range transcript lengths. Returns (kept, dropped).
    """
    if backup and os.path.abspath(src_csv) == os.path.abspath(dst_csv):
        shutil.copy2(src_csv, src_csv + ".bak")
    with open(src_csv, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
        fieldnames = rows[0].keys() if rows else required_cols
    kept, dropped = [], 0
    for r in rows:
        text = (r.get("text") or "").strip()
        if all((r.get(c) or "").strip() for c in required_cols) and (
            min_chars <= len(text) <= max_chars
        ):
            kept.append(r)
        else:
            dropped += 1
    with open(dst_csv, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=list(fieldnames))
        w.writeheader()
        w.writerows(kept)
    return len(kept), dropped


# ---------------------------------------------------------------------------
# HF streaming download (network-gated)
# ---------------------------------------------------------------------------


def write_wav(path: str, audio, sr: int) -> None:
    """Write mono float32 [-1,1] samples as 16-bit PCM wav (stdlib only)."""
    import numpy as np

    pcm = (np.clip(np.asarray(audio, np.float32), -1, 1) * 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def download_hf_corpus(
    dataset: str,
    config: str,
    split: str,
    out_root: str,
    target_hours: float,
    target_sr: int = 16000,
    audio_col: str = "audio",
    text_col: str = "transcript",
    speaker_col: Optional[str] = "speaker_id",
    speaker_prefix: str = "",
    out_split: str = "train",
) -> Dict[str, float]:
    """Stream a HuggingFace audio dataset into the standard corpus tree.

    Capability match for data_librispeech.py:41-120 and
    download_emonet_german.py: streaming iteration with a wall duration
    budget, resample to ``target_sr``, write ``<utt>.wav`` +
    ``<utt>.normalized.txt`` under ``out_root/<out_split>/<speaker>/``.
    Requires network + the `datasets` package; import is deferred so the
    rest of this module stays hermetic.
    """
    from datasets import Audio, load_dataset  # deferred: network-facing dep

    ds = load_dataset(dataset, config, split=split, streaming=True)
    ds = ds.cast_column(audio_col, Audio(sampling_rate=target_sr))
    budget_s = target_hours * 3600.0
    got_s = 0.0
    n = 0
    for sample in ds:
        if got_s >= budget_s:
            break
        audio = sample[audio_col]
        data, sr = audio["array"], audio["sampling_rate"]
        text = str(sample.get(text_col, "")).strip()
        if not text or len(data) == 0:
            continue
        spk = str(sample.get(speaker_col, "spk")) if speaker_col else "spk"
        spk = f"{speaker_prefix}{spk}"
        utt = f"{spk}_{n:08d}"
        d = os.path.join(out_root, out_split, spk)
        os.makedirs(d, exist_ok=True)
        write_wav(os.path.join(d, utt + ".wav"), data, sr)
        Path(os.path.join(d, utt + ".normalized.txt")).write_text(
            text, encoding="utf-8"
        )
        got_s += len(data) / sr
        n += 1
    return {"clips": n, "hours": got_s / 3600.0}
