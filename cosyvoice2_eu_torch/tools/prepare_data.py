"""Dataset preparation: wav/text lists -> training parquet shards.

Counterpart of the JAX package's ``tools/prepare_data.py`` (reference:
cosy_repo/tools/extract_embedding.py, tools/extract_speech_token.py,
tools/make_parquet_list.py and examples/libritts/cosyvoice2/run.sh stages
1-4): given kaldi-style ``wav.scp`` and ``text`` files, extracts FSQ speech
tokens and CAM++ x-vectors with the port's models on ``--device`` and writes
parquet shards with the columns the training pipeline reads (utt, spk, text,
speech, sample_rate, speech_token, utt_embedding, spk_embedding).

``utterance_rows`` computes the rows (on the card); ``write_shards`` writes
them, and is the only part that needs ``pyarrow``, imported when it writes.
``--tokenizer_params`` and ``--campplus_params`` take a checkpoint directory
of either package (``runtime/checkpoint.py::load_pytree``).

Usage:
  python -m cosyvoice2_eu_torch.tools.prepare_data --wav_scp data/wav.scp \\
      --text data/text --utt2spk data/utt2spk --out_dir data/parquet \\
      --num_utts_per_parquet 1000 --tokenizer_params ckpt/tokenizer \\
      --campplus_params ckpt/campplus --device cuda
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np


def read_kv(path: str) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(maxsplit=1)
            if len(parts) == 2:
                out[parts[0]] = parts[1]
    return out


def utterance_rows(wavs: dict, texts: dict, utt2spk: dict, tokenize_fn=None,
                   embed_fn=None) -> list:
    """One row per utterance of ``wavs`` that has a text (an unreadable wav
    is skipped with a warning): the 24 kHz waveform, and with the functions
    given its speech tokens, its x-vector and its speaker's mean x-vector
    (extract_embedding.py)."""
    from cosyvoice2_eu_torch.frontend.frontend import load_wav

    rows, spk_embs = [], {}
    for utt in (u for u in wavs if u in texts):
        try:
            wav24 = load_wav(wavs[utt], 24000)
            wav16 = load_wav(wavs[utt], 16000)
        except Exception as e:
            logging.warning("skip %s: %s", utt, e)
            continue
        row = {"utt": utt, "spk": utt2spk.get(utt, utt), "text": texts[utt],
               "speech": wav24.tolist(), "sample_rate": 24000}
        if tokenize_fn is not None:
            row["speech_token"] = tokenize_fn(wav16).tolist()
        if embed_fn is not None:
            emb = embed_fn(wav16)
            row["utt_embedding"] = emb.tolist()
            spk_embs.setdefault(row["spk"], []).append(emb)
        rows.append(row)
    if embed_fn is not None:
        spk_mean = {s: np.mean(e, axis=0).tolist() for s, e in spk_embs.items()}
        for row in rows:
            row["spk_embedding"] = spk_mean[row["spk"]]
    return rows


def write_shards(rows: list, out_dir: str, num_utts_per_parquet: int = 1000) -> list:
    """Parquet shards of ``num_utts_per_parquet`` rows and their list
    ``data.list`` in ``out_dir``; returns the shard paths."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for start in range(0, len(rows), num_utts_per_parquet):
        shard = rows[start:start + num_utts_per_parquet]
        path = os.path.join(out_dir, f"parquet_{len(paths):09d}.tar.parquet")
        pq.write_table(pa.table({k: [r[k] for r in shard] for k in shard[0]}), path)
        paths.append(path)
        logging.info("wrote %s (%d utts)", path, len(shard))
    with open(os.path.join(out_dir, "data.list"), "w") as f:
        f.write("\n".join(paths) + "\n")
    return paths


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--wav_scp", required=True)
    parser.add_argument("--text", required=True)
    parser.add_argument("--utt2spk", default=None)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--num_utts_per_parquet", type=int, default=1000)
    parser.add_argument("--tokenizer_params", default=None,
                        help="checkpoint directory of the FSQ speech tokenizer")
    parser.add_argument("--campplus_params", default=None,
                        help="checkpoint directory of the CAM++ x-vector model")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from cosyvoice2_eu_torch.frontend.frontend import (
        make_speech_tokenizer_fn,
        make_spk_embedding_fn,
    )
    from cosyvoice2_eu_torch.runtime.checkpoint import load_pytree

    wavs = read_kv(args.wav_scp)
    texts = read_kv(args.text)
    utt2spk = read_kv(args.utt2spk) if args.utt2spk else {u: u for u in wavs}
    tokenize_fn = embed_fn = None
    if args.tokenizer_params:
        tokenize_fn = make_speech_tokenizer_fn(load_pytree(args.tokenizer_params),
                                               device=args.device)
    if args.campplus_params:
        embed_fn = make_spk_embedding_fn(load_pytree(args.campplus_params), device=args.device)
    rows = utterance_rows(wavs, texts, utt2spk, tokenize_fn, embed_fn)
    paths = write_shards(rows, args.out_dir, args.num_utts_per_parquet)
    logging.info("done: %d shards", len(paths))
    return paths


if __name__ == "__main__":
    main()
